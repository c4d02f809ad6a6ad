"""The split-KV plan of the two bf16 GQA attention kernels
(``kernels/gqa_split.py``, read by ``flash_attention`` and
``paged_flash_decode``), a plain-torch model of the kernels' split
algebra held against both plain versions, and the kernel build's hash of
the shared header.

The model mirrors ``csrc/gqa_attention.cuh``: per (slot, kv head, tile
of 16 position-major query rows), the key range the rows can see, cut
into key tiles, the tiles cut into splits by ``split_tiles``; each split
keeps a partial (m, l, unnormalised acc), and the partials are combined
in split order.  It is test code only: nothing on the main path uses it.
At fp32 it must agree with ``flash_attention_ref`` and
``paged_flash_decode_ref`` to the reference's 2e-5 kernel bar."""
import numpy as np
import pytest
import torch

from test_kernels import FLASH_CASES
from torch_paged_cases import GQA_CASES, paged_case

from repro_torch.kernels import (build, flash_attention_ref,
                                 paged_flash_decode_ref)
from repro_torch.kernels import gqa_split
from repro_torch.models.attention import PagedView, paged_read

torch.set_num_threads(2)

TOL = 2e-5              # the reference's own kernel-vs-oracle bar
NEG_FLOOR = -1e30       # the kernels' running-max floor (kNegInf)
ROW_TILE = gqa_split.ROWS[1]   # rows a one-warp (split) block owns

# the six bf16 main-path calls: (name, B * hk, g * S, max keys a slot)
MAIN_PATH = [
    ("flash prefill B8 S=T=512", 8 * 8, 2 * 512, 512),
    ("flash decode B8 S1 T576", 8 * 8, 2 * 1, 576),
    ("paged chunk B1 S32 qwen h16", 1 * 8, 2 * 32, 37 * 16),
    ("paged chunk B1 S32 jamba h32", 1 * 8, 4 * 32, 37 * 16),
    ("paged decode B8 S1 qwen h16", 8 * 8, 2 * 1, 37 * 16),
    ("paged decode B8 S1 jamba h32", 8 * 8, 4 * 1, 37 * 16),
]


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_tiles", range(0, 41))
def test_split_tiles_cover_every_tile_exactly_once(n_tiles):
    for splits in range(1, gqa_split.MAX_SPLITS + 1):
        walked = [t for s in range(splits)
                  for t in gqa_split.split_tiles(5, n_tiles, splits, s)]
        assert walked == list(range(5, 5 + n_tiles)), (n_tiles, splits)


@pytest.mark.parametrize("case", MAIN_PATH, ids=lambda c: c[0])
def test_plan_fills_the_card_on_the_main_path(case):
    _, kv_blocks, rows, max_keys = case
    warps, splits = gqa_split.plan(kv_blocks, rows, max_keys)
    assert 1 <= splits <= gqa_split.MAX_SPLITS
    assert gqa_split.blocks(kv_blocks, rows, warps, splits) >= gqa_split.SMS


def test_plan_slab_prefill_takes_one_split_of_128_rows():
    assert gqa_split.plan(64, 1024, 512) == (4, 1)
    assert gqa_split.blocks(64, 1024, 4, 1) == 512
    assert gqa_split.plan(16, 1024, 512)[0] == 1       # 128 blocks: split


def test_plan_never_exceeds_the_cluster_limit():
    for kv_blocks in (1, 2, 8, 64, 200):
        for rows in (1, 2, 16, 64, 1024):
            for max_keys in (1, 63, 64, 65, 592, 4096, 32768):
                warps, splits = gqa_split.plan(kv_blocks, rows, max_keys)
                assert warps in (1, 4)
                assert 1 <= splits <= gqa_split.MAX_SPLITS
                assert splits <= -(-max_keys // gqa_split.KEY_TILE[warps])
                if warps > 1:
                    assert splits == 1


# --------------------------------------------------------------------------
# the split-combine model against both plain versions
# --------------------------------------------------------------------------

def split_model(q, k, v, qpos, *, causal, window, limit, key_tile, splits):
    """q (B, S, h, hd); k, v (B, T, hk, hd) slot-major; qpos (B, S) int.
    Key t is visible to a row at position p iff t < limit, t <= p (when
    causal) and t > p - window (when window > 0).  Rows with no visible
    key output 0."""
    B, S, h, hd = q.shape
    hk = k.shape[2]
    g = h // hk
    out = torch.zeros(B, S, h, hd)
    scale = np.float32(1.0 / np.sqrt(hd))
    for b in range(B):
        for kvh in range(hk):
            rows = [(s, kvh * g + m) for s in range(S) for m in range(g)]
            for r0 in range(0, len(rows), ROW_TILE):
                tile = rows[r0:r0 + ROW_TILE]
                pos = torch.tensor([int(qpos[b, s]) for s, _ in tile])
                hi = min(int(pos.max()), limit - 1) if causal else limit - 1
                lo = max(0, int(pos.min()) - window + 1) if window else 0
                n = hi // key_tile - lo // key_tile + 1 if hi >= lo else 0
                qr = torch.stack([q[b, s, head] for s, head in tile]).float()
                parts = []
                for split in range(splits):
                    tiles = gqa_split.split_tiles(lo // key_tile, n, splits,
                                                  split)
                    keys = torch.arange(tiles.start * key_tile,
                                        tiles.stop * key_tile)
                    keys = keys[(keys >= lo) & (keys <= hi)]
                    sc = (qr @ k[b, keys, kvh].float().T) * scale
                    vis = (keys[None, :] < limit).expand(len(tile), -1)
                    if causal:
                        vis = vis & (keys[None, :] <= pos[:, None])
                    if window:
                        vis = vis & (keys[None, :] > pos[:, None] - window)
                    sc = torch.where(vis, sc, -torch.inf)
                    m = torch.clamp(sc.max(dim=1).values if len(keys)
                                    else torch.full((len(tile),), -torch.inf),
                                    min=NEG_FLOOR)
                    p = torch.exp(sc - m[:, None])
                    parts.append((m, p.sum(dim=1), p @ v[b, keys, kvh].float()))
                big_m = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                big_l = torch.zeros(len(tile))
                acc = torch.zeros(len(tile), hd)
                for m, l, a in parts:                    # split order
                    w = torch.exp(m - big_m)
                    big_l = big_l + l * w
                    acc = acc + a * w[:, None]
                res = torch.where(big_l[:, None] > 0,
                                  acc / big_l.clamp(min=1e-30)[:, None], 0.0)
                for (s, head), row in zip(tile, res):
                    out[b, s, head] = row
    return out


# (key tile, splits); None: the plan's, at the one-warp blocks' tile
SPLITS = [(gqa_split.KEY_TILE[1], None), (8, 3), (8, 8)]


def _splits(given, kv_blocks, rows, max_keys):
    return given or gqa_split.plan(kv_blocks, rows, max_keys)[1]


@pytest.mark.parametrize("key_tile,splits", SPLITS)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_split_model_matches_flash_ref(case, key_tile, splits):
    B, S, T, h, hk, hd, causal, window = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, S, h, hd), (B, T, hk, hd), (B, T, hk, hd)))
    qpos = np.broadcast_to(np.arange(S) + T - S, (B, S))
    got = split_model(q, k, v, qpos, causal=causal, window=window, limit=T,
                      key_tile=key_tile,
                      splits=_splits(splits, B * hk, h // hk * S, T))
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def _paged_model(q, k, v, table, pos, ps, window, key_tile, splits):
    B, S, h, hd = q.shape
    hk, W = k.shape[1], table.shape[1]
    view = PagedView(table, ps)
    k_full, _ = paged_read(k, view)
    v_full, _ = paged_read(v, view)
    return split_model(q, k_full, v_full, pos, causal=True, window=window,
                       limit=W * ps, key_tile=key_tile,
                       splits=_splits(splits, B * hk, h // hk * S, W * ps))


PAGED_EXTRA = [
    # B, S, h, hk, hd, page_size, W, window, lengths
    # the windowed chunk: every key of the early splits is masked
    (4, 32, 4, 2, 32, 16, 37, 100, (40, 200, 333, 560)),
    # decode with a slot holding one token
    (3, 1, 8, 2, 64, 16, 37, 0, (1, 17, 592)),
    # Jamba's group of 4 over a chunk
    (1, 32, 8, 2, 32, 16, 37, 0, (512,)),
]


@pytest.mark.parametrize("key_tile,splits", SPLITS)
@pytest.mark.parametrize("case", GQA_CASES + PAGED_EXTRA)
def test_split_model_matches_paged_ref(case, key_tile, splits):
    B, S, h, hk, hd, ps, W, window = case[:8]
    lengths = case[8] if len(case) > 8 else None
    q, k, v, table, pos = (torch.from_numpy(x) for x in paged_case(
        sum(case[:8]), B, S, h, hk, hd, ps, W, lengths=lengths))
    got = _paged_model(q, k, v, table, pos, ps, window, key_tile, splits)
    want = paged_flash_decode_ref(q, k, v, table, pos, page_size=ps,
                                  window=window)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("key_tile,splits", SPLITS)
def test_split_model_row_without_a_visible_key_is_zero(key_tile, splits):
    """A padded query (position -1) sees no key: every split keeps l = 0
    and m at the floor, and the combined row is exactly 0; the other
    rows still match the plain version."""
    B, S, h, hk, hd, ps, W = 2, 5, 4, 2, 32, 8, 6
    q, k, v, table, pos = (torch.from_numpy(x) for x in paged_case(
        11, B, S, h, hk, hd, ps, W, lengths=(30, 48)))
    pos[0, 0] = -1
    got = _paged_model(q, k, v, table, pos, ps, 0, key_tile, splits)
    assert torch.equal(got[0, 0], torch.zeros(h, hd))
    want = paged_flash_decode_ref(q, k, v, table, pos, page_size=ps)
    seen = pos >= 0
    torch.testing.assert_close(got[seen], want[seen], atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# the build hashes the shared header
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stem", ["flash_attention", "paged_decode"])
def test_editing_a_header_changes_the_build_path(stem, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._paths(stem)[1]
    assert build._paths(stem)[1] == before          # stable
    header = csrc / "gqa_attention.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build._paths(stem)[1] != before
