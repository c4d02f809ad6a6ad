"""The split-KV plan of the bf16 absorbed-MLA kernel (``kernels/
mla_split.py``, read by ``paged_flash_decode_mla``), a plain-torch model
of the kernel's algebra held against the plain version, and the kernel
build's hash of the PTX header.

The model mirrors ``csrc/paged_decode_mla.cu``: per (slot, tile of 64
position-major query rows), the key range the rows can see, cut into
64-key tiles, the tiles cut into splits by ``split_tiles``; each split
walks its tiles with an online softmax in the exp2 domain (running max
floored at -1e30, the probabilities rounded to the input type before
the value product) and keeps a partial (m, l, unnormalised acc); the
partials are combined in split order.  It is test code only: nothing on
the main path uses it.  At fp32 it must agree with
``paged_flash_decode_mla_ref`` to the reference's 2e-5 kernel bar."""
import numpy as np
import pytest
import torch

from torch_paged_cases import MLA_CASES, mla_case

from repro_torch.kernels import build, mla_split, paged_flash_decode_mla_ref
from repro_torch.models.attention import PagedView, paged_read

torch.set_num_threads(2)

TOL = 2e-5              # the reference's own kernel-vs-oracle bar
BF16_TOL = 2e-2         # the card's bf16 bar (tests/test_torch_gpu.py)
NEG_FLOOR = -1e30       # the kernel's running-max floor (kNegInf)
LOG2E = 1.4426950408889634
SCALE_FULL = float(np.float32(1 / np.sqrt(192)))   # 1/sqrt(nope + rope)

# the bf16 main-path calls of phase 9: (name, B, h * S, max keys a slot)
MAIN_PATH = [
    ("decode B8 S1 h128", 8, 128 * 1, 37 * 16),
    ("chunk B1 S32 h128", 1, 128 * 32, 37 * 16),
]


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,want", zip(MAIN_PATH, [(8, 5, 80),
                                                      (8, 2, 128)]),
                         ids=[c[0] for c in MAIN_PATH])
def test_plan_main_path_fills_the_card_in_one_wave(case, want):
    _, B, rows, max_keys = case
    warps, splits = mla_split.plan(B, rows, max_keys)
    assert (warps, splits, mla_split.blocks(B, rows, splits)) == want
    assert mla_split.blocks(B, rows, splits) <= mla_split.SMS


def test_plan_ragged_windowed_chunk_takes_no_split():
    """Four slots of a 32-token chunk are 256 row-tile blocks already."""
    assert mla_split.plan(4, 128 * 32, 37 * 16) == (8, 1)
    assert mla_split.blocks(4, 128 * 32, 1) == 256


@pytest.mark.parametrize("case", MLA_CASES)
def test_plan_small_cases(case):
    """The reference's MLA_CASES hold at most 48 keys a slot: one tile,
    so one split, one block a slot."""
    B, S, h, r, rope, ps, W, window = case
    warps, splits = mla_split.plan(B, h * S, W * ps)
    assert (warps, splits) == (8, 1)
    assert mla_split.blocks(B, h * S, splits) == B


@pytest.mark.parametrize("case", MAIN_PATH, ids=lambda c: c[0])
def test_plan_max_splits_one_turns_the_split_off(case, monkeypatch):
    _, B, rows, max_keys = case
    monkeypatch.setattr(mla_split, "MAX_SPLITS", 1)
    assert mla_split.plan(B, rows, max_keys) == (8, 1)


def test_plan_never_exceeds_the_cluster_limit_or_one_wave():
    for B in (1, 2, 3, 8, 64):
        for rows in (1, 4, 64, 128, 4096):
            for max_keys in (1, 63, 64, 65, 592, 32768):
                warps, splits = mla_split.plan(B, rows, max_keys)
                assert warps == mla_split.WARPS
                assert 1 <= splits <= mla_split.MAX_SPLITS
                assert splits <= -(-max_keys // mla_split.KEY_TILE)
                if splits > 1:
                    assert (mla_split.blocks(B, rows, splits)
                            <= mla_split.SMS)


# --------------------------------------------------------------------------
# the kernel's algebra against the plain version
# --------------------------------------------------------------------------

def split_model(q_lat, q_rope, ckv, krope, qpos, *, scale, window, limit,
                splits, key_tile=mla_split.KEY_TILE, parts_out=None):
    """q_lat (B, S, h, r), q_rope (B, S, h, rope); ckv (B, T, r), krope
    (B, T, rope) slot-major with T = limit; qpos (B, S) int.  Key t is
    visible to a row at position p iff t < limit, t <= p and (window > 0)
    t > p - window.  Rows with no visible key output 0.  When given,
    ``parts_out`` collects every split's (m, l) per row tile."""
    B, S, h, r = q_lat.shape
    dt = q_lat.dtype
    rows = mla_split.ROWS
    out = torch.zeros(B, S * h, r)
    for b in range(B):
        ql = q_lat[b].reshape(S * h, r).float()        # position-major rows
        qr = q_rope[b].reshape(S * h, -1).float()
        row_pos = torch.as_tensor(np.asarray(qpos[b])).long() \
            .repeat_interleave(h)
        for r0 in range(0, S * h, rows):
            pos = row_pos[r0:r0 + rows]
            nr = len(pos)
            p_lo, p_hi = int(pos.min()), int(pos.max())
            hi = -1 if p_hi < 0 else min(p_hi, limit - 1)
            lo = max(0, p_lo - window + 1) if window else 0
            n = hi // key_tile - lo // key_tile + 1 if hi >= lo else 0
            parts = []
            for split in range(splits):
                m = torch.full((nr,), NEG_FLOOR)
                l = torch.zeros(nr)
                acc = torch.zeros(nr, r)
                for tile in mla_split.split_tiles(lo // key_tile, n, splits,
                                                  split):
                    keys = torch.arange(tile * key_tile,
                                        (tile + 1) * key_tile)
                    loaded = (keys >= lo) & (keys <= hi)   # others zero-filled
                    idx = keys.clamp(max=limit - 1)
                    kl = torch.where(loaded[:, None], ckv[b, idx], 0)
                    kr = torch.where(loaded[:, None], krope[b, idx], 0)
                    s = (ql[r0:r0 + nr] @ kl.float().T
                         + qr[r0:r0 + nr] @ kr.float().T) * (scale * LOG2E)
                    vis = (keys[None] <= pos[:, None]) & (keys[None] < limit)
                    if window:
                        vis &= keys[None] > pos[:, None] - window
                    s = torch.where(vis, s, -torch.inf)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    l = l * alpha + p.sum(dim=1)
                    acc = (acc * alpha[:, None]
                           + p.to(dt).float() @ kl.to(dt).float())
                    m = m_new
                parts.append((m, l, acc))
            if parts_out is not None:
                parts_out.append([(m, l) for m, l, _ in parts])
            big_m = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            big_l = torch.zeros(nr)
            acc = torch.zeros(nr, r)
            for m, l, a in parts:                        # split order
                w = torch.exp2(m - big_m)
                big_l = big_l + l * w
                acc = acc + a * w[:, None]
            out[b, r0:r0 + nr] = torch.where(
                big_l[:, None] > 0, acc / big_l.clamp(min=1e-30)[:, None],
                0.0)
    return out.reshape(B, S, h, r).to(dt)


def _model(args, ps, scale, window, splits, key_tile=mla_split.KEY_TILE,
           parts_out=None):
    q_lat, q_rope, ckv, krope, table, pos = args
    B, S, h, _ = q_lat.shape
    W = table.shape[1]
    view = PagedView(table, ps)
    ckv_c, _ = paged_read(ckv, view)
    krope_c, _ = paged_read(krope, view)
    if splits is None:
        splits = mla_split.plan(B, h * S, W * ps)[1]
    return split_model(q_lat, q_rope, ckv_c, krope_c, pos, scale=scale,
                       window=window, limit=W * ps, splits=splits,
                       key_tile=key_tile, parts_out=parts_out)


def _args(case, lengths=None, dtype=torch.float32):
    B, S, h, r, rope, ps, W, window = case
    host = mla_case(sum(case), B, S, h, r, rope, ps, W, lengths=lengths)
    return tuple(torch.from_numpy(x).to(dtype) for x in host[:4]) + tuple(
        torch.from_numpy(x) for x in host[4:])


# (key tile, splits); None: the plan's, at the kernel's 64-key tile
SPLITS = [(mla_split.KEY_TILE, None), (8, 3), (8, 8)]

# deepseek-v3-671b's widths (h 128, r 512, rope 64) at small depth:
# B, S, h, r, rope, page_size, W, window, lengths
FULL_WIDTH = [
    (3, 1, 128, 512, 64, 16, 10, 0, (1, 77, 160)),     # decode, ragged slots
    (1, 4, 128, 512, 64, 16, 9, 0, (140,)),           # chunk
    (2, 4, 128, 512, 64, 16, 9, 40, (20, 144)),       # windowed chunk
]


@pytest.mark.parametrize("key_tile,splits", SPLITS)
@pytest.mark.parametrize("case", MLA_CASES)
def test_split_model_matches_plain_small_widths(case, key_tile, splits):
    ps, window = case[5], case[7]
    args = _args(case)
    got = _model(args, ps, 0.125, window, splits, key_tile)
    want = paged_flash_decode_mla_ref(*args, page_size=ps, scale=0.125,
                                      window=window)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("key_tile,splits", SPLITS + [(64, 2), (64, 8)])
@pytest.mark.parametrize("case", FULL_WIDTH, ids=["decode", "chunk",
                                                  "windowed-chunk"])
def test_split_model_matches_plain_full_width(case, key_tile, splits):
    ps, window, lengths = case[5], case[7], case[8]
    args = _args(case[:8], lengths)
    got = _model(args, ps, SCALE_FULL, window, splits, key_tile)
    want = paged_flash_decode_mla_ref(*args, page_size=ps, scale=SCALE_FULL,
                                      window=window)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_split_model_bf16_within_the_card_bar():
    """In bf16 the model rounds the unnormalised probabilities (the
    plain version the normalised ones) and still meets the card's bar."""
    case = FULL_WIDTH[1]
    args = _args(case[:8], case[8], torch.bfloat16)
    got = _model(args, case[5], SCALE_FULL, 0, 2)
    want = paged_flash_decode_mla_ref(*args, page_size=case[5],
                                      scale=SCALE_FULL)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("key_tile,splits", [(64, 8), (8, 8)])
def test_split_model_splits_that_see_no_key(key_tile, splits):
    """More splits than key tiles: the empty splits keep l = 0 and m at
    the floor and weigh exactly 0 in the combine; a query at position
    -1 sees no key in any split and outputs exactly 0."""
    case = (2, 2, 4, 32, 16, 8, 4, 0)
    B, S, h, r, rope, ps, W, window = case
    args = _args(case, lengths=(20, 3))
    args[5][0, 0] = -1
    parts = []
    got = _model(args, ps, 0.125, window, splits, key_tile, parts_out=parts)
    empty = [(m, l) for tile in parts for m, l in tile if not l.any()]
    assert empty, "some split must see no key"
    for m, l in empty:
        assert torch.equal(m, torch.full_like(m, NEG_FLOOR))
    assert torch.equal(got[0, 0], torch.zeros(h, r))
    want = paged_flash_decode_mla_ref(*args, page_size=ps, scale=0.125)
    seen = args[5] >= 0
    torch.testing.assert_close(got[seen], want[seen], atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# the build hashes every header the source includes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stem", ["paged_decode_mla", "paged_decode",
                                  "flash_attention"])
def test_editing_the_ptx_header_changes_the_build_path(stem, tmp_path,
                                                       monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_bytes(src.read_bytes())
    assert '#include "sm90.cuh"' in ((csrc / f"{stem}.cu").read_text()
                                     + (csrc / "gqa_attention.cuh")
                                     .read_text())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._paths(stem)[1]
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build._paths(stem)[1] != before
