"""The port on the card: the CUDA paged flash-decode (GQA and absorbed
MLA), WKV6, Mamba selective-scan and flash-attention kernels against
their plain PyTorch versions, the launch counters, and greedy serving
(qwen3, RWKV-6, Jamba and DeepSeek-V3 smoke configs; qwen3 also through
the lockstep slab engine) on the card against the CPU.  Marked ``gpu``; each test skips by itself
where no card is present.  Imports no jax (the card's machine has
none).

Run on a machine with an H100:  PYTHONPATH=src pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from torch_paged_cases import (GQA_CASES, MLA_CASES, POISON, mla_case,
                               paged_case)

from repro_torch.configs import smoke_config
from repro_torch.kernels import (flash_attention, flash_attention_ref,
                                 launch_counts, mamba_ref, mamba_scan,
                                 paged_flash_decode, paged_flash_decode_mla,
                                 paged_flash_decode_mla_ref,
                                 paged_flash_decode_ref,
                                 reset_launch_counts, wkv6, wkv6_chunked)
from repro_torch.kernels.wkv6 import HEAD_SIZES
from repro_torch.models import init_model
from repro_torch.serve import ContinuousScheduler, ServeEngine

pytestmark = pytest.mark.gpu

# fp32: the reference's own kernel bar (tests/test_paged_decode.py).
# bf16: 8-bit mantissa (eps 7.8e-3); the plain version also rounds the
# normalised probabilities to bf16 before the value product, the kernels
# keep them in fp32 or (the GQA kernels) round them before normalising.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

FULL_WIDTH_CASES = [
    # B, S, h, hk, hd, page_size, W, window  (qwen3-1.7b widths)
    (8, 1, 16, 8, 128, 16, 37, 0),     # decode over 8 slots
    (1, 32, 16, 8, 128, 16, 37, 0),    # prefill chunk
    (4, 32, 16, 8, 128, 16, 37, 100),  # windowed chunk: masked pages first
    # bf16 splits the keys of all of these over a cluster (up to 8 blocks)
    (8, 1, 32, 8, 128, 16, 37, 0),     # Jamba's g = 4, decode
    (1, 32, 32, 8, 128, 16, 37, 0),    # Jamba's g = 4, prefill chunk
    (8, 1, 16, 8, 64, 16, 37, 0),      # hd 64, decode
    (2, 32, 8, 2, 32, 8, 40, 50),      # hd 32, pages of 8, windowed chunk
    # rows enough to fill the card: bf16 takes the warpgroup (wgmma) blocks
    (8, 128, 32, 8, 128, 16, 16, 0),
    (8, 128, 32, 8, 64, 16, 16, 40),   # hd 64, windowed
    (8, 128, 32, 8, 32, 8, 24, 0),     # hd 32, pages of 8
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, dtype, q, k, v, table, pos):
    return (torch.from_numpy(q).to(dev, dtype), torch.from_numpy(k).to(dev, dtype),
            torch.from_numpy(v).to(dev, dtype), torch.from_numpy(table).to(dev),
            torch.from_numpy(pos).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GQA_CASES + FULL_WIDTH_CASES)
def test_kernel_matches_plain(cuda, case, dtype):
    B, S, h, hk, hd, ps, W, window = case
    lengths = None
    if (B, S) == (8, 1):           # mixed slot lengths, 1 token .. max_len
        lengths = np.linspace(1, W * ps, B).astype(int)
    args = _on(cuda, dtype, *paged_case(sum(case), B, S, h, hk, hd, ps, W,
                                        lengths=lengths))
    got = paged_flash_decode(*args, page_size=ps, window=window)
    want = paged_flash_decode_ref(*args, page_size=ps, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_trash_poison_never_leaks(cuda, dtype):
    """Poisoned trash/unwritten storage gives the bitwise same output as
    zero-filled storage: visibility alone isolates it (bf16: through the
    split-KV combine too)."""
    case = (2, 3, 4, 2, 32, 8, 4)
    q, k, v, table, pos = paged_case(5, *case)
    clean_k, clean_v = (np.where(x == POISON, 0.0, x).astype(np.float32)
                        for x in (k, v))
    big_k, big_v = (np.where(x == POISON, 1e8, x).astype(np.float32)
                    for x in (k, v))
    a = paged_flash_decode(*_on(cuda, dtype, q, clean_k, clean_v, table,
                                pos), page_size=8)
    b = paged_flash_decode(*_on(cuda, dtype, q, big_k, big_v, table,
                                pos), page_size=8)
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", FULL_WIDTH_CASES[:2])
def test_kernel_split_combine_is_deterministic(cuda, case):
    """bf16 splits are combined in a fixed order: repeated calls give the
    bitwise same output, whatever order the cluster's blocks finish in;
    a padded query (position -1) outputs exactly 0."""
    B, S, h, hk, hd, ps, W, window = case
    q, k, v, table, pos = _on(cuda, torch.bfloat16, *paged_case(
        3, B, S, h, hk, hd, ps, W, lengths=np.linspace(W * ps, S, B)
        .astype(int)))
    pos[0, 0] = -1
    first = paged_flash_decode(q, k, v, table, pos, page_size=ps)
    for _ in range(20):
        assert torch.equal(paged_flash_decode(q, k, v, table, pos,
                                              page_size=ps), first)
    assert not first[0, 0].any()


def test_kernel_counts_launches_and_rejects_bad_input(cuda):
    args = _on(cuda, torch.float32, *paged_case(1, 2, 1, 4, 2, 64, 16, 4))
    reset_launch_counts()
    paged_flash_decode(*args, page_size=16)
    paged_flash_decode(*args, page_size=16)
    assert launch_counts()["paged_flash_decode"] == 2
    q, k, v, table, pos = args
    with pytest.raises(TypeError):
        paged_flash_decode(q, k.half(), v.half(), table, pos, page_size=16)
    with pytest.raises(TypeError):
        paged_flash_decode(q, k, v, table.long(), pos, page_size=16)
    assert launch_counts()["paged_flash_decode"] == 2


def test_greedy_serving_on_card_matches_cpu(cuda):
    """The smoke config in fp32: greedy tokens through the kernel on the
    card equal the plain path on the CPU, and every attention call of
    the run launched the kernel."""
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 19)]
    outs = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu")
        if dev == "cuda":
            model = model.to(cuda)
        sch = ContinuousScheduler(cfg, model, slots=2, max_len=96,
                                  page_size=16, decode_chunk=4)
        reset_launch_counts()
        outs[dev] = sch.generate(prompts, 12)
        st = sch.stats()
    calls = st["prefill_dispatches"] + st["decode_dispatches"] * 4
    assert launch_counts()["paged_flash_decode"] == cfg.num_layers * calls
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# WKV6
# --------------------------------------------------------------------------

# fp32: the reference's own WKV bar (tests/test_kernels.py).  bf16: both
# sides round y to bf16 from fp32 sums taken in another order, so they
# may land one bf16 step apart (2^-7 relative), beside the fp32 bar.
WKV_ATOL = 5e-4
WKV_BF16_RTOL = 2 ** -7

WKV_CASES = [
    # B, T, H, K, decay scale
    (1, 32, 32, 64, 1.0),      # rwkv6-1.6b prefill chunk
    (2, 80, 4, 64, 1.0),       # ragged, three chunks carry the state
    (1, 64, 4, 64, 2.5),       # decays past the -60 clip
    (2, 40, 8, 32, 1.0),       # smoke widths
    (3, 1, 2, 32, 1.0),        # one step
] + [
    # every other head size the kernel is built for, a cluster of K / 16
    # ranks (one at K 16: no cross-rank sum; eight at K 128), at one
    # chunk and at three that carry the state
    (B, T, 4, K, 1.0) for K in HEAD_SIZES if K != 64
    for B, T in ((1, 32), (2, 80))
]


def _wkv_inputs(seed, B, T, H, K, scale):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    wl = (-scale * np.exp(0.3 * rng.standard_normal((B, T, H, K)))
          if scale != 1.0 else -np.exp(rng.standard_normal((B, T, H, K))))
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, wl.astype(np.float32), u, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_kernel_matches_plain(cuda, case, dtype):
    r, k, v, wl, u, s0 = (torch.from_numpy(x).to(cuda)
                          for x in _wkv_inputs(sum(case[:4]), *case))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    y, s = wkv6(r, k, v, wl, u, s0)
    y_want, s_want = wkv6_chunked(r, k, v, wl, u, s0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    rtol = WKV_BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), y_want.float(), atol=WKV_ATOL,
                               rtol=rtol)
    torch.testing.assert_close(s, s_want, atol=WKV_ATOL, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", range(1, 33))
def test_wkv6_kernel_matches_plain_every_prompt_tail(cuda, T, dtype):
    """rwkv6-1.6b widths (H 32, K 64) at every length a prefill chunk or
    a prompt's ragged tail can have: the kernel's tile is 32 rows, its
    sub-chunks 16, so each T pads a different part of them."""
    _wkv6_matches_plain(cuda, 100 + T, (1, T, 32, 64, 1.0), dtype)


def _wkv6_matches_plain(cuda, seed, case, dtype, chunk=32):
    r, k, v, wl, u, s0 = (torch.from_numpy(x).to(cuda)
                          for x in _wkv_inputs(seed, *case))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    y, s = wkv6(r, k, v, wl, u, s0, chunk=chunk)
    y_want, s_want = wkv6_chunked(r, k, v, wl, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    rtol = WKV_BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), y_want.float(), atol=WKV_ATOL,
                               rtol=rtol)
    torch.testing.assert_close(s, s_want, atol=WKV_ATOL, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 80, 4, 64, 1.0), (1, 64, 4, 64, 2.5)])
@pytest.mark.parametrize("chunk", [8, 16, 20, 64])
def test_wkv6_kernel_matches_plain_other_chunks(cuda, chunk, case, dtype):
    """A chunk shorter than the kernel's 32-row tile pads rows of it in
    every chunk (at 8 and 16, a whole sub-chunk); a longer one runs as
    chunks of 32, which the plain version's chunk of 64 matches but for
    its clip, here reached (decay ~-2.5 a step)."""
    _wkv6_matches_plain(cuda, chunk + case[1], case, dtype, chunk=chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(1, 32, 32, 64, 1.0), (2, 80, 4, 64, 1.0)])
def test_wkv6_cluster_sum_is_deterministic(cuda, case, dtype):
    """The ranks' partial outputs are summed in rank order: 20 calls give
    the same bits."""
    r, k, v, wl, u, s0 = (torch.from_numpy(x).to(cuda)
                          for x in _wkv_inputs(7, *case))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    y0, s0_out = wkv6(r, k, v, wl, u, s0)
    for _ in range(19):
        y, s = wkv6(r, k, v, wl, u, s0)
        assert torch.equal(y, y0) and torch.equal(s, s0_out)


def test_wkv6_counts_launches_and_rejects_bad_input(cuda):
    r, k, v, wl, u, s0 = (torch.from_numpy(x).to(cuda)
                          for x in _wkv_inputs(0, 1, 8, 2, 32, 1.0))
    reset_launch_counts()
    wkv6(r, k, v, wl, u, s0)
    wkv6(r, k, v, wl, u, s0)
    assert launch_counts()["wkv6"] == 2
    with pytest.raises(TypeError):
        wkv6(r, k, v, wl.double(), u, s0)
    with pytest.raises(TypeError):
        wkv6(r.bfloat16(), k, v, wl, u, s0)
    strided = torch.cat([r, r], dim=-1)[..., ::2]      # r's shape, strided
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(strided, k, v, wl, u, s0)
    assert launch_counts()["wkv6"] == 2


@pytest.mark.parametrize("K", [8, 40, 144])
def test_wkv6_rejects_head_sizes_it_is_not_built_for(cuda, K):
    """Head sizes off the 16-channel ranks, or past a cluster of 8,
    raise before any launch."""
    args = [torch.from_numpy(x).to(cuda)
            for x in _wkv_inputs(0, 1, 4, 2, K, 1.0)]
    reset_launch_counts()
    with pytest.raises(ValueError, match="head size"):
        wkv6(*args)
    assert launch_counts().get("wkv6", 0) == 0


def test_rwkv_greedy_serving_on_card_matches_cpu(cuda):
    """The RWKV-6 smoke config in fp32: greedy tokens through the kernel
    on the card equal the plain path on the CPU, and every prefill call
    of two or more tokens launched the kernel once per layer (decode
    steps and one-token chunks take the plain step)."""
    cfg = smoke_config("rwkv6-1.6b").with_overrides(dtype="float32")
    rng = np.random.default_rng(0)
    lengths = (5, 40, 33)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    chunk = 32
    multi = sum(1 for n in lengths for s in range(0, n, chunk)
                if min(chunk, n - s) >= 2)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu")
        if dev == "cuda":
            model = model.to(cuda)
        sch = ContinuousScheduler(cfg, model, slots=2, max_len=96,
                                  page_size=16, decode_chunk=4,
                                  prefill_chunk=chunk)
        reset_launch_counts()
        outs[dev] = sch.generate(prompts, 12)
    assert launch_counts()["wkv6"] == cfg.num_layers * multi
    assert launch_counts().get("paged_flash_decode", 0) == 0
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# Mamba selective scan
# --------------------------------------------------------------------------

# fp32: the reference's own Mamba bar (tests/test_kernels.py).  bf16: both
# sides round y to bf16 from fp32 sums taken in another order, so they
# may land one bf16 step apart (2^-7 relative), beside the fp32 bar.
MAMBA_ATOL = 5e-4
MAMBA_BF16_RTOL = 2 ** -7

MAMBA_CASES = [
    # Bb, T, dI, dS
    (1, 32, 8192, 16),     # jamba-v0.1-52b prefill chunk
    (2, 72, 256, 16),      # ragged T: three staged tiles, the last short
    (2, 40, 512, 8),       # smoke widths
    (3, 5, 100, 4),        # dI not a multiple of the block's channels
    (1, 9, 96, 32),
]


def _mamba_inputs(seed, Bb, T, dI, dS):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, T, dI)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, T, dI)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((dI, dS)))).astype(np.float32)
    B = rng.standard_normal((Bb, T, dS)).astype(np.float32)
    C = rng.standard_normal((Bb, T, dS)).astype(np.float32)
    D = rng.standard_normal((dI,)).astype(np.float32)
    h0 = rng.standard_normal((Bb, dI, dS)).astype(np.float32)
    return x, dt, A, B, C, D, h0


def _mamba_on(dev, dtype, x, dt, A, B, C, D, h0, *, strided=False):
    """x, dt, B, C in ``dtype``; with ``strided`` B and C are column
    slices of one projection, as ``apply_mamba`` passes them."""
    t = lambda a, dt_=torch.float32: torch.from_numpy(a).to(dev, dt_)
    if strided:
        proj = torch.cat([t(B, dtype), t(B, dtype), t(C, dtype)], dim=-1)
        dS = B.shape[-1]
        Bt, Ct = proj[..., dS:2 * dS], proj[..., 2 * dS:]
    else:
        Bt, Ct = t(B, dtype), t(C, dtype)
    return t(x, dtype), t(dt, dtype), t(A), Bt, Ct, t(D), t(h0)


@pytest.mark.parametrize("strided", [False, True], ids=["contig", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MAMBA_CASES)
def test_mamba_kernel_matches_plain(cuda, case, dtype, strided):
    args = _mamba_on(cuda, dtype, *_mamba_inputs(sum(case), *case),
                     strided=strided)
    y, s = mamba_scan(*args)
    y_want, s_want = mamba_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    rtol = MAMBA_BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), y_want, atol=MAMBA_ATOL, rtol=rtol)
    torch.testing.assert_close(s, s_want, atol=MAMBA_ATOL, rtol=0.0)


@pytest.mark.parametrize("strided", [False, True], ids=["contig", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 75])
@pytest.mark.parametrize("dS", [4, 8, 16, 32])
def test_mamba_kernel_matches_plain_every_state_size(cuda, dS, T, dtype,
                                                     strided):
    """Each d_state the kernel is built for, one-step to three-tile calls,
    at a dI (8176) whose last block of 32 channels is half full."""
    args = _mamba_on(cuda, dtype, *_mamba_inputs(dS + T, 1, T, 8176, dS),
                     strided=strided)
    y, s = mamba_scan(*args)
    y_want, s_want = mamba_ref(*args)
    torch.cuda.synchronize()
    rtol = MAMBA_BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), y_want, atol=MAMBA_ATOL, rtol=rtol)
    torch.testing.assert_close(s, s_want, atol=MAMBA_ATOL, rtol=0.0)


def test_mamba_counts_launches_and_rejects_bad_input(cuda):
    x, dt, A, B, C, D, h0 = _mamba_on(cuda, torch.float32,
                                      *_mamba_inputs(0, 1, 8, 64, 16))
    reset_launch_counts()
    mamba_scan(x, dt, A, B, C, D, h0)
    mamba_scan(x, dt, A, B, C, D, h0)
    assert launch_counts()["mamba_scan"] == 2
    with pytest.raises(TypeError):
        mamba_scan(x, dt, A.double(), B, C, D, h0)
    with pytest.raises(TypeError):
        mamba_scan(x.bfloat16(), dt, A, B, C, D, h0)
    strided = torch.cat([x, x], dim=-1)[..., ::2]     # x's shape, strided
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(strided, dt, A, B, C, D, h0)
    with pytest.raises(ValueError, match="d_state"):
        mamba_scan(x, dt, A[:, :2].contiguous(), B[..., :2], C[..., :2], D,
                   h0[..., :2].contiguous())
    assert launch_counts()["mamba_scan"] == 2


def test_jamba_greedy_serving_on_card_matches_cpu(cuda):
    """The Jamba smoke config in fp32 (Mamba + MLP, attention + MoE):
    greedy tokens through the kernels on the card equal the plain path
    on the CPU; every prefill call of two or more tokens launched the
    scan kernel once per Mamba layer, every model call the paged kernel
    once per attention layer."""
    cfg = smoke_config("jamba-v0.1-52b").with_overrides(dtype="float32")
    rng = np.random.default_rng(0)
    lengths = (5, 40, 33)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    chunk = 32
    multi = sum(1 for n in lengths for s in range(0, n, chunk)
                if min(chunk, n - s) >= 2)
    kinds = [mixer for mixer, _ in cfg.layer_pattern()]
    outs = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu")
        if dev == "cuda":
            model = model.to(cuda)
        sch = ContinuousScheduler(cfg, model, slots=2, max_len=96,
                                  page_size=16, decode_chunk=4,
                                  prefill_chunk=chunk)
        reset_launch_counts()
        outs[dev] = sch.generate(prompts, 12)
        st = sch.stats()
    calls = st["prefill_dispatches"] + st["decode_dispatches"] * 4
    assert launch_counts()["mamba_scan"] == kinds.count("mamba") * multi
    assert launch_counts()["paged_flash_decode"] == kinds.count("attn") * calls
    assert launch_counts().get("wkv6", 0) == 0
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# absorbed-MLA paged decode (DeepSeek-V3)
# --------------------------------------------------------------------------

MLA_FULL_WIDTH_CASES = [
    # B, S, h, r, rope, page_size, W, window  (deepseek-v3-671b widths)
    (8, 1, 128, 512, 64, 16, 37, 0),      # decode over 8 slots
    (1, 32, 128, 512, 64, 16, 37, 0),     # prefill chunk at 544 tokens
    (4, 32, 128, 512, 64, 16, 37, 100),   # ragged, windowed chunk
]
# the small widths (the other builds of the bf16 kernel) over slots long
# enough that the plan splits their keys over a cluster
MLA_LONG_SMALL_CASES = [
    (2, 1, 4, 32, 16, 16, 32, 0),         # r 32 / rope 16: 8 splits
    (2, 3, 2, 64, 8, 8, 40, 24),          # r 64 / rope 8, windowed
]
MLA_SCALE = float(np.float32(1 / np.sqrt(192)))   # 1/sqrt(nope + rope)


def _mla_lengths(case):
    B, S, h, _, _, ps, W, _ = case
    if (B, S, h) == (8, 1, 128):   # slots of 1 token .. max_len
        return np.linspace(1, W * ps, B).astype(int)
    if (B, S, h) == (1, 32, 128):
        return [544]
    if (B, S, h) == (4, 32, 128):
        return [40, 200, 333, 560]
    if case in MLA_LONG_SMALL_CASES:
        return np.linspace(W * ps // 2, W * ps, B).astype(int)
    return None


def _mla_on(dev, dtype, q_lat, q_rope, ckv, krope, table, pos):
    return tuple(torch.from_numpy(x).to(dev, dtype)
                 for x in (q_lat, q_rope, ckv, krope)) + (
        torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLA_CASES + MLA_FULL_WIDTH_CASES
                         + MLA_LONG_SMALL_CASES)
def test_mla_kernel_matches_plain(cuda, case, dtype):
    B, S, h, r, rope, ps, W, window = case
    args = _mla_on(cuda, dtype, *mla_case(sum(case), B, S, h, r, rope, ps, W,
                                          lengths=_mla_lengths(case)))
    scale = MLA_SCALE if h == 128 else 0.125
    got = paged_flash_decode_mla(*args, page_size=ps, scale=scale,
                                 window=window)
    want = paged_flash_decode_mla_ref(*args, page_size=ps, scale=scale,
                                      window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_kernel_trash_poison_never_leaks(cuda, dtype):
    """The trash page, unreferenced pages and unwritten page tails flooded
    with 1e8 give the bitwise same output as zero-filled storage."""
    q_lat, q_rope, ckv, krope, table, pos = mla_case(
        5, 3, 4, 128, 512, 64, 16, 6, lengths=[7, 50, 96])
    outs = []
    for fill in (0.0, 1e8):
        c, k = (np.where(x == POISON, fill, x).astype(np.float32)
                for x in (ckv, krope))
        outs.append(paged_flash_decode_mla(
            *_mla_on(cuda, dtype, q_lat, q_rope, c, k, table, pos),
            page_size=16, scale=MLA_SCALE))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("case", MLA_FULL_WIDTH_CASES + MLA_LONG_SMALL_CASES)
def test_mla_split_off_matches_split(cuda, case, monkeypatch):
    """bf16: the split-KV run (a cluster of up to 8 blocks a row tile,
    combined in split order) agrees with the unsplit run (one block walks
    every key tile), both within the bf16 tolerance of the plain version."""
    from repro_torch.kernels import mla_split
    B, S, h, r, rope, ps, W, window = case
    args = _mla_on(cuda, torch.bfloat16, *mla_case(
        sum(case), B, S, h, r, rope, ps, W, lengths=_mla_lengths(case)))
    scale = MLA_SCALE if h == 128 else 0.125
    kw = dict(page_size=ps, scale=scale, window=window)
    if case != MLA_FULL_WIDTH_CASES[2]:       # 256 row-tile blocks: no split
        assert mla_split.plan(B, h * S, W * ps)[1] > 1
    split = paged_flash_decode_mla(*args, **kw)
    monkeypatch.setattr(mla_split, "MAX_SPLITS", 1)
    whole = paged_flash_decode_mla(*args, **kw)
    want = paged_flash_decode_mla_ref(*args, **kw)
    torch.cuda.synchronize()
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(split.float(), whole.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(whole.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", MLA_FULL_WIDTH_CASES[:2])
def test_mla_split_combine_is_deterministic(cuda, case):
    """bf16 splits are combined in a fixed order: 20 calls give the
    bitwise same output, whatever order the cluster's blocks finish in;
    a query at position -1 sees no key and outputs exactly 0."""
    B, S, h, r, rope, ps, W, window = case
    q_lat, q_rope, ckv, krope, table, pos = _mla_on(
        cuda, torch.bfloat16, *mla_case(3, B, S, h, r, rope, ps, W,
                                        lengths=_mla_lengths(case)))
    pos[0, 0] = -1
    call = lambda: paged_flash_decode_mla(q_lat, q_rope, ckv, krope, table,
                                          pos, page_size=ps, scale=MLA_SCALE)
    first = call()
    for _ in range(20):
        assert torch.equal(call(), first)
    assert not first[0, 0].any()


def test_mla_kernel_counts_launches_and_rejects_bad_input(cuda):
    args = _mla_on(cuda, torch.float32, *mla_case(1, 2, 1, 4, 32, 16, 16, 4))
    reset_launch_counts()
    paged_flash_decode_mla(*args, page_size=16, scale=0.1)
    paged_flash_decode_mla(*args, page_size=16, scale=0.1)
    assert launch_counts()["paged_flash_decode_mla"] == 2
    q_lat, q_rope, ckv, krope, table, pos = args
    with pytest.raises(TypeError):
        paged_flash_decode_mla(q_lat, q_rope, ckv.half(), krope, table, pos,
                               page_size=16, scale=0.1)
    with pytest.raises(TypeError):
        paged_flash_decode_mla(q_lat, q_rope, ckv, krope, table.long(), pos,
                               page_size=16, scale=0.1)
    with pytest.raises(ValueError, match="multiples of 8"):
        paged_flash_decode_mla(q_lat[..., :28].contiguous(), q_rope,
                               ckv[:, :28].contiguous(), krope, table, pos,
                               page_size=16, scale=0.1)
    strided = torch.cat([q_lat, q_lat], dim=-1)[..., ::2]   # q_lat's shape
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash_decode_mla(strided, q_rope, ckv, krope, table, pos,
                               page_size=16, scale=0.1)
    assert launch_counts()["paged_flash_decode_mla"] == 2


def test_deepseek_greedy_serving_on_card_matches_cpu(cuda):
    """The DeepSeek-V3 smoke config deepened to 4 layers (MLA + dense
    MLP, then three MLA + sigmoid MoE) in fp32: greedy tokens through the
    MLA kernel on the card equal the plain path on the CPU, and every
    model call launched the kernel once per layer and no other kernel."""
    cfg = smoke_config("deepseek-v3-671b").with_overrides(num_layers=4,
                                                          dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 33)]
    outs = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu")
        if dev == "cuda":
            model = model.to(cuda)
        sch = ContinuousScheduler(cfg, model, slots=2, max_len=96,
                                  page_size=16, decode_chunk=4,
                                  prefill_chunk=32)
        reset_launch_counts()
        outs[dev] = sch.generate(prompts, 12)
        st = sch.stats()
    calls = st["prefill_dispatches"] + st["decode_dispatches"] * 4
    counts = launch_counts()
    assert counts["paged_flash_decode_mla"] == cfg.num_layers * calls
    for name in ("paged_flash_decode", "wkv6", "mamba_scan"):
        assert counts.get(name, 0) == 0, name
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# flash attention (the lockstep slab engine)
# --------------------------------------------------------------------------

# the reference's FLASH_CASES (tests/test_kernels.py, which imports jax)
FLASH_CASES = [
    # B, S, T, h, hk, hd, causal, window
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 96, 160, 4, 4, 64, True, 0),       # right-aligned decode-style
    (2, 128, 128, 8, 2, 128, True, 48),    # sliding window
    (1, 64, 64, 2, 1, 64, False, 0),       # bidirectional, MQA
    (1, 33, 70, 2, 2, 64, True, 0),        # ragged (padding paths)
    (8, 1, 576, 16, 8, 128, True, 0),      # qwen3-1.7b slab decode step
    (8, 512, 512, 16, 8, 128, True, 0),    # qwen3-1.7b slab prefill (bf16:
                                           # 64-row blocks, no split)
    (8, 1, 576, 16, 8, 64, True, 0),       # hd 64 decode step (8 splits)
    (4, 32, 300, 16, 8, 128, True, 100),   # windowed chunk (early splits
                                           # see no key)
    (8, 512, 512, 16, 8, 64, True, 0),     # hd 64 prefill (bf16: wgmma)
    (4, 256, 256, 32, 8, 128, True, 100),  # windowed prefill (bf16: wgmma)
]


def _flash_inputs(dev, dtype, seed, B, S, T, h, hk, hd):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype)
        for shape in ((B, S, h, hd), (B, T, hk, hd), (B, T, hk, hd)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, S, T, h, hk, hd, causal, window = case
    q, k, v = _flash_inputs(cuda, dtype, sum(case), B, S, T, h, hk, hd)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 7, 70], ids=["decode", "chunk", "prefill"])
def test_flash_kernel_on_strided_slab_slice(cuda, dtype, S):
    """k[:, :valid] of a (B, max_len, hk, hd) slab, as the slab path
    passes it: read through its strides (no copy), and the cache's tail
    past the valid length -- poisoned with 1e4, then 1e8 -- changes no
    bit of the output."""
    B, max_len, valid, h, hk, hd = 3, 100, 70, 16, 8, 128
    q, k, v = _flash_inputs(cuda, dtype, S, B, S, max_len, h, hk, hd)
    for t in (k, v):
        t[:, valid:] = 1e4
    ks, vs = k[:, :valid], v[:, :valid]
    assert not ks.is_contiguous()
    got = flash_attention(q, ks, vs)
    want = flash_attention_ref(q, ks.contiguous(), vs.contiguous())
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for t in (k, v):
        t[:, valid:] = 1e8
    assert torch.equal(flash_attention(q, ks, vs), got)


def test_flash_counts_launches_and_rejects_bad_input(cuda):
    q, k, v = _flash_inputs(cuda, torch.float32, 0, 2, 4, 9, 4, 2, 64)
    reset_launch_counts()
    flash_attention(q, k, v)
    flash_attention(q, k, v, causal=False, window=3)
    assert launch_counts()["flash_attention"] == 2
    with pytest.raises(ValueError, match="see no key"):
        flash_attention(q, k[:, :3], v[:, :3])
    with pytest.raises(TypeError):
        flash_attention(q, k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())
    with pytest.raises(ValueError, match="stride"):
        flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                        v)
    assert launch_counts()["flash_attention"] == 2


def test_legacy_greedy_serving_on_card_matches_cpu(cuda):
    """The smoke config in fp32 through the lockstep slab engine: greedy
    tokens through the flash kernel on the card equal the plain path on
    the CPU, and every attention call launched the kernel (one prefill
    and NEW - 1 decode calls in each layer)."""
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    new = 12
    outs = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu")
        if dev == "cuda":
            model = model.to(cuda)
        reset_launch_counts()
        outs[dev] = ServeEngine(cfg, model, batch_size=2,
                                max_len=48).generate(prompts, new).cpu()
    counts = launch_counts()
    assert counts["flash_attention"] == cfg.num_layers * new
    assert counts.get("paged_flash_decode", 0) == 0
    np.testing.assert_array_equal(outs["cpu"].numpy(), outs["cuda"].numpy())


# --------------------------------------------------------------------------
# training: the flash kernel's autograd Function and the train step
# --------------------------------------------------------------------------

TRAIN_FLASH_CASES = [
    # B, S (= T), h, hk, hd, window
    (2, 256, 16, 8, 128, 0),     # qwen3-1.7b's heads, causal
    (1, 300, 4, 2, 64, 48),      # the smoke config's heads, windowed, ragged
]
# dq, dk, dv against autograd of the plain version, as max |err| /
# max |grad|: the backward is plain PyTorch on both sides, q-chunked in
# the Function; bf16 rounds each chunk's products once more
TRAIN_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TRAIN_FLASH_CASES)
def test_flash_function_gradients_match_plain(cuda, case, dtype):
    B, S, h, hk, hd, window = case
    q, k, v = _flash_inputs(cuda, dtype, sum(case), B, S, S, h, hk, hd)
    dout = torch.randn_like(q)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    out = flash_attention(*leaves, window=window)
    assert out.grad_fn is not None and "FlashAttention" in out.grad_fn.name()
    out.backward(dout)
    assert launch_counts()["flash_attention"] == 1
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = flash_attention_ref(*ref_leaves, window=window)
    want.backward(dout)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(out.detach().float(), want.detach().float(),
                               atol=tol, rtol=tol)
    for name, a, b in zip("qkv", leaves, ref_leaves):
        assert a.grad.dtype == dtype
        rel = ((a.grad.float() - b.grad.float()).abs().max()
               / b.grad.float().abs().max()).item()
        assert rel <= TRAIN_GRAD_TOL[dtype], (name, rel)


def _train(cfg, model, tc, batches):
    from repro_torch.train import TrainState, make_train_step, trainable
    step, opt = make_train_step(cfg, tc)
    state = TrainState(model, opt.init(trainable(model)), 0)
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, {k: p.detach().cpu() for k, p in trainable(model).items()}


def test_train_step_on_card_matches_cpu(cuda):
    """The smoke config in fp32, 3 AdamW steps from the same masters:
    the first loss (equal weights) within 1e-5 relative; later losses
    within 1e-4 and every param within 3 lr, since AdamW's g / (|g| +
    eps) moves an entry whose gradient is near eps by up to lr a step
    on rounding alone; every layer launched the kernel (and its remat
    recompute)."""
    from repro_torch.train import TrainConfig
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    tc = TrainConfig(lr=3e-4, grad_clip=1.0)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 64))}
               for _ in range(3)]
    got = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu", train=True).to(dev)
        reset_launch_counts()
        got[dev] = _train(cfg, model, tc, batches)
    assert launch_counts()["flash_attention"] == 3 * cfg.num_layers * 2
    (cl, cp), (gl, gp) = got["cpu"], got["cuda"]
    rel = [abs(a - b) / abs(a) for a, b in zip(cl, gl)]
    assert rel[0] <= 1e-5 and max(rel) <= 1e-4, rel
    assert max((cp[k] - gp[k]).abs().max().item() for k in cp) <= 3 * 3e-4


@pytest.mark.parametrize("remat,micro", [(True, 1), (False, 1), (True, 2)],
                         ids=["remat", "no-remat", "remat-2-micro"])
def test_train_step_launch_counts(cuda, remat, micro):
    """One bf16 step launches the kernel once a layer a microbatch, twice
    under remat (the recompute), and nothing else."""
    from repro_torch.train import TrainConfig
    cfg = smoke_config("qwen3-1.7b")
    model = init_model(cfg, seed=0, device=cuda, train=True)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 128))
    reset_launch_counts()
    losses, _ = _train(cfg, model,
                       TrainConfig(remat=remat, microbatches=micro),
                       [{"tokens": tokens}])
    counts = launch_counts()
    assert np.isfinite(losses[0])
    assert counts["flash_attention"] == micro * cfg.num_layers * (
        2 if remat else 1)
    assert sum(counts.values()) == counts["flash_attention"]
