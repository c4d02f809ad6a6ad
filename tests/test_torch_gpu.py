"""The port on the card: the CUDA paged flash-decode (GQA and absorbed
MLA), WKV6, Mamba selective-scan and flash-attention kernels against
their plain PyTorch versions, the launch counters, and greedy serving
(qwen3, RWKV-6, Jamba and DeepSeek-V3 smoke configs; qwen3 also through
the lockstep slab engine) on the card against the CPU; the flash
backward kernel against its tiled plain version and autograd of the
plain forward (``-k flash_bwd``), the forward's log-sum-exp bitwise
harmless at every block shape (``-k flash_lse``); the training
step, and its data-parallel ``Trainer`` over a world of one NCCL rank,
with the replicated strategies and the ZeRO ladder (``-k zero``: zero1
/ zero2 / zero3 bitwise the one-device step at one NCCL rank, and 2
gloo ranks sharing the card); the Table-1 nets on the card against the
CPU; checkpoints saved on the card and restored on the CPU, and back;
the scan backward kernels against the plain backwards (``-k
scan_bwd``); the paged kernels at speculative decode's verify shape (``-k verify``),
``cow_fork`` on card pools and the speculative tick's one host sync
(``-k "cow or spec_tick"``).  Marked ``gpu``; each test
skips by itself where no card is present.  Imports no jax (the card's
machine has none).

Run on a machine with an H100:  PYTHONPATH=src pytest -m gpu tests/test_torch_gpu.py
"""
import os

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
from repro_torch.kernels.flash_attention import BWD_FORMS, BWD_TILED_TOL
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
    assert launch_counts()["flash_attention_bwd"] == 1
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


# the backward kernel (csrc/flash_attention_bwd.cu) on its own at
# BWD_FORMS (every form the forward takes; chip_smoke.py's phase 2 reads
# the same list), against the tiled plain version (its algorithm and
# schedule) at BWD_TILED_TOL and autograd of the plain forward at
# TRAIN_GRAD_TOL, as max |err| / max |grad|
def _bwd_inputs(dev, dtype, case):
    B, S, T, h, hk, hd, hdv, _, _ = case
    rng = np.random.default_rng(sum(case))
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype) for shape in (
            (B, S, h, hd), (B, T, hk, hd), (B, T, hk, hdv), (B, S, h, hdv)))


def _grad_rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_FORMS)
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    """The forward's log-sum-exp against the plain one; the backward
    kernel's dq, dk, dv against flash_attention_bwd_tiled and autograd of
    the plain forward (flash_attention_bwd_ref), in the inputs' dtypes;
    two calls bitwise equal (no atomics)."""
    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention_bwd, flash_attention_bwd_ref,
        flash_attention_bwd_tiled, flash_attention_lse_ref)
    causal, window = case[7:]
    q, k, v, dout = _bwd_inputs(cuda, dtype, case)
    out, lse = _launch(q, k, v, causal, window, with_lse=True)
    want_lse = flash_attention_lse_ref(q, k, causal=causal, window=window)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                              window=window)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                window=window)
    tiled = flash_attention_bwd_tiled(q, k, v, out, lse, dout, causal=causal,
                                      window=window)
    ref = flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    for name, a, b, t, r in zip("qkv", got, again, tiled, ref):
        assert a.dtype == dtype and a.shape == r.shape, name
        assert torch.equal(a, b), name
        assert _grad_rel(a, t) <= BWD_TILED_TOL[dtype], (name, "tiled")
        assert _grad_rel(a, r) <= TRAIN_GRAD_TOL[dtype], (name, "ref")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_leaves_the_forward_bitwise(cuda, dtype):
    """At every block shape the forward is built for (block_choices), the
    output is the same bit for bit with and without the log-sum-exp, and
    the log-sum-exp agrees with the plain one."""
    from repro_torch.kernels.flash_attention import (
        _launch, block_choices, flash_attention_lse_ref)
    for case in ((1, 300, 300, 16, 8, 128, 128, True, 0),
                 (2, 64, 64, 4, 4, 192, 128, True, 20),
                 (1, 40, 90, 16, 16, 64, 64, False, 0)):
        causal, window = case[7:]
        q, k, v, _ = _bwd_inputs(cuda, dtype, case)
        want_lse = flash_attention_lse_ref(q, k, causal=causal,
                                           window=window)
        for block_q, block_kv in block_choices(dtype, k.shape[1]):
            plain = _launch(q, k, v, causal, window, block_q, block_kv)
            out, lse = _launch(q, k, v, causal, window, block_q, block_kv,
                               with_lse=True)
            assert torch.equal(out, plain), (case, block_q, block_kv)
            torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


def test_flash_bwd_counts_launches_and_rejects_bad_input(cuda):
    """One count a call (its two kernels); k and v read through their
    strides (a slab slice gives the contiguous copy's gradients bit for
    bit); what the kernel does not take raises before any launch."""
    from repro_torch.kernels.flash_attention import (_launch,
                                                     flash_attention_bwd)
    case = (2, 40, 70, 4, 2, 64, 64, True, 0)
    q, k, v, dout = _bwd_inputs(cuda, torch.bfloat16, case)
    out, lse = _launch(q, k, v, True, 0, with_lse=True)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    slab_k = torch.zeros((2, 96, 2, 64), dtype=k.dtype, device=cuda)
    slab_v = torch.zeros_like(slab_k)
    slab_k[:, :70], slab_v[:, :70] = k, v
    sliced = flash_attention_bwd(q, slab_k[:, :70], slab_v[:, :70], out, lse,
                                 dout)
    assert launch_counts()["flash_attention_bwd"] == 2
    for a, b in zip(got, sliced):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="see no key"):
        flash_attention_bwd(q, k[:, :9], v[:, :9], out, lse, dout)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k.float(), v.float(), out, lse, dout)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse.bfloat16(), dout)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                            v[..., :32].contiguous(), out[..., :32], lse,
                            dout[..., :32])
    with pytest.raises(ValueError, match="stride"):
        flash_attention_bwd(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            v, out, lse, dout)
    assert launch_counts()["flash_attention_bwd"] == 2


def _train(cfg, model, tc, batches):
    from repro_torch.train import make_train_step, start_state, trainable
    step, opt = make_train_step(cfg, tc)
    state = start_state(model, opt)
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
    assert counts["flash_attention_bwd"] == micro * cfg.num_layers
    assert sum(counts.values()) == (counts["flash_attention"]
                                    + counts["flash_attention_bwd"])


def test_bf16_master_step_on_card_matches_cpu(cuda):
    """bf16 masters with fp32 compute, 2 SGD steps of 2 microbatches
    summed in bf16, from the same masters on the card and the CPU: the
    losses within 1e-5; every master within one bf16 ulp a step (the ulp
    at the largest of the entry's magnitudes and its tensor's largest
    move, the bar of tests/test_torch_bf16_masters.py); the masters and
    their gradients stay bf16; every layer launched the kernel twice a
    microbatch (remat)."""
    from repro_torch.train import TrainConfig
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    tc = TrainConfig(optimizer="sgd", lr=1e-3, microbatches=2,
                     param_dtype="bfloat16", grad_dtype="bfloat16")
    rng = np.random.default_rng(2)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 64))}
               for _ in range(2)]
    start = init_model(cfg, seed=0, device="cpu", train=True,
                       param_dtype=torch.bfloat16)
    p0 = {k: p.detach().clone() for k, p in start.named_parameters()}
    got = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu", train=True,
                           param_dtype=torch.bfloat16).to(dev)
        reset_launch_counts()
        got[dev] = _train(cfg, model, tc, batches)
        assert all(p.dtype == torch.bfloat16 and p.grad.dtype ==
                   torch.bfloat16 for p in model.parameters())
    assert launch_counts()["flash_attention"] == 2 * 2 * cfg.num_layers * 2
    (cl, cp), (gl, gp) = got["cpu"], got["cuda"]
    assert max(abs(a - b) for a, b in zip(cl, gl)) <= 1e-5, (cl, gl)
    for k in cp:
        a, b, s0 = gp[k].double(), cp[k].double(), p0[k].double()
        m = torch.maximum(torch.maximum(a.abs(), b.abs()), s0.abs())
        m = torch.clamp(torch.maximum(m, (b - s0).abs().max()), min=1e-38)
        ulps = (a - b).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)
        assert ulps.max().item() <= 2, k


# --------------------------------------------------------------------------
# the paper's data parallelism on the card
# --------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(cuda):
    """A world of one NCCL rank (the card's machine has one card) and its
    ("data",) mesh; the group is torn down after the test."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_dp_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield make_dp_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("strategy", ["flat", "bucketed"])
def test_trainer_over_one_nccl_rank_equals_train_step(cuda, nccl_mesh,
                                                      strategy):
    """A 2-layer full-width qwen3-1.7b in bf16 on fp32 masters, 3 AdamW
    steps in 2 microbatches with remat: averaging over one rank is
    exact, so the Trainer's losses and masters equal ``make_train_step``'s
    bit for bit."""
    from repro_torch.api import Trainer
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, trainable)
    cfg = get_config("qwen3-1.7b").with_overrides(num_layers=2)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, microbatches=2, remat=True)
    rng = np.random.default_rng(2)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 512))
                .astype(np.int32)} for _ in range(3)]
    state = init_train_state(cfg, tc, seed=0, device=cuda)
    step, _ = make_train_step(cfg, tc)
    want = []
    for b in batches:
        state, m = step(state, b)
        want.append(float(m["loss"]))
    trainer = Trainer.create(cfg, optimizer="adamw", lr=3e-4,
                             dp=DPConfig(strategy=strategy, microbatches=2),
                             mesh=nccl_mesh, train_cfg=TrainConfig(remat=True),
                             seed=0, device=cuda)
    reset_launch_counts()
    got = [float(trainer.step(b)["loss"]) for b in batches]
    assert got == want
    assert launch_counts()["flash_attention"] == 3 * 2 * cfg.num_layers * 2
    assert len(trainer.sync_ms()) == 3
    ref = trainable(state.params)
    for k, p in trainable(trainer.state.params).items():
        assert torch.equal(p, ref[k]), k


@pytest.mark.parametrize("name", ["adult-dnn", "acoustic-dnn", "mnist-dnn",
                                  "mnist-cnn", "cifar10-dnn", "cifar10-cnn",
                                  "higgs-dnn"])
def test_paper_nets_on_card_match_cpu(cuda, name, monkeypatch):
    """A Table-1 net in fp32 with TF32 off (cuDNN's default is on): on
    equal weights the card's logits equal the CPU's within 1e-5; over 5
    SGD(0.1) steps a DNN's masters stay within 1e-5 after each step, a
    CNN's within 1e-4.  A CNN's gradient is not continuous in the
    rounding: ReLU's mask and max-pool's argmax can fall apart where a
    conv output sits at a near-tie that the card's and the CPU's fp32
    summation orders decide differently, and each such flip moves a
    whole gradient entry (mnist-cnn read 1.08e-5 after its first step on
    an H100)."""
    from repro_torch import optim
    from repro_torch.api import Trainer
    from repro_torch.configs import PAPER_NETS
    from repro_torch.data import make_dataset
    from repro_torch.models import apply_paper_net, init_paper_net
    from repro_torch.train import cross_entropy
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    net = PAPER_NETS[name]
    ds = make_dataset(net.dataset, n=128, as_images=net.kind == "cnn")
    batch = {"x": ds.x, "y": ds.y}
    got, logits = {}, {}
    for dev in ("cpu", cuda):
        model = init_paper_net(net, seed=0, device="cpu").to(dev)
        with torch.no_grad():
            logits[str(dev)] = apply_paper_net(
                net, model, torch.from_numpy(ds.x).to(dev)).cpu().numpy()
        t = Trainer.create(
            loss_fn=lambda m, b: cross_entropy(
                apply_paper_net(net, m, b["x"]), b["y"]),
            params=model, optimizer=optim.sgd(0.1), device=dev)
        got[str(dev)] = []
        for _ in range(5):
            t.step(batch)
            got[str(dev)].append(t.params)
    assert np.abs(logits["cpu"] - logits[str(cuda)]).max() <= 1e-5
    gaps = [max(np.abs(a[k] - b[k]).max() for k in a)
            for a, b in zip(got["cpu"], got[str(cuda)])]
    assert max(gaps) <= (1e-5 if net.kind == "dnn" else 1e-4), gaps


def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """A checkpoint records no device: a smoke-config trainer's state
    saved on the card restores on the CPU to equal masters and moments,
    and one saved on the CPU restores on the card."""
    from repro_torch.api import Trainer
    from repro_torch.train import trainable
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    batch = {"tokens": np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)}

    def state(t):
        return {"params": trainable(t.state.params),
                **{k: v for k, v in t.state.opt_state.items()
                   if k != "step"}}

    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        saver = Trainer.create(cfg, optimizer="adamw", device=src)
        for _ in range(2):
            saver.step(batch)
        saver.save(tmp_path / src)
        loader = Trainer.create(cfg, optimizer="adamw", seed=1, device=dst)
        assert loader.restore(tmp_path / src) == 2
        assert loader.state.opt_state["step"] == 2
        want = state(saver)
        for kind, leaves in state(loader).items():
            for k, t in leaves.items():
                assert t.device.type == dst
                assert torch.equal(t.cpu(), want[kind][k].cpu()), (kind, k)


# --------------------------------------------------------------------------
# the ZeRO ladder on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,overlap", [
    ("zero1", False), ("zero1", True), ("zero2", False), ("zero3", False),
    ("zero3", "serial")])
def test_zero_over_one_nccl_rank_equals_train_step(cuda, nccl_mesh,
                                                   strategy, overlap):
    """The 2-layer full-width qwen3-1.7b of the test above under each
    ZeRO strategy: at one rank the reduce-scatter and the all-gather are
    copies and AdamW is elementwise, so the losses and masters equal
    ``make_train_step``'s bit for bit; zero3 holds only its shard (and
    its moments) between steps."""
    from repro_torch.api import Trainer
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, trainable)
    cfg = get_config("qwen3-1.7b").with_overrides(num_layers=2)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, microbatches=2, remat=True)
    rng = np.random.default_rng(2)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 512))
                .astype(np.int32)} for _ in range(3)]
    state = init_train_state(cfg, tc, seed=0, device=cuda)
    step, _ = make_train_step(cfg, tc)
    want = []
    for b in batches:
        state, m = step(state, b)
        want.append(float(m["loss"]))
    trainer = Trainer.create(
        cfg, optimizer="adamw", lr=3e-4,
        dp=DPConfig(strategy=strategy, microbatches=2, overlap=overlap,
                    bucket_bytes=64 * 2 ** 20),
        mesh=nccl_mesh, train_cfg=TrainConfig(remat=True), seed=0,
        device=cuda)
    reset_launch_counts()
    got = [float(trainer.step(b)["loss"]) for b in batches]
    assert got == want
    assert launch_counts()["flash_attention"] == 3 * 2 * cfg.num_layers * 2
    spans = trainer.sync_ms_by_label()
    assert set(spans) == {"reduce_scatter", "all_gather"}
    ref = trainable(state.params)
    for k, p in trainer.params.items():
        assert np.array_equal(p, ref[k].detach().cpu().numpy()), k
    if strategy == "zero3":
        st = trainer.state
        assert st.flat.full.untyped_storage().nbytes() == 0
        assert max(p.untyped_storage().nbytes()
                   for p in trainable(st.params).values()) == 0


ZERO_GLOO_CODE = """
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch import optim
from repro_torch.api import Trainer
from repro_torch.configs.paper_nets import MNIST_DNN
from repro_torch.core import DPConfig
from repro_torch.core.collectives import _all_gather, _reduce_scatter
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.models import apply_paper_net, init_paper_net
from repro_torch.train import cross_entropy

dev = torch.device("cuda", 0)
mesh = make_dp_mesh(1)
x = torch.arange(8, dtype=torch.float32, device=dev) + 8 * RANK
sh = torch.empty(4, device=dev)
_reduce_scatter(sh, x, None, async_op=True).wait()
full = torch.empty(8, device=dev)
_all_gather(full, sh, None, async_op=True).wait()
rng = np.random.default_rng(0)
batch = {"x": rng.standard_normal((64, 784), dtype=np.float32),
         "y": rng.integers(0, 10, 64).astype(np.int32)}

def run(strategy, **kw):
    t = Trainer.create(
        loss_fn=lambda m, b: cross_entropy(
            apply_paper_net(MNIST_DNN, m, b["x"]), b["y"]),
        params=init_paper_net(MNIST_DNN, seed=0, device=dev),
        optimizer=optim.adam(1e-3), dp=DPConfig(strategy=strategy, **kw),
        mesh=mesh, device=dev)
    for _ in range(5):
        t.step(batch)
    return t.params

ref = run("flat")
gaps = {s: max(float(np.abs(p - ref[k]).max()) for k, p in run(s).items())
        for s in ("zero1", "zero2", "zero3")}
gaps["zero3_overlap"] = max(float(np.abs(p - ref[k]).max()) for k, p in run(
    "zero3", overlap=True, bucket_bytes=1 << 16).items())
print(json.dumps({"rs": sh.cpu().tolist(), "ag": full.cpu().tolist(),
                  "gaps": gaps}))
"""


def test_zero_over_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """Two gloo ranks share the card: gloo's reduce-scatter and
    all-gather take CUDA tensors (async handles too), and MNIST-DNN under
    zero1 / zero2 / zero3 (and zero3 bucket-pipelined) stays within the
    reference's 1e-5 of ``flat`` over 5 Adam steps (fp32, TF32 off)."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from torch_ranks import run_ranks
    res = run_ranks(ZERO_GLOO_CODE, 2, tmp_path, timeout=300)
    for rank, r in enumerate(res):
        assert r["rs"] == [8 + 2 * i + 8 * rank for i in range(4)]
        assert r["ag"] == [float(2 * a + 8) for a in range(8)]
        assert max(r["gaps"].values()) <= 1e-5, r["gaps"]


# --------------------------------------------------------------------------
# the whole-sequence branches of RWKV-6, Jamba and DeepSeek-V3: MLA's
# widths in the flash kernel, the scan kernels' autograd Functions, slab
# serving and training on the card
# --------------------------------------------------------------------------

MLA_FLASH_CASES = [
    # B, S, T, h, hk  (q and k 192 wide, v 128: DeepSeek-V3's MLA)
    (2, 70, 70, 4, 4),        # prefill-shaped, causal, ragged tiles
    (1, 9, 130, 8, 2),        # right-aligned, GQA
    (8, 128, 128, 32, 32),    # rows enough for the warpgroup blocks
]


def _mla_inputs(dev, dtype, seed, B, S, T, h, hk):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, S, h, 192), generator=g).to(dev, dtype),
            torch.randn((B, T, hk, 192), generator=g).to(dev, dtype),
            torch.randn((B, T, hk, 128), generator=g).to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLA_FLASH_CASES)
def test_flash_kernel_mla_widths_match_plain(cuda, case, dtype):
    """q/k 192, v 128: the kernel against its plain version, and the
    gradients of FlashAttention against autograd of the plain version."""
    q, k, v = _mla_inputs(cuda, dtype, sum(case), *case)
    dout = torch.randn(q.shape[:3] + (128,), device=cuda).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    out = flash_attention(*leaves)
    out.backward(dout)
    assert launch_counts()["flash_attention"] == 1
    assert out.shape == q.shape[:3] + (128,)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = flash_attention_ref(*ref_leaves)
    want.backward(dout)
    torch.testing.assert_close(out.detach().float(), want.detach().float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for name, a, b in zip("qkv", leaves, ref_leaves):
        rel = ((a.grad.float() - b.grad.float()).abs().max()
               / b.grad.float().abs().max()).item()
        assert rel <= TRAIN_GRAD_TOL[dtype], (name, rel)


def test_flash_kernel_refuses_widths_it_is_not_built_for(cuda):
    q, k, v = _mla_inputs(cuda, torch.bfloat16, 0, 1, 4, 4, 2, 2)
    with pytest.raises(ValueError, match="not built"):
        flash_attention(q[..., :160].contiguous(), k[..., :160].contiguous(),
                        v)
    with pytest.raises(ValueError, match="not built"):
        flash_attention(q, k, torch.cat([v, v], -1)[..., :192].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_functions_gradients_match_plain(cuda, dtype):
    """WKV6 and MambaScan (kernel forward, backward kernel) against
    autograd of the plain chunked forms, cotangents on y and the final
    state; each forward and each backward launched once."""
    from repro_torch.kernels import mamba_chunked
    g = torch.Generator().manual_seed(3)
    rand = lambda *s: torch.randn(s, generator=g)        # noqa: E731
    B, T, H, K = 2, 75, 4, 64
    wkv = [rand(B, T, H, K).to(cuda, dtype) for _ in range(3)] + [
        -torch.exp(rand(B, T, H, K)).to(cuda), rand(H, K).to(cuda),
        rand(B, H, K, K).to(cuda)]
    Bb, Tm, dI, dS = 2, 150, 256, 16
    proj = rand(Bb, Tm, 8 + 2 * dS).to(cuda, dtype)
    mamba = [rand(Bb, Tm, dI).to(cuda, dtype),
             torch.nn.functional.softplus(rand(Bb, Tm, dI)).to(cuda, dtype),
             -torch.exp(rand(dI, dS)).to(cuda), proj[..., 8:8 + dS],
             proj[..., 8 + dS:], rand(dI).to(cuda), rand(Bb, dI, dS).to(cuda)]
    for name, fn, plain, args in (("wkv6", wkv6, wkv6_chunked, wkv),
                                  ("mamba_scan", mamba_scan, mamba_chunked,
                                   mamba)):
        leaves = [a.clone().requires_grad_() for a in args]
        reset_launch_counts()
        y, s = fn(*leaves)
        assert launch_counts()[name] == 1
        dy, ds = torch.randn_like(y.float()), torch.randn_like(s)
        ((y.float() * dy).sum() + (s * ds).sum()).backward()
        assert launch_counts()[f"{name}_bwd"] == 1
        ref = [a.clone().requires_grad_() for a in args]
        y_ref, s_ref = plain(*ref)
        ((y_ref.float() * dy).sum() + (s_ref * ds).sum()).backward()
        for i, (a, b) in enumerate(zip(leaves, ref)):
            rel = ((a.grad.float() - b.grad.float()).abs().max()
                   / b.grad.float().abs().max()).item()
            assert rel <= TRAIN_GRAD_TOL[dtype], (name, i, rel)


# the scan backward kernels against the plain backwards on the same
# cotangents, max |err| / max |grad| (chip_smoke's SCAN_BWD_TOL): fp32 two
# fp32 evaluations of one gradient, each within ~2.3e-6 of a float64 one;
# bf16 one rounding of each gradient, at most one bf16 step (2^-7) of the
# largest
SCAN_BWD_TOL = {torch.float32: 5e-6, torch.bfloat16: 2.0 ** -7}
# B, T, H, K, chunk, decay: ragged tails, every cluster size's corner
# (1 rank at K 16, 8 at K 128), a short chunk, decays past the clip
WKV_BWD_CASES = [(2, 80, 4, 64, 32, 1.0), (1, 45, 2, 16, 16, 1.0),
                 (1, 70, 2, 128, 32, 1.0), (2, 37, 3, 32, 8, 1.0),
                 (1, 64, 4, 64, 32, 2.5)]
# Bb, T, dI, dS: ragged 32-step tiles and 32-channel blocks, every d_state
MAMBA_BWD_CASES = [(2, 75, 96, 16), (1, 40, 64, 4), (2, 33, 80, 8),
                   (1, 70, 8176, 32), (1, 1, 64, 16)]


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _scan_bwd_case(cuda, kind, case, dtype):
    """(the kernel's wrapper, the plain backward, its inputs, dy, ds)."""
    from repro_torch.kernels.mamba_scan import (mamba_chunked_bwd,
                                                mamba_scan_bwd)
    from repro_torch.kernels.wkv6 import wkv6_bwd, wkv6_chunked_bwd
    rng = np.random.default_rng(sum(case[:4]))
    if kind == "wkv6":
        B, T, H, K, chunk, decay = case
        host = _wkv_inputs(sum(case[:4]), B, T, H, K, decay)
        args = [torch.from_numpy(x).to(cuda) for x in host]
        args[:3] = [a.to(dtype) for a in args[:3]]
        dy = torch.from_numpy(rng.standard_normal((B, T, H, K)).astype(
            np.float32)).to(cuda, dtype)
        ds = torch.from_numpy(rng.standard_normal((B, H, K, K)).astype(
            np.float32)).to(cuda)
        return ((lambda *a: wkv6_bwd(*a, chunk=chunk)),
                (lambda *a: wkv6_chunked_bwd(*a, chunk=chunk)), args, dy, ds)
    Bb, T, dI, dS = case
    args = list(_mamba_on(cuda, dtype, *_mamba_inputs(sum(case), *case),
                          strided=True))
    dy = torch.from_numpy(rng.standard_normal((Bb, T, dI)).astype(
        np.float32)).to(cuda, dtype)
    ds = torch.from_numpy(rng.standard_normal((Bb, dI, dS)).astype(
        np.float32)).to(cuda)
    return mamba_scan_bwd, mamba_chunked_bwd, args, dy, ds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,case",
                         [("wkv6", c) for c in WKV_BWD_CASES]
                         + [("mamba", c) for c in MAMBA_BWD_CASES],
                         ids=str)
def test_scan_bwd_kernels_match_plain_backward(cuda, kind, case, dtype):
    """csrc/wkv6_bwd.cu and csrc/mamba_scan_bwd.cu (Mamba's B and C
    strided column slices of one projection) against the plain
    chunk-recomputing backwards on the same cotangents, with and without
    the final state's, at SCAN_BWD_TOL; the gradients in the inputs'
    dtypes, dB and dC contiguous; two calls bitwise equal."""
    kernel, plain, args, dy, ds = _scan_bwd_case(cuda, kind, case, dtype)
    for dstate in (ds, None):
        got = kernel(*args, dy, dstate)
        again = kernel(*args, dy, dstate)
        want = plain(*args, dy, dstate)
        torch.cuda.synchronize()
        for i, (a, b, w) in enumerate(zip(got, again, want)):
            assert a.dtype == w.dtype and a.shape == w.shape, (i, a.dtype)
            assert a.is_contiguous(), i
            assert torch.equal(a, b), i
            assert _rel(a, w) <= SCAN_BWD_TOL[dtype], (i, _rel(a, w))


def test_scan_bwd_kernels_count_launches_and_reject_bad_input(cuda):
    """One count a call; a cotangent in another dtype than the inputs',
    a head size or d_state the kernels are not built for raise before
    any launch."""
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd
    from repro_torch.kernels.wkv6 import wkv6_bwd
    kernel, _, args, dy, ds = _scan_bwd_case(
        cuda, "wkv6", (1, 20, 2, 32, 32, 1.0), torch.float32)
    reset_launch_counts()
    kernel(*args, dy, ds)
    kernel(*args, dy, None)
    assert launch_counts()["wkv6_bwd"] == 2
    with pytest.raises(TypeError):
        wkv6_bwd(*args, dy.bfloat16(), ds)
    with pytest.raises(TypeError):
        wkv6_bwd(*args, dy, ds.double())
    bad = [torch.from_numpy(x).to(cuda) for x in _wkv_inputs(0, 1, 4, 2, 40,
                                                             1.0)]
    with pytest.raises(ValueError, match="head size"):
        wkv6_bwd(*bad, torch.zeros_like(bad[0]), None)
    assert launch_counts()["wkv6_bwd"] == 2
    _, _, args, dy, ds = _scan_bwd_case(cuda, "mamba", (1, 20, 64, 16),
                                        torch.bfloat16)
    mamba_scan_bwd(*args, dy, ds)
    assert launch_counts()["mamba_scan_bwd"] == 1
    with pytest.raises(TypeError):
        mamba_scan_bwd(*args, dy.float(), ds)
    x, dt, A, B, C, D, h0 = args
    with pytest.raises(ValueError, match="d_state"):
        mamba_scan_bwd(x, dt, A[:, :2].contiguous(), B[..., :2], C[..., :2],
                       D, h0[..., :2].contiguous(), dy, None)
    assert launch_counts()["mamba_scan_bwd"] == 1


ARCHS = ["rwkv6-1.6b", "jamba-v0.1-52b", "deepseek-v3-671b"]


def _card_config(arch, **kw):
    """The smoke config in fp32; DeepSeek-V3's with MLA's real head
    widths (nope 128 + rope 64, v 128), the ones the flash kernel is
    built for (the smoke config's 48 / 32 are not)."""
    import dataclasses
    cfg = smoke_config(arch).with_overrides(dtype="float32", **kw)
    if cfg.attention == "mla":
        cfg = cfg.with_overrides(head_dim=192, mla=dataclasses.replace(
            cfg.mla, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128))
    return cfg


def _kernel_counts(cfg, calls):
    """Launches of each kernel when every layer runs ``calls[kind]``
    times: RWKV-6 and Mamba their scans, attention the flash kernel."""
    kinds = [m for m, _ in cfg.layer_pattern()]
    return {"wkv6": kinds.count("rwkv6") * calls["scan"],
            "mamba_scan": kinds.count("mamba") * calls["scan"],
            "flash_attention": kinds.count("attn") * calls["attn"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_slab_serving_on_card_matches_cpu(cuda, arch):
    """Each smoke config (``_card_config``) through the lockstep slab engine: greedy
    tokens on the card equal the CPU's; each whole-prompt scan and every
    flash call (MLA: its prefill only) launched its kernel."""
    cfg = _card_config(arch)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    new = 8
    outs = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu").to(dev)
        reset_launch_counts()
        outs[dev] = ServeEngine(cfg, model, batch_size=2,
                                max_len=48).generate(prompts, new).cpu()
    counts = launch_counts()
    want = _kernel_counts(cfg, {"scan": 1, "attn": 1 if cfg.attention ==
                                "mla" else new})
    assert {k: counts.get(k, 0) for k in want} == want
    np.testing.assert_array_equal(outs["cpu"].numpy(), outs["cuda"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_train_step_on_card_matches_cpu(cuda, arch):
    """Each smoke config (DeepSeek-V3 without its MTP head) in fp32, 2
    AdamW steps from the same masters: the first loss within 1e-5
    relative, the second within 1e-4; each layer's kernel launched in
    the forward and the remat recompute."""
    from repro_torch.train import TrainConfig
    cfg = _card_config(arch, mtp_depth=0)
    tc = TrainConfig(lr=3e-4)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 80))}
               for _ in range(2)]
    got = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu", train=True).to(dev)
        reset_launch_counts()
        got[dev] = _train(cfg, model, tc, batches)
    counts = launch_counts()
    want = _kernel_counts(cfg, {"scan": 2 * 2, "attn": 2 * 2})
    assert {k: counts.get(k, 0) for k in want} == want
    # one backward kernel a layer a step (no remat recompute)
    assert counts.get("flash_attention_bwd", 0) == want["flash_attention"] // 2
    assert counts.get("wkv6_bwd", 0) == want["wkv6"] // 2
    assert counts.get("mamba_scan_bwd", 0) == want["mamba_scan"] // 2
    rel = [abs(a - b) / abs(a) for a, b in zip(got["cpu"][0], got["cuda"][0])]
    assert rel[0] <= 1e-5 and rel[1] <= 1e-4, rel


# --------------------------------------------------------------------------
# the prefix cache and speculative decoding on the card
# --------------------------------------------------------------------------

def _verify_lengths(seed, B=8):
    return np.random.default_rng(seed).integers(480, 545, B)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["gqa", "mla"])
def test_verify_chunks_match_plain_and_mask_rolled_back_rows(cuda, kernel,
                                                             dtype):
    """Speculative decode's verify forward: B 8, S = k = 4 query rows a
    slot at per-slot positions (~512 tokens a slot), at qwen3's (h 16 over
    8 kv heads of 128) and DeepSeek-V3's (h 128, latent 512, rope 64)
    widths.  Rows past a slot's last query position -- where a rejected
    draft leaves its K/V -- are masked by position: raising them to 1e8
    changes no bit."""
    B, S, ps, W = 8, 4, 16, 37
    lengths = _verify_lengths(3)
    if kernel == "gqa":
        host = paged_case(5, B, S, 16, 8, 128, ps, W, lengths=lengths)
        args = _on(cuda, dtype, *host)
        run = lambda a: paged_flash_decode(*a, page_size=ps)     # noqa
        ref = paged_flash_decode_ref(*args, page_size=ps)
        pools = (1, 2)
    else:
        host = mla_case(5, B, S, 128, 512, 64, ps, W, lengths=lengths)
        args = _mla_on(cuda, dtype, *host)
        run = lambda a: paged_flash_decode_mla(                  # noqa
            *a, page_size=ps, scale=MLA_SCALE)
        ref = paged_flash_decode_mla_ref(*args, page_size=ps, scale=MLA_SCALE)
        pools = (2, 3)
    got = run(args)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    stale = list(args)
    for i in pools:
        stale[i] = torch.where(torch.from_numpy(host[i] == POISON).to(cuda),
                               1e8, args[i].float()).to(dtype)
    assert torch.equal(run(stale), got)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v3-671b"])
def test_cow_fork_copies_cuda_pool_pages(cuda, arch):
    """``cow_fork`` on the card: the shared page's rows land in the fresh
    page of every pooled leaf, and nothing else moves."""
    from repro_torch.serve import PagedKVCache
    cfg = smoke_config(arch)
    kv = PagedKVCache(cfg, slots=2, max_len=64, page_size=16, num_pages=9,
                      device=cuda)
    kv.alloc(0, 40)
    for layer in kv.cache:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, device=cuda))
    before = [{k: t.clone() for k, t in layer.items()} for layer in kv.cache]
    shared = kv._owned[0][1]
    kv.retain(shared)
    new = kv.cow_fork(0, 1)
    rows = lambda p: slice(p * 16, (p + 1) * 16)                  # noqa
    for layer, old in zip(kv.cache, before):
        for k, t in layer.items():
            assert torch.equal(t[rows(new)], old[k][rows(shared)])
            keep = torch.ones(t.shape[0], dtype=torch.bool, device=cuda)
            keep[rows(new)] = False
            assert torch.equal(t[keep], old[k][keep])
    assert kv.refcount(shared) == 1 and kv.table()[0, 1] == new


def _decode_tick_syncs(sch):
    """Blocking host syncs that torch's sync debug mode reports during
    one decode tick of ``sch`` (every slot active, nothing to admit)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            sch._decode_tick()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def test_spec_tick_makes_one_host_sync_on_card(cuda):
    """qwen3 smoke with an MTP head, fp32 on the card: a speculative tick
    reads the device back once, whatever its k and length -- as many
    syncing calls as the plain tick -- and its greedy tokens equal the
    plain decode's on the CPU."""
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32",
                                                    mtp_depth=1)
    model = init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 21)]
    kw = dict(slots=2, max_len=128, page_size=16, prefill_chunk=8)
    want = ContinuousScheduler(cfg, model, decode_chunk=4, **kw).generate(
        prompts, 12)
    card = model.to(cuda)
    syncs = {}
    for k, chunk in ((0, 4), (4, 2), (4, 4), (2, 8)):
        sch = ContinuousScheduler(cfg, card, spec_decode=k,
                                  decode_chunk=chunk, **kw)
        for p in prompts:
            sch.submit(p, 40)
        sch._admit()
        syncs[(k, chunk)] = _decode_tick_syncs(sch)
        st = sch.stats()
        assert st["decode_host_syncs"] == st["decode_dispatches"] == 1
    assert len(set(syncs.values())) == 1, syncs
    for k in (2, 4):
        got = ContinuousScheduler(cfg, card, spec_decode=k, decode_chunk=4,
                                  **kw).generate(prompts, 12)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the six newcomers: the paged kernel at their group sizes, the flash
# kernel's non-causal forms, the encoder-decoder and the VLM on the card
# --------------------------------------------------------------------------

NEW_GROUP_CASES = [
    # B, S, h, hk, hd, page_size, W, window: granite (g 48 over one kv
    # head), qwen2.5-32b (g 5), deepseek-coder-33b (g 7), deepseek-moe-16b
    # (g 1): a 16-row tile holds parts of several positions at g 5 and 7
    (8, 1, 48, 1, 128, 16, 37, 0), (1, 32, 48, 1, 128, 16, 37, 0),
    (8, 1, 40, 8, 128, 16, 37, 0), (1, 32, 40, 8, 128, 16, 37, 0),
    (8, 1, 56, 8, 128, 16, 37, 0), (1, 32, 56, 8, 128, 16, 37, 0),
    (8, 1, 16, 16, 128, 16, 37, 0), (1, 32, 16, 16, 128, 16, 37, 0),
    # windowed chunks: the tile skip reads the tile's lowest and highest
    # positions
    (4, 32, 40, 8, 128, 16, 37, 100), (4, 32, 56, 8, 128, 16, 37, 70),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", NEW_GROUP_CASES)
def test_kernel_new_group_sizes_match_plain(cuda, case, dtype):
    B, S, h, hk, hd, ps, W, window = case
    lengths = (np.random.default_rng(sum(case)).integers(480, 545, B)
               if S == 1 else None)
    args = _on(cuda, dtype, *paged_case(sum(case), B, S, h, hk, hd, ps, W,
                                        lengths=lengths))
    got = paged_flash_decode(*args, page_size=ps, window=window)
    want = paged_flash_decode_ref(*args, page_size=ps, window=window)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


CROSS_FLASH_CASES = [
    # B, S, T, h, hk, hd: non-causal, no window (an encoder, cross-
    # attention); seamless's (64, 64) widths
    (2, 1, 96, 4, 4, 64),          # a decode step against the source
    (2, 15, 16, 4, 4, 64),         # seq - 1 targets against seq frames
    (2, 255, 256, 16, 16, 64),     # ... at 16 heads
    (1, 300, 70, 4, 4, 64),        # more targets than frames
    (2, 128, 128, 16, 16, 64),     # the bidirectional encoder
    (8, 1024, 1024, 16, 16, 64),   # ... at phase 25's length (bf16: wgmma)
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CROSS_FLASH_CASES)
def test_flash_kernel_noncausal_forms_match_plain(cuda, case, dtype):
    from repro_torch.models.attention import chunked_attention
    B, S, T, h, hk, hd = case
    q, k, v = _flash_inputs(cuda, dtype, sum(case), B, S, T, h, hk, hd)
    want = flash_attention_ref(q, k, v, causal=False)
    # through the slab entry point, as the cross layers call it: any query
    # positions, all T keys
    reset_launch_counts()
    got = chunked_attention(q, k, v, q_positions=torch.arange(7, 7 + S),
                            kv_positions=range(T), causal=False, window=0)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_frontend_greedy_on_card_matches_cpu(cuda, arch):
    """The smoke config in fp32 through ``apply_model``'s slab prefill and
    8 greedy decode steps: the card's tokens equal the CPU's, and every
    attention call (encoder, self, cross) launched the flash kernel."""
    from repro_torch.models import apply_model, batch_inputs, init_cache
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12))}
    if cfg.is_encoder_decoder:
        batch = {"tgt_tokens": batch["tokens"], "src_embeds":
                 rng.standard_normal((2, 40, cfg.d_model), dtype=np.float32)}
    else:
        batch["vision_embeds"] = rng.standard_normal(
            (2, cfg.num_frontend_tokens, 1024), dtype=np.float32)
    new = 8
    outs = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu").to(dev)
        tokens, fronts = batch_inputs({k: torch.from_numpy(v).to(dev)
                                       for k, v in batch.items()})
        rows = tokens.shape[1] + sum(v.shape[1] for k, v in fronts.items()
                                     if k == "vision_embeds")
        cache = init_cache(cfg, torch.float32, batch=2, max_len=rows + new,
                           cross_len=40 if cfg.is_encoder_decoder else 0,
                           device=dev)
        reset_launch_counts()
        logits = apply_model(cfg, model, tokens, cache=cache, cache_pos=0,
                             mode="prefill", last_only=True, **fronts)["logits"]
        toks = [logits[:, -1].argmax(-1)[:, None]]
        for i in range(new - 1):
            logits = apply_model(cfg, model, toks[-1], cache=cache,
                                 cache_pos=rows + i, mode="decode")["logits"]
            toks.append(logits[:, -1].argmax(-1)[:, None])
        outs[dev] = torch.cat(toks, 1).cpu().numpy()
    per_call = (2 * cfg.num_layers if cfg.is_encoder_decoder
                else cfg.num_layers)
    assert launch_counts()["flash_attention"] == cfg.encoder_layers \
        + per_call * new
    np.testing.assert_array_equal(outs["cpu"], outs["cuda"])


# --------------------------------------------------------------------------
# the mesh step over one NCCL rank
# --------------------------------------------------------------------------

# qwen3's mesh forms are the one-device ops at size 1; the MoE's
# expert-parallel combine sums the k slots one by one where the dense
# dispatch sums them in one reduction, so deepseek-moe-16b is held to
# the fp32 training bar
MESH_ONE_TOL = {"qwen3-1.7b": 0.0, "deepseek-moe-16b": 1e-5}


@pytest.mark.parametrize("arch", sorted(MESH_ONE_TOL))
def test_mesh_step_over_one_nccl_rank_equals_train_step(cuda, arch):
    """A 2-layer full-width model in fp32 (TF32 off) on a (data 1, model
    1) mesh of one NCCL rank: every master and moment a DTensor placed by
    the rules (all replicated at size 1), the layers' mesh forms, the
    flash kernel on every attention call -- 3 momentum steps equal to the
    one-device step's losses and masters: qwen3 bitwise,
    deepseek-moe-16b (its MoE through ``apply_moe_ep``) within 1e-5."""
    import socket
    import torch.distributed as dist
    from repro_torch.bridge import gather_named
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, trainable)
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).with_overrides(num_layers=2, dtype="float32")
    tc = TrainConfig(optimizer="momentum", lr=1e-2, remat=True)
    rng = np.random.default_rng(28)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 256))
                .astype(np.int32)} for _ in range(3)]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_serve_mesh(1, 1, device_type="cuda")
        got = {}
        for where in ("mesh", "one"):
            m = mesh if where == "mesh" else None
            state = init_train_state(cfg, tc, mesh=m, seed=0, device=cuda)
            step, _ = make_train_step(cfg, tc, mesh=m)
            reset_launch_counts()
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
            assert launch_counts()["flash_attention"] == 3 * 2 * 2
            got[where] = (losses, {k: v.cpu() for k, v in gather_named(
                trainable(state.params)).items()})
            del state
    finally:
        dist.destroy_process_group()
    tol = MESH_ONE_TOL[arch]
    assert np.abs(np.subtract(got["mesh"][0], got["one"][0])).max() <= tol
    for k, v in got["one"][1].items():
        assert (got["mesh"][1][k] - v).abs().max() <= tol, k


def test_serve_mesh_over_one_nccl_rank_equals_engine(cuda):
    """A 2-layer full-width qwen3-1.7b in fp32 (TF32 off) served by the
    continuous scheduler on a (data 1, model 1) mesh of one NCCL rank --
    the weights DTensors placed by the serve-mode rules, the pool by
    ``pool_spec`` (all whole at size 1), each tick under the serve
    topology -- gives every sample's logits and the greedy tokens of the
    one-device engine bit for bit, with the paged kernel on every
    attention call."""
    import socket
    import torch.distributed as dist
    from repro_torch.bridge import mesh_placer
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import scheduler as sched_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-1.7b").with_overrides(num_layers=2,
                                                  dtype="float32")
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 97, 13, 64)]
    plain = sched_lib.sample, sched_lib.masked_sample

    def serve(model, mesh):
        logits = []

        def keep(fn):
            def rec(lg, *a, **k):
                logits.append(lg.clone())
                return fn(lg, *a, **k)
            return rec
        sched_lib.sample, sched_lib.masked_sample = map(keep, plain)
        try:
            sch = ContinuousScheduler(cfg, model, slots=4, max_len=128,
                                      mesh=mesh)
            reset_launch_counts()
            outs = sch.generate(prompts, 16)
            st = sch.stats()
        finally:
            sched_lib.sample, sched_lib.masked_sample = plain
        calls = st["prefill_dispatches"] + 8 * st["decode_dispatches"]
        assert launch_counts()["paged_flash_decode"] == 2 * calls
        return outs, logits

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        ref, ref_logits = serve(init_model(cfg, seed=0, device=cuda), None)
        mesh = make_serve_mesh(1, 1, device_type="cuda")
        got, logits = serve(init_model(cfg, seed=0, device=cuda, place=(
            mesh_placer(cfg, mesh, mode="serve"))), mesh)
    finally:
        dist.destroy_process_group()
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert len(logits) == len(ref_logits)
    assert all(torch.equal(a, b) for a, b in zip(logits, ref_logits))


# --------------------------------------------------------------------------
# kernels/ops.py on the card: the impl dispatch, the block surface and
# --decode-kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl,launches", [("auto", 1), ("cuda", 1),
                                           ("ref", 0), ("chunked", 0)])
def test_ops_impls_launch_only_when_the_kernel_is_named(cuda, impl,
                                                        launches):
    """On CUDA tensors "auto" and "cuda" launch each kernel once, "ref"
    and "chunked" run the plain forms there and launch nothing; every
    output within the plain version's bars."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba_scan import mamba_ref as plain_mamba
    rng = np.random.default_rng(0)

    def on(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)

    q, k, v = on(2, 40, 4, 64), on(2, 72, 2, 64), on(2, 72, 2, 64)
    r, kk, vv = on(1, 32, 2, 64), on(1, 32, 2, 64), on(1, 32, 2, 64)
    wl = -torch.exp(on(1, 32, 2, 64))
    u, s0 = on(2, 64), on(1, 2, 64, 64)
    x, dt = on(1, 32, 256), torch.nn.functional.softplus(on(1, 32, 256))
    A, Bm, Cm = -torch.exp(on(256, 16)), on(1, 32, 16), on(1, 32, 16)
    D, h0 = on(256), on(1, 256, 16)
    runs = {
        "flash_attention": (lambda: ops.flash_attention(q, k, v, impl=impl),
                            flash_attention_ref(q, k, v), 2e-5),
        "wkv6": (lambda: ops.wkv6(r, kk, vv, wl, u, s0, impl=impl)[0],
                 wkv6_chunked(r, kk, vv, wl, u, s0)[0], 5e-4),
        "mamba_scan": (lambda: ops.mamba_scan(x, dt, A, Bm, Cm, D, h0,
                                              impl=impl)[0],
                       plain_mamba(x, dt, A, Bm, Cm, D, h0)[0], 5e-4),
    }
    for name, (run, want, tol) in runs.items():
        reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        assert launch_counts().get(name, 0) == launches, name
        assert sum(launch_counts().values()) == launches, name
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 64, 4, 2, 128),
                                   (3, 1, 300, 16, 8, 128),
                                   (1, 96, 96, 4, 4, 64),
                                   (2, 7, 200, 8, 1, 64)])
def test_flash_every_block_shape_matches_plain(cuda, shape, dtype):
    """The flash kernel at each block shape it is built for
    (``block_choices``), set on the surface and passed per call, within
    the plain version's bars; the surface is restored after."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import block_choices
    from repro_torch.kernels.flash_attention import \
        flash_attention as kernel
    B, S, T, h, hk, hd = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in ((B, S, h, hd), (B, T, hk, hd),
                                          (B, T, hk, hd)))
    want = flash_attention_ref(q, k, v).float()
    for block_q, block_kv in block_choices(dtype, T):
        prev = ops.set_flash_blocks(block_q, block_kv)
        try:
            reset_launch_counts()
            got = kernel(q, k, v)
        finally:
            ops.set_flash_blocks(*prev)
        torch.testing.assert_close(got.float(), want, atol=TOL[dtype],
                                   rtol=TOL[dtype])
        assert launch_counts()["flash_attention"] == 1
        torch.testing.assert_close(
            kernel(q, k, v, block_q=block_q, block_kv=block_kv), got,
            atol=0, rtol=0)
    assert ops.get_flash_blocks() == (None, None)


def test_flash_unbuilt_block_shape_raises_on_card(cuda):
    from repro_torch.kernels.flash_attention import \
        flash_attention as kernel
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    for blocks, match in (((64, None), r"\[16, 128\]"),
                          ((128, 32), "only 16-row"),
                          ((16, 40), "multiple of 32")):
        with pytest.raises(ValueError, match=match):
            kernel(q, k, k, block_q=blocks[0], block_kv=blocks[1])
    with pytest.raises(ValueError, match="does not split"):
        kernel(q.float(), k.float(), k.float(), block_kv=32)


def test_decode_kernel_cuda_and_plain_equal_on_card(cuda):
    """The scheduler at decode_kernel "cuda" and "plain" on the card
    (fp32): equal greedy tokens; paged launches layers x model calls and
    0; "auto" launches as "cuda" does."""
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    model = init_model(cfg, seed=2, device=cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 19)]
    kw = dict(slots=2, max_len=96, page_size=8, prefill_chunk=32,
              decode_chunk=4)
    outs, launches = {}, {}
    for kernel in ("cuda", "plain", "auto"):
        sched = ContinuousScheduler(cfg.with_overrides(decode_kernel=kernel),
                                    model, **kw)
        reset_launch_counts()
        outs[kernel] = sched.generate(prompts, 8)
        st = sched.stats()
        launches[kernel] = launch_counts().get("paged_flash_decode", 0)
        calls = st["prefill_dispatches"] + 4 * st["decode_dispatches"]
        assert launches[kernel] == (0 if kernel == "plain"
                                    else cfg.num_layers * calls), kernel
    for a, b, c in zip(outs["cuda"], outs["plain"], outs["auto"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
