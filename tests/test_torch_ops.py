"""The port's ``kernels/ops.py`` against the reference's
``repro.kernels.ops``: the implementation dispatch (``impl=`` and
``set_default_impl``) of flash attention, WKV6 and the Mamba scan, each
port impl against the reference's matching one on the same numpy
inputs; the flash block surface (``set_flash_blocks`` /
``get_flash_blocks``), twins of ``tests/test_kernels.py``'s surface
tests; the launch layouts the surface gives the CUDA kernel (the
shapes it is built for, and refusals of the rest); the refusals of
"cuda" on CPU tensors, of the reference's "pallas" and of unknown
names; and the default impl steering the models' scans."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.configs import smoke_config
from repro_torch.kernels import gqa_split, ops
from repro_torch.kernels.flash_attention import SMALL_ROWS, launch_layout
from repro_torch.kernels.flash_attention import block_choices as port_choices
from repro_torch.kernels.flash_attention import resolve_blocks
from repro_torch.models import apply_model, init_model

torch.set_num_threads(2)

# the reference's bars: 2e-5 for attention against its oracle in fp32
# (tests/test_torch_flash_attention.py); the same scan algorithm in two
# libraries within 1e-4 (WKV6) and 5e-5 (Mamba), the sequential oracle
# against the chunked form within 5e-4, the reference's own bar for both
# scans (tests/test_torch_wkv6.py, tests/test_torch_mamba_scan.py)
ATTN_TOL = 2e-5
SAME_ALGO = {"wkv6": 1e-4, "mamba": 5e-5}
ACROSS_ALGO = 5e-4

# port impl -> the reference impl it is held against; the port's "auto"
# on a CPU tensor runs the plain version, the reference's default is
# "chunked"
PAIRS = [("ref", "ref"), ("chunked", "chunked"), ("auto", "chunked")]
# what the port's plain version under each impl computes, by algorithm:
# the scans' "auto" on the CPU is WKV6's chunked form, Mamba's
# sequential oracle
ALGO = {"wkv6": {"ref": "ref", "chunked": "chunked", "auto": "chunked"},
        "mamba": {"ref": "ref", "chunked": "chunked", "auto": "ref"}}

# B, S, T, h, hk, hd, causal, window (tests/test_kernels.py's forms)
ATTN_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 24, 56, 4, 4, 32, True, 0),        # right-aligned decode-style
    (2, 48, 48, 4, 2, 32, True, 16),       # sliding window
    (1, 32, 32, 2, 1, 32, False, 0),       # bidirectional, MQA
    (1, 17, 40, 2, 2, 32, True, 0),        # ragged q-chunks
]


@pytest.fixture
def surface():
    """The process-wide block surface and default impl, restored after."""
    blocks, impl = ops.get_flash_blocks(), ops.get_default_impl()
    try:
        yield
    finally:
        ops.set_flash_blocks(*blocks)
        ops.set_default_impl(impl)
    assert ops.get_flash_blocks() == blocks


def _qkv(seed, B, S, T, h, hk, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, h, hd)).astype(np.float32),
            rng.standard_normal((B, T, hk, hd)).astype(np.float32),
            rng.standard_normal((B, T, hk, hd)).astype(np.float32))


def _wkv_inputs(seed, B=2, T=40, H=2, K=32):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    wl = (-np.exp(rng.standard_normal((B, T, H, K)))).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, wl, u, s0


def _mamba_inputs(seed, Bb=2, T=40, dI=24, dS=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, T, dI)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, T, dI)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((dI, dS)))).astype(np.float32)
    B = rng.standard_normal((Bb, T, dS)).astype(np.float32)
    C = rng.standard_normal((Bb, T, dS)).astype(np.float32)
    D = rng.standard_normal((dI,)).astype(np.float32)
    h0 = rng.standard_normal((Bb, dI, dS)).astype(np.float32)
    return x, dt, A, B, C, D, h0


def _t(*a):
    return tuple(torch.from_numpy(x) for x in a)


def _j(*a):
    return tuple(jnp.asarray(x) for x in a)


# --------------------------------------------------------------------------
# port ops.* against reference ops.*, impl by impl
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_reference_impl(case, pair):
    B, S, T, h, hk, hd, causal, window = case
    q, k, v = _qkv(sum(case[:6]), B, S, T, h, hk, hd)
    port_impl, ref_impl = pair
    got = ops.flash_attention(*_t(q, k, v), causal=causal, window=window,
                              impl=port_impl, block_q=16)
    want = jax_ops.flash_attention(*_j(q, k, v), causal=causal,
                                   window=window, impl=ref_impl, block_q=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_wkv6_matches_reference_impl(pair):
    port_impl, ref_impl = pair
    a = _wkv_inputs(3)
    y, s = ops.wkv6(*_t(*a), impl=port_impl, chunk=16)
    yw, sw = jax_ops.wkv6(*_j(*a), impl=ref_impl, chunk=16)
    tol = (SAME_ALGO["wkv6"] if ALGO["wkv6"][port_impl] == ref_impl
           else ACROSS_ALGO)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), atol=tol, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), atol=tol, rtol=0)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_mamba_scan_matches_reference_impl(pair):
    port_impl, ref_impl = pair
    a = _mamba_inputs(5)
    y, s = ops.mamba_scan(*_t(*a), impl=port_impl, chunk=16)
    yw, sw = jax_ops.mamba_scan(*_j(*a), impl=ref_impl, chunk=16)
    tol = (SAME_ALGO["mamba"] if ALGO["mamba"][port_impl] == ref_impl
           else ACROSS_ALGO)
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), atol=tol, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), atol=tol, rtol=0)


def test_ref_returns_fp32_like_reference_other_impls_the_input_dtype():
    """The oracles return fp32 y, as the reference's do; the chunked
    forms and the wrappers cast y to the input's dtype."""
    w = [t.to(torch.bfloat16) if i < 3 else t
         for i, t in enumerate(_t(*_wkv_inputs(1, T=8)))]
    m = [t.to(torch.bfloat16) if i in (0, 1, 3, 4) else t
         for i, t in enumerate(_t(*_mamba_inputs(1, T=8)))]
    for impl, dtype in (("ref", torch.float32), ("chunked", torch.bfloat16),
                        ("auto", torch.bfloat16)):
        assert ops.wkv6(*w, impl=impl)[0].dtype == dtype, impl
        assert ops.mamba_scan(*m, impl=impl)[0].dtype == dtype, impl


def test_steps_are_the_reference_steps():
    a = _wkv_inputs(2, T=1)
    step = [x[:, 0] for x in a[:4]] + [a[4], a[5]]
    y, s = ops.wkv6_step(*_t(*step))
    yw, sw = jax_ops.wkv6_step(*_j(*step))
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), atol=1e-5, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), atol=1e-5, rtol=0)
    x, dt, A, B, C, D, h0 = _mamba_inputs(2, T=1)
    step = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, h0)
    y, s = ops.mamba_step(*_t(*step))
    yw, sw = jax_ops.mamba_step(*_j(*step))
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), atol=1e-5, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), atol=1e-5, rtol=0)


def test_default_impl_is_auto_and_steers_calls(surface):
    """"auto" is the default (the reference's is "chunked"); a set
    default reaches calls that name no impl, as the reference's does."""
    assert ops.get_default_impl() == "auto"
    assert jax_ops.get_default_impl() == "chunked"
    q, k, v = _t(*_qkv(9, 1, 24, 56, 4, 2, 32))
    want = jax_ref.attention_ref(*_j(q.numpy(), k.numpy(), v.numpy()))
    for impl in ("ref", "chunked", "auto"):
        ops.set_default_impl(impl)
        assert ops.get_default_impl() == impl
        np.testing.assert_allclose(ops.flash_attention(q, k, v).numpy(),
                                   np.asarray(want), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


# --------------------------------------------------------------------------
# no hidden fallback: the refusals
# --------------------------------------------------------------------------

def test_cuda_impl_refuses_cpu_tensors(surface):
    q, k, v = _t(*_qkv(0, 1, 8, 8, 2, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.wkv6(*_t(*_wkv_inputs(0, T=4)), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.mamba_scan(*_t(*_mamba_inputs(0, T=4)), impl="cuda")
    ops.set_default_impl("cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("name", ["pallas", "xla", "triton", ""])
def test_pallas_and_unknown_impls_raise_naming_cuda(name, surface):
    q, k, v = _t(*_qkv(0, 1, 8, 8, 2, 2, 32))
    with pytest.raises(ValueError, match='"cuda"'):
        ops.set_default_impl(name)
    assert ops.get_default_impl() == "auto"
    if name:                                 # "" is the default's None
        with pytest.raises(ValueError, match='"cuda"'):
            ops.flash_attention(q, k, v, impl=name)
        with pytest.raises(ValueError, match='"cuda"'):
            ops.wkv6(*_t(*_wkv_inputs(0, T=4)), impl=name)
        with pytest.raises(ValueError, match='"cuda"'):
            ops.mamba_scan(*_t(*_mamba_inputs(0, T=4)), impl=name)


def test_impls_keep_the_kernels_refusals():
    """A causal call whose first rows see no key is refused by every
    impl, as the kernel's wrapper refuses it."""
    q, k, v = _t(*_qkv(0, 1, 12, 8, 2, 2, 32))
    for impl in ("ref", "chunked", "auto"):
        with pytest.raises(ValueError, match="see no key"):
            ops.flash_attention(q, k, v, impl=impl)


# --------------------------------------------------------------------------
# the block surface (twins of tests/test_kernels.py:177-212)
# --------------------------------------------------------------------------

def test_set_flash_blocks_roundtrip_and_restore(surface):
    """Set returns the previous pair (so sweeps can restore), partial
    updates leave the other knob untouched, None goes back to the plan."""
    orig = ops.get_flash_blocks()
    assert orig == (None, None)              # the shape plan
    try:
        prev = ops.set_flash_blocks(128, 256)
        assert prev == orig
        assert ops.get_flash_blocks() == (128, 256)
        assert ops.set_flash_blocks(block_kv=64) == (128, 256)
        assert ops.get_flash_blocks() == (128, 64)     # block_q untouched
        assert ops.set_flash_blocks(block_q=None) == (128, 64)
        assert ops.get_flash_blocks() == (None, 64)
        with pytest.raises(AssertionError):
            ops.set_flash_blocks(0)
        with pytest.raises(AssertionError):
            ops.set_flash_blocks(block_kv=-32)
        assert ops.get_flash_blocks() == (None, 64)
    finally:
        ops.set_flash_blocks(*orig)
    assert ops.get_flash_blocks() == orig


@pytest.mark.parametrize("impl", ["ref", "chunked", "auto"])
def test_flash_attention_uses_block_surface(impl, surface):
    """flash_attention with no explicit blocks resolves them from the
    surface -- numerics identical across block choices, and equal to the
    reference's oracle and its chunked form at the same blocks."""
    q, k, v = _qkv(11, 1, 64, 64, 2, 2, 32)
    want = jax_ref.attention_ref(*_j(q, k, v))
    outs = []
    for bq, bkv in ((16, 32), (32, 16), (None, None)):
        ops.set_flash_blocks(bq, bkv)
        out = ops.flash_attention(*_t(q, k, v), impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=ATTN_TOL, rtol=ATTN_TOL)
        if bq is not None:
            prev = jax_ops.set_flash_blocks(bq, bkv)
            try:
                ref_out = jax_ops.flash_attention(*_j(q, k, v),
                                                  impl="chunked")
            finally:
                jax_ops.set_flash_blocks(*prev)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                       atol=ATTN_TOL, rtol=ATTN_TOL)
        outs.append(out)
    if impl == "chunked":       # one q-chunk or four: the same rows
        for out in outs[1:]:
            torch.testing.assert_close(out, outs[0], atol=1e-6, rtol=0)


# (B, S, T, h, hk): qwen3-1.7b's slab prefill and decode, its training
# forward, and a decode chunk
LAYOUT_SHAPES = [(8, 512, 512, 16, 8), (8, 1, 576, 16, 8),
                 (1, 4096, 4096, 16, 8), (1, 32, 300, 16, 8)]


@pytest.mark.parametrize("shape", LAYOUT_SHAPES)
def test_layouts_none_keeps_the_plan(shape):
    """Blocks None give today's layouts: the split plan for bf16, the
    SMALL_ROWS rule for fp32."""
    B, S, T, h, hk = shape
    assert launch_layout(torch.bfloat16, *shape) == gqa_split.plan(
        B * hk, h // hk * S, T)
    assert launch_layout(torch.float32, *shape) == (
        (4 if h // hk * S >= SMALL_ROWS else 1),)


@pytest.mark.parametrize("shape", LAYOUT_SHAPES)
def test_layouts_of_every_built_block_shape(shape):
    """block_q picks the block shape the kernel is built for; block_kv
    the splits, ceil(T / block_kv), 16-row blocks implied."""
    B, S, T, h, hk = shape
    bf16, f32 = torch.bfloat16, torch.float32
    assert launch_layout(bf16, *shape, block_q=128) == (4, 1)
    assert launch_layout(f32, *shape, block_q=16) == (1,)
    assert launch_layout(f32, *shape, block_q=64) == (4,)
    warps, splits = launch_layout(bf16, *shape, block_q=16)
    assert warps == 1 and 1 <= splits <= gqa_split.MAX_SPLITS
    least = 32 * -(-T // (32 * gqa_split.MAX_SPLITS))      # 8 splits
    for block_kv in range(least, T + 64, 32):
        for block_q in (None, 16):
            assert launch_layout(bf16, *shape, block_q=block_q,
                                 block_kv=block_kv) == (1, -(-T // block_kv))
    assert launch_layout(bf16, *shape, block_kv=least)[1] <= 8


@pytest.mark.parametrize("T", [1, 40, 512, 576, 4096])
def test_block_choices_are_every_built_shape_once(T):
    """``block_choices`` (the card's sweep) lists the plan, each built
    block_q, and one block_kv for each split count, all legal."""
    for dtype in (torch.float32, torch.bfloat16):
        choices = port_choices(dtype, T)
        assert choices[0] == (None, None)
        layouts = [launch_layout(dtype, 8, 1, T, 16, 8, *c) for c in choices]
        qs = [c[0] for c in choices if c[1] is None][1:]
        assert qs == ([16, 64] if dtype == torch.float32 else [16, 128])
        splits = [lay[1] for c, lay in zip(choices, layouts)
                  if c[1] is not None]
        assert len(splits) == len(set(splits))
        if dtype == torch.bfloat16:
            tiles = -(-T // 32)
            assert set(splits) == {-(-tiles // m) for m in range(
                -(-tiles // gqa_split.MAX_SPLITS), tiles + 1)}


@pytest.mark.parametrize("blocks,dtype,match", [
    ((64, None), torch.bfloat16, r"legal: None or \[16, 128\]"),
    ((32, None), torch.bfloat16, r"legal: None or \[16, 128\]"),
    ((128, None), torch.float32, r"legal: None or \[16, 64\]"),
    ((None, 64), torch.float32, "does not split"),
    ((16, 64), torch.float32, "does not split"),
    ((128, 64), torch.bfloat16, "only 16-row blocks split"),
    ((16, 48), torch.bfloat16, "a multiple of 32"),
    ((None, 64), torch.bfloat16, "from 96"),         # 9 splits of 576 keys
])
def test_unbuilt_block_values_raise_never_round(blocks, dtype, match):
    with pytest.raises(ValueError, match=match):
        launch_layout(dtype, 8, 1, 576, 16, 8, *blocks)


def test_launch_reads_the_surface(surface):
    """The kernel's launch takes the surface's blocks where a call
    passes none, and a call's own blocks over the surface's
    (``resolve_blocks``, which ``_launch`` hands ``launch_layout``)."""
    assert resolve_blocks() == (None, None)
    ops.set_flash_blocks(16, 256)
    assert resolve_blocks() == (16, 256)
    assert resolve_blocks(128, None) == (128, 256)
    assert resolve_blocks(None, 64) == (16, 64)
    ops.set_flash_blocks(block_kv=None)
    assert resolve_blocks() == (16, None)


# --------------------------------------------------------------------------
# the default impl steers the models' scans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,scan", [("rwkv6-1.6b", "wkv6"),
                                       ("jamba-v0.1-52b", "mamba")])
def test_default_impl_steers_the_models_scans(arch, scan, surface,
                                              monkeypatch):
    """The mixers call the scans through ``ops`` (as the reference's
    models do), so ``set_default_impl`` picks the form a prefill runs;
    every form gives the same logits within the scans' bar."""
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    model = init_model(cfg, seed=3, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    ran = []
    names = {"wkv6": ("wkv6_ref", "wkv6_chunked", "_wkv6"),
             "mamba": ("mamba_ref", "mamba_chunked", "_mamba")}[scan]
    for name in names:
        monkeypatch.setattr(ops, name, lambda *a, _f=getattr(ops, name),
                            _n=name, **k: ran.append(_n) or _f(*a, **k))
    logits = {}
    for impl, name in zip(("ref", "chunked", "auto"), names):
        ops.set_default_impl(impl)
        ran.clear()
        logits[impl] = apply_model(cfg, model, tok, mode="train")["logits"]
        assert ran and set(ran) == {name}, (impl, ran)
    for impl in ("ref", "chunked"):
        torch.testing.assert_close(logits[impl], logits["auto"], atol=1e-4,
                                   rtol=1e-4)
