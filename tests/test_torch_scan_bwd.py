"""The scan backward kernels' plain versions on the CPU: ``wkv6_bwd_tiled``
and ``mamba_bwd_tiled`` (the algorithms of ``csrc/wkv6_bwd.cu`` and
``csrc/mamba_scan_bwd.cu``: saved chunk or tile states, the reverse walk,
the partial sums added in a fixed order) against ``jax.grad`` of the
reference's checkpointed chunk scans (``ops.wkv6_chunked``,
``ops.mamba_chunked``) on the same numpy inputs; the wrappers' CPU
branch; that no device other than the CPU takes a plain backward in the
wrappers; and that the autograd Functions keep the plain backwards on
meta tensors (the dry run's count).  The CUDA kernels run only on the
card (``tests/test_torch_gpu.py``)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels.mamba_scan import (mamba_bwd_tiled, mamba_chunked_bwd,
                                            mamba_ref_bwd, mamba_scan_bwd)
from repro_torch.kernels.wkv6 import (wkv6_bwd, wkv6_bwd_tiled, wkv6_chunked_bwd,
                                      wkv6_ref_bwd)

torch.set_num_threads(2)

# the modules (``repro_torch.kernels`` exports ops' wrappers under their names)
wkv6_mod = importlib.import_module("repro_torch.kernels.wkv6")
mamba_mod = importlib.import_module("repro_torch.kernels.mamba_scan")

# fp32: max |err| within 1e-5 of max |grad|, the plain backwards' bar
# against the same oracle (tests/test_torch_wkv6.py, test_torch_mamba_scan.py)
GRAD_REL = 1e-5
# bf16 inputs: each gradient is computed in fp32 from the bf16 values and
# rounded once to bf16 (half an ulp, 2^-9 relative), so 2^-8 of max |grad|
# plus the fp32 bar
BF16_REL = 2.0 ** -8 + GRAD_REL

# (B, T, H, K, chunk): the reference's WKV_CASES (tests/test_kernels.py),
# the last ragged at a short chunk, and the kernel's 32-step tile over a
# ragged tail
WKV_CASES = [
    (2, 64, 2, 64, 16),
    (1, 80, 3, 32, 32),
    (2, 37, 1, 64, 8),
    (1, 45, 2, 16, 32),
]
# (Bb, T, dI, dS): the reference's MAMBA_CASES' shapes (T 72 and 40 ragged
# against the kernel's 32-step tile), and dI 80 (a ragged 32-channel block)
MAMBA_CASES = [
    (2, 64, 256, 8, 16),
    (1, 72, 128, 16, 32),
    (2, 40, 512, 4, 8),
    (1, 70, 80, 32, 64),
]


def _wkv_inputs(seed, B, T, H, K, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    wl = (-decay_scale * np.exp(rng.standard_normal((B, T, H, K)))
          ).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    dy = rng.standard_normal((B, T, H, K)).astype(np.float32)
    ds = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return (r, k, v, wl, u, s0), dy, ds


def _mamba_inputs(seed, Bb, T, dI, dS):
    """The reference test's distributions: dt = softplus(N(0, 1)),
    A = -exp(N(0, 1)), the rest N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, T, dI)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, T, dI)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((dI, dS)))).astype(np.float32)
    B = rng.standard_normal((Bb, T, dS)).astype(np.float32)
    C = rng.standard_normal((Bb, T, dS)).astype(np.float32)
    D = rng.standard_normal((dI,)).astype(np.float32)
    h0 = rng.standard_normal((Bb, dI, dS)).astype(np.float32)
    dy = rng.standard_normal((Bb, T, dI)).astype(np.float32)
    ds = rng.standard_normal((Bb, dI, dS)).astype(np.float32)
    return (x, dt, A, B, C, D, h0), dy, ds


def _ref_grads(fn, args, dy, ds, **kw):
    """jax.grad of sum(y dy) + sum(state ds) through the reference's
    chunked form (ds None: the state's term left out)."""
    def loss(*a):
        y, s = fn(*a, **kw)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(s * ds)
    return [np.asarray(g) for g in jax.grad(
        loss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))]


def _assert_close(got, want, names, rel=GRAD_REL, low=()):
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        bar = (BF16_REL if name in low else rel) * np.abs(w).max()
        err = np.abs(g.float().numpy() - w).max()
        assert err <= bar, (name, err, bar)


WKV_NAMES = ("r", "k", "v", "w_log", "u", "state")
MAMBA_NAMES = ("x", "dt", "A", "B", "C", "D", "state")


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv6_tiled_backward_matches_reference_grad(case):
    """wkv6_bwd_tiled against jax.grad of the reference's wkv6_chunked at
    the same chunk, with and without a cotangent on the final state."""
    B, T, H, K, chunk = case
    args, dy, ds = _wkv_inputs(sum(case), B, T, H, K)
    t = [torch.from_numpy(a) for a in args]
    for cot in (ds, None):
        want = _ref_grads(ops.wkv6_chunked, args, dy, cot, chunk=chunk)
        got = wkv6_bwd_tiled(*t, torch.from_numpy(dy),
                             None if cot is None else torch.from_numpy(cot),
                             chunk=chunk)
        assert all(g.dtype == torch.float32 for g in got)
        _assert_close(got, want, WKV_NAMES)


def test_wkv6_tiled_backward_past_the_clip():
    """Log-decays of about -3 a step carry L[j] - Lp[t] past -60 within a
    32-step chunk: the clipped pairs' terms (zero gradient in the
    reference, at most e^-60 |r k| here) change nothing at the bar."""
    B, T, H, K = 1, 64, 2, 32
    args, dy, ds = _wkv_inputs(11, B, T, H, K, decay_scale=3.0)
    L = np.cumsum(args[3][:, :32], axis=1)
    assert (L[:, -1] - L[:, 0] < -60).any()
    want = _ref_grads(ops.wkv6_chunked, args, dy, ds, chunk=32)
    got = wkv6_bwd_tiled(*map(torch.from_numpy, (*args, dy, ds)))
    _assert_close(got, want, WKV_NAMES)


def test_wkv6_tiled_backward_bf16_inputs():
    """bf16 r, k, v and dy: the gradients come back in the inputs' dtypes
    (dr, dk, dv bf16; dw, du, dstate fp32), against jax.grad on the
    bf16-rounded values in fp32."""
    B, T, H, K = 2, 40, 2, 32
    args, dy, ds = _wkv_inputs(12, B, T, H, K)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    low = [bf(a) for a in args[:3]] + [bf(dy)]
    rounded = [a.float().numpy() for a in low]
    want = _ref_grads(ops.wkv6_chunked, (*rounded[:3], *args[3:]),
                      rounded[3], ds, chunk=32)
    got = wkv6_bwd_tiled(*low[:3], *map(torch.from_numpy, args[3:]), low[3],
                         torch.from_numpy(ds))
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    _assert_close(got, want, WKV_NAMES, low=("r", "k", "v"))


@pytest.mark.parametrize("case", MAMBA_CASES, ids=str)
def test_mamba_tiled_backward_matches_reference_grad(case):
    """mamba_bwd_tiled against jax.grad of the reference's mamba_chunked
    (its chunk differs from the backward's 32-step tile on purpose), with
    and without a cotangent on the final state."""
    Bb, T, dI, dS, chunk = case
    args, dy, ds = _mamba_inputs(sum(case), Bb, T, dI, dS)
    t = [torch.from_numpy(a) for a in args]
    for cot in (ds, None):
        want = _ref_grads(ops.mamba_chunked, args, dy, cot, chunk=chunk)
        got = mamba_bwd_tiled(*t, torch.from_numpy(dy),
                              None if cot is None else torch.from_numpy(cot))
        assert all(g.dtype == torch.float32 for g in got)
        _assert_close(got, want, MAMBA_NAMES)


def test_mamba_tiled_backward_strided_b_c_and_bf16():
    """B and C as column slices of one projection (the model's), in bf16
    with x, dt and dy: dB and dC come back contiguous in bf16, the fp32
    gradients in fp32, against jax.grad on the bf16-rounded values."""
    Bb, T, dI, dS, R = 2, 50, 96, 16, 8
    args, dy, ds = _mamba_inputs(13, Bb, T, dI, dS)
    x, dt, A, B, C, D, h0 = args
    rng = np.random.default_rng(14)
    proj = np.concatenate([rng.standard_normal((Bb, T, R)).astype(np.float32),
                           B, C], axis=-1)
    pt = torch.from_numpy(proj).to(torch.bfloat16)
    Bt, Ct = pt[..., R:R + dS], pt[..., R + dS:]
    assert Bt.stride(1) == R + 2 * dS
    low = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, dt, dy)]
    r = lambda t: t.float().numpy()
    want = _ref_grads(ops.mamba_chunked, (r(low[0]), r(low[1]), A, r(Bt),
                                          r(Ct), D, h0), r(low[2]), ds,
                      chunk=64)
    got = mamba_bwd_tiled(low[0], low[1], torch.from_numpy(A), Bt, Ct,
                          torch.from_numpy(D), torch.from_numpy(h0), low[2],
                          torch.from_numpy(ds))
    assert got[3].is_contiguous() and got[4].is_contiguous()
    assert [g.dtype for g in got] == ([torch.bfloat16] * 2 + [torch.float32]
                                      + [torch.bfloat16] * 2
                                      + [torch.float32] * 2)
    _assert_close(got, want, MAMBA_NAMES, low=("x", "dt", "B", "C"))


@pytest.mark.parametrize("mod", ["wkv6", "mamba"])
def test_sequential_backwards_match_reference_grad(mod):
    """wkv6_ref_bwd and mamba_ref_bwd (the sequential oracles' gradients,
    which phase 2 of chip_smoke.py runs in float64 as its yardstick)
    against jax.grad of the reference's chunked forms, with and without
    the state's cotangent; float64 inputs stay float64."""
    if mod == "wkv6":
        args, dy, ds = _wkv_inputs(61, 2, 45, 2, 16)
        fn, ref, names = wkv6_ref_bwd, ops.wkv6_chunked, WKV_NAMES
    else:
        args, dy, ds = _mamba_inputs(62, 2, 45, 48, 8)
        fn, ref, names = mamba_ref_bwd, ops.mamba_chunked, MAMBA_NAMES
    for cot in (ds, None):
        want = _ref_grads(ref, args, dy, cot, chunk=16)
        host = (*args, dy) + (() if cot is None else (cot,))
        for dtype in (np.float32, np.float64):
            t = [torch.from_numpy(a.astype(dtype)) for a in host]
            got = fn(*t, *(() if cot is not None else (None,)))
            assert all(g.dtype == t[0].dtype for g in got)
            _assert_close(got, want, names)


def test_tiled_backwards_agree_with_the_plain_backwards():
    """On the same inputs the tiled versions and the chunk-recomputing
    plain backwards (the Functions' backwards until the kernels) agree
    at the fp32 bar."""
    args, dy, ds = _wkv_inputs(21, 1, 70, 2, 32)
    t = [torch.from_numpy(a) for a in (*args, dy, ds)]
    _assert_close(wkv6_bwd_tiled(*t), [g.numpy() for g in
                                       wkv6_chunked_bwd(*t)], WKV_NAMES)
    args, dy, ds = _mamba_inputs(22, 2, 70, 64, 8)
    t = [torch.from_numpy(a) for a in (*args, dy, ds)]
    _assert_close(mamba_bwd_tiled(*t), [g.numpy() for g in
                                        mamba_chunked_bwd(*t)], MAMBA_NAMES)


def test_wrappers_take_the_tiled_versions_on_cpu_and_check_shapes():
    """wkv6_bwd and mamba_scan_bwd on CPU tensors are the tiled versions,
    bit for bit; a cotangent of the wrong shape raises."""
    args, dy, ds = _wkv_inputs(31, 1, 33, 2, 16)
    t = [torch.from_numpy(a) for a in (*args, dy, ds)]
    for a, b in zip(wkv6_bwd(*t, chunk=16), wkv6_bwd_tiled(*t, chunk=16)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dy"):
        wkv6_bwd(*t[:6], t[6][:, 1:], t[7])
    with pytest.raises(ValueError, match="dstate"):
        wkv6_bwd(*t[:7], t[7][:, :1])
    args, dy, ds = _mamba_inputs(32, 1, 33, 40, 4)
    t = [torch.from_numpy(a) for a in (*args, dy, ds)]
    for a, b in zip(mamba_scan_bwd(*t), mamba_bwd_tiled(*t)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dy"):
        mamba_scan_bwd(*t[:7], t[7][:, 1:], t[8])
    with pytest.raises(ValueError, match="dstate"):
        mamba_scan_bwd(*t[:8], t[8][:, :1])


@pytest.mark.parametrize("mod", ["wkv6", "mamba"])
def test_backward_wrappers_never_fall_back_off_the_cpu(mod, monkeypatch):
    """A tensor off the CPU reaches the kernel's launch, which raises on
    any device but CUDA (here: meta) before anything is built; neither
    plain backward nor the tiled version runs."""
    if mod == "wkv6":
        args, dy, ds = _wkv_inputs(41, 1, 20, 2, 16)
        fn, module, plain = wkv6_bwd, wkv6_mod, ("wkv6_bwd_tiled",
                                                  "wkv6_chunked_bwd")
    else:
        args, dy, ds = _mamba_inputs(42, 1, 20, 32, 8)
        fn, module, plain = mamba_scan_bwd, mamba_mod, ("mamba_bwd_tiled",
                                                         "mamba_chunked_bwd")
    called = []
    for name in plain:
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, **k: called.append(_n))
    monkeypatch.setattr(module, "load_library",
                        lambda stem: called.append(stem))
    meta = [torch.from_numpy(a).to("meta") for a in (*args, dy, ds)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        fn(*meta)
    assert called == []


@pytest.mark.parametrize("mod", ["wkv6", "mamba"])
def test_functions_keep_the_plain_backward_on_meta(mod, monkeypatch):
    """The dry run differentiates the Functions on meta tensors: their
    backward is the chunk-recomputing plain one there (the reference's
    loop, as the count expects), never the kernel's wrapper."""
    if mod == "wkv6":
        args, dy, ds = _wkv_inputs(51, 1, 40, 2, 16)
        module, fn, kernel = wkv6_mod, "wkv6_chunked_bwd", "wkv6_bwd"
        apply = lambda *a: wkv6_mod.WKV6.apply(*a, 32)
    else:
        args, dy, ds = _mamba_inputs(52, 1, 40, 32, 8)
        module, fn, kernel = mamba_mod, "mamba_chunked_bwd", "mamba_scan_bwd"
        apply = lambda *a: mamba_mod.MambaScan.apply(*a, 64)
    calls = []
    plain = getattr(module, fn)
    monkeypatch.setattr(module, fn, lambda *a, **k: (calls.append(fn),
                                                      plain(*a, **k))[1])
    monkeypatch.setattr(module, kernel, lambda *a, **k: calls.append(kernel))
    leaves = [torch.from_numpy(a).to("meta").requires_grad_() for a in args]
    y, s = apply(*leaves)
    torch.autograd.backward((y, s), (torch.from_numpy(dy).to("meta"),
                                     torch.from_numpy(ds).to("meta")))
    assert calls == [fn]
    assert all(a.grad is not None and a.grad.shape == a.shape
               for a in leaves)
