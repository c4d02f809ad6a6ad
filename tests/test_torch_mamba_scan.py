"""The port's Mamba selective scan against the reference: the kernel's
plain version (``mamba_scan`` on CPU tensors) against ``ref.mamba_ref``,
``ops.mamba_chunked`` and interpret-mode ``mamba_pallas``;
``mamba_step`` against ``ops.mamba_step``; strided B/C, bf16 in and
out, and the wrapper's refusal to fall back when asked for another
device.  Inputs are drawn with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.mamba_scan import mamba_pallas
from repro_torch.kernels import mamba_ref, mamba_scan, mamba_step

torch.set_num_threads(2)

# the reference's MAMBA_CASES (tests/test_kernels.py): Bb, T, dI, dS,
# chunk, block_di -- the last two are the reference's blocking only
MAMBA_CASES = [
    (2, 64, 256, 8, 16, 128),
    (1, 72, 128, 16, 32, 128),   # ragged T
    (2, 40, 512, 4, 8, 256),
]
# The reference's own Mamba bar (tests/test_kernels.py): the chunked form
# and the kernels take the sums over time and state in other orders.
ATOL = 5e-4
# port scan vs reference scan: the same recurrence in another library,
# whose sum over dS may run in another order; |y| reaches ~20 on these
# inputs, where an fp32 ulp is 2e-6, so a few ulps
SAME_ALGO_ATOL = 5e-5


def _inputs(seed, Bb, T, dI, dS):
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
    return x, dt, A, B, C, D, h0


def _torch(*a):
    return tuple(torch.from_numpy(x) for x in a)


def _jax(*a):
    return tuple(jnp.asarray(x) for x in a)


def _close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_plain_matches_reference_scan_and_chunked(case):
    Bb, T, dI, dS, chunk, _ = case
    args = _inputs(sum(case), Bb, T, dI, dS)
    got = mamba_scan(*_torch(*args))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _close(got, ref.mamba_ref(*_jax(*args)), SAME_ALGO_ATOL)
    _close(got, ops.mamba_chunked(*_jax(*args), chunk=chunk), ATOL)


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_plain_matches_interpret_mode_pallas(case):
    Bb, T, dI, dS, chunk, block_di = case
    args = _inputs(sum(case) + 1, Bb, T, dI, dS)
    got = mamba_scan(*_torch(*args))
    want = mamba_pallas(*_jax(*args), chunk=chunk, block_di=block_di,
                        interpret=True)
    _close(got, want, ATOL)


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_port_scan_oracle_matches_reference_scan(case):
    Bb, T, dI, dS, _, _ = case
    args = _inputs(sum(case) + 2, Bb, T, dI, dS)
    _close(mamba_ref(*_torch(*args)), ref.mamba_ref(*_jax(*args)),
           SAME_ALGO_ATOL)


@pytest.mark.parametrize("T", [1, 7, 33])
def test_ragged_lengths_match_reference(T):
    """No padding: any T gives the reference scan's result, and the
    first T steps of a longer call equal the T-step call."""
    x, dt, A, B, C, D, h0 = _inputs(T, 2, T + 5, 64, 16)
    short = tuple(np.ascontiguousarray(a[:, :T]) for a in (x, dt, B, C))
    args = (short[0], short[1], A, short[2], short[3], D, h0)
    got = mamba_scan(*_torch(*args))
    _close(got, ref.mamba_ref(*_jax(*args)), SAME_ALGO_ATOL)
    y_long, _ = mamba_scan(*_torch(x, dt, A, B, C, D, h0))
    assert torch.equal(y_long[:, :T], got[0])


def test_step_matches_reference_step_and_scan():
    x, dt, A, B, C, D, h0 = _inputs(5, 3, 1, 64, 8)
    args1 = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, h0)
    y, h = mamba_step(*_torch(*args1))
    yr, hr = ops.mamba_step(*_jax(*args1))
    _close((y, h), (yr, hr), SAME_ALGO_ATOL)
    ys, hs = mamba_scan(*_torch(x, dt, A, B, C, D, h0))
    _close((y, h), (ys[:, 0], hs), SAME_ALGO_ATOL)


def test_strided_b_and_c_from_one_projection():
    """B and C arrive as column slices of one (Bb, T, R + 2 dS)
    projection, as in ``apply_mamba``: same result as contiguous."""
    x, dt, A, B, C, D, h0 = _inputs(9, 2, 20, 128, 16)
    R = 8
    proj = np.concatenate([np.zeros((2, 20, R), np.float32), B, C], axis=-1)
    pt = torch.from_numpy(proj)
    Bs, Cs = pt[..., R:R + 16], pt[..., R + 16:]
    assert not Bs.is_contiguous() and Bs.stride(2) == 1
    got = mamba_scan(*_torch(x, dt, A), Bs, Cs, *_torch(D, h0))
    want = mamba_scan(*_torch(x, dt, A, B, C, D, h0))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bf16_in_gives_bf16_out_and_fp32_state():
    """bf16 x/dt/B/C: y comes back in bf16, one bf16 rounding of the fp32
    scan over the same (bf16) inputs; the state stays fp32."""
    x, dt, A, B, C, D, h0 = _inputs(11, 1, 32, 128, 16)
    xb, dtb, Bb, Cb = (t.bfloat16() for t in _torch(x, dt, B, C))
    y, h = mamba_scan(xb, dtb, *_torch(A), Bb, Cb, *_torch(D, h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y32, h32 = mamba_ref(xb, dtb, *_torch(A), Bb, Cb, *_torch(D, h0))
    assert torch.equal(y, y32.bfloat16()) and torch.equal(h, h32)


def test_wrapper_refuses_other_devices_and_bad_shapes():
    """No silent fallback: a tensor that is not on the CPU launches the
    kernel, is counted (the meta device: the dry run's empty outputs of
    the kernel's shapes, no op of the plain version run) or raises (the
    launch of any other device)."""
    import importlib
    from repro_torch.roofline.cost import count
    kernel = importlib.import_module("repro_torch.kernels.mamba_scan")
    args = _torch(*_inputs(0, 1, 4, 32, 8))
    meta = tuple(t.to("meta") for t in args)
    ops_run = []

    class Ops(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            ops_run.append(func._overloadpacket.__name__)
            return func(*a, **(kw or {}))
    with Ops():
        (y, h), c = count(mamba_scan, *meta, track_memory=False)
    assert set(ops_run) <= {"empty_like"}, ops_run
    assert y.shape == meta[0].shape and h.shape == meta[-1].shape
    assert (c["flops"], c["dot_bytes"]) == kernel.meta_cost(1, 4, 32, 8)
    with pytest.raises(ValueError, match="device"):
        kernel._launch(*args)
    x, dt, A, B, C, D, h0 = args
    with pytest.raises(ValueError, match="state"):
        mamba_scan(x, dt, A, B, C, D, h0[:, :, :4])
    with pytest.raises(ValueError, match="dt"):
        mamba_scan(x, dt[:, :2], A, B, C, D, h0)


def test_probe_build_is_its_own_library():
    """The clock-stamp probe (``-DSCAN_PROBE``) builds under another
    name than the shipped kernel, and switching it off returns to the
    shipped build."""
    from repro_torch.kernels import build
    shipped = build._paths("mamba_scan")[1]
    assert "-DSCAN_PROBE" not in build._flags("mamba_scan")
    build.set_probe("mamba_scan", True)
    try:
        assert "-DSCAN_PROBE" in build._flags("mamba_scan")
        assert build._paths("mamba_scan")[1] != shipped
    finally:
        build.set_probe("mamba_scan", False)
    assert build._paths("mamba_scan")[1] == shipped


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_chunked_matches_reference_chunked(case):
    """The port's mamba_chunked (the reference's chunk schedule, steps in
    order inside a chunk) against ops.mamba_chunked."""
    from repro_torch.kernels import mamba_chunked
    Bb, T, dI, dS, chunk, _ = case
    args = _inputs(sum(case) + 3, Bb, T, dI, dS)
    got = mamba_chunked(*_torch(*args), chunk=chunk)
    _close(got, ops.mamba_chunked(*_jax(*args), chunk=chunk), SAME_ALGO_ATOL)
    _close(got, mamba_ref(*_torch(*args)), ATOL)


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_plain_backward_matches_reference_grad(case):
    """The plain backward of MambaScan's autograd Function against
    jax.grad of the reference's checkpointed chunk scan: max |err|
    within 1e-5 of max |grad|."""
    import jax
    from repro_torch.kernels import mamba_chunked_bwd
    Bb, T, dI, dS, chunk, _ = case
    args = _inputs(sum(case) + 4, Bb, T, dI, dS)
    rng = np.random.default_rng(sum(case))
    dy = rng.standard_normal((Bb, T, dI)).astype(np.float32)
    ds = rng.standard_normal((Bb, dI, dS)).astype(np.float32)

    def loss(*a):
        y, s = ops.mamba_chunked(*a, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    want = jax.grad(loss, argnums=tuple(range(7)))(*_jax(*args))
    got = mamba_chunked_bwd(*_torch(*args), *_torch(dy, ds), chunk=chunk)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "D", "state"), got,
                          want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


def test_cpu_autograd_is_the_backward_oracle():
    """CPU tensors differentiate the plain forward (mamba_ref); its
    gradient is what the Function's backward computes, for strided B and
    C as the model passes them."""
    from repro_torch.kernels import mamba_chunked_bwd
    x, dt, A, B, C, D, h0 = _torch(*_inputs(5, 2, 150, 32, 8))
    BC = torch.cat([B, C], dim=-1)
    B, C = BC[..., :8], BC[..., 8:]
    args = (x, dt, A, B, C, D, h0)
    leaves = [a.clone().requires_grad_() for a in args]
    y, _ = mamba_scan(*leaves)
    dy = torch.randn_like(y)
    want = torch.autograd.grad(y, leaves, dy)
    got = mamba_chunked_bwd(*args, dy, None)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
