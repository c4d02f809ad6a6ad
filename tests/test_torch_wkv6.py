"""The port's WKV6 against the reference: the kernel's plain version
(``wkv6`` on CPU tensors) against ``ops.wkv6_chunked``, ``ref.wkv6_ref``
and interpret-mode ``wkv6_pallas``; ``wkv6_step`` against
``ops.wkv6_step``; and the wrapper's refusal to fall back when asked
for the card.  Inputs are drawn with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.rwkv6_scan import wkv6_pallas
from repro_torch.kernels import wkv6, wkv6_chunked, wkv6_ref, wkv6_step

torch.set_num_threads(2)

# the reference's WKV_CASES (tests/test_kernels.py): B, T, H, K, chunk
WKV_CASES = [
    (2, 64, 2, 64, 16),
    (1, 80, 3, 32, 32),   # T not a multiple of chunk
    (2, 37, 1, 64, 8),
]
# The reference's own WKV bar (tests/test_kernels.py): the chunked form
# re-associates the time sums and takes exp of cumsum differences.
ATOL = 5e-4
# port plain vs reference chunked: the same algorithm in another library;
# only the order of the einsum contractions differs
SAME_ALGO_ATOL = 1e-4


def _inputs(seed, B, T, H, K, *, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    wl = (-decay_scale * np.exp(rng.standard_normal((B, T, H, K)))
          ).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, wl, u, s0


def _torch(*a):
    return tuple(torch.from_numpy(x) for x in a)


def _jax(*a):
    return tuple(jnp.asarray(x) for x in a)


@pytest.mark.parametrize("case", WKV_CASES)
def test_plain_matches_reference_chunked_and_scan(case):
    B, T, H, K, chunk = case
    args = _inputs(sum(case), B, T, H, K)
    y, s = wkv6(*_torch(*args), chunk=chunk)
    yc, sc = ops.wkv6_chunked(*_jax(*args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yc), atol=SAME_ALGO_ATOL,
                               rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sc), atol=SAME_ALGO_ATOL,
                               rtol=0)
    yr, sr = ref.wkv6_ref(*_jax(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", WKV_CASES)
def test_plain_matches_interpret_mode_pallas(case):
    B, T, H, K, chunk = case
    args = _inputs(sum(case) + 1, B, T, H, K)
    y, s = wkv6(*_torch(*args), chunk=chunk)
    yp, sp = wkv6_pallas(*_jax(*args), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", WKV_CASES)
def test_port_scan_oracle_matches_reference_scan(case):
    B, T, H, K, _ = case
    args = _inputs(sum(case) + 2, B, T, H, K)
    y, s = wkv6_ref(*_torch(*args))
    yr, sr = ref.wkv6_ref(*_jax(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=SAME_ALGO_ATOL,
                               rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=SAME_ALGO_ATOL,
                               rtol=0)


def test_plain_with_decays_past_the_clip():
    """Decays near -4 a step: pairs more than ~15 steps apart in a chunk
    fall below the -60 clip, which must be applied as the reference
    applies it."""
    B, T, H, K = 1, 64, 2, 32
    args = _inputs(7, B, T, H, K, decay_scale=4.0)
    L = np.cumsum(args[3][:, :32], axis=1)
    assert (L[:, -1] - L[:, 0] < -60).any()        # the clip is reached
    # L reaches -350 within a chunk, where an fp32 ulp is 3e-5: the
    # exps of its differences carry that error, so even the same
    # algorithm is held to the reference's own bar here
    y, s = wkv6(*_torch(*args))
    yc, sc = ops.wkv6_chunked(*_jax(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sc), atol=ATOL, rtol=0)
    yp, sp = wkv6_pallas(*_jax(*args), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=ATOL, rtol=0)
    yr, _ = ref.wkv6_ref(*_jax(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=ATOL, rtol=0)


def test_plain_bf16_inputs_give_bf16_output():
    """bf16 r/k/v: computed in fp32 from the same rounded values as the
    reference, y rounded to bf16 by both -- so they agree to one bf16
    rounding step of |y| (eps 2^-8 relative)."""
    B, T, H, K = 2, 40, 2, 32
    r, k, v, wl, u, s0 = _inputs(11, B, T, H, K)
    tb = tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v))
    y, s = wkv6(*tb, *_torch(wl, u, s0))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    jb = tuple(jnp.asarray(x).astype(jnp.bfloat16) for x in (r, k, v))
    yc, sc = ops.wkv6_chunked(*jb, *_jax(wl, u, s0))
    want = np.asarray(yc.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want,
                               atol=2 ** -8 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sc), atol=SAME_ALGO_ATOL,
                               rtol=0)


def test_step_matches_reference_step_and_scan():
    B, H, K = 2, 2, 32
    r, k, v, wl, u, s0 = _inputs(3, B, 1, H, K)
    y, s = wkv6_step(*_torch(r[:, 0], k[:, 0], v[:, 0], wl[:, 0], u, s0))
    yj, sj = ops.wkv6_step(*_jax(r[:, 0], k[:, 0], v[:, 0], wl[:, 0], u, s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-5, rtol=0)
    yr, sr = wkv6_ref(*_torch(r, k, v, wl, u, s0))
    np.testing.assert_allclose(y.numpy(), yr[:, 0].numpy(), atol=1e-5, rtol=0)


def test_wrapper_leaves_inputs_untouched_and_checks_shapes():
    args = _torch(*_inputs(5, 1, 9, 2, 32))
    before = [a.clone() for a in args]
    y, s = wkv6(*args)
    assert y.shape == args[0].shape and s.shape == args[5].shape
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    r, k, v, wl, u, s0 = args
    with pytest.raises(ValueError):
        wkv6(r, k, v[:, :5], wl, u, s0)
    with pytest.raises(ValueError):
        wkv6(r, k, v, wl, u[:1], s0)
    with pytest.raises(ValueError):
        wkv6(r[:, :0], k[:, :0], v[:, :0], wl[:, :0], u, s0)


def test_wrapper_raises_off_the_cpu_never_falls_back():
    """Only a CPU tensor takes the plain version: any other device
    launches the kernel (CUDA) or raises -- here a meta tensor, which a
    fallback would have computed on quietly."""
    args = _torch(*_inputs(5, 1, 9, 2, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        wkv6(*(a.to("meta") for a in args))


def test_chunk_schedule_is_the_references():
    """chunk = min(32, T): a short segment is one chunk, and the result
    does not depend on how the caller would have padded it."""
    args = _torch(*_inputs(9, 1, 20, 1, 32))
    y, s = wkv6_chunked(*args)
    y1, s1 = wkv6_chunked(*args, chunk=20)
    assert torch.equal(y, y1) and torch.equal(s, s1)
