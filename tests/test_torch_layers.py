"""The port's building blocks against the reference, op by op, in fp32.
Inputs are numpy arrays from a seed handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(2)

# fp32 parity bar per op.  Small widths keep matmul sums short enough
# that reordering them stays inside it.
ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rmsnorm(eps):
    r = _rng(1)
    x = r.standard_normal((2, 3, 64)).astype(np.float32) * 3
    scale = r.standard_normal(64).astype(np.float32)
    _close(tl.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), eps),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), eps))


def test_rmsnorm_casts_back_to_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    assert tl.rmsnorm(torch.ones(8), x).dtype == torch.bfloat16


@pytest.mark.parametrize("gated", [True, False])
def test_apply_mlp(gated):
    r = _rng(2)
    d, ff = 32, 64
    p = {k: (r.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_up", (d, ff)), ("w_gate", (d, ff)),
                      ("w_down", (ff, d)))}
    x = r.standard_normal((2, 5, d)).astype(np.float32)
    got = tl.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), gated=gated)
    want = jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), gated=gated)
    _close(got, want)


def test_embed_and_fp32_unembed():
    r = _rng(3)
    table = (r.standard_normal((50, 16)) * 0.02).astype(np.float32)
    tokens = r.integers(0, 50, (2, 7))
    _close(tl.apply_embed(torch.from_numpy(table), torch.from_numpy(tokens),
                          torch.float32),
           jl.apply_embed({"table": jnp.asarray(table)}, jnp.asarray(tokens),
                          jnp.float32))
    x = r.standard_normal((2, 7, 16)).astype(np.float32)
    _close(tl.apply_unembed(torch.from_numpy(table), torch.from_numpy(x)),
           jnp.einsum("bsd,vd->bsv", jnp.asarray(x), jnp.asarray(table)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_per_slot_positions(theta):
    """Split-half RoPE with (B, S) per-slot positions, as the paged
    decode path calls it (slots at different depths)."""
    r = _rng(4)
    hd = 64
    x = r.standard_normal((3, 4, 2, hd)).astype(np.float32)
    pos = r.integers(0, 4000, (3, 4)).astype(np.int32)
    freqs = torch.from_numpy(tl.rope_freqs(hd, theta))
    np.testing.assert_array_equal(tl.rope_freqs(hd, theta),
                                  jl.rope_freqs(hd, theta))
    angles = tl.rope_angles(torch.from_numpy(pos), freqs)
    _close(tl.apply_rope(torch.from_numpy(x), angles),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_init_helpers_truncated_normal_and_std():
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init(256, 512, generator=g)
    std = 1.0 / np.sqrt(256)
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    assert w.abs().max() <= 3 * std + 1e-7
    # a normal truncated at 3 sigma keeps 98.7% of the variance
    assert abs(w.std().item() / std - 0.987) < 0.02
    e = tl.truncated_normal((1000, 64), 0.02, generator=g)
    assert e.abs().max() <= 0.06 + 1e-7
    assert torch.equal(tl.dense_init(8, 8, generator=torch.Generator()
                                     .manual_seed(3)),
                       tl.dense_init(8, 8, generator=torch.Generator()
                                     .manual_seed(3)))
