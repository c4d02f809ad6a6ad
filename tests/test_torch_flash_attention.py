"""The port's flash attention and ``chunked_attention`` against the
reference: the plain version (taken for CPU tensors) against the
reference's oracle ``attention_ref`` and its Pallas kernel in interpret
mode over the reference's own ``FLASH_CASES``; the port's
``chunked_attention`` against the reference's; and the reduction the
card's branch of ``chunked_attention`` makes (the keys sliced to the
valid length, queries right-aligned) checked on the plain versions.
Inputs are drawn with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_kernels import FLASH_CASES

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels import flash_attention, flash_attention_ref
from repro_torch.models import attention as attn

torch.set_num_threads(2)

# the reference's own bars: 2e-5 for attention kernels against the
# oracle in fp32; tests/test_kernels.py's ``tol`` against its Pallas
# kernel (2e-4 fp32, 2e-2 bf16)
ORACLE_TOL = 2e-5
PALLAS_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, S, T, h, hk, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, h, hd)).astype(np.float32),
            rng.standard_normal((B, T, hk, hd)).astype(np.float32),
            rng.standard_normal((B, T, hk, hd)).astype(np.float32))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_matches_attention_ref(case):
    B, S, T, h, hk, hd, causal, window = case
    q, k, v = _qkv(sum(case), B, S, T, h, hk, hd)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal, window=window)
    want = jax_ref.attention_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                 causal=causal, window=window)
    assert got.shape == (B, S, h, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_matches_pallas_kernel(case, dtype):
    """Against the TPU kernel itself, run in interpret mode with the
    reference test's blocks (32 queries, 64 keys)."""
    B, S, T, h, hk, hd, causal, window = case
    q, k, v = _qkv(sum(case) + 1, B, S, T, h, hk, hd)
    got = flash_attention(*(torch.from_numpy(x).to(TORCH[dtype])
                            for x in (q, k, v)), causal=causal, window=window)
    want = flash_attention_pallas(*(jnp.asarray(x, JNP[dtype])
                                    for x in (q, k, v)), causal=causal,
                                  window=window, block_q=32, block_kv=64)
    assert got.dtype == TORCH[dtype]
    tol = PALLAS_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_causal_call_with_more_queries_than_keys_raises():
    """Right-aligned causal queries 0 .. S-T-1 see no key: the reference's
    oracle averages all T keys there, its Pallas kernel the keys of the
    blocks it visited.  The wrapper refuses such calls; bidirectional
    ones are fine."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 5, 3, 2, 1, 64))
    with pytest.raises(ValueError, match="see no key"):
        flash_attention(q, k, v, causal=True)
    out = flash_attention(q, k, v, causal=False)
    want = jax_ref.attention_ref(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                 causal=False)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=ORACLE_TOL)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k, v[:, :2], causal=False)


CHUNKED_CASES = [
    # name, S, T, chunk, q offset, kv_valid_len, causal, window
    ("query padding", 37, 37, 16, 0, None, True, 0),
    ("valid length below T", 5, 48, 1024, 25, 30, True, 0),
    ("decode step", 1, 48, 1024, 29, 30, True, 0),
    ("window", 40, 40, 16, 0, None, True, 12),
    ("bidirectional", 20, 20, 8, 0, None, False, 0),
]


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=lambda c: c[0])
def test_chunked_attention_matches_reference(case):
    _, S, T, chunk, off, valid, causal, window = case
    B, h, hk, hd = 2, 4, 2, 32
    q, k, v = _qkv(S + T, B, S, T, h, hk, hd)
    qpos = np.arange(off, off + S)
    kw = dict(causal=causal, window=window, kv_valid_len=valid, chunk=chunk)
    got = attn.chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 q_positions=torch.from_numpy(qpos),
                                 kv_positions=torch.arange(T), **kw)
    want = jax_chunked(*(jnp.asarray(x) for x in (q, k, v)),
                       q_positions=jnp.asarray(qpos),
                       kv_positions=jnp.arange(T), **kw)
    assert got.shape == (B, S, h, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)
    again = attn.chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                   q_positions=range(off, off + S),
                                   kv_positions=range(T), **kw)
    torch.testing.assert_close(again, got, atol=0, rtol=0)


SLAB_FORMS = [
    # name, S, T (cache length), valid, window, dtype
    ("prefill S == T", 24, 24, 24, 0, "float32"),
    ("decode step", 1, 40, 17, 0, "float32"),
    ("prefill chunk at an offset", 6, 40, 30, 0, "float32"),
    ("windowed decode", 1, 40, 33, 8, "float32"),
    ("decode step bf16", 1, 40, 17, 0, "bfloat16"),
]


@pytest.mark.parametrize("form", SLAB_FORMS, ids=lambda f: f[0])
def test_card_branch_reduction_on_plain_versions(form):
    """The card's branch of chunked_attention (``_flash_slab``: the keys
    sliced to the valid length as a strided view, then flash_attention
    with right-aligned queries) equals the CPU loop over all T keys with
    the validity mask -- run here on CPU tensors, where flash_attention
    is its plain version."""
    _, S, T, valid, window, dtype = form
    q, k, v = (torch.from_numpy(x).to(TORCH[dtype])
               for x in _qkv(T + valid, 2, S, T, 4, 2, 64))
    kw = dict(q_positions=range(valid - S, valid), kv_positions=range(T),
              window=window, kv_valid_len=None if valid == T else valid)
    loop = attn.chunked_attention(q, k, v, **kw)
    card = attn._flash_slab(q, k, v, causal=True, **kw)
    direct = flash_attention(q, k[:, :valid], v[:, :valid], window=window)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    torch.testing.assert_close(card, direct, atol=0, rtol=0)
    torch.testing.assert_close(card.float(), loop.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("kw", [
    dict(q_positions=range(0, 4), kv_positions=range(10), kv_valid_len=6),
    dict(q_positions=range(2, 6), kv_positions=range(1, 11)),
    dict(q_positions=np.array([0, 2, 4, 6]), kv_positions=range(10),
         kv_valid_len=7),
    dict(q_positions=range(2, 6), kv_positions=range(10), kv_valid_len=11),
], ids=["not right-aligned", "keys not from 0", "queries not consecutive",
        "valid beyond T"])
def test_card_branch_refuses_other_position_forms(kw):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 4, 10, 2, 2, 64))
    with pytest.raises(ValueError, match="slab form"):
        attn._flash_slab(q, k, v, causal=True, window=0,
                         **{"kv_valid_len": None, **kw})


def test_plain_version_casts_probabilities_to_v_dtype():
    """As attention_ref: fp32 scores and softmax, the probabilities
    rounded to bf16 before the value product."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(3, 1, 8, 8, 2, 2, 64))
    got = flash_attention_ref(q, k, v)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / 8.0
    s = torch.where(torch.ones(8, 8, dtype=torch.bool).tril(), s, -1e30)
    p = torch.softmax(s, -1).bfloat16()
    want = torch.einsum("bhst,bthd->bshd", p, v)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# MLA's widths, cut down: q and k of nope + rope, v narrower (the
# reference's chunked_attention scales by q's width and returns v's)
WIDTH_CASES = [
    # B, S, T, h, hk, dqk, dv, causal, window
    (2, 24, 24, 4, 4, 48, 32, True, 0),
    (1, 9, 30, 4, 2, 48, 32, True, 0),      # right-aligned, GQA
    (1, 20, 20, 2, 2, 24, 16, True, 7),     # windowed
]


def _qkv_widths(seed, B, S, T, h, hk, dqk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, h, dqk)).astype(np.float32),
            rng.standard_normal((B, T, hk, dqk)).astype(np.float32),
            rng.standard_normal((B, T, hk, dv)).astype(np.float32))


@pytest.mark.parametrize("case", WIDTH_CASES)
def test_plain_value_width_matches_reference_chunked(case):
    """flash_attention_ref and its backward at a v width other than q's,
    against the reference's chunked_attention (the train and prefill
    branch MLA runs) and its jax.grad."""
    import jax
    B, S, T, h, hk, dqk, dv, causal, window = case
    q, k, v = _qkv_widths(sum(case), B, S, T, h, hk, dqk, dv)
    dout = np.random.default_rng(1).standard_normal(
        (B, S, h, dv)).astype(np.float32)

    def jfwd(q, k, v):
        return jax_chunked(q, k, v, q_positions=jnp.arange(S) + (T - S),
                           kv_positions=jnp.arange(T), causal=causal,
                           window=window, chunk=8)

    want = jfwd(*map(jnp.asarray, (q, k, v)))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window)
    assert got.shape == (B, S, h, dv)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)
    jgrads = jax.grad(lambda *a: jnp.sum(jfwd(*a) * dout), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    grads = flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v)),
                                    torch.from_numpy(dout), causal=causal,
                                    window=window, chunk=8)
    for name, g, w in zip("qkv", grads, jgrads):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


def test_value_width_shapes_are_checked():
    """v may be narrower than q and k (MLA); it must share k's batch,
    length and heads.  The kernel is built for the widths of
    KERNEL_WIDTHS only."""
    from repro_torch.kernels.flash_attention import KERNEL_WIDTHS
    assert KERNEL_WIDTHS == ((64, 64), (128, 128), (192, 128))
    q, k, v = map(torch.from_numpy, _qkv_widths(0, 1, 4, 6, 2, 2, 48, 32))
    assert flash_attention(q, k, v).shape == (1, 4, 2, 32)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k, v[:, :5])
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k, v[:, :, :1])
