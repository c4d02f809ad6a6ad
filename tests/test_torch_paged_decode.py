"""The port's paged attention against the reference: the plain
``paged_flash_decode`` (what the CPU runs, and what the CUDA kernel is
held to on the card) against the reference's Pallas kernel (interpret
mode) and its ``paged_read`` + ``masked_attention`` oracle, plus the
pool addressing the kernel relies on."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_paged_cases import GQA_CASES, POISON, paged_case

from repro.kernels.paged_decode import paged_flash_decode as jax_kernel
from repro.models import attention as ja
from repro_torch.kernels import (launch_counts, paged_flash_decode,
                                 paged_flash_decode_ref, reset_launch_counts)
from repro_torch.kernels.paged_decode import visible_tokens
from repro_torch.models import attention as ta

torch.set_num_threads(2)

TOL = 2e-5      # the reference's own kernel-vs-oracle bar


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("case", GQA_CASES)
def test_plain_paged_decode_matches_reference(case):
    B, S, h, hk, hd, ps, W, window = case
    q, k, v, table, pos = paged_case(sum(case), B, S, h, hk, hd, ps, W)
    got = paged_flash_decode(*_t(q, k, v, table, pos), page_size=ps,
                             window=window).numpy()
    jq, jk, jv, jt, jp = _j(q, k, v, table, pos)
    kernel = jax_kernel(jq, jk, jv, jt, jp, page_size=ps, window=window)
    view = ja.PagedView(jt, ps)
    k_full, kv_pos = ja.paged_read(jk, view)
    v_full, _ = ja.paged_read(jv, view)
    oracle = ja.masked_attention(jq, k_full, v_full, q_positions=jp,
                                 kv_positions=kv_pos, window=window)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL, rtol=TOL)


def test_trash_poison_never_leaks():
    """Trash page, unreferenced pages and unwritten page tails flooded
    with 1e8 give the bitwise same output as zero-filled storage."""
    q, k, v, table, pos = paged_case(7, 2, 3, 4, 2, 32, 8, 4)
    outs = []
    for fill in (0.0, 1e8):
        kk, vv = (np.where(x == POISON, fill, x).astype(np.float32)
                  for x in (k, v))
        outs.append(paged_flash_decode(*_t(q, kk, vv, table, pos),
                                       page_size=8))
    assert torch.equal(outs[0], outs[1])
    want = jax_kernel(*_j(q, k, v, table, pos), page_size=8)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_cpu_wrapper_takes_plain_path_without_counting():
    q, k, v, table, pos = _t(*paged_case(3, 2, 1, 4, 2, 64, 16, 4))
    reset_launch_counts()
    a = paged_flash_decode(q, k, v, table, pos, page_size=16)
    b = paged_flash_decode_ref(q, k, v, table, pos, page_size=16)
    assert torch.equal(a, b)
    assert launch_counts().get("paged_flash_decode", 0) == 0
    with pytest.raises(ValueError):
        paged_flash_decode(q, k, v, table, pos[:, :0], page_size=16)
    with pytest.raises(ValueError):
        paged_flash_decode(q, k[..., :32], v[..., :32], table, pos,
                           page_size=16)


def test_visible_tokens_counts_the_union_of_query_windows():
    pos = np.array([[5, 6, 7], [29, 30, 31]])
    assert visible_tokens(pos, 4, 8) == 8 + 32
    assert visible_tokens(pos, 4, 8, window=4) == (7 - 2 + 1) + (31 - 26 + 1)


# --------------------------------------------------------------------------
# pool addressing
# --------------------------------------------------------------------------

def test_paged_write_indices_match_reference():
    table = np.array([[3, 1, 0], [2, 0, 0]], np.int32)
    pos = np.array([[0, 5, 9, 11, 12, -1], [4, 8, 30, 7, 0, 100]], np.int32)
    got = ta.paged_write_indices(ta.PagedView(*_t(table), 4), *_t(pos))
    want = ja.paged_write_indices(ja.PagedView(*_j(table), 4), *_j(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_read_matches_reference():
    ps = 4
    pool = np.arange(5 * ps * 6, dtype=np.float32).reshape(5 * ps, 2, 3)
    table = np.array([[2, 1, 0], [4, 0, 0]], np.int32)
    got, kv_pos = ta.paged_read(*_t(pool), ta.PagedView(*_t(table), ps))
    want, jpos = ja.paged_read(*_j(pool), ja.PagedView(*_j(table), ps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(kv_pos.numpy(), np.asarray(jpos))


def test_paged_append_matches_reference_and_sinks_to_trash():
    ps = 4
    pool = np.arange(4 * ps * 2, dtype=np.float32).reshape(4 * ps, 2)
    table = np.array([[2, 3], [0, 0]], np.int32)      # slot 1 is idle
    pos = np.array([[3, 4], [5, 6]], np.int32)
    new = np.full((2, 2, 2), -5.0, np.float32)
    new[0] = [[-1, -2], [-3, -4]]
    tpool = torch.from_numpy(pool.copy())
    idx = ta.paged_write_indices(ta.PagedView(*_t(table), ps), *_t(pos))
    out = ta._paged_append(tpool, idx, *_t(new))
    assert out.data_ptr() == tpool.data_ptr()              # in place
    want = ja._paged_append(*_j(pool), ja.PagedView(*_j(table), ps),
                            *_j(pos, new))
    np.testing.assert_array_equal(out[ps:].numpy(), np.asarray(want)[ps:])
    np.testing.assert_array_equal(out[ps:2 * ps].numpy(), pool[ps:2 * ps])
