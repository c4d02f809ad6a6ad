"""Paged flash-decode: fused page-table gather + online softmax, for
GQA and for DeepSeek's absorbed MLA.

``paged_flash_decode`` replaces the TPU kernel ``repro/kernels/
paged_decode.py::paged_flash_decode`` (body ``_gqa_kernel``) with a
CUDA C++ kernel for Hopper, ``csrc/paged_decode.cu``;
``paged_flash_decode_mla`` replaces ``paged_flash_decode_mla`` (body
``_mla_kernel``) with ``csrc/paged_decode_mla.cu``.  Every attention
call of the serving path goes through one of them: decode steps (S = 1)
and chunked-prefill chunks (S <= prefill_chunk).

Bound.  GQA: memory.  A call must read each visible K/V row once, about
``sum_b visible_tokens_b * hk * hd * 2 * sizeof(dtype)`` bytes, against
a few FLOPs per byte.  Absorbed MLA: operations.  All h query heads
read the same latent rows (r + rope values a token), and each (query
row, visible key) pair costs 2 (2 r + rope) FLOPs.  Both kernels walk
only the pages that can hold a visible key, never materialise the
slot-major gather that the plain versions build, and keep scores and
softmax state on chip.

MLA design, bf16 (the path serving runs): blocks of two warpgroups
own 64 position-major query rows of a slot and run both products on the
tensor cores (``wgmma``), the scores from a shared-memory q tile and a
ring of two 64-key latent + rope tiles, the value product on the latent
columns of the same staged tile; the keys split over a thread-block
cluster of up to 8 blocks, combined in split order
(``kernels/mla_split.py``).

GQA design, bf16 (the path serving runs): the shared core of
``csrc/gqa_attention.cuh``, as ``flash_attention``'s bf16 path uses it,
with the block's table row and query positions in shared memory and
each staged key row's page looked up once.  Decode steps and prefill
chunks, whose grids are small (8 slots x 8 kv heads), run one-warp
blocks of 16 rows (``mma.sync`` m16n8k16 on 32-key tiles staged by a
ring of ``cp.async`` copies) and split the keys over a thread-block
cluster of up to 8 blocks that combine their partial softmax states in
a fixed order (``kernels/gqa_split.py``); a call with rows enough to
fill the card takes the warpgroup (``wgmma``) blocks.  fp32 keeps the
first version's FMA kernels (GQA and MLA), never TF32: the card-vs-CPU
greedy parity of the fp32 serving runs rests on them.

The wrappers take the plain version ONLY for CPU tensors.  A CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import gqa_split, mla_split
from repro_torch.kernels.build import count_launch, load_library

__all__ = ["paged_flash_decode", "paged_flash_decode_ref",
           "paged_flash_decode_mla", "paged_flash_decode_mla_ref",
           "visible_tokens"]

ROWS_PER_BLOCK = 16        # fp32: query rows (of the g*S group rows) per block
KEYS_PER_TILE = 64         # fp32: target keys staged per shared-memory tile
BF16_HEAD_DIMS = (32, 64, 128)   # head widths the bf16 kernel is built for
SMEM_LIMIT = 227 * 1024    # dynamic shared memory one Hopper block may use

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])
# the bf16 entry takes (warps, splits) where fp32 takes (rows_per_block,
# pages_per_tile): the same types


def _lib():
    lib = load_library("paged_decode")
    if not getattr(lib, "_typed", False):
        for fn in (lib.paged_flash_decode_f32, lib.paged_flash_decode_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        for fn in (lib.paged_flash_decode_smem_bytes,
                   lib.paged_flash_decode_bf16_smem_bytes):
            fn.argtypes = [ctypes.c_int] * 3
            fn.restype = ctypes.c_ulonglong
        lib.paged_flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.paged_flash_decode_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


_MLA_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_void_p])
# the bf16 entry also takes the split count, after the window
_MLA_BF16_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                      + [ctypes.c_float, ctypes.c_void_p])
MLA_MAX_R, MLA_MAX_ROPE = 512, 64   # widths the MLA kernels are built for


def _mla_lib():
    lib = load_library("paged_decode_mla")
    if not getattr(lib, "_typed", False):
        lib.paged_flash_decode_mla_f32.argtypes = _MLA_ARGTYPES
        lib.paged_flash_decode_mla_bf16.argtypes = _MLA_BF16_ARGTYPES
        for fn in (lib.paged_flash_decode_mla_f32,
                   lib.paged_flash_decode_mla_bf16):
            fn.restype = ctypes.c_int
        lib.paged_flash_decode_mla_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.paged_flash_decode_mla_smem_bytes.restype = ctypes.c_ulonglong
        lib.paged_flash_decode_mla_error_string.argtypes = [ctypes.c_int]
        lib.paged_flash_decode_mla_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def paged_flash_decode_ref(q, k_pool, v_pool, page_table, q_positions, *,
                           page_size, window=0):
    """The plain version: gather the slot-major view, then attend."""
    from repro_torch.models.attention import (PagedView, masked_attention,
                                              paged_read)
    view = PagedView(page_table, page_size)
    k_full, kv_positions = paged_read(k_pool, view)
    v_full, _ = paged_read(v_pool, view)
    return masked_attention(q, k_full, v_full, q_positions=q_positions,
                            kv_positions=kv_positions, window=window)


def _check(q, k_pool, v_pool, page_table, q_positions, page_size):
    if q.dim() != 4 or k_pool.dim() != 3:
        raise ValueError(f"q must be (B,S,h,hd) and pools (N,hk,hd); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}")
    B, S, h, hd = q.shape
    N, hk, hd_k = k_pool.shape
    if hd_k != hd or v_pool.shape != k_pool.shape:
        raise ValueError("k_pool, v_pool and q disagree on (hk, hd)")
    if h % hk:
        raise ValueError(f"num_heads={h} is not a multiple of kv_heads={hk}")
    if N % page_size:
        raise ValueError(f"pool rows {N} not a multiple of page_size")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be (B, W); got "
                         f"{tuple(page_table.shape)}")
    if tuple(q_positions.shape) != (B, S):
        raise ValueError(f"q_positions must be (B, S)=({B}, {S}); got "
                         f"{tuple(q_positions.shape)}")


def paged_flash_decode(q, k_pool, v_pool, page_table, q_positions, *,
                       page_size, window=0):
    """Fused paged gather + flash attention for GQA decode.

    q: (B, S, h, hd); k_pool, v_pool: (N, hk, hd) token-major pools;
    page_table: (B, W) int32 (0 = trash page); q_positions: (B, S)
    int32.  Returns (B, S, h, hd) in q's dtype.  CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    _check(q, k_pool, v_pool, page_table, q_positions, page_size)
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k_pool, v_pool, page_table,
                                      q_positions, page_size=page_size,
                                      window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    tensors = (q, k_pool, v_pool, page_table, q_positions)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_flash_decode: all operands must share a device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_flash_decode: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_flash_decode: pools must have q's dtype")
    if page_table.dtype != torch.int32 or q_positions.dtype != torch.int32:
        raise TypeError("paged_flash_decode: page_table and q_positions must "
                        "be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode: operands must be contiguous")
    B, S, h, hd = q.shape
    hk = k_pool.shape[1]
    if hd % 8 or any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_flash_decode: head_dim must be a multiple of "
                         "8 and q/pools 16-byte aligned (vector loads)")
    W = page_table.shape[1]
    lib = _lib()
    if q.dtype == torch.float32:
        fn = lib.paged_flash_decode_f32
        pages_per_tile = max(1, KEYS_PER_TILE // page_size)
        layout = (min(ROWS_PER_BLOCK, (h // hk) * S), pages_per_tile)
        smem = lib.paged_flash_decode_smem_bytes(
            layout[0], pages_per_tile * page_size, hd)
    else:
        if hd not in BF16_HEAD_DIMS:
            raise ValueError(f"paged_flash_decode: head_dim {hd} not built "
                             f"for bf16 (head widths {BF16_HEAD_DIMS})")
        fn = lib.paged_flash_decode_bf16
        layout = gqa_split.plan(B * hk, (h // hk) * S, W * page_size)
        smem = lib.paged_flash_decode_bf16_smem_bytes(hd, layout[0], W)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_flash_decode: page_size={page_size}, "
                         f"head_dim={hd}, table width {W} need {smem} B of "
                         "shared memory")
    out = torch.empty_like(q)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
            B, S, h, hk, hd, W, page_size, int(window), *layout, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("paged_flash_decode launch failed: "
                           + lib.paged_flash_decode_error_string(rc).decode())
    count_launch("paged_flash_decode")
    return out


def paged_flash_decode_mla_ref(q_lat, q_rope, ckv_pool, krope_pool,
                               page_table, q_positions, *, page_size, scale,
                               window=0):
    """The plain version, the reference's XLA formula (``apply_mla``'s
    paged branch): gather the slot-major latent and rope keys, fp32
    scores, mask, softmax, probabilities cast to q_lat's dtype, value
    product on the latent."""
    from repro_torch.models.attention import NEG_INF, PagedView, paged_read
    view = PagedView(page_table, page_size)
    dt = q_lat.dtype
    ckv_c, kv_positions = paged_read(ckv_pool, view)
    krope_c, _ = paged_read(krope_pool, view)
    ckv_c, krope_c = ckv_c.to(dt), krope_c.to(dt)
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv_c.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             krope_c.float()))
    scores = scores * scale
    mask = kv_positions[None, None, :] <= q_positions[:, :, None]
    if window:
        mask &= kv_positions[None, None, :] > q_positions[:, :, None] - window
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,btr->bshr", probs.to(dt), ckv_c)


def _check_mla(q_lat, q_rope, ckv_pool, krope_pool, page_table, q_positions,
               page_size):
    if q_lat.dim() != 4 or q_rope.dim() != 4 or ckv_pool.dim() != 2 \
            or krope_pool.dim() != 2:
        raise ValueError(f"q_lat, q_rope must be (B,S,h,r), (B,S,h,rope) and "
                         f"the pools (N,r), (N,rope); got "
                         f"{tuple(q_lat.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(ckv_pool.shape)}, {tuple(krope_pool.shape)}")
    B, S, h, r = q_lat.shape
    rope = q_rope.shape[-1]
    N = ckv_pool.shape[0]
    if tuple(q_rope.shape[:3]) != (B, S, h):
        raise ValueError("q_lat and q_rope disagree on (B, S, h)")
    if ckv_pool.shape[1] != r:
        raise ValueError(f"ckv_pool width {ckv_pool.shape[1]} != latent {r}")
    if tuple(krope_pool.shape) != (N, rope):
        raise ValueError(f"krope_pool must be ({N}, {rope}); got "
                         f"{tuple(krope_pool.shape)}")
    if N % page_size:
        raise ValueError(f"pool rows {N} not a multiple of page_size")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be (B, W); got "
                         f"{tuple(page_table.shape)}")
    if tuple(q_positions.shape) != (B, S):
        raise ValueError(f"q_positions must be (B, S)=({B}, {S}); got "
                         f"{tuple(q_positions.shape)}")


def paged_flash_decode_mla(q_lat, q_rope, ckv_pool, krope_pool, page_table,
                           q_positions, *, page_size, scale, window=0):
    """Absorbed-MLA paged decode: attend in the latent space against the
    compressed pool (one kv "head" shared by all h query heads; V is the
    latent itself).

    q_lat: (B, S, h, r), q_nope projected through w_uk; q_rope: (B, S,
    h, rope); ckv_pool: (N, r); krope_pool: (N, rope); page_table: (B,
    W) int32 (0 = trash page); q_positions: (B, S) int32; scale: the
    caller's, 1/sqrt(nope + rope).  Returns the latent output (B, S, h,
    r) in q_lat's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    _check_mla(q_lat, q_rope, ckv_pool, krope_pool, page_table, q_positions,
               page_size)
    if q_lat.device.type == "cpu":
        return paged_flash_decode_mla_ref(
            q_lat, q_rope, ckv_pool, krope_pool, page_table, q_positions,
            page_size=page_size, scale=scale, window=window)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_mla: unsupported device "
                         f"{q_lat.device}")
    tensors = (q_lat, q_rope, ckv_pool, krope_pool, page_table, q_positions)
    if any(t.device != q_lat.device for t in tensors):
        raise ValueError("paged_flash_decode_mla: all operands must share a "
                         "device")
    if q_lat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_flash_decode_mla: dtype {q_lat.dtype} not "
                        "supported (float32 or bfloat16)")
    if any(t.dtype != q_lat.dtype for t in tensors[1:4]):
        raise TypeError("paged_flash_decode_mla: q_rope and the pools must "
                        "have q_lat's dtype")
    if page_table.dtype != torch.int32 or q_positions.dtype != torch.int32:
        raise TypeError("paged_flash_decode_mla: page_table and q_positions "
                        "must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode_mla: operands must be contiguous")
    B, S, h, r = q_lat.shape
    rope = q_rope.shape[-1]
    if (r % 8 or r > MLA_MAX_R or rope % 8 or rope > MLA_MAX_ROPE
            or any(t.data_ptr() % 16 for t in tensors[:4])):
        raise ValueError(f"paged_flash_decode_mla: latent width {r} and rope "
                         f"width {rope} must be multiples of 8, at most "
                         f"{MLA_MAX_R} and {MLA_MAX_ROPE}, and q/pools "
                         "16-byte aligned (vector loads)")
    lib = _mla_lib()
    smem = lib.paged_flash_decode_mla_smem_bytes(r, rope,
                                                 q_lat.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_flash_decode_mla: r={r}, rope={rope} need "
                         f"{smem} B of shared memory")
    out = torch.empty_like(q_lat)
    W = page_table.shape[1]
    if q_lat.dtype == torch.float32:
        fn, layout = lib.paged_flash_decode_mla_f32, ()
    else:
        fn = lib.paged_flash_decode_mla_bf16
        layout = mla_split.plan(B, h * S, W * page_size)[1:]     # splits
    rc = fn(*(t.data_ptr() for t in tensors), out.data_ptr(),
            B, S, h, r, rope, W, page_size, int(window), *layout,
            float(scale), torch.cuda.current_stream(q_lat.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "paged_flash_decode_mla launch failed: "
            + lib.paged_flash_decode_mla_error_string(rc).decode())
    count_launch("paged_flash_decode_mla")
    return out


def visible_tokens(q_positions, page_table_width, page_size, window=0):
    """Keys each slot must read (host numpy): the union over the slot's
    queries of the visible positions -- what the bound counts."""
    pos = np.asarray(q_positions)
    T = page_table_width * page_size
    total = 0
    for row in pos:
        hi = min(int(row.max()), T - 1)
        lo = 0 if not window else max(0, int(row.min()) - window + 1)
        total += max(0, hi - lo + 1)
    return total
