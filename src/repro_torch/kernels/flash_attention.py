"""Flash attention: causal, sliding-window or bidirectional GQA with
right-aligned queries.

``flash_attention`` replaces the TPU kernel ``repro/kernels/
flash_attention.py::flash_attention_pallas`` (body ``_flash_kernel``)
with a CUDA C++ kernel for Hopper, ``csrc/flash_attention.cu``.  Every
self-attention call of the lockstep slab engine goes through it: the
whole-prompt prefill (S == T) and each decode step (S = 1 against the
valid prefix of the slab cache, a strided view that is not copied).

Bound.  Memory, at the slab path's shapes: a call must read q, k and v
once and write the output once, ``(2 B S h + 2 B T hk) hd sizeof``
bytes, against 4 hd operations per visible (query row, key) pair.  At
qwen3-1.7b's prefill (B 8, S = T = 512, 16 q / 8 kv heads of 128,
bf16) that is 50.3 MB (15.0 us at 3.35 TB/s) against 8.6 GFLOP (8.7 us
on the bf16 tensor cores); a decode step at T = 576 reads 18.9 MB.

Design (bf16, the path serving runs).  The shared core of
``csrc/gqa_attention.cuh``, planned by ``kernels/gqa_split.py``.  A
slab prefill runs 512 blocks of one warpgroup and 128 query rows, both
products as warpgroup MMAs (``wgmma``) on 64-key K/V tiles staged by
``cp.async``.  A decode step runs one-warp blocks of 16 rows
(``mma.sync`` m16n8k16) and splits the keys over a thread-block cluster
of up to 8 blocks, which combine their partial softmax states in a
fixed order.  Scores and softmax in fp32; the probabilities pass to the
value product in registers, rounded to bf16.  Masks are applied only to
the diagonal and window-edge tiles.  Query rows are taken position-
major across the g = h / hk heads of a group, so the group shares
every K/V tile.

fp32 keeps the first version's FMA kernel (16 or 64 rows a block, fp32
tiles in shared memory), and never TF32: the card-vs-CPU greedy parity
of the fp32 serving runs rests on it.

The wrapper takes the plain version ONLY for CPU tensors.  A CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import gqa_split
from repro_torch.kernels.build import count_launch, load_library

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_bwd_ref",
           "KERNEL_HEAD_DIMS"]

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)   # head widths the kernel is built for
SMALL_ROWS = 64                # below this many rows a kv head: 16-row blocks
SMEM_LIMIT = 227 * 1024        # dynamic shared memory one Hopper block may use

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])
# bf16: (warps, splits) in place of rows_per_thread
_BF16_ARGTYPES = _ARGTYPES[:16] + [ctypes.c_int] * 2 + _ARGTYPES[17:]


def _lib():
    lib = load_library("flash_attention")
    if not getattr(lib, "_typed", False):
        for fn, types in ((lib.flash_attention_f32, _ARGTYPES),
                          (lib.flash_attention_bf16, _BF16_ARGTYPES)):
            fn.argtypes = types
            fn.restype = ctypes.c_int
        for fn in (lib.flash_attention_smem_bytes,
                   lib.flash_attention_bf16_smem_bytes):
            fn.argtypes = [ctypes.c_int] * 2
            fn.restype = ctypes.c_ulonglong
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _attend(q, k, v, q_pos0, causal, window):
    """Rows of q at positions q_pos0, q_pos0 + 1, ... against all T keys:
    kv heads repeated over their group, one masked fp32 softmax, the
    probabilities cast to v's dtype for the value product."""
    S, h, hd = q.shape[1:]
    T, hk = k.shape[1], k.shape[2]
    if h != hk:
        k = torch.repeat_interleave(k, h // hk, dim=2)
        v = torch.repeat_interleave(v, h // hk, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / np.sqrt(hd)
    qpos = torch.arange(S, device=q.device)[:, None] + q_pos0
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """The plain version, the reference's oracle ``kernels/ref.py::
    attention_ref``: kv heads repeated over their group, one masked fp32
    softmax over right-aligned queries (query i at position i + T - S),
    the probabilities cast to v's dtype for the value product.  A row
    with no visible key gets the uniform mean over all T keys, as
    there."""
    return _attend(q, k, v, k.shape[1] - q.shape[1], causal, window)


def flash_attention_bwd_ref(q, k, v, dout, *, causal=True, window=0,
                            chunk=1024):
    """(dq, dk, dv) of ``flash_attention_ref`` for the output gradient
    ``dout``, in q's, k's and v's dtypes.

    The reference trains by differentiating its ``chunked_attention``
    loop with each q-chunk checkpointed (``models/attention.py:106``),
    and this is that gradient: for each ``chunk`` rows of q it recomputes
    the chunk's masked fp32 softmax against all T keys (right-aligned, as
    ``flash_attention_ref``; the probabilities cast to v's dtype) and
    takes the chunk's dq and its share of dk and dv by
    ``torch.autograd.grad``; dk and dv are summed over the chunks in
    fp32.  A chunk's (B, h, chunk, T) fp32 scores are the largest
    temporary.  Plain PyTorch on any device: the backward of the
    kernel's ``autograd.Function``, which no TPU kernel had."""
    S, T = q.shape[1], k.shape[1]
    q, k, v, dout = (t.detach() for t in (q, k, v, dout))
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        kg, vg = k.requires_grad_(), v.requires_grad_()
        for c0 in range(0, S, chunk):
            qc = q[:, c0:c0 + chunk].requires_grad_()
            out = _attend(qc, kg, vg, c0 + T - S, causal, window)
            gq, gk, gv = torch.autograd.grad(out, (qc, kg, vg),
                                             dout[:, c0:c0 + chunk])
            dq[:, c0:c0 + chunk] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B,S,h,hd) and k, v (B,T,hk,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, S, h, hd = q.shape
    T, hk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v {tuple(v.shape)} must have k's shape "
                         f"{tuple(k.shape)} (the value width is q's)")
    if h % hk:
        raise ValueError(f"num_heads={h} is not a multiple of kv_heads={hk}")
    if S < 1 or T < 1:
        raise ValueError(f"flash_attention needs S >= 1 and T >= 1; got "
                         f"S={S}, T={T}")
    if causal and S > T:
        # right-aligned causal queries 0 .. S-T-1 would see no key; the
        # reference's two oracles disagree on such rows
        raise ValueError(f"causal flash_attention with S={S} > T={T}: the "
                         f"first {S - T} queries see no key")


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, S, h, hd); k, v: (B, T, hk, hd) with h % hk == 0 ->
    (B, S, h, hd) in q's dtype.  Query i sits at position i + T - S;
    key t is visible to it iff t <= i + T - S (when ``causal``) and
    t > i + T - S - window (when ``window`` > 0).  Scores and softmax in
    fp32, scale 1/sqrt(hd).

    CPU tensors take the plain version (its autograd is the gradient's
    oracle); CUDA tensors launch the kernel, which reads k and v through
    their batch and sequence strides (a slice of a larger cache is not
    copied).  When grad mode is on and an input requires grad, the
    launch goes through ``FlashAttention``, whose backward is
    ``flash_attention_bwd_ref``.  Raises on a causal call with S > T,
    whose first rows would see no key."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward with a gradient: the forward launches
    ``csrc/flash_attention.cu`` and saves q, k and v; the backward is the
    plain ``flash_attention_bwd_ref``, which recomputes each q-chunk's
    softmax (the gradient of the reference's checkpointed loop)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_ref(
            q, k, v, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def _launch(q, k, v, causal, window):
    """One launch of the kernel on CUDA tensors, checked."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all operands must share a device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: k and v must have q's dtype")
    B, S, h, hd = q.shape
    T, hk = k.shape[1], k.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not built "
                         f"(kernel head widths {KERNEL_HEAD_DIMS})")
    if not q.is_contiguous():
        raise ValueError("flash_attention: q must be contiguous")
    vec = 16 // q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError(f"flash_attention: {name} must have unit dim "
                             f"stride and head stride hd; got strides "
                             f"{t.stride()}")
        if t.stride(0) % vec or t.stride(1) % vec or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name}'s rows must be "
                             "16-byte aligned (vector loads)")
    if q.data_ptr() % 16:
        raise ValueError("flash_attention: q must be 16-byte aligned")
    lib = _lib()
    if q.dtype == torch.float32:
        fn = lib.flash_attention_f32
        layout = (4 if (h // hk) * S >= SMALL_ROWS else 1,)   # rows a thread
        smem = lib.flash_attention_smem_bytes(hd, *layout)
    else:
        fn = lib.flash_attention_bf16
        layout = gqa_split.plan(B * hk, (h // hk) * S, T)     # warps, splits
        smem = lib.flash_attention_bf16_smem_bytes(hd, layout[0])
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_attention: head_dim={hd} needs {smem} B of "
                         "shared memory")
    out = torch.empty_like(q)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, h, hk, hd, k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), int(bool(causal)), int(window), *layout, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    count_launch("flash_attention")
    return out
