"""RWKV-6 WKV recurrence: chunked form, CUDA kernel beside its plain version.

Replaces the TPU kernel ``repro/kernels/rwkv6_scan.py::wkv6_pallas``
(body ``_wkv6_kernel``) with a CUDA C++ kernel for Hopper,
``csrc/wkv6.cu``.  Every prefill chunk of two or more tokens of an
RWKV-6 stack goes through it, in every layer; a one-token step takes
``wkv6_step``, which the reference also leaves to plain array code.

    y_t[v]  = sum_k r_t[k] * (S_t[k, v] + u[k] * k_t[k] * v_t[v])
    S_{t+1} = diag(exp(w_log_t)) S_t + k_t v_t^T

Bound: memory.  A call reads r, k, v (compute dtype), w_log and the
state (fp32) once and writes y and the final state once -- about
1.84 MB for a 32-token prefill chunk at 32 heads of 64 in bf16.  The
K / 16 blocks of a head form a thread-block cluster, each owning 16
key channels and their state rows; the pairwise decay factors at a
16-row sub-chunk boundary, so the chunk's products run on the tensor
cores with split operands (bf16 hi + lo, or 3xTF32 for fp32); see the
source's note.

``wkv6`` takes the plain version ONLY for CPU tensors.  A CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import count_launch, load_library

__all__ = ["wkv6", "wkv6_chunked", "wkv6_ref", "wkv6_step"]

EXP_CLIP = -60.0
CHUNK = 32                 # time steps per chunk (the reference's default)
MAX_CHUNK = 32             # the kernel's chunk tile: two 16-row sub-chunks
HEAD_SIZES = tuple(range(16, 129, 16))   # K: clusters of 1 to 8 ranks of 16

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib():
    lib = load_library("wkv6")
    if not getattr(lib, "_typed", False):
        for fn in (lib.wkv6_f32, lib.wkv6_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def wkv6_ref(r, k, v, w_log, u, state):
    """Naive scan over time (the test oracle, ``repro.kernels.ref``).

    r, k, v, w_log: (B, T, H, K); u: (H, K); state: (B, H, K, V) with
    V == K.  Returns y (B, T, H, K) fp32 and the final state fp32."""
    r, k, v, w_log = (a.float() for a in (r, k, v, w_log))
    u = u.float()
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[..., :, None] * kv))
        S = torch.exp(w_log[:, t])[..., :, None] * S + kv
    return torch.stack(ys, dim=1), S


def _wkv6_chunk(S, r, k, v, wl, u):
    """One chunk.  S: (B, H, K, V) fp32; r, k, v, wl: (B, C, H, K) fp32."""
    L = torch.cumsum(wl, dim=1)                      # inclusive log-decay
    Lprev = L - wl                                   # exclusive
    y_state = torch.einsum("bchk,bhkv->bchv", r * torch.exp(Lprev), S)
    D = Lprev[:, :, None] - L[:, None]               # (B, C, C, H, K), t x j
    C = L.shape[1]
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    W = torch.exp(D.clamp(EXP_CLIP, 0.0)) * tri[None, :, :, None, None]
    scores = torch.einsum("bthk,bjhk,btjhk->bthj", r, k, W)
    y_intra = torch.einsum("bthj,bjhv->bthv", scores, v)
    coef = torch.einsum("bthk,hk,bthk->bth", r, u, k)
    y = y_state + y_intra + coef[..., None] * v
    Llast = L[:, -1:]
    k_sc = k * torch.exp(Llast - L)
    S_new = torch.exp(Llast[:, 0])[..., None] * S + torch.einsum(
        "bchk,bchv->bhkv", k_sc, v)
    return S_new, y


def wkv6_chunked(r, k, v, w_log, u, state, *, chunk=CHUNK):
    """The kernel's plain version (``repro.kernels.ops.wkv6_chunked``):
    chunks of ``min(chunk, T)`` steps, a ragged tail zero-padded, fp32
    inside; y is returned in r's dtype, the final state in fp32."""
    B, T, H, K = r.shape
    chunk = min(chunk, T)
    pad = (-T) % chunk
    args = [a.float() for a in (r, k, v, w_log)]
    if pad:
        args = [torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                for a in args]
    nc = args[0].shape[1] // chunk
    S = state.float()
    uf = u.float()
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        S, y = _wkv6_chunk(S, *(a[:, sl] for a in args), uf)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(r.dtype), S


def wkv6_step(r, k, v, w_log, u, state):
    """One decode step (``repro.kernels.ops.wkv6_step``), plain PyTorch
    as in the reference.  r, k, v, w_log: (B, H, K); state (B, H, K, V).
    Returns y (B, H, V) fp32 and the new state fp32."""
    r, k, v, wl = (a.float() for a in (r, k, v, w_log))
    state = state.float()
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r,
                     state + u.float()[..., :, None] * kv)
    new = torch.exp(wl)[..., :, None] * state + kv
    return y, new


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _check(r, k, v, w_log, u, state):
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, K); got {tuple(r.shape)}")
    B, T, H, K = r.shape
    if T < 1:
        raise ValueError("wkv6 needs at least one time step")
    for name, t in (("k", k), ("v", v), ("w_log", w_log)):
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, r has "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u must be (H, K)=({H}, {K}); got {tuple(u.shape)}")
    if tuple(state.shape) != (B, H, K, K):
        raise ValueError(f"state must be (B, H, K, K)=({B}, {H}, {K}, {K}); "
                         f"got {tuple(state.shape)}")


def wkv6(r, k, v, w_log, u, state, *, chunk=CHUNK):
    """Chunked RWKV-6 WKV over a segment.

    r, k, v: (B, T, H, K) in bf16 or fp32 (one dtype); w_log: (B, T, H,
    K) fp32 log-decays (<= 0); u: (H, K) fp32; state: (B, H, K, K) fp32.
    Returns y (B, T, H, K) in r's dtype and the final state (B, H, K, K)
    fp32; the inputs are not modified.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, whose chunk tile holds at
    most 32 steps: a longer ``chunk`` runs as chunks of 32, which the
    plain version's longer chunk matches but for its clip (at most
    e^-60 |r k| a term)."""
    _check(r, k, v, w_log, u, state)
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, w_log, u, state, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    tensors = (r, k, v, w_log, u, state)
    if any(t.device != r.device for t in tensors):
        raise ValueError("wkv6: all operands must share a device")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wkv6: dtype {r.dtype} not supported (float32 or "
                        "bfloat16)")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("wkv6: k and v must have r's dtype")
    if any(t.dtype != torch.float32 for t in (w_log, u, state)):
        raise TypeError("wkv6: w_log, u and state must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv6: operands must be contiguous")
    B, T, H, K = r.shape
    if K not in HEAD_SIZES or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"wkv6: head size must be a multiple of 16 up to "
                         f"{HEAD_SIZES[-1]} and operands 16-byte aligned "
                         "(vector loads)")
    if chunk < 1:
        raise ValueError(f"wkv6: chunk must be >= 1; got {chunk}")
    chunk = min(chunk, T, MAX_CHUNK)
    if B * H > 65535:
        raise ValueError(f"wkv6: B * H = {B * H} > 65535 (the grid's y)")
    lib = _lib()
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    fn = lib.wkv6_f32 if r.dtype == torch.float32 else lib.wkv6_bf16
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            B, T, H, K, chunk,
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("wkv6 launch failed: "
                           + lib.wkv6_error_string(rc).decode())
    count_launch("wkv6")
    return y, s_out
