"""RWKV-6 WKV recurrence: chunked form, CUDA kernel beside its plain version.

Replaces the TPU kernel ``repro/kernels/rwkv6_scan.py::wkv6_pallas``
(body ``_wkv6_kernel``) with a CUDA C++ kernel for Hopper,
``csrc/wkv6.cu``.  Every prefill chunk of two or more tokens of an
RWKV-6 stack goes through it, in every layer, and so does every slab
prefill and every training forward; a one-token decode step takes
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

Gradient.  The TPU kernel has none: the reference trains through its
chunked XLA form with each chunk under ``jax.checkpoint``.  ``WKV6``
is the kernel's ``autograd.Function``: its forward is the kernel, its
backward ``wkv6_chunked_bwd``, plain PyTorch that recomputes the chunks
(the gradient of that checkpointed scan).

``wkv6`` takes the plain version ONLY for CPU tensors.  A CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import count_launch, load_library
from repro_torch.roofline.cost import add_kernel_cost

__all__ = ["wkv6", "wkv6_chunked", "wkv6_chunked_bwd", "wkv6_ref",
           "wkv6_step", "WKV6"]

EXP_CLIP = -60.0
CHUNK = 32                 # time steps per chunk (the reference's default)
BWD_GROUP = 16             # chunks whose gradients one autograd call takes
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


def padded_chunks(chunk, *tensors):
    """(B, T, ...) tensors -> fp32 (B, nc, chunk, ...), the ragged tail
    zero-padded (a zero step: no input, and decay 1 for a zero log-decay
    or a zero dt)."""
    T = tensors[0].shape[1]
    pad = (-T) % chunk
    out = []
    for a in tensors:
        a = a.float()
        if pad:
            a = torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        out.append(a.unflatten(1, (-1, chunk)))
    return out


def wkv6_chunked(r, k, v, w_log, u, state, *, chunk=CHUNK):
    """The kernel's plain version (``repro.kernels.ops.wkv6_chunked``):
    chunks of ``min(chunk, T)`` steps, a ragged tail zero-padded, fp32
    inside; y is returned in r's dtype, the final state in fp32."""
    T = r.shape[1]
    args = padded_chunks(min(chunk, T), r, k, v, w_log)
    S = state.float()
    uf = u.float()
    ys = []
    for c in range(args[0].shape[1]):
        S, y = _wkv6_chunk(S, *(a[:, c] for a in args), uf)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(r.dtype), S


def wkv6_chunked_bwd(r, k, v, w_log, u, state, dy, dstate, *, chunk=CHUNK):
    """Gradients (dr, dk, dv, dw_log, du, dstate0) of ``wkv6_chunked``'s
    (y, final state) for the cotangents ``dy`` (B, T, H, K) and
    ``dstate`` (B, H, K, K, or None for zero), in the inputs' dtypes.

    The gradient of the reference's scan with each chunk checkpointed:
    the chunk-boundary states are recomputed (fp32, in order); the
    state's gradient is carried back across the chunks in reverse
    (``dS_c = exp(L_last) dS_{c+1} + (r e^{L_prev})^T dy_c``, exactly the
    two ways a chunk reads its incoming state); then each chunk's
    gradients are taken by ``torch.autograd.grad`` through
    ``_wkv6_chunk`` given its incoming state and the cotangents of its
    y and outgoing state -- ``BWD_GROUP`` chunks in one call, folded
    into the batch, so the host issues a few dozen calls a layer rather
    than a few thousand.  Plain PyTorch on any device: ``WKV6``'s
    backward, which no TPU kernel had."""
    B, T, H, K = r.shape
    chunk = min(chunk, T)
    rc, kc, vc, wc, dyc = padded_chunks(chunk, r, k, v, w_log, dy)
    nc = rc.shape[1]
    uf = u.detach().float()
    with torch.no_grad():
        L = torch.cumsum(wc, dim=2)                     # (B, nc, C, H, K)
        Llast = L[:, :, -1]                             # (B, nc, H, K)
        # incoming state of every chunk, in order
        k_sc = kc * torch.exp(Llast[:, :, None] - L)
        kv = torch.einsum("bnchk,bnchv->bnhkv", k_sc, vc)
        decay = torch.exp(Llast)[..., None]             # (B, nc, H, K, 1)
        states = [state.detach().float()]
        for c in range(nc - 1):
            states.append(decay[:, c] * states[-1] + kv[:, c])
        del k_sc, kv
        # the state's gradient, carried back: dS_in[c] reaches chunk c
        g = torch.einsum("bnchk,bnchv->bnhkv", rc * torch.exp(L - wc), dyc)
        d_out = [None] * nc                             # cotangent of S_new
        d_out[nc - 1] = (torch.zeros_like(states[0]) if dstate is None
                         else dstate.float())
        for c in range(nc - 1, 0, -1):
            d_out[c - 1] = decay[:, c] * d_out[c] + g[:, c]
        dstate0 = decay[:, 0] * d_out[0] + g[:, 0]
        del L, g
    grads = [torch.empty_like(rc), torch.empty_like(kc),
             torch.empty_like(vc), torch.empty_like(wc)]
    du = torch.zeros_like(uf)
    for c0 in range(0, nc, BWD_GROUP):
        c1 = min(nc, c0 + BWD_GROUP)
        n = c1 - c0
        fold = lambda a: a[:, c0:c1].flatten(0, 1)      # (B * n, ...)
        with torch.enable_grad():
            ins = [fold(a).detach().requires_grad_() for a in (rc, kc, vc, wc)]
            ug = uf.clone().requires_grad_()
            s_in = torch.stack(states[c0:c1], dim=1).flatten(0, 1)
            s_new, y = _wkv6_chunk(s_in, *ins[:3], ins[3], ug)
            cot = (torch.stack(d_out[c0:c1], dim=1).flatten(0, 1),
                   fold(dyc))
            got = torch.autograd.grad((s_new, y), (*ins, ug), cot)
        for buf, gi in zip(grads, got[:4]):
            buf[:, c0:c1] = gi.unflatten(0, (B, n))
        du += got[4]
    dr, dk, dv, dw = (gi.flatten(1, 2)[:, :T] for gi in grads)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dw.to(w_log.dtype), du.to(u.dtype), dstate0.to(state.dtype))


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
    version (its autograd is the gradient's oracle); CUDA tensors launch
    the kernel, whose chunk tile holds at most 32 steps: a longer
    ``chunk`` runs as chunks of 32, which the plain version's longer
    chunk matches but for its clip (at most e^-60 |r k| a term).  When
    grad mode is on and an input requires grad, the launch goes through
    ``WKV6``, whose backward is ``wkv6_chunked_bwd``."""
    _check(r, k, v, w_log, u, state)
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, w_log, u, state, chunk=chunk)
    tensors = (r, k, v, w_log, u, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return WKV6.apply(r, k, v, w_log, u, state, chunk)
    return _launch(r, k, v, w_log, u, state, chunk)


class WKV6(torch.autograd.Function):
    """The kernel's forward with a gradient: the forward launches
    ``csrc/wkv6.cu`` and saves the inputs; the backward is the plain
    ``wkv6_chunked_bwd`` (the gradient of the reference's checkpointed
    chunk scan), for r, k, v, w_log, u and the initial state."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, state, chunk):
        ctx.save_for_backward(r, k, v, w_log, u, state)
        ctx.chunk = chunk
        return _launch(r, k, v, w_log, u, state, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w_log, u, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        grads = wkv6_chunked_bwd(r, k, v, w_log, u, state, dy, dstate,
                                 chunk=ctx.chunk)
        return (*grads, None)


def meta_cost(B, T, H, K, chunk=CHUNK):
    """(FLOPs, dot bytes) the dry run charges a call: the products of
    the plain version (``wkv6_chunked``, fp32), chunk by chunk of C =
    min(chunk, T) steps over the padded ceil(T / C) chunks -- the state
    read (BH, C, K) x (K, K), the intra-chunk scores (B C C H dots of
    K), the score-value product (BH, C, C) x (C, K), the bonus (B C H
    dots of K) and the state update (BH, K, C) x (C, K)."""
    C = min(chunk, T)
    nc = -(-T // C)
    BH = B * H
    flops = 2 * BH * (2 * C * K * K + 2 * C * C * K) + 2 * B * C * H * K
    dot = 4 * (BH * (C * K + K * K + C * K) + B * C * C * H * (2 * K + 1)
               + BH * (C * C + 2 * C * K) + B * C * H * (2 * K + 1)
               + BH * (2 * K * C + K * K))
    return nc * flops, nc * dot


def _launch(r, k, v, w_log, u, state, chunk):
    """One launch of the kernel on CUDA tensors, checked.  A meta tensor
    (the dry run, ``launch.dryrun``) launches nothing: it charges
    ``meta_cost`` to the running count and returns empty outputs of the
    kernel's shapes."""
    if r.device.type == "meta":
        add_kernel_cost(*meta_cost(*r.shape, chunk=chunk))
        return torch.empty_like(r), torch.empty_like(state)
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
