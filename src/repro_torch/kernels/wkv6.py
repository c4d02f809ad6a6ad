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
backward the backward kernel ``csrc/wkv6_bwd.cu`` (``wkv6_bwd``), the
gradient of that checkpointed scan.  Its plain versions:
``wkv6_chunked_bwd`` (recomputes the chunks through autograd; the meta
tensors' backward, so the dry run counts the reference's loop) and
``wkv6_bwd_tiled`` (the backward kernel's algorithm, what CPU tensors
run); ``wkv6_ref_bwd`` is the sequential oracle's gradient, which
``chip_smoke.py`` runs in float64 as the fp32 backwards' yardstick.

``wkv6`` and ``wkv6_bwd`` take a plain version ONLY for CPU tensors.  A
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import count_launch, load_library
from repro_torch.roofline.cost import add_kernel_cost

__all__ = ["wkv6", "wkv6_bwd", "wkv6_bwd_tiled", "wkv6_chunked",
           "wkv6_chunked_bwd", "wkv6_ref", "wkv6_ref_bwd", "wkv6_step",
           "WKV6"]

EXP_CLIP = -60.0
CHUNK = 32                 # time steps per chunk (the reference's default)
BWD_GROUP = 16             # chunks whose gradients one autograd call takes
MAX_CHUNK = 32             # the kernel's chunk tile: two 16-row sub-chunks
HEAD_SIZES = tuple(range(16, 129, 16))   # K: clusters of 1 to 8 ranks of 16

_ARGTYPES = {"wkv6": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_void_p],
             "wkv6_bwd": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
             + [ctypes.c_void_p]}


def _lib(stem="wkv6"):
    """The forward's library, or with ``stem`` "wkv6_bwd" the backward's."""
    lib = load_library(stem)
    if not getattr(lib, "_typed", False):
        for fn in (getattr(lib, f"{stem}_f32"), getattr(lib, f"{stem}_bf16")):
            fn.argtypes = _ARGTYPES[stem]
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{stem}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
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


def wkv6_ref_bwd(r, k, v, w_log, u, state, dy, dstate):
    """The gradient of ``wkv6_ref`` (no clip), step by step in reverse,
    carrying G, the cotangent of the state: (dr, dk, dv, dw_log, du,
    dstate0) for the cotangents ``dy`` and ``dstate`` (None for zero),
    computed in the inputs' dtype or fp32, whichever is wider, and
    returned in the inputs' dtypes -- float64 inputs give the yardstick
    the fp32 backwards are measured against."""
    ct = torch.promote_types(r.dtype, torch.float32)
    r_, k_, v_, wl, u_, dy_ = (a.to(ct) for a in (r, k, v, w_log, u, dy))
    B, T, H, K = r.shape
    S = torch.empty((T + 1, *state.shape), dtype=ct, device=r.device)
    S[0] = state
    for t in range(T):
        S[t + 1] = (torch.exp(wl[:, t])[..., None] * S[t]
                    + k_[:, t, :, :, None] * v_[:, t, :, None, :])
    G = (torch.zeros_like(S[0]) if dstate is None else dstate.to(ct))
    dr, dk, dv, dw = (torch.empty_like(r_) for _ in range(4))
    du = torch.zeros_like(u_)
    for t in range(T - 1, -1, -1):
        rt, kt, vt, dyt = r_[:, t], k_[:, t], v_[:, t], dy_[:, t]
        vdy = (vt * dyt).sum(-1, keepdim=True)          # the bonus's score
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", S[t], dyt) + u_ * kt * vdy
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", G, vt) + u_ * rt * vdy
        dv[:, t] = ((u_ * rt * kt).sum(-1, keepdim=True) * dyt
                    + torch.einsum("bhkv,bhk->bhv", G, kt))
        du += (rt * kt * vdy).sum(0)
        w = torch.exp(wl[:, t])
        dw[:, t] = w * (G * S[t]).sum(-1)
        G = w[..., None] * G + rt[..., None] * dyt[:, :, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dw.to(w_log.dtype), du.to(u.dtype), G.to(state.dtype))


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


def wkv6_bwd_tiled(r, k, v, w_log, u, state, dy, dstate, *, chunk=CHUNK):
    """The backward kernel's algorithm (``csrc/wkv6_bwd.cu``) in plain
    PyTorch: the gradients of ``wkv6_chunked`` as ``wkv6_chunked_bwd``
    returns them, in chunks of ``min(chunk, T, 32)`` steps.  Pass 1 runs
    the state recurrence alone and keeps each chunk's incoming state;
    pass 2 walks the chunks in reverse with the closed forms of the
    source's note -- dA = dy v^T, dv from A and the outgoing state's
    cotangent G, dr and dk from dA and the clipped decays, dw as the
    in-order reverse sums of dL and dLp from the last step, du one
    partial a batch row added in batch order, G carried back as
    ``e^Ll G + (r e^Lp)^T dy``."""
    B, T, H, K = r.shape
    C = min(chunk, T, MAX_CHUNK)
    rc, kc, vc, wc, dyc = padded_chunks(C, r, k, v, w_log, dy)
    nc = rc.shape[1]
    uf = u.float()
    L = torch.cumsum(wc, dim=2)                     # (B, nc, C, H, K)
    Lp = L - wc
    Ll = L[:, :, -1]                                # (B, nc, H, K)
    ek = torch.exp(Ll[:, :, None] - L)              # e^(Ll - L)
    eL = torch.exp(Ll)[..., None]                   # (B, nc, H, K, 1)
    states = [state.float()]                        # pass 1
    for c in range(nc - 1):
        states.append(eL[:, c] * states[-1] + torch.einsum(
            "bchk,bchv->bhkv", kc[:, c] * ek[:, c], vc[:, c]))
    G = (torch.zeros_like(states[0]) if dstate is None
         else dstate.float())
    before = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=r.device), diagonal=-1)   # j < t
    diag = torch.eye(C, dtype=torch.bool, device=r.device)
    grads = [torch.empty_like(rc) for _ in range(4)]
    du_part = torch.zeros((B, H, K), device=r.device)
    for c in range(nc - 1, -1, -1):                 # pass 2
        r_, k_, v_, dy_ = rc[:, c], kc[:, c], vc[:, c], dyc[:, c]
        L_, Lp_, S = L[:, c], Lp[:, c], states[c]
        W = torch.exp((Lp_[:, :, None] - L_[:, None]).clamp(EXP_CLIP, 0.0)
                      ) * before[None, :, :, None, None]    # (B, t, j, H, K)
        A = torch.einsum("bthk,bjhk,btjhk->bthj", r_, k_, W) + torch.einsum(
            "bthk,hk,bthk->bth", r_, uf, k_)[..., None] * diag[:, None]
        dA = torch.einsum("bthv,bjhv->bthj", dy_, v_) * (before | diag)[
            :, None]
        bonus = dA.diagonal(dim1=1, dim2=3).transpose(1, 2)[..., None]
        dv = (torch.einsum("bthj,bthv->bjhv", A, dy_)
              + torch.einsum("bjhk,bhkv->bjhv", k_ * ek[:, c], G))
        dr_x = (torch.exp(Lp_) * torch.einsum("bhkv,bthv->bthk", S, dy_)
                + torch.einsum("bthj,bjhk,btjhk->bthk", dA, k_, W))
        dk_st = ek[:, c] * torch.einsum("bhkv,bjhv->bjhk", G, v_)
        dk_x = torch.einsum("bthj,bthk,btjhk->bjhk", dA, r_, W) + dk_st
        dLp, dL = r_ * dr_x, -k_ * dk_x
        acc = eL[:, c, ..., 0] * (S * G).sum(-1) + (k_ * dk_st).sum(1)
        dw = torch.empty_like(dL)
        for t in range(C - 1, -1, -1):              # in order, from the end
            acc = acc + dL[:, t]
            dw[:, t] = acc
            acc = acc + dLp[:, t]
        du_part += (bonus * r_ * k_).sum(1)
        for buf, g in zip(grads, (dr_x + bonus * uf * k_,
                                  dk_x + bonus * uf * r_, dv, dw)):
            buf[:, c] = g
        G = eL[:, c] * G + torch.einsum("bthk,bthv->bhkv",
                                        r_ * torch.exp(Lp_), dy_)
    du = du_part[0]
    for b in range(1, B):                           # batch order
        du = du + du_part[b]
    dr, dk, dv, dw = (g.flatten(1, 2)[:, :T] for g in grads)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dw.to(w_log.dtype), du.to(u.dtype), G.to(state.dtype))


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
    ``WKV6``, whose backward is the backward kernel (``wkv6_bwd``)."""
    _check(r, k, v, w_log, u, state)
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, w_log, u, state, chunk=chunk)
    tensors = (r, k, v, w_log, u, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return WKV6.apply(r, k, v, w_log, u, state, chunk)
    return _launch(r, k, v, w_log, u, state, chunk)


def wkv6_bwd(r, k, v, w_log, u, state, dy, dstate, *, chunk=CHUNK):
    """Gradients (dr, dk, dv, dw_log, du, dstate0) of ``wkv6``'s (y,
    final state) for the cotangents ``dy`` (B, T, H, K, in r's dtype)
    and ``dstate`` (B, H, K, K fp32, or None for zero), in the inputs'
    dtypes.  CUDA tensors launch the backward kernel ``csrc/wkv6_bwd.cu``
    (its chunk tile holds at most 32 steps, as the forward's) or raise,
    with the forward's checks; CPU tensors take ``wkv6_bwd_tiled``, the
    same algorithm in plain PyTorch."""
    _check(r, k, v, w_log, u, state)
    if dy.shape != r.shape:
        raise ValueError(f"wkv6_bwd: dy has shape {tuple(dy.shape)}, r has "
                         f"{tuple(r.shape)}")
    if dstate is not None and dstate.shape != state.shape:
        raise ValueError(f"wkv6_bwd: dstate has shape {tuple(dstate.shape)}"
                         f", state has {tuple(state.shape)}")
    if r.device.type == "cpu":
        return wkv6_bwd_tiled(r, k, v, w_log, u, state, dy, dstate,
                              chunk=chunk)
    return _launch_bwd(r, k, v, w_log, u, state, dy, dstate, chunk)


class WKV6(torch.autograd.Function):
    """The kernel's forward with a gradient: the forward launches
    ``csrc/wkv6.cu`` and saves the inputs; the backward launches the
    backward kernel ``csrc/wkv6_bwd.cu`` (``wkv6_bwd``: the gradient of
    the reference's checkpointed chunk scan) for r, k, v, w_log, u and
    the initial state.  On meta tensors (the dry run) the backward is
    ``wkv6_chunked_bwd``, so the count is the reference's loop's."""

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
        bwd = wkv6_chunked_bwd if r.device.type == "meta" else wkv6_bwd
        return (*bwd(r, k, v, w_log, u, state, dy, dstate, chunk=ctx.chunk),
                None)


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
    chunk = _check_cuda("wkv6", (r, k, v), (w_log, u, state), chunk)
    B, T, H, K = r.shape
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


def _check_cuda(name, low, fp32, chunk):
    """Refuse what the kernels do not take: another device or dtype
    (``low`` in one compute dtype, ``fp32`` in float32), operands not
    contiguous or not 16-byte aligned, another head size, chunk or grid.
    Returns the launch's chunk tile."""
    r = low[0]
    if r.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {r.device}")
    tensors = (*low, *fp32)
    if any(t.device != r.device for t in tensors):
        raise ValueError(f"{name}: all operands must share a device")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {r.dtype} not supported (float32 "
                        "or bfloat16)")
    if any(t.dtype != r.dtype for t in low):
        raise TypeError(f"{name}: k, v (and dy) must have r's dtype")
    if any(t.dtype != torch.float32 for t in fp32):
        raise TypeError(f"{name}: w_log, u and the states must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    B, T, H, K = r.shape
    if K not in HEAD_SIZES or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: head size must be a multiple of 16 up to "
                         f"{HEAD_SIZES[-1]} and operands 16-byte aligned "
                         "(vector loads)")
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be >= 1; got {chunk}")
    if B * H > 65535:
        raise ValueError(f"{name}: B * H = {B * H} > 65535 (the grid's y)")
    return min(chunk, T, MAX_CHUNK)


def _launch_bwd(r, k, v, w_log, u, state, dy, dstate, chunk):
    """One launch of the backward kernel on CUDA tensors, checked: pass 1
    writes each chunk's incoming state to a scratch buffer, pass 2 the
    gradients, then a second kernel adds du's batch rows."""
    dy = dy.contiguous()              # autograd's cotangents may be views
    dstate = None if dstate is None else dstate.contiguous()
    fp32 = (w_log, u, state) + (() if dstate is None else (dstate,))
    chunk = _check_cuda("wkv6_bwd", (r, k, v, dy), fp32, chunk)
    B, T, H, K = r.shape
    lib = _lib("wkv6_bwd")
    f32 = dict(dtype=torch.float32, device=r.device)
    states = torch.empty((-(-T // chunk), B, H, K, K), **f32)
    du_part = torch.empty((B, H, K), **f32)
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dw = torch.empty_like(w_log)
    du = torch.empty_like(u)
    ds0 = torch.empty_like(state)
    fn = lib.wkv6_bwd_f32 if r.dtype == torch.float32 else lib.wkv6_bwd_bf16
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), state.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), states.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du_part.data_ptr(), du.data_ptr(), ds0.data_ptr(),
            B, T, H, K, chunk, torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("wkv6_bwd launch failed: "
                           + lib.wkv6_bwd_error_string(rc).decode())
    count_launch("wkv6_bwd")
    return dr, dk, dv, dw, du, ds0
