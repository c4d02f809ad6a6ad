"""Mamba-1 selective scan: CUDA kernel beside its plain versions.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py::mamba_pallas``
(body ``_mamba_kernel``) with a CUDA C++ kernel for Hopper,
``csrc/mamba_scan.cu``.  Every prefill chunk of two or more tokens of
a Mamba layer goes through it, and so does every slab prefill and every
training forward; a one-token decode step takes ``mamba_step``, which
the reference also leaves to plain array code.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t^T
    y_t = h_t C_t + D * x_t

Bound: memory.  A call reads x, dt, B, C (compute dtype), A, D and the
state (fp32) once and writes y and the final state once -- about
3.18 MB for a 32-token prefill chunk of Jamba (dI 8192, dS 16) in
bf16.  Each thread of the kernel keeps several state entries of one
channel in registers for the whole segment, sums y over them before
its few shuffles, and runs each 32-step tile in unrolled groups with
the next tile's cp.async copies in flight; see the source's note.

Plain versions: ``mamba_ref``, the sequential oracle (what CPU tensors
run), and ``mamba_chunked``, the reference's chunked XLA form (chunks
of 64 steps, each chunk's trajectory from a zero start plus the decayed
incoming state; inside a chunk the steps run in order, which is what
the reference's associative scan computes).  Gradient: the TPU kernel
has none, and the reference trains through ``mamba_chunked`` with each
chunk under ``jax.checkpoint``.  ``MambaScan`` is the kernel's
``autograd.Function``: its forward is the kernel, its backward
``mamba_chunked_bwd``, plain PyTorch that recomputes the chunks.

``mamba_scan`` takes the plain version ONLY for CPU tensors.  A CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import count_launch, load_library
from repro_torch.roofline.cost import add_kernel_cost
from repro_torch.kernels.wkv6 import padded_chunks

__all__ = ["mamba_scan", "mamba_ref", "mamba_chunked", "mamba_chunked_bwd",
           "mamba_step", "MambaScan"]

STATE_SIZES = (4, 8, 16, 32)   # d_state values the kernel is built for
CHUNK = 64                     # the reference's mamba_chunked chunk
BWD_GROUP = 8                  # chunks whose gradients one autograd call takes

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])


def _lib():
    lib = load_library("mamba_scan")
    if not getattr(lib, "_typed", False):
        for fn in (lib.mamba_scan_f32, lib.mamba_scan_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def mamba_ref(x, dt, A, B, C, D, state):
    """Sequential scan over time (``repro.kernels.ref.mamba_ref``).

    x, dt: (Bb, T, dI); A: (dI, dS); B, C: (Bb, T, dS); D: (dI,);
    state: (Bb, dI, dS).  Returns y (Bb, T, dI) fp32 and the final
    state fp32."""
    x, dt, B, C = (a.float() for a in (x, dt, B, C))
    A, D = A.float(), D.float()
    h = state.float()
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t, :, None] * A)
        h = da * h + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bis,bs->bi", h, C[:, t]) + D * x[:, t])
    return torch.stack(ys, dim=1), h


def _mamba_chunk(h, x, dt, B, C, A, D):
    """One chunk (the reference's ``ops._mamba_chunk``).  h: (Bb, dI, dS)
    fp32 incoming state; x, dt: (Bb, C, dI), B, C: (Bb, C, dS) fp32.
    The chunk's trajectory from a zero start (``Hin``), in order, plus
    the incoming state decayed by the cumulative log-decay.  Returns
    (the outgoing state, y (Bb, C, dI))."""
    logda = dt[..., None] * A                        # (Bb, C, dI, dS) <= 0
    L = torch.cumsum(logda, dim=1)
    b = (dt * x)[..., None] * B[:, :, None, :]       # input terms
    hin, run = [], None
    for t in range(x.shape[1]):
        run = b[:, t] if run is None else torch.exp(logda[:, t]) * run + b[:, t]
        hin.append(run)
    ht = torch.exp(L) * h[:, None] + torch.stack(hin, dim=1)
    y = torch.einsum("bcis,bcs->bci", ht, C) + D * x
    return ht[:, -1], y


def mamba_chunked(x, dt, A, B, C, D, state, *, chunk=CHUNK):
    """The reference's ``ops.mamba_chunked``: chunks of ``min(chunk, T)``
    steps, a ragged tail zero-padded, fp32 inside; y in x's dtype, the
    final state fp32."""
    Bb, T, dI = x.shape
    chunk = min(chunk, T)
    xs, dts, Bs, Cs = padded_chunks(chunk, x, dt, B, C)
    A, D = A.float(), D.float()
    h = state.float()
    ys = []
    for c in range(xs.shape[1]):
        h, y = _mamba_chunk(h, xs[:, c], dts[:, c], Bs[:, c], Cs[:, c], A, D)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T].to(x.dtype), h


def mamba_chunked_bwd(x, dt, A, B, C, D, state, dy, dstate, *, chunk=CHUNK):
    """Gradients (dx, ddt, dA, dB, dC, dD, dstate0) of ``mamba_chunked``'s
    (y, final state) for the cotangents ``dy`` (Bb, T, dI) and
    ``dstate`` (Bb, dI, dS, or None for zero), in the inputs' dtypes.

    The gradient of the reference's scan with each chunk checkpointed:
    each chunk's outgoing state is ``exp(L_last) h_in`` plus its
    zero-start trajectory's last state, so the chunk-boundary states are
    recomputed in order from those; the state's gradient is carried back
    across the chunks in reverse (``dh_c = exp(L_last) dh_{c+1} +
    sum_t exp(L_t) dy_t C_t``, the two ways a chunk reads its incoming
    state); then each chunk's gradients are taken by
    ``torch.autograd.grad`` through ``_mamba_chunk``, ``BWD_GROUP``
    chunks in one call, folded into the batch.  Plain PyTorch on any
    device: ``MambaScan``'s backward, which no TPU kernel had."""
    Bb, T, dI = x.shape
    chunk = min(chunk, T)
    xs, dts, Bs, Cs, dys = padded_chunks(chunk, x, dt, B, C, dy)
    nc = xs.shape[1]
    Af, Df = A.detach().float(), D.detach().float()
    zero = torch.zeros_like(state, dtype=torch.float32)
    decay, last, carry = [], [], []
    with torch.no_grad():
        for c0 in range(0, nc, BWD_GROUP):
            c1 = min(nc, c0 + BWD_GROUP)
            fold = lambda a: a[:, c0:c1].flatten(0, 1)
            logda = fold(dts)[..., None] * Af
            L = torch.cumsum(logda, dim=1)              # (n Bb, C, dI, dS)
            e = torch.exp(L)
            h_end, _ = _mamba_chunk(zero.repeat(c1 - c0, 1, 1), fold(xs),
                                    fold(dts), fold(Bs), fold(Cs), Af, Df)
            decay += list(e[:, -1].unflatten(0, (Bb, -1)).unbind(1))
            last += list(h_end.unflatten(0, (Bb, -1)).unbind(1))
            # d(y of the chunk) / d(its incoming state), applied to dy
            carry += list(torch.einsum("ncis,nci,ncs->nis", e, fold(dys),
                                       fold(Cs)).unflatten(0, (Bb, -1))
                          .unbind(1))
            del logda, L, e
        states = [state.detach().float()]
        for c in range(nc - 1):
            states.append(decay[c] * states[-1] + last[c])
        d_out = [None] * nc                            # cotangent of h_out
        d_out[nc - 1] = zero if dstate is None else dstate.float()
        for c in range(nc - 1, 0, -1):
            d_out[c - 1] = decay[c] * d_out[c] + carry[c]
        dstate0 = decay[0] * d_out[0] + carry[0]
        del last, carry
    grads = [torch.empty_like(a) for a in (xs, dts, Bs, Cs)]
    dA, dD = torch.zeros_like(Af), torch.zeros_like(Df)
    for c0 in range(0, nc, BWD_GROUP):
        c1 = min(nc, c0 + BWD_GROUP)
        n = c1 - c0
        fold = lambda a: a[:, c0:c1].flatten(0, 1)
        with torch.enable_grad():
            ins = [fold(a).detach().requires_grad_() for a in (xs, dts, Bs, Cs)]
            Ag, Dg = Af.clone().requires_grad_(), Df.clone().requires_grad_()
            h_in = torch.stack(states[c0:c1], dim=1).flatten(0, 1)
            h_out, y = _mamba_chunk(h_in, *ins, Ag, Dg)
            cot = (torch.stack(d_out[c0:c1], dim=1).flatten(0, 1), fold(dys))
            got = torch.autograd.grad((h_out, y), (*ins, Ag, Dg), cot)
        for buf, gi in zip(grads, got[:4]):
            buf[:, c0:c1] = gi.unflatten(0, (Bb, n))
        dA += got[4]
        dD += got[5]
    dx, ddt, dB, dC = (gi.flatten(1, 2)[:, :T] for gi in grads)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype), dD.to(D.dtype), dstate0.to(state.dtype))


def mamba_step(x, dt, A, B, C, D, state):
    """One decode step (``repro.kernels.ops.mamba_step``), plain PyTorch
    as in the reference.  x, dt: (Bb, dI); B, C: (Bb, dS); state (Bb,
    dI, dS).  Returns y (Bb, dI) fp32 and the new state fp32."""
    x32, dt32, B32, C32 = (a.float() for a in (x, dt, B, C))
    da = torch.exp(dt32[..., None] * A.float())
    h = da * state.float() + (dt32 * x32)[..., None] * B32[:, None, :]
    y = torch.einsum("bis,bs->bi", h, C32) + D.float() * x32
    return y, h


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _check(x, dt, A, B, C, D, state):
    if x.dim() != 3:
        raise ValueError(f"x must be (Bb, T, dI); got {tuple(x.shape)}")
    Bb, T, dI = x.shape
    if T < 1:
        raise ValueError("mamba_scan needs at least one time step")
    if dt.shape != x.shape:
        raise ValueError(f"dt has shape {tuple(dt.shape)}, x has "
                         f"{tuple(x.shape)}")
    if A.dim() != 2 or A.shape[0] != dI:
        raise ValueError(f"A must be (dI, dS) with dI={dI}; got "
                         f"{tuple(A.shape)}")
    dS = A.shape[1]
    for name, t in (("B", B), ("C", C)):
        if tuple(t.shape) != (Bb, T, dS):
            raise ValueError(f"{name} must be (Bb, T, dS)=({Bb}, {T}, {dS}); "
                             f"got {tuple(t.shape)}")
    if tuple(D.shape) != (dI,):
        raise ValueError(f"D must be ({dI},); got {tuple(D.shape)}")
    if tuple(state.shape) != (Bb, dI, dS):
        raise ValueError(f"state must be (Bb, dI, dS)=({Bb}, {dI}, {dS}); "
                         f"got {tuple(state.shape)}")


def mamba_scan(x, dt, A, B, C, D, state, *, chunk=CHUNK):
    """Mamba-1 selective scan over a segment.

    x, dt, B, C in bf16 or fp32 (one dtype): x, dt (Bb, T, dI) and B, C
    (Bb, T, dS), whose rows may be strided (column slices of one
    projection) as long as dS is the unit-stride axis; A (dI, dS), D
    (dI,) and state (Bb, dI, dS) fp32.  Returns y (Bb, T, dI) in x's
    dtype and the final state (Bb, dI, dS) fp32; the inputs are not
    modified.  CPU tensors take the plain version (``mamba_ref``; its
    autograd is the gradient's oracle); CUDA tensors launch the kernel.
    When grad mode is on and an input requires grad, the launch goes
    through ``MambaScan``, whose backward is ``mamba_chunked_bwd`` in
    chunks of ``chunk`` steps.  The kernel keeps its own tile (each
    thread walks the whole segment in 32-step tiles), so ``chunk`` sets
    only the plain backward's recomputation, as ``wkv6``'s does past
    its kernel's 32-step tile."""
    _check(x, dt, A, B, C, D, state)
    if x.device.type == "cpu":
        y, h = mamba_ref(x, dt, A, B, C, D, state)
        return y.to(x.dtype), h
    tensors = (x, dt, A, B, C, D, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return MambaScan.apply(*tensors, chunk)
    return _launch(*tensors)


class MambaScan(torch.autograd.Function):
    """The kernel's forward with a gradient: the forward launches
    ``csrc/mamba_scan.cu`` and saves the inputs; the backward is the
    plain ``mamba_chunked_bwd`` (the gradient of the reference's
    checkpointed chunk scan), for x, dt, A, B, C, D and the initial
    state."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, state, chunk=CHUNK):
        ctx.save_for_backward(x, dt, A, B, C, D, state)
        ctx.chunk = chunk
        return _launch(x, dt, A, B, C, D, state)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, D, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return (*mamba_chunked_bwd(x, dt, A, B, C, D, state, dy, dstate,
                                   chunk=ctx.chunk), None)


def meta_cost(Bb, T, dI, dS):
    """(FLOPs, dot bytes) the dry run charges a call: the product of the
    plain version (``mamba_ref``, fp32), one (Bb, dI, dS) x (dS, 1)
    read-out of the state a step."""
    return 2 * Bb * T * dI * dS, 4 * Bb * T * (dI * dS + dS + dI)


def _launch(x, dt, A, B, C, D, state):
    """One launch of the kernel on CUDA tensors, checked.  A meta tensor
    (the dry run, ``launch.dryrun``) launches nothing: it charges
    ``meta_cost`` to the running count and returns empty outputs of the
    kernel's shapes."""
    if x.device.type == "meta":
        add_kernel_cost(*meta_cost(*x.shape, B.shape[-1]))
        return torch.empty_like(x), torch.empty_like(state)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {x.device}")
    tensors = (x, dt, A, B, C, D, state)
    if any(t.device != x.device for t in tensors):
        raise ValueError("mamba_scan: all operands must share a device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mamba_scan: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if any(t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError("mamba_scan: dt, B and C must have x's dtype")
    if any(t.dtype != torch.float32 for t in (A, D, state)):
        raise TypeError("mamba_scan: A, D and state must be float32")
    if not all(t.is_contiguous() for t in (x, dt, A, D, state)):
        raise ValueError("mamba_scan: x, dt, A, D and state must be "
                         "contiguous")
    if B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("mamba_scan: B and C need a unit stride over dS")
    Bb, T, dI = x.shape
    dS = A.shape[1]
    if dS not in STATE_SIZES:
        raise ValueError(f"mamba_scan: d_state {dS} not in {STATE_SIZES}")
    lib = _lib()
    y = torch.empty_like(x)
    s_out = torch.empty_like(state)
    fn = lib.mamba_scan_f32 if x.dtype == torch.float32 else \
        lib.mamba_scan_bf16
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), state.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), Bb, T, dI, dS, B.stride(0), B.stride(1),
            C.stride(0), C.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("mamba_scan launch failed: "
                           + lib.mamba_scan_error_string(rc).decode())
    count_launch("mamba_scan")
    return y, s_out
