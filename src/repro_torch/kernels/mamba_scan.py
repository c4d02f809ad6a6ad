"""Mamba-1 selective scan: CUDA kernel beside its plain versions.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py::mamba_pallas``
(body ``_mamba_kernel``) with a CUDA C++ kernel for Hopper,
``csrc/mamba_scan.cu``.  Every prefill chunk of two or more tokens of
a Mamba layer goes through it; a one-token step takes ``mamba_step``,
which the reference also leaves to plain array code.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t^T
    y_t = h_t C_t + D * x_t

Bound: memory.  A call reads x, dt, B, C (compute dtype), A, D and the
state (fp32) once and writes y and the final state once -- about
3.18 MB for a 32-token prefill chunk of Jamba (dI 8192, dS 16) in
bf16.  Each thread of the kernel keeps several state entries of one
channel in registers for the whole segment, sums y over them before
its few shuffles, and runs each 32-step tile in unrolled groups with
the next tile's cp.async copies in flight; see the source's note.

``mamba_scan`` takes the plain version ONLY for CPU tensors.  A CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import count_launch, load_library

__all__ = ["mamba_scan", "mamba_ref", "mamba_step"]

STATE_SIZES = (4, 8, 16, 32)   # d_state values the kernel is built for

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


def mamba_scan(x, dt, A, B, C, D, state):
    """Mamba-1 selective scan over a segment.

    x, dt, B, C in bf16 or fp32 (one dtype): x, dt (Bb, T, dI) and B, C
    (Bb, T, dS), whose rows may be strided (column slices of one
    projection) as long as dS is the unit-stride axis; A (dI, dS), D
    (dI,) and state (Bb, dI, dS) fp32.  Returns y (Bb, T, dI) in x's
    dtype and the final state (Bb, dI, dS) fp32; the inputs are not
    modified.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    _check(x, dt, A, B, C, D, state)
    if x.device.type == "cpu":
        y, h = mamba_ref(x, dt, A, B, C, D, state)
        return y.to(x.dtype), h
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
