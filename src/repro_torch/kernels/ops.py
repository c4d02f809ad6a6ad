"""The implementation dispatch of the whole-sequence kernels, and the
flash kernel's block surface (port of ``repro.kernels.ops``).

Implementations per op (``impl=``, or the process-wide default of
``set_default_impl``):
  * "auto"    -- the wrappers' own rule, and the default: a CPU tensor
                 takes the plain version, a CUDA tensor launches the
                 hand-written kernel (or raises), a meta tensor charges
                 the kernel's ``meta_cost`` (the dry run).
  * "cuda"    -- the kernel, the counterpart of the reference's
                 "pallas": a CUDA tensor launches it (a meta tensor
                 charges it), a CPU tensor raises.
  * "ref"     -- the naive oracles (``flash_attention_ref``,
                 ``wkv6_ref``, ``mamba_ref``) on the tensors' own device.
  * "chunked" -- the plain chunked forms (``models.attention.
                 chunked_attention_loop`` with ``chunk=block_q``,
                 ``wkv6_chunked``, ``mamba_chunked``) on the tensors' own
                 device.

The reference defaults to "chunked" and reaches its Pallas kernels only
when named.  The port defaults to "auto", because its main path must
launch the kernels on the card.  "ref" and "chunked" run on a CUDA
tensor only when a caller names them; nothing gives way to them when a
build or a launch fails.  The models' scans (``models/ssm.py``) call
through here, as the reference's do, so the default steers them.

The flash block surface (``set_flash_blocks`` / ``get_flash_blocks``).
The reference's knobs are the TPU kernel's BlockSpecs; the CUDA kernels
are built for a few block shapes, chosen at run time, so the knobs
name those shapes:
  * None (the default) keeps the shape plan: ``gqa_split.plan`` for
    bf16, the ``SMALL_ROWS`` rule for fp32 (``kernels/flash_attention.
    py``).  No launch on the main path changes while both are None.
  * ``block_q`` is the query rows a block holds: bf16 16 (one warp,
    ``mma.sync``, 32-key tiles) or 128 (one warpgroup, ``wgmma``, 64-key
    tiles); fp32 16 or 64 (1 or 4 rows a thread).
  * ``block_kv`` is the keys one split walks, so a call of T keys runs
    ceil(T / block_kv) splits: a multiple of 32 (the one-warp key tile)
    giving at most ``gqa_split.MAX_SPLITS`` (8) splits.  Only bf16
    16-row blocks take splits, so a set ``block_kv`` implies them; with
    ``block_q`` 128 or in fp32 it raises.
  * A value the kernel was not built for raises a ``ValueError`` that
    names the legal set at the launch; it is never rounded.
  * The chunked path takes ``block_q`` as its q-chunk (256 while the
    surface holds None, the reference's default), as the reference does.
``kernels/flash_attention.py::_launch`` reads the surface where a call
passes no blocks; ``paged_flash_decode`` does not read it, as in the
reference.  An omitted argument leaves its knob unchanged, None sets it
back to the plan, and ``set_flash_blocks`` returns the previous pair,
so ``set_flash_blocks(*prev)`` restores any state.  The surface is
process-wide; a caller that sets it restores it in a ``finally``.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import _check as _flash_check
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.mamba_scan import _check as _mamba_check
from repro_torch.kernels.mamba_scan import mamba_scan as _mamba
from repro_torch.kernels.mamba_scan import (mamba_chunked, mamba_ref,
                                            mamba_step)
from repro_torch.kernels.wkv6 import _check as _wkv6_check
from repro_torch.kernels.wkv6 import wkv6 as _wkv6
from repro_torch.kernels.wkv6 import wkv6_chunked, wkv6_ref, wkv6_step

__all__ = ["IMPLS", "flash_attention", "wkv6", "wkv6_step", "mamba_scan",
           "mamba_step", "set_default_impl", "get_default_impl",
           "set_flash_blocks", "get_flash_blocks"]

IMPLS = ("auto", "ref", "chunked", "cuda")
CHUNKED_BLOCK_Q = 256      # the chunked path's q-chunk while block_q is None

_DEFAULT_IMPL = "auto"
_FLASH_BLOCKS = {"block_q": None, "block_kv": None}
_KEEP = object()


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS} (the port's "
                         "kernel is \"cuda\", the reference's \"pallas\")")


def set_default_impl(impl: str) -> None:
    global _DEFAULT_IMPL
    _check_impl(impl)
    _DEFAULT_IMPL = impl


def get_default_impl() -> str:
    return _DEFAULT_IMPL


def set_flash_blocks(block_q=_KEEP, block_kv=_KEEP):
    """Set the flash kernel's block shape: an omitted knob is left as it
    is, None sets it back to the shape plan, an int must be > 0 (whether
    the kernel is built for it is checked at the launch).  Returns the
    previous ``(block_q, block_kv)`` so sweeps can restore."""
    prev = get_flash_blocks()
    for name, value in (("block_q", block_q), ("block_kv", block_kv)):
        if value is _KEEP:
            continue
        if value is not None:
            assert value > 0
            value = int(value)
        _FLASH_BLOCKS[name] = value
    return prev


def get_flash_blocks():
    return _FLASH_BLOCKS["block_q"], _FLASH_BLOCKS["block_kv"]


def _resolve(impl, t, op):
    """The impl a call runs: ``impl`` or the default, checked; "cuda"
    refuses a CPU tensor."""
    impl = impl or _DEFAULT_IMPL
    _check_impl(impl)
    if impl == "cuda" and t.device.type == "cpu":
        raise ValueError(f"{op}(impl=\"cuda\") launches the CUDA kernel and "
                         "needs CUDA tensors; got a CPU tensor")
    return impl


# --------------------------------------------------------------------------
# WKV6 (RWKV-6 recurrence with data-dependent decay)
# --------------------------------------------------------------------------

def wkv6(r, k, v, w_log, u, state, *, impl=None, chunk=32):
    """RWKV-6 WKV over a segment (``kernels.wkv6.wkv6``'s shapes).  "ref"
    returns y in fp32, as the reference's oracle does; the other impls
    return y in r's dtype.  ``chunk``: the chunked form's and the plain
    backward's; the kernel keeps its own 32-step tile."""
    impl = _resolve(impl, r, "wkv6")
    if impl in ("ref", "chunked"):
        _wkv6_check(r, k, v, w_log, u, state)
        if impl == "ref":
            return wkv6_ref(r, k, v, w_log, u, state)
        return wkv6_chunked(r, k, v, w_log, u, state, chunk=chunk)
    return _wkv6(r, k, v, w_log, u, state, chunk=chunk)


# --------------------------------------------------------------------------
# Mamba selective scan
# --------------------------------------------------------------------------

def mamba_scan(x, dt, A, B, C, D, state, *, impl=None, chunk=64):
    """Mamba-1 selective scan over a segment (``kernels.mamba_scan.
    mamba_scan``'s shapes).  "ref" returns y in fp32, as the reference's
    oracle does; the other impls return y in x's dtype.  ``chunk``: the
    chunked form's and the plain backward's; the kernel keeps its own
    tile."""
    impl = _resolve(impl, x, "mamba_scan")
    if impl in ("ref", "chunked"):
        _mamba_check(x, dt, A, B, C, D, state)
        if impl == "ref":
            return mamba_ref(x, dt, A, B, C, D, state)
        return mamba_chunked(x, dt, A, B, C, D, state, chunk=chunk)
    return _mamba(x, dt, A, B, C, D, state, chunk=chunk)


# --------------------------------------------------------------------------
# Flash attention
# --------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal=True, window=0, impl=None,
                    block_q=None, block_kv=None):
    """Right-aligned GQA attention (``kernels.flash_attention.
    flash_attention``'s shapes and refusals).  ``block_q`` / ``block_kv``
    default to the ``set_flash_blocks`` surface; pass them to set one
    call's."""
    impl = _resolve(impl, q, "flash_attention")
    if impl == "ref":
        _flash_check(q, k, v, causal)
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if impl == "chunked":
        from repro_torch.models.attention import chunked_attention_loop
        _flash_check(q, k, v, causal)
        if block_q is None:
            block_q = _FLASH_BLOCKS["block_q"] or CHUNKED_BLOCK_Q
        S, T = q.shape[1], k.shape[1]
        return chunked_attention_loop(
            q, k, v, q_positions=range(T - S, T), kv_positions=range(T),
            causal=causal, window=window, chunk=block_q)
    return _flash(q, k, v, causal=causal, window=window, block_q=block_q,
                  block_kv=block_kv)
