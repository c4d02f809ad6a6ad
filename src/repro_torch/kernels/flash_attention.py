"""Flash attention: causal, sliding-window or bidirectional GQA with
right-aligned queries.

``flash_attention`` replaces the TPU kernel ``repro/kernels/
flash_attention.py::flash_attention_pallas`` (body ``_flash_kernel``)
with a CUDA C++ kernel for Hopper, ``csrc/flash_attention.cu``.  Every
self-attention call of the lockstep slab engine goes through it: the
whole-prompt prefill (S == T) and each decode step (S = 1 against the
valid prefix of the slab cache, a strided view that is not copied); so
does every training forward, and the train and prefill branch of MLA,
whose q and k are 192 wide (nope 128 + rope 64) and v 128.

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

Widths.  Both kernels are built for (q/k width, v width) in
``KERNEL_WIDTHS``: (64, 64), (128, 128) and MLA's (192, 128).  The K
tile and the score product run over the first, the V tile, the
accumulator and the output over the second.  Any other pair raises; it
is never padded or split.

Training.  ``FlashAttention`` (the Function every training step runs on
the card) launches this forward asking for each row's log-sum-exp and
its backward kernel, ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd``): FlashAttention-2 from the saved output and
log-sum-exp, by blocks of keys walking the rows of the group's g heads
that see them, masking only the partly visible 16 x 16 units
(``bwd_rows``, ``bwd_keys``, ``bwd_unit_state``).  bf16 is
FlashAttention-3's shape: a producer warp feeding two consumer
warpgroups of 64 keys through TMA and mbarriers, every product a
warpgroup MMA (``wgmma``), and dQ not recomputed but summed over the key
blocks in key order (bitwise repeatable); fp32 runs on FMAs.  The
reference's TPU kernel has no backward; the reference trains by
differentiating its checkpointed ``chunked_attention`` loop, whose
gradient ``flash_attention_bwd_ref`` is: the oracle, and what meta
tensors (the dry run) take.  ``flash_attention_bwd_tiled`` is the kernels'
algorithm in plain PyTorch.  Bound: operations, 10 hd per visible (query
head row, key) pair at the tensor cores' rate.

Block shapes.  ``launch_layout`` turns the block surface of
``kernels/ops.py`` (``set_flash_blocks``, or a call's own ``block_q`` /
``block_kv``) into the launch's layout: None keeps the shape plan, a
set value must name a shape the kernel was built for (bf16 16 or 128
query rows a block, fp32 16 or 64; ``block_kv`` only for bf16 16-row
blocks, which split the keys) or raises; it is never rounded.

The wrapper takes the plain version ONLY for CPU tensors.  A CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import gqa_split
from repro_torch.kernels.build import count_launch, load_library
from repro_torch.roofline.cost import add_kernel_cost

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_bwd_ref",
           "flash_attention_bwd", "flash_attention_bwd_tiled",
           "flash_attention_lse_ref", "bwd_rows", "bwd_keys",
           "bwd_unit_state", "bwd_tiles", "KERNEL_WIDTHS", "block_choices",
           "launch_layout", "resolve_blocks"]

NEG_INF = -1e30
# (q and k width, v width) pairs the kernel is built for
KERNEL_WIDTHS = ((64, 64), (128, 128), (192, 128))
SMALL_ROWS = 64                # below this many rows a kv head: 16-row blocks
F32_BLOCK_Q = {16: 1, 64: 4}   # fp32: query rows a block -> rows a thread
SMEM_LIMIT = 227 * 1024        # dynamic shared memory one Hopper block may use

# q, k, v, out, lse; B, S, T, h, hk, hd, hdv; k's and v's batch and
# sequence strides; causal, window, rows_per_thread; scale, stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])
# bf16: (warps, splits) in place of rows_per_thread
_BF16_ARGTYPES = _ARGTYPES[:18] + [ctypes.c_int] * 2 + _ARGTYPES[19:]
# the backward: q, k, v, out, lse, dout, scratch (fp32: D; bf16: the
# workspace), dq, dk, dv; B, S, T, h, hk, hd, hdv; the strides; causal,
# window; scale, stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2
                 + [ctypes.c_float, ctypes.c_void_p])
# rows and keys of the unit on which the backward kernel masks or not
BWD_UNIT = 16


def _lib():
    lib = load_library("flash_attention")
    if not getattr(lib, "_typed", False):
        for fn, types in ((lib.flash_attention_f32, _ARGTYPES),
                          (lib.flash_attention_bf16, _BF16_ARGTYPES)):
            fn.argtypes = types
            fn.restype = ctypes.c_int
        for fn in (lib.flash_attention_smem_bytes,
                   lib.flash_attention_bf16_smem_bytes):
            fn.argtypes = [ctypes.c_int] * 3
            fn.restype = ctypes.c_ulonglong
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _visible(S, T, q_pos0, causal, window, device):
    """(S, T) bool: key t is visible to the query at position q_pos0 + s."""
    qpos = torch.arange(S, device=device)[:, None] + q_pos0
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _masked_scores(q, k, q_pos0, causal, window):
    """(B, h, S, T) fp32 scores of q's rows (positions q_pos0, q_pos0 + 1,
    ...) against all T keys, kv heads repeated over their group, scaled
    by 1/sqrt of q's width; keys a row does not see hold NEG_INF."""
    S, h, hd = q.shape[1:]
    T, hk = k.shape[1], k.shape[2]
    if h != hk:
        k = torch.repeat_interleave(k, h // hk, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / np.sqrt(hd)
    mask = _visible(S, T, q_pos0, causal, window, q.device)
    return torch.where(mask[None, None], s, NEG_INF)


def _attend(q, k, v, q_pos0, causal, window):
    """Rows of q at positions q_pos0, q_pos0 + 1, ... against all T keys:
    kv heads repeated over their group, one masked fp32 softmax (scale
    1/sqrt of q's width), the probabilities cast to v's dtype for the
    value product, over v's own width."""
    h, hk = q.shape[2], k.shape[2]
    if h != hk:
        v = torch.repeat_interleave(v, h // hk, dim=2)
    p = torch.softmax(_masked_scores(q, k, q_pos0, causal, window), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """The plain version, the reference's oracle ``kernels/ref.py::
    attention_ref``: kv heads repeated over their group, one masked fp32
    softmax over right-aligned queries (query i at position i + T - S),
    the probabilities cast to v's dtype for the value product.  A row
    with no visible key gets the uniform mean over all T keys, as
    there."""
    return _attend(q, k, v, k.shape[1] - q.shape[1], causal, window)


def flash_attention_lse_ref(q, k, *, causal=True, window=0):
    """(B, h, S) fp32: each query row's natural-log log-sum-exp of its
    scaled scores over the keys it sees (queries right-aligned, as
    ``flash_attention_ref``) -- what the kernel's forward writes for its
    backward when asked."""
    return torch.logsumexp(
        _masked_scores(q, k, k.shape[1] - q.shape[1], causal, window), dim=-1)


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
    temporary.  Plain PyTorch on any device: the oracle the backward
    kernel is held to (the gradient ``ops.flash_attention(impl="ref")``
    takes by autograd of ``flash_attention_ref``, here q-chunk by
    q-chunk), and what ``FlashAttention`` runs on meta tensors, so the
    dry run counts the reference's XLA loop.  No CUDA tensor reaches it
    on the training path: ``FlashAttention`` launches the kernel."""
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


# ---- the backward's schedule.  Rows are position-major across the g
# heads of a kv head's group (row r: position r // g + T - S, head
# r % g of the group), as both kernels take them.  The kernels
# (csrc/flash_attention_bwd.cu: rows_seeing, keys_seen, unit_state)
# repeat these three functions' arithmetic line for line.

def bwd_rows(k0, k1, S, T, g, causal, window):
    """Rows ``[lo, hi)`` that see some key of ``[k0, k1)`` (k1 <= T):
    the row range a dk/dv block walks."""
    off = T - S
    p_lo = k0 if causal else off
    p_hi = k1 - 1 + window - 1 if window > 0 else off + S - 1
    s_lo, s_hi = max(0, p_lo - off), min(S - 1, p_hi - off)
    return (s_lo * g, (s_hi + 1) * g) if s_lo <= s_hi else (0, 0)


def bwd_keys(r0, r1, S, T, g, causal, window):
    """Keys ``[lo, hi)`` that some row of ``[r0, r1)`` (r1 <= g S) sees:
    the key range a dq block walks."""
    off = T - S
    p_lo, p_hi = r0 // g + off, (r1 - 1) // g + off
    k_hi = min(T - 1, p_hi) if causal else T - 1
    k_lo = max(0, p_lo - window + 1) if window > 0 else 0
    return (k_lo, k_hi + 1) if k_lo <= k_hi else (0, 0)


def bwd_unit_state(r0, r1, k0, k1, S, T, g, causal, window):
    """Rows ``[r0, r1)`` against keys ``[k0, k1)`` (both within the valid
    ones): 0 when no pair is visible (the unit is skipped), 1 when every
    pair is (it runs unmasked), 2 otherwise (it is masked)."""
    if r0 >= r1 or k0 >= k1:
        return 0
    off = T - S
    p_lo, p_hi = r0 // g + off, (r1 - 1) // g + off
    if not ((not causal or k0 <= p_hi)
            and (window <= 0 or k1 - 1 > p_lo - window)):
        return 0
    full = ((not causal or k1 - 1 <= p_lo)
            and (window <= 0 or k0 > p_hi - window))
    return 1 if full else 2


def bwd_tiles(hd):
    """The bf16 backward kernel's tiles at q/k width ``hd``: keys a block
    (128: 64 for each of its two consumer warpgroups, the M of their
    products) and rows a staged Q/dO tile (64; 32 at MLA's 192, where dK
    and dV take most of a consumer thread's registers)."""
    return {"kv_keys": 128, "kv_rows": 32 if hd > 128 else 64}


# The forms at which the card checks the backward kernel against
# ``flash_attention_bwd_tiled`` (the card tests and chip_smoke.py's phase 2
# read this one list): every width pair, group sizes 1 to 48, causal
# right-aligned, windowed, non-causal with S > T and S < T, ragged tiles.
BWD_FORMS = (
    # B, S, T, h, hk, hd, hdv, causal, window
    (2, 128, 128, 4, 2, 64, 64, True, 0),
    (1, 96, 160, 4, 4, 64, 64, True, 0),       # right-aligned, S < T
    (2, 128, 128, 8, 2, 128, 128, True, 48),   # sliding window
    (1, 64, 64, 2, 1, 64, 64, False, 0),       # bidirectional, MQA
    (1, 33, 70, 2, 2, 64, 64, True, 0),        # ragged (padding paths)
    (1, 100, 37, 6, 2, 64, 64, False, 0),      # non-causal, S > T
    (1, 77, 77, 6, 2, 192, 128, True, 0),      # MLA's widths, g 3
    (2, 70, 90, 6, 2, 128, 128, False, 13),    # non-causal windowed, S < T
    (1, 300, 300, 48, 1, 128, 128, True, 0),   # granite's g 48
    # the key block's and the row tile's edges: T one past a 128-key block
    # (g S not a multiple of the tile; g 3: rows of a tile span positions),
    # several key blocks adding to one row tile in turn, MLA one past
    (1, 130, 130, 6, 2, 128, 128, True, 0),
    (2, 100, 129, 4, 1, 64, 64, False, 0),
    (1, 129, 129, 2, 2, 192, 128, True, 0),
    (1, 200, 520, 6, 2, 64, 64, True, 130),
)
# The kernel against the tiled version, as max |err| / max |grad|.  The
# two round P and dS to the same dtype and differ only in the order of
# their fp32 sums, so the bar sits below the one against autograd of the
# plain version (TRAIN_GRAD_TOL, 2e-2 in bf16): in bf16 it is about one
# ulp of an output near max |grad| (2^-8 to 2^-7 of it), twice the
# largest reading on an H100 (2.33e-3, at MLA's widths).
BWD_TILED_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


def _unit_mask(r0, r1, k0, k1, S, T, g, causal, window, device):
    """(r1 - r0, k1 - k0) visibility of a block of rows against a block of
    keys, built unit by unit from ``bwd_unit_state``: a skipped unit all
    False, an unmasked one all True, a masked one by position."""
    off = T - S
    pos = torch.arange(r0, r1, device=device) // g + off
    key = torch.arange(k0, k1, device=device)
    vis = torch.ones((r1 - r0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        vis &= key[None] <= pos[:, None]
    if window > 0:
        vis &= key[None] > pos[:, None] - window
    out = torch.zeros_like(vis)
    for u0 in range(r0 - r0 % BWD_UNIT, r1, BWD_UNIT):
        for w0 in range(k0 - k0 % BWD_UNIT, k1, BWD_UNIT):
            a, b = max(u0, r0), min(u0 + BWD_UNIT, r1)
            c, d = max(w0, k0), min(w0 + BWD_UNIT, k1)
            state = bwd_unit_state(a, b, c, d, S, T, g, causal, window)
            if state:
                out[a - r0:b - r0, c - k0:d - k0] = (
                    True if state == 1 else vis[a - r0:b - r0, c - k0:d - k0])
    return out


def flash_attention_bwd_tiled(q, k, v, out, lse, dout, *, causal=True,
                              window=0, tiles=None):
    """(dq, dk, dv) by the backward kernel's algorithm and schedule, in
    plain PyTorch (the CPU tests hold it to ``jax.grad`` of the reference's
    ``chunked_attention``; on the card the kernel is held to it).

    FlashAttention-2: D = rowsum(dout * out) in fp32, P = exp(S scale -
    lse) from the forward's log-sum-exp ``lse`` (B, h, S), dV = P^T dO
    with P rounded to v's dtype, dP = dO V^T, dS = P (dP - D), dQ = dS K
    scale and dK = dS^T Q scale with dS rounded to q's dtype; every sum
    in fp32.  As the kernel: by blocks of keys over the rows that see
    them (``bwd_rows``, in whole row tiles), each 16-row x 16-key unit
    unmasked or masked by ``bwd_unit_state``; a block's dQ partial (its
    keys' dS K, fp32) is added to the fp32 sum of dQ block by block in key
    order, and the sum is scaled and rounded once (at MLA's widths the
    kernel's dq kernel sums 64-key tiles in one fp32 accumulator, in the
    same key order).  ``tiles``: ``bwd_tiles``'s keys (by default the
    kernel's own at q's width)."""
    B, S, h, hd = q.shape
    tiles = tiles or bwd_tiles(hd)
    T, hk, hdv = k.shape[1], k.shape[2], v.shape[3]
    g, dev = h // hk, q.device
    scale = float(np.float32(1.0 / np.sqrt(hd)))

    def rows_of(x):                  # (B, S, h, W) -> (B, hk, g S, W)
        return x.reshape(B, S, hk, g, x.shape[3]).permute(
            0, 2, 1, 3, 4).reshape(B, hk, S * g, x.shape[3])

    qr, dor = rows_of(q), rows_of(dout)
    lse_r = lse.reshape(B, hk, g, S).transpose(2, 3).reshape(B, hk, S * g)
    dsum = (dor.float() * rows_of(out).float()).sum(-1)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)      # (B, hk, T, W)
    R = g * S

    dq = torch.zeros((B, hk, R, hd), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, hk, T, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, hk, T, hdv), dtype=torch.float32, device=dev)
    kb, qt = tiles["kv_keys"], tiles["kv_rows"]
    for k0 in range(0, T, kb):                 # key blocks in key order
        k1 = min(k0 + kb, T)
        lo, hi = bwd_rows(k0, k1, S, T, g, causal, window)
        if hi <= lo:
            continue
        r0, r1 = lo - lo % qt, min(R, -(-hi // qt) * qt)
        s = qr[:, :, r0:r1].float() @ kh[:, :, k0:k1].float().transpose(2, 3)
        x = s * scale - lse_r[:, :, r0:r1, None]
        vis = _unit_mask(r0, r1, k0, k1, S, T, g, causal, window, dev)
        p = torch.where(vis, torch.exp(x), torch.zeros((), device=dev))
        dp = dor[:, :, r0:r1].float() @ vh[:, :, k0:k1].float().transpose(2, 3)
        ds = (p * (dp - dsum[:, :, r0:r1, None])).to(q.dtype).float()
        dv[:, :, k0:k1] = p.transpose(2, 3).to(v.dtype).float() @ (
            dor[:, :, r0:r1].float())
        dk[:, :, k0:k1] = ds.transpose(2, 3) @ qr[:, :, r0:r1].float()
        dq[:, :, r0:r1] += ds @ kh[:, :, k0:k1].float()
    dq = (dq * scale).reshape(B, hk, S, g, hd).permute(0, 2, 1, 3, 4)
    return (dq.reshape(B, S, h, hd).to(q.dtype),
            (dk * scale).transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B,S,h,hd) and k, v (B,T,hk,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, S, h, hd = q.shape
    T, hk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if v.dim() != 4 or tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError(f"v has shape {tuple(v.shape)}; it must have k's "
                         f"batch, length and heads {tuple(k.shape[:3])}")
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


def flash_attention(q, k, v, *, causal=True, window=0, block_q=None,
                    block_kv=None):
    """q: (B, S, h, hd); k: (B, T, hk, hd); v: (B, T, hk, hdv) with
    h % hk == 0 -> (B, S, h, hdv) in q's dtype.  Query i sits at
    position i + T - S; key t is visible to it iff t <= i + T - S (when
    ``causal``) and t > i + T - S - window (when ``window`` > 0).
    Scores and softmax in fp32, scale 1/sqrt(hd).  The kernel takes the
    (hd, hdv) pairs of ``KERNEL_WIDTHS``.

    CPU tensors take the plain version (its autograd is the gradient's
    oracle); CUDA tensors launch the kernel, which reads k and v through
    their batch and sequence strides (a slice of a larger cache is not
    copied).  When grad mode is on and an input requires grad, the
    launch goes through ``FlashAttention``, whose backward launches the
    backward kernel (``flash_attention_bwd``).  Raises on a causal call
    with S > T, whose first rows would see no key.  ``block_q`` /
    ``block_kv``: the
    launch's block shape (``launch_layout``); None reads the surface of
    ``ops.set_flash_blocks``.  The plain version takes no blocks."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, block_q,
                                    block_kv)
    return _launch(q, k, v, causal, window, block_q, block_kv)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward with a gradient: the forward launches
    ``csrc/flash_attention.cu`` asking for the rows' log-sum-exp and saves
    q, k, v, the output and the log-sum-exp; the backward launches
    ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``).  On meta
    tensors (the dry run) the backward is ``flash_attention_bwd_ref``, so
    the count is the reference's XLA loop's."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q=None, block_kv=None):
        out, lse = _launch(q, k, v, causal, window, block_q, block_kv,
                           with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "meta":
            dq, dk, dv = flash_attention_bwd_ref(
                q, k, v, dout, causal=ctx.causal, window=ctx.window)
        else:
            dq, dk, dv = flash_attention_bwd(
                q, k, v, out, lse, dout, causal=ctx.causal,
                window=ctx.window)
        return dq, dk, dv, None, None, None, None


def meta_cost(B, S, T, h, hd, hdv, v_bytes):
    """(FLOPs, dot bytes) the dry run charges a call: the two products
    of the plain version (``_attend``), the masked half included, as
    the reference's XLA loop computes them -- fp32 scores of q (B, S,
    h, hd) against the repeated k (B, T, h, hd), then the probabilities
    in v's dtype (``v_bytes`` an element) against the repeated v (B, T,
    h, hdv)."""
    flops = 2 * B * h * S * T * (hd + hdv)
    dot = (4 * (B * S * h * hd + B * T * h * hd + B * h * S * T)
           + v_bytes * (B * h * S * T + B * T * h * hdv + B * S * h * hdv))
    return flops, dot


def resolve_blocks(block_q=None, block_kv=None):
    """A launch's ``(block_q, block_kv)``: the call's own where given,
    else the block surface's (``ops.get_flash_blocks``)."""
    from repro_torch.kernels.ops import get_flash_blocks
    surface_q, surface_kv = get_flash_blocks()
    return (surface_q if block_q is None else block_q,
            surface_kv if block_kv is None else block_kv)


def launch_layout(dtype, B, S, T, h, hk, block_q=None, block_kv=None):
    """The layout argument of a launch: ``(rows a thread,)`` for fp32,
    ``(warps, splits)`` for bf16 (``gqa_split.plan``).  ``block_q`` /
    ``block_kv`` None keep the plan; a set value the kernel was not
    built for raises ``ValueError`` naming the legal set."""
    if dtype != torch.float32:
        return gqa_split.plan(B * hk, (h // hk) * S, T, block_q=block_q,
                              block_kv=block_kv)
    if block_kv is not None:
        raise ValueError(f"flash_attention: block_kv={block_kv}, but the "
                         "fp32 kernel does not split the keys (each block "
                         "walks all of them); legal: None")
    if block_q is None:
        return (4 if (h // hk) * S >= SMALL_ROWS else 1,)
    if block_q not in F32_BLOCK_Q:
        raise ValueError(f"flash_attention: fp32 block_q={block_q} is not "
                         f"built; legal: None or {sorted(F32_BLOCK_Q)}")
    return (F32_BLOCK_Q[block_q],)


def block_choices(dtype, T):
    """Every block shape the kernel is built for at T keys, as ``(block_q,
    block_kv)`` pairs: the plan's (None, None), each ``block_q`` with
    ``block_kv`` None, and for bf16 the 16-row blocks once for each split
    count a ``block_kv`` can give (the smallest ``block_kv`` giving it)."""
    if dtype == torch.float32:
        return [(None, None)] + [(bq, None) for bq in sorted(F32_BLOCK_Q)]
    out = [(None, None)] + [(bq, None) for bq in sorted(gqa_split.ROWS.values())]
    tile, seen = gqa_split.KEY_TILE[1], set()
    least = tile * -(-T // (tile * gqa_split.MAX_SPLITS))
    for block_kv in range(least, -(-T // tile) * tile + 1, tile):
        splits = -(-T // block_kv)
        if splits not in seen:
            seen.add(splits)
            out.append((gqa_split.ROWS[1], block_kv))
    return out


def _check_cuda(q, k, v, name="flash_attention"):
    """Refuse what the CUDA kernels do not take: another device or dtype,
    other widths, a non-contiguous q, k or v rows not 16-byte aligned or
    not unit-strided within a row."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: all operands must share a device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: k and v must have q's dtype")
    hd, hdv = q.shape[3], v.shape[3]
    if (hd, hdv) not in KERNEL_WIDTHS:
        raise ValueError(f"{name}: head_dim {hd} with v width {hdv} "
                         f"not built (kernel widths {KERNEL_WIDTHS})")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    vec = 16 // q.element_size()
    for label, t, width in (("k", k, hd), ("v", v, hdv)):
        if t.stride(3) != 1 or t.stride(2) != width:
            raise ValueError(f"{name}: {label} must have unit dim "
                             f"stride and head stride {width}; got strides "
                             f"{t.stride()}")
        if t.stride(0) % vec or t.stride(1) % vec or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label}'s rows must be "
                             "16-byte aligned (vector loads)")
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be 16-byte aligned")


def _launch(q, k, v, causal, window, block_q=None, block_kv=None,
            with_lse=False):
    """One launch of the kernel on CUDA tensors, checked, in the block
    shape of ``block_q`` / ``block_kv`` (None: the surface's,
    ``ops.get_flash_blocks``).  ``with_lse``: also return each row's
    log-sum-exp, (B, h, S) fp32 (the output is the same bit for bit).  A
    meta tensor (the dry run, ``launch.dryrun``) launches nothing: it
    charges ``meta_cost`` to the running count and returns empty outputs
    of the kernel's shapes."""
    B, S, h, hd = q.shape
    T, hk, hdv = k.shape[1], k.shape[2], v.shape[3]
    if q.device.type == "meta":
        add_kernel_cost(*meta_cost(B, S, T, h, hd, hdv, v.element_size()))
        out = q.new_empty((B, S, h, hdv))
        return ((out, q.new_empty((B, h, S), dtype=torch.float32))
                if with_lse else out)
    _check_cuda(q, k, v)
    layout = launch_layout(q.dtype, B, S, T, h, hk,
                           *resolve_blocks(block_q, block_kv))
    lib = _lib()
    if q.dtype == torch.float32:
        fn = lib.flash_attention_f32
        smem = lib.flash_attention_smem_bytes(hd, hdv, *layout)
    else:
        fn = lib.flash_attention_bf16
        smem = lib.flash_attention_bf16_smem_bytes(hd, hdv, layout[0])
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_attention: widths ({hd}, {hdv}) need {smem} "
                         "B of shared memory")
    out = q.new_empty((B, S, h, hdv))
    lse = (torch.empty((B, h, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, S, T, h, hk, hd, hdv, k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), int(bool(causal)), int(window), *layout, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    count_launch("flash_attention")
    return (out, lse) if with_lse else out


def _bwd_lib(device):
    """The backward's library, its shared-memory sizes set on ``device``
    (once a device: ``flash_attention_bwd_init`` acts on the current one)."""
    lib = load_library("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        for fn in (lib.flash_attention_bwd_f32, lib.flash_attention_bwd_bf16):
            fn.argtypes = _BWD_ARGTYPES
            fn.restype = ctypes.c_int
        lib.flash_attention_bwd_init.argtypes = []
        lib.flash_attention_bwd_init.restype = ctypes.c_int
        lib.flash_attention_bwd_bf16_workspace.argtypes = [ctypes.c_int] * 5
        lib.flash_attention_bwd_bf16_workspace.restype = ctypes.c_ulonglong
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        lib._devices = set()
        lib._typed = True
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in lib._devices:
        with torch.cuda.device(index):
            rc = lib.flash_attention_bwd_init()
        if rc != 0:
            raise RuntimeError(
                "flash_attention_bwd: setting shared memory failed: "
                + lib.flash_attention_bwd_error_string(rc).decode())
        lib._devices.add(index)
    return lib


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0):
    """(dq, dk, dv) of ``flash_attention`` in q's, k's and v's dtypes, from
    the forward's output ``out`` and its rows' log-sum-exp ``lse`` (B, h,
    S) fp32, for the output gradient ``dout``.  Every form the forward
    takes.  CUDA tensors launch ``csrc/flash_attention_bwd.cu`` (bf16: the
    row statistics, the warp-specialised gradient kernel with dQ summed in
    key-block order in a workspace, dQ's rounding; fp32: dq, then
    dk/dv; one count) or raise, with the forward's checks; k and v are
    read through their batch and sequence strides.  CPU tensors take
    ``flash_attention_bwd_tiled``, the same algorithm in plain PyTorch."""
    _check(q, k, v, causal)
    B, S, h, hd = q.shape
    T, hk, hdv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(out.shape) != (B, S, h, hdv) or tuple(dout.shape) != tuple(
            out.shape):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must be {(B, S, h, hdv)}")
    if tuple(lse.shape) != (B, h, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be (B, h, S) = "
                         f"{(B, h, S)} fp32; got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if q.device.type == "cpu":
        return flash_attention_bwd_tiled(q, k, v, out, lse, dout,
                                         causal=causal, window=window)
    _check_cuda(q, k, v, "flash_attention_bwd")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError("flash_attention_bwd: out and dout must have q's "
                        "dtype")
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    for name, t in (("out", out), ("dout", dout), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be 16-byte "
                             "aligned")
    lib = _bwd_lib(q.device)
    dq = torch.empty_like(q)
    dk = torch.empty((B, T, hk, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, T, hk, hdv), dtype=q.dtype, device=q.device)
    if q.dtype == torch.float32:
        fn = lib.flash_attention_bwd_f32
        scratch = torch.empty((B, h, S), dtype=torch.float32, device=q.device)
    else:
        fn = lib.flash_attention_bwd_bf16
        scratch = torch.empty(lib.flash_attention_bwd_bf16_workspace(
            B, S, h, hk, hd), dtype=torch.uint8, device=q.device)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, T, h, hk, hd, hdv,
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            int(bool(causal)), int(window), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention_bwd launch failed: "
                           + lib.flash_attention_bwd_error_string(rc).decode())
    count_launch("flash_attention_bwd")
    return dq, dk, dv
