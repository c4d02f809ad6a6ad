"""Attention for the serving and training paths: GQA (qk-norm, RoPE)
and MLA.

Port of ``repro.models.attention``.  Two cache forms:
- the paged pool of the continuous engine: K/V in a shared token-major
  page pool ``(num_pages * page_size, kv_heads, head_dim)`` with no
  batch axis, and a per-slot page table (``PagedView``) mapping each
  slot's logical positions to physical pool rows.  DeepSeek-V3's
  multi-head latent attention (MLA) pools its compressed latent
  instead: ``{"ckv": (N, kv_lora), "krope": (N, rope)}``, read by the
  absorbed decode (queries projected into the latent, which is also
  the value).  ``repro_torch.serve.kvcache`` owns allocation; this
  module owns the read and write paths.  Page 0 is the trash page:
  never allocated, the write sink of idle slots and out-of-range
  positions.
- the slab cache of the lockstep engine: k and v of ``(B, max_len,
  kv_heads, head_dim)`` (MLA: ``{"ckv": (B, max_len, kv_lora),
  "krope": (B, max_len, rope)}``), all slots at the same depth (a
  scalar ``cache_pos``).  Its attention is ``chunked_attention``, which
  on the card runs the flash-attention kernel; MLA's slab decode is the
  absorbed form in plain ops, as in the reference.

The train branches have no cache: the queries attend causally over
their own keys through ``chunked_attention`` (MLA: the latent expanded
to per-head keys of nope + rope and values of ``v_head_dim``); an
encoder's, bidirectionally.

Cross-attention (``apply_cross_attention``, an encoder-decoder's
decoder layers): queries from the decoder, keys and values projected
from the encoder's output, no RoPE and no mask; its cache (``{"k",
"v"}`` of (B, cross_len, hk, hd)) holds the encoder's K/V, written by
the prefill and read whole by every decode step.  The paged pool has no
cross form.

On a mesh (``apply_attention_mesh``, the train forward of DTensor
masters): when the rule splits the query heads over ``"model"``, each
rank projects its own heads (``wq`` column-parallel, and ``wk`` / ``wv``
too when the kv heads divide; else every kv head is projected,
replicated, and each rank keeps those its q heads read), runs the
attention core -- the flash kernel on the card -- on its local heads,
and ``wo`` is row-parallel, its partial sums all-reduced over
``"model"``.  Otherwise (the head_dim fallback) the weights are
gathered and the layer runs replicated.

Serving on a mesh (a serve topology registered, ``sharding.ctx``) takes
the same form in the paged and slab branches.  Paged: the pool holds
this rank's block of each leaf (``ctx.Placed``); where the kv heads are
cut, k / v are projected column-parallel and the paged kernel runs on
the rank's own heads against its own shard; where the pool is cut on
head_dim (fewer kv heads than ``"model"``), every rank projects every
kv head, writes its head_dim block of the new k / v, and the pages of
the call's slots are gathered over ``"model"`` before the kernel
(``ctx.gather_pages``).  MLA's latent and rope pools are cut on their
widths: ``apply_mla`` writes its block and reads the slots' pages
gathered, with its weights gathered and the kernel replicated.  Slab:
the layer reads its cache gathered over ``"model"`` (``transformer``),
projects every kv head and attends on its own q heads.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode import (paged_flash_decode,
                                              paged_flash_decode_mla,
                                              paged_flash_decode_mla_ref,
                                              paged_flash_decode_ref)
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.comm import copy_to, reduce_from, shard_dims, use

MODEL = ("model",)

NEG_INF = -1e30


class PagedView(NamedTuple):
    """How a decode-mode model call reads a paged KV cache.

    page_table -- (B, table_width) int32 tensor: physical page id of each
                  slot's logical block (0 = the reserved trash page).
    page_size  -- tokens per page.
    """
    page_table: Any
    page_size: int


# --------------------------------------------------------------------------
# per-query-position attention core (the plain path the kernel replaces)
# --------------------------------------------------------------------------

def masked_attention(q, k, v, *, q_positions, kv_positions, window=0):
    """q: (B, S, h, hd); k, v: (B, T, hk, hd); q_positions: (B, S);
    kv_positions: (T,).  Key t is visible to query (b, s) iff
    ``kv_positions[t] <= q_positions[b, s]`` (and within the sliding
    window when set).  Scores and softmax in fp32; the probabilities are
    cast to v's dtype for the value product, as in the reference."""
    B, S, h, hd = q.shape
    hk = k.shape[2]
    g = h // hk
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, S, hk, g, hd).permute(0, 2, 3, 1, 4)
    s = torch.einsum("bkgqd,btkd->bkgqt", qg.float(), k.float()) * scale
    m = kv_positions[None, None, :] <= q_positions[:, :, None]   # (B,S,T)
    if window:
        m &= kv_positions[None, None, :] > q_positions[:, :, None] - window
    m &= q_positions[:, :, None] >= 0
    s = torch.where(m[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype), v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, h, v.shape[-1])


# --------------------------------------------------------------------------
# chunked softmax attention core (slab prefill and slab decode)
# --------------------------------------------------------------------------

def _positions(pos, device):
    return (torch.arange(pos.start, pos.stop, pos.step, device=device)
            if isinstance(pos, range) else torch.as_tensor(pos, device=device))


def chunked_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                      window=0, kv_valid_len=None, chunk=1024):
    """q: (B, S, h, hd); k, v: (B, T, hk, hd).  Returns (B, S, h, hd_v).

    q_positions: (S,) global positions of the queries; kv_positions:
    (T,) of the keys (tensors or ``range``s).  kv_valid_len: keys at
    positions >= it are masked (the unwritten tail of a decode cache).

    CPU tensors run the reference's loop: queries in chunks of
    ``chunk`` (padded to a multiple of it with position -1), fp32
    scores, one masked softmax over all T keys per chunk, the
    probabilities cast to v's dtype for the value product.

    CUDA tensors run the flash-attention kernel, for the two forms the
    slab and train paths give, with ``kv_positions = range(T)`` and the
    valid length ``kv_valid_len`` (or T) as a ``range`` and an int:
    causal (or windowed), ``q_positions = range(off, off + S)`` with
    ``off + S`` the valid length -- the queries right-aligned against
    the valid keys, which is the kernel's masking; and non-causal
    without a window (an encoder, cross-attention), with any query
    positions, which that mask does not read.  The keys are sliced to
    the valid length (a strided view, not a copy); meta tensors (the
    dry run) take that form too.  Any other form raises (positions on
    the card cannot be checked without a host sync in every layer).
    ``chunk`` is the CPU loop's; the kernel tiles itself."""
    if q.device.type in ("cuda", "meta"):
        return _flash_slab(q, k, v, q_positions=q_positions,
                           kv_positions=kv_positions, causal=causal,
                           window=window, kv_valid_len=kv_valid_len)
    return chunked_attention_loop(q, k, v, q_positions=q_positions,
                                  kv_positions=kv_positions, causal=causal,
                                  window=window, kv_valid_len=kv_valid_len,
                                  chunk=chunk)


def chunked_attention_loop(q, k, v, *, q_positions, kv_positions,
                           causal=True, window=0, kv_valid_len=None,
                           chunk=1024):
    """The reference's ``chunked_attention`` loop in plain PyTorch, on
    the tensors' own device (what ``chunked_attention`` runs on the CPU,
    and ``ops.flash_attention(impl="chunked")`` on any device): queries
    in chunks of ``chunk`` (padded to a multiple of it with position
    -1), fp32 scores, one masked softmax over all T keys per chunk, the
    probabilities cast to v's dtype for the value product."""
    B, S, h, hd = q.shape
    T, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / np.sqrt(hd)
    qpos_all = _positions(q_positions, q.device)
    kv_pos = _positions(kv_positions, q.device)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        qpos_all = torch.cat([qpos_all, qpos_all.new_full((pad,), -1)])
    nc = q.shape[1] // chunk
    qg = q.reshape(B, nc, chunk, hk, g, hd).permute(1, 0, 3, 4, 2, 5)
    kf = k.float()
    outs = []
    for c in range(nc):
        qpos = qpos_all[c * chunk:(c + 1) * chunk]
        s = torch.einsum("bkgqd,btkd->bkgqt", qg[c].float(), kf) * scale
        m = torch.ones((chunk, T), dtype=torch.bool, device=q.device)
        if causal:
            m &= kv_pos[None, :] <= qpos[:, None]
        if window:
            m &= kv_pos[None, :] > qpos[:, None] - window
        if kv_valid_len is not None:
            m &= kv_pos[None, :] < kv_valid_len
        m &= qpos[:, None] >= 0                          # query padding
        s = torch.where(m[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype), v))
    out = torch.stack(outs)                          # (nc, B, hk, g, Cq, hd_v)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, nc * chunk, h,
                                                v.shape[-1])
    return out[:, :S]


def _flash_slab(q, k, v, *, q_positions, kv_positions, causal, window,
                kv_valid_len):
    """``chunked_attention`` on the card: the slab form (causal or
    windowed) or the non-causal form, checked on the host, as one
    flash-attention call on the valid keys."""
    S, T = q.shape[1], k.shape[1]
    valid = T if kv_valid_len is None else kv_valid_len
    keys_ok = (isinstance(kv_positions, range) and isinstance(valid, int)
               and kv_positions == range(T) and 0 < valid <= T)
    if keys_ok and not causal and not window:
        return flash_attention(q, k[:, :valid], v[:, :valid], causal=False)
    if not (keys_ok and causal and isinstance(q_positions, range)
            and q_positions == range(valid - S, valid)):
        raise ValueError(
            "chunked_attention on the card takes the slab form: "
            "kv_positions == range(T) and q_positions == range(off, off + "
            "S) with off + S == kv_valid_len (or T), as ranges and an int, "
            "causal; or non-causal with no window over kv_positions == "
            f"range(T); got causal={causal}, window={window}, q_positions="
            f"{q_positions!r}, kv_positions={kv_positions!r}, kv_valid_len="
            f"{kv_valid_len!r} (S={S}, T={T})")
    return flash_attention(q, k[:, :valid], v[:, :valid], causal=True,
                           window=window)


# --------------------------------------------------------------------------
# paged decode attention: the kernel or the plain version
# --------------------------------------------------------------------------

def decode_kernel_for(cfg, device) -> str:
    """The paged decode attention a call on ``device`` runs under
    ``cfg.decode_kernel``: "cuda" (the kernel) or "plain" (the plain
    version over the gathered pages).  "auto" follows the device (the
    kernel but on the CPU); "cuda" on the CPU raises."""
    kind = cfg.decode_kernel
    on_cpu = torch.device(device).type == "cpu"
    if kind == "auto":
        return "plain" if on_cpu else "cuda"
    if kind == "cuda" and on_cpu:
        raise ValueError("decode_kernel=\"cuda\" launches the paged-decode "
                         "kernel and needs a CUDA pool; the pool is on the "
                         "CPU (use \"auto\" or \"plain\")")
    return kind


def _paged(cfg, kernel, plain, *args, **kw):
    """``kernel(*args, **kw)`` or ``plain(...)``, by ``decode_kernel_for``
    on the device of the first argument."""
    use = decode_kernel_for(cfg, args[0].device) == "cuda"
    return (kernel if use else plain)(*args, **kw)


# --------------------------------------------------------------------------
# paged-pool addressing
# --------------------------------------------------------------------------

def paged_write_indices(paged: PagedView, positions):
    """(B, S) logical positions -> (B, S) int64 physical pool rows.
    Out-of-range and negative positions map to the trash page (page 0),
    so padded lanes and idle slots write harmlessly."""
    table = paged.page_table
    bs = paged.page_size
    width = table.shape[1]
    pos = positions.clamp(0, width * bs - 1).long()
    phys = torch.gather(table.long(), 1, pos // bs) * bs + pos % bs
    valid = (positions >= 0) & (positions < width * bs)
    return torch.where(valid, phys, torch.zeros_like(phys))


def paged_read(pool_leaf, paged: PagedView):
    """Gather a slot-major view (B, W * page_size, ...) out of a
    token-major pool (N, ...), page by page.  Unallocated blocks gather
    the trash page; the causal mask kills those positions.  Returns the
    view and its logical positions (W * page_size,)."""
    table = paged.page_table
    bs = paged.page_size
    B, width = table.shape
    pages = pool_leaf.reshape((pool_leaf.shape[0] // bs, bs)
                              + tuple(pool_leaf.shape[1:]))
    full = pages[table.long()]                            # (B, W, bs, ...)
    return (full.reshape((B, width * bs) + tuple(pool_leaf.shape[1:])),
            torch.arange(width * bs, device=pool_leaf.device))


def _paged_append(pool_leaf, write_idx, new):
    """Scatter S new per-slot entries (B, S, ...) into the pool at the
    (B, S) rows ``paged_write_indices`` gave (computed once per model
    call: every layer writes the same rows of its own pool).

    Unlike the reference's functional ``.at[].set``, the pool is updated
    IN PLACE (``index_copy_``): the serving pool is the largest tensor
    on the card, and a copy per layer per step would double its traffic.
    Duplicate rows only ever target the trash page, whose content is
    never read unmasked.  Returns the pool."""
    flat = new.reshape((-1,) + tuple(new.shape[2:])).to(pool_leaf.dtype)
    return pool_leaf.index_copy_(0, write_idx.reshape(-1), flat)


def _paged_update(cache, new, write_idx, paged, comm=None):
    """Write the new entries {name: (B, S, ...)} into their pooled
    leaves and return (the pools to read, in ``new``'s order, and their
    ``PagedView``).  On a mesh (``cache`` a ``ctx.Placed``), an entry
    computed whole on every rank of the model group is cut to this
    rank's block of its leaf before the write, and the pages the call's
    slots map are then gathered whole for the read; an entry already at
    the block's width (column-parallel k / v of a heads-cut pool) is
    written and read as the rank's own."""
    split = getattr(cache, "split", {})
    cut = False
    for name, t in new.items():
        dim = split.get(name)
        if dim is not None and t.shape[dim + 1] != cache[name].shape[dim]:
            t = shctx.own_update(t, comm, dim + 1)
            cut = True
        _paged_append(cache[name], write_idx, t)
    pools = [cache[name] for name in new]
    if not cut:
        return pools, paged
    pools, table = shctx.gather_pages(pools, paged.page_table,
                                      paged.page_size, comm,
                                      [split.get(n) for n in new])
    return pools, PagedView(table, paged.page_size)


# --------------------------------------------------------------------------
# GQA attention layer
# --------------------------------------------------------------------------

def _padded_heads(cfg):
    """(h_padded, real_head_mask or None).  Each kv head's group is
    padded at its END, so GQA grouping stays aligned and the padded
    heads are exact zeros."""
    h, hk = cfg.num_heads, cfg.num_kv_heads
    if not cfg.pad_heads_to or cfg.pad_heads_to == h:
        return h, None
    hp = cfg.pad_heads_to
    if hp % hk or hp <= h:
        raise ValueError(f"pad_heads_to={hp} must exceed num_heads={h} "
                         f"and divide by num_kv_heads={hk}")
    g_old, g_new = h // hk, hp // hk
    mask = np.zeros((hp,), np.float32)
    for i in range(hk):
        mask[i * g_new:i * g_new + g_old] = 1.0
    return hp, mask


def init_attention(cfg, *, generator, device="cpu", dtype, cross=False):
    """Weights in the reference's layout, projections cast to ``dtype``
    as drawn: wq (d, h, hd), wk/wv (d, hk, hd), wo (h, hd, d), the qkv
    biases (``qkv_bias``; never for ``cross``-attention, as in the
    reference), qk-norm scales (hd,) in fp32."""
    d, hk, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    h, mask = _padded_heads(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)
    # the padded heads' zeros are part of the draw (a leaf a mesh places
    # as it is drawn, ``bridge.mesh_placer``)
    rows = None if mask is None else np.repeat(mask, hd)
    wq = dense_init(d, h * hd, scale=None if rows is None else rows[None],
                    **kw).reshape(d, h, hd)
    wk = dense_init(d, hk * hd, **kw).reshape(d, hk, hd)
    wv = dense_init(d, hk * hd, **kw).reshape(d, hk, hd)
    wo = dense_init(h * hd, d, scale=None if rows is None else rows[:, None],
                    **kw).reshape(h, hd, d)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((h, hd), device=device, dtype=dtype)
        p["bk"] = torch.zeros((hk, hd), device=device, dtype=dtype)
        p["bv"] = torch.zeros((hk, hd), device=device, dtype=dtype)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), device=device)}
        p["k_norm"] = {"scale": torch.ones((hd,), device=device)}
    return p


def make_cache(cfg, dtype, *, pool=None, batch=None, max_len=None,
               device="cpu"):
    """One layer's KV cache: with ``pool`` = (num_pages, page_size) the
    paged pool, token-major k and v of (N, hk, hd); without it the slab,
    k and v of (batch, max_len, hk, hd)."""
    if pool is not None:
        num_pages, page_size = pool
        shape = (num_pages * page_size, cfg.num_kv_heads, cfg.head_dim)
    else:
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, nh, hd = w.shape
    return (x @ w.reshape(d, nh * hd)).unflatten(-1, (nh, hd))


def _q(cfg, p, x):
    """q (B, S, h, hd) of x: projection, bias, qk-norm (no RoPE)."""
    q = _proj(x, p["wq"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    return q


def _kv(cfg, p, src):
    """k and v (B, T, hk, hd) of src: projections, bias, qk-norm on k
    (no RoPE)."""
    dt = src.dtype
    k = _proj(src, p["wk"].to(dt))
    v = _proj(src, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def _qkv(cfg, p, x, rope):
    """q (B, S, h, hd), k and v (B, S, hk, hd) of x: projections, bias,
    qk-norm, then RoPE on q and k by ``rope`` (``rope_angles``).  Each
    weight is cast to x's dtype at use (a no-op for a serving model)."""
    k, v = _kv(cfg, p, x)
    return apply_rope(_q(cfg, p, x), rope), apply_rope(k, rope), v


def _out(cfg, p, out):
    """The padded-head mask, then wo."""
    _, head_mask = _padded_heads(cfg)
    if head_mask is not None:
        out = out * torch.from_numpy(head_mask).to(out)[None, None, :, None]
    B, S, h, hd = out.shape
    return out.reshape(B, S, h * hd) @ p["wo"].to(out.dtype).reshape(h * hd,
                                                                      -1)


def apply_attention(cfg, p, x, *, positions, cache, rope, paged=None,
                    write_idx=None, mode="decode", cache_pos=0, causal=True):
    """Self-attention over the serving cache, or without one in training.
    Order as in the reference: qk-norm on q and k, RoPE, cache write,
    attention, the padded-head mask, wo.

    Train (``mode="train"``, no cache, ``paged`` None): x (B, S, d) at
    positions 0..S-1, causal attention of the S queries over their own
    S keys through ``chunked_attention`` (the flash kernel on the card,
    differentiable); with ``causal`` False (an encoder), every query
    sees every key and the sliding window does not apply.

    Paged (``paged`` given; decode steps and prefill chunks): x (B, S,
    d), positions (B, S) per slot; cache {"k", "v"} pools, updated in
    place at ``write_idx`` (``paged_write_indices``); attention through
    ``paged_flash_decode``, or its plain version, by ``cfg.decode_kernel``
    (``decode_kernel_for``).

    Slab (``paged`` None): cache {"k", "v"} of (B, max_len, hk, hd),
    updated in place.  ``mode="prefill"`` writes the S new keys at 0 and
    attends over them; ``mode="decode"`` writes them at the scalar
    ``cache_pos`` and attends over the cache's first cache_pos + S keys.
    Both through ``chunked_attention`` (the flash kernel on the card).
    rope: ``rope_angles`` of the call's positions."""
    q, k, v = _qkv(cfg, p, x, rope)
    return _out(cfg, p, _attend(cfg, q, k, v, positions=positions,
                                cache=cache, paged=paged,
                                write_idx=write_idx, mode=mode,
                                cache_pos=cache_pos, causal=causal))


def _seq_keys(k, v, comm):
    """Under the sequence split (``ctx.seq_cut``) the keys and values of
    the blocks up to this rank's, gathered over ``"data"``; else as
    they are.  The block's queries then sit right-aligned against them."""
    if comm is None or not shctx.is_seq_cut():
        return k, v
    return shctx.seq_prefix(k, comm), shctx.seq_prefix(v, comm)


def _attend(cfg, q, k, v, *, positions, cache, paged, write_idx, mode,
            cache_pos, causal, heads=None, comm=None):
    """``apply_attention``'s core on q (B, S, h, hd) and the new k, v (B,
    S, hk, hd) after RoPE: the cache write and the attention, by mode.
    ``heads`` (a slice or an index list) picks the kv heads the q heads
    read out of k / v / the pools (a mesh form's local q heads), after
    the write; ``comm`` places a pool's write and read on a mesh
    (``_paged_update``)."""
    pick = (lambda t, dim: t) if heads is None else (    # noqa: E731
        lambda t, dim: t[(slice(None),) * dim + (heads,)].contiguous())
    dt = q.dtype
    if mode == "train":
        k, v = _seq_keys(k, v, comm)
        S, T = q.shape[1], k.shape[1]
        return chunked_attention(q, pick(k, 2), pick(v, 2),
                                 q_positions=range(T - S, T),
                                 kv_positions=range(T), causal=causal,
                                 window=cfg.swa_window if causal else 0)
    if paged is not None:
        (k_pool, v_pool), view = _paged_update(cache, {"k": k, "v": v},
                                               write_idx, paged, comm)
        return _paged(cfg, paged_flash_decode, paged_flash_decode_ref, q,
                      pick(k_pool, 1).to(dt), pick(v_pool, 1).to(dt),
                      view.page_table, positions, page_size=view.page_size,
                      window=cfg.swa_window)
    S, max_len = q.shape[1], cache["k"].shape[1]
    start = 0 if mode == "prefill" else int(cache_pos)
    if start + S > max_len:
        raise ValueError(f"slab attention: {S} keys at {start} overrun "
                         f"a {max_len}-long cache")
    cache["k"][:, start:start + S] = k
    cache["v"][:, start:start + S] = v
    if mode == "prefill":
        return chunked_attention(q, pick(k, 2), pick(v, 2),
                                 q_positions=range(S), kv_positions=range(S),
                                 window=cfg.swa_window)
    return chunked_attention(
        q, pick(cache["k"], 2).to(dt), pick(cache["v"], 2).to(dt),
        q_positions=range(start, start + S), kv_positions=range(max_len),
        window=cfg.swa_window, kv_valid_len=start + S)


def apply_cross_attention(cfg, p, x, *, enc_out, cache):
    """An encoder-decoder layer's cross-attention (the reference's
    ``apply_attention(kv_src=...)``, whose ``rope`` follows ``causal``:
    none here).  q from x (B, S, d); k and v projected from ``enc_out``
    (B, S_src, d) when it is given -- train and prefill, the latter
    also writing them at rows 0..S_src-1 of ``cache`` -- else (decode)
    read from the whole of ``cache``, {"k", "v"} of (B, cross_len, hk,
    hd): every one of its cross_len rows is visible, the zero rows past
    a shorter source too, as in the reference.  No mask and no window;
    through ``chunked_attention`` (the flash kernel's non-causal form
    on the card), whose queries' positions mask nothing."""
    q = _q(cfg, p, x)
    if enc_out is not None:
        k, v = _kv(cfg, p, enc_out.to(x.dtype))
        if cache is not None:
            n = k.shape[1]
            if n > cache["k"].shape[1]:
                raise ValueError(f"cross-attention: a {n}-frame source "
                                 f"overruns a {cache['k'].shape[1]}-long "
                                 "cross cache")
            cache["k"][:, :n] = k
            cache["v"][:, :n] = v
    elif cache is not None:
        k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    else:
        raise ValueError("cross-attention needs the encoder's output or a "
                         "filled cross cache")
    out = chunked_attention(q, k, v, q_positions=range(x.shape[1]),
                            kv_positions=range(k.shape[1]), causal=False,
                            window=0)
    return _out(cfg, p, out)


def _local_kv_heads(h_loc, first, group):
    """The kv heads that q heads ``first .. first + h_loc - 1`` read (q
    head i reads kv head i // group), as (slice, local group) when they
    read a contiguous run evenly, else (per-q-head index list, 1)."""
    idx = [(first + j) // group for j in range(h_loc)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if h_loc % n == 0 and idx == [lo + j // (h_loc // n)
                                  for j in range(h_loc)]:
        return slice(lo, lo + n), h_loc // n
    return idx, 1


def apply_attention_mesh(cfg, p, x, comm, *, rope, causal=True,
                         positions=None, cache=None, paged=None,
                         write_idx=None, mode="train", cache_pos=0):
    """``apply_attention`` of DTensor weights ``p`` on x (B, S, d)
    replicated over ``"model"`` (module docstring), in any of its modes.
    The replicated-kv form projects k and v outside the tensor-parallel
    region, so their weights' gradients stay replicated; the q / k norm
    scales used inside it sum their gradients over ``"model"``.  A slab
    cache (read whole over ``"model"``) takes every kv head, so its kv
    form is the replicated one."""
    core = dict(positions=positions, cache=cache, paged=paged,
                write_idx=write_idx, mode=mode, cache_pos=cache_pos,
                causal=causal, comm=comm)
    if shard_dims(p["wq"], comm).get("model") != 1:
        w = {k: use(v, comm) for k, v in p.items()}
        q, k, v = _qkv(cfg, w, x, rope)
        return _out(cfg, w, _attend(cfg, q, k, v, **core))
    kv_split = (shard_dims(p["wk"], comm).get("model") == 1
                and (mode == "train" or paged is not None))
    tp = {"wq", "bq", "wo"} | ({"wk", "wv", "bk", "bv"} if kv_split
                               else set())
    in_tp = {"q_norm"} | ({"k_norm"} if kv_split else set())
    w = {k: use(v, comm, keep=MODEL) if k in tp else
         use(v, comm, tp_axes=MODEL) if k in in_tp else use(v, comm)
         for k, v in p.items()}
    xin = copy_to(x, comm, MODEL)
    q = apply_rope(_q(cfg, w, xin), rope)
    h_loc = q.shape[2]
    first = comm.index("model") * h_loc
    heads = None
    if kv_split:
        k, v = _kv(cfg, w, xin)
    else:
        hp, _ = _padded_heads(cfg)
        k, v = (copy_to(t, comm, MODEL) for t in _kv(cfg, w, x))
        heads, _ = _local_kv_heads(h_loc, first, hp // cfg.num_kv_heads)
    out = _attend(cfg, q, apply_rope(k, rope), v, heads=heads, **core)
    _, head_mask = _padded_heads(cfg)
    if head_mask is not None:
        out = out * torch.from_numpy(head_mask[first:first + h_loc]).to(
            out)[None, None, :, None]
    B, S, h, hd = out.shape
    y = out.reshape(B, S, h * hd) @ w["wo"].to(out.dtype).reshape(h * hd, -1)
    return reduce_from(y, comm, MODEL)


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention), paged absorbed decode
# --------------------------------------------------------------------------

def init_mla(cfg, *, generator, device="cpu", dtype):
    """Weights in the reference's layout, projections cast to ``dtype``
    as drawn: w_dq (d, q_lora), q_norm (q_lora,), w_uq (q_lora, H,
    nope + rope), w_dkv (d, kv_lora + rope), kv_norm (kv_lora,), w_uk
    (kv_lora, H, nope), w_uv (kv_lora, H, v), wo (H, v, d)."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    ones = lambda n: {"scale": torch.ones((n,), device=device)}
    return {
        "w_dq": dense_init(d, m.q_lora_rank, **kw),
        "q_norm": ones(m.q_lora_rank),
        "w_uq": dense_init(m.q_lora_rank, H * qk_hd, **kw).reshape(
            m.q_lora_rank, H, qk_hd),
        "w_dkv": dense_init(d, m.kv_lora_rank + m.qk_rope_head_dim, **kw),
        "kv_norm": ones(m.kv_lora_rank),
        "w_uk": dense_init(m.kv_lora_rank, H * m.qk_nope_head_dim,
                           **kw).reshape(m.kv_lora_rank, H,
                                         m.qk_nope_head_dim),
        "w_uv": dense_init(m.kv_lora_rank, H * m.v_head_dim, **kw).reshape(
            m.kv_lora_rank, H, m.v_head_dim),
        "wo": dense_init(H * m.v_head_dim, d, **kw).reshape(
            H, m.v_head_dim, d),
    }


def make_mla_cache(cfg, dtype, *, pool=None, batch=None, max_len=None,
                   device="cpu"):
    """One MLA layer's cache: with ``pool`` = (num_pages, page_size) the
    paged pool, token-major latent ``ckv`` (N, kv_lora) and the shared
    rope key ``krope`` (N, rope); without it the slab, ``ckv`` (batch,
    max_len, kv_lora) and ``krope`` (batch, max_len, rope)."""
    m = cfg.mla
    if pool is not None:
        num_pages, page_size = pool
        lead = (num_pages * page_size,)
    else:
        lead = (batch, max_len)
    return {"ckv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                               device=device),
            "krope": torch.zeros(lead + (m.qk_rope_head_dim,), dtype=dtype,
                                 device=device)}


def _mla_qkv(cfg, p, x, rope):
    """(q_nope, q_rope, ckv, krope) of x: (B, S, d); q_nope (B, S, H,
    nope), q_rope (B, S, H, rope) and krope (B, S, rope) rotated by
    ``rope`` (the angles of ``rope_freqs(rope_dim)``), ckv (B, S,
    kv_lora) normalised.  Each weight is cast to x's dtype at use."""
    m = cfg.mla
    dt = x.dtype
    ql = rmsnorm(p["q_norm"], x @ p["w_dq"].to(dt), cfg.norm_eps)
    q = _proj(ql, p["w_uq"].to(dt))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], rope)
    dkv = x @ p["w_dkv"].to(dt)
    ckv = rmsnorm(p["kv_norm"], dkv[..., :m.kv_lora_rank], cfg.norm_eps)
    # one rope key shared by every head: rotated as a single head
    krope = apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :],
                       rope)[:, :, 0, :]
    return q_nope, q_rope, ckv, krope


def mla_scale(cfg) -> float:
    """The score scale, 1/sqrt(nope + rope) (not 1/sqrt(head_dim)), as
    the fp32 number the reference multiplies by."""
    m = cfg.mla
    return float(np.float32(1.0 / np.sqrt(m.qk_nope_head_dim
                                          + m.qk_rope_head_dim)))


def apply_mla(cfg, p, x, *, positions, cache, rope, paged=None,
              write_idx=None, mode="decode", cache_pos=0, comm=None):
    """MLA over the serving cache, or without one in training.

    Paged (``paged`` given; decode steps and prefill chunks), absorbed:
    x (B, S, d); positions (B, S) per slot; cache {"ckv", "krope"}
    pools, updated in place at ``write_idx``.  As in the reference:
    append the latent and rope key, project q_nope into the latent
    through w_uk, attend in the latent space (scores q_lat . ckv +
    q_rope . krope, V = the latent itself) through
    ``paged_flash_decode_mla`` (or its plain version, by
    ``cfg.decode_kernel``), then w_uv and wo.

    Train (``mode="train"``, no cache) and slab ``"prefill"`` (cache
    {"ckv", "krope"} of (B, max_len, ...), filled from 0): the latent is
    expanded to per-head keys [k_nope | krope] of nope + rope and values
    of ``v_head_dim``, and the queries [q_nope | q_rope] attend causally
    over them through ``chunked_attention`` -- on the card the flash
    kernel at q/k width 192 and v width 128 (differentiable), scaled by
    1/sqrt(nope + rope) as q's width gives.

    Slab ``"decode"``: the S new latents are written at the scalar
    ``cache_pos``, and the queries attend in the latent space over the
    whole slab, each masked causally by its own position -- the
    absorbed form in plain ops, as the reference computes it.
    rope: the angles of ``rope_freqs(qk_rope_head_dim)`` at the call's
    positions.  ``comm``: a paged pool cut over a mesh's ``"model"``
    (this rank writes its block, the slots' pages are read gathered;
    ``_paged_update``)."""
    m = cfg.mla
    dt = x.dtype
    q_nope, q_rope, ckv, krope = _mla_qkv(cfg, p, x, rope)
    if paged is not None:
        (ckv_pool, krope_pool), view = _paged_update(
            cache, {"ckv": ckv, "krope": krope}, write_idx, paged, comm)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"].to(dt))
        out_lat = _paged(
            cfg, paged_flash_decode_mla, paged_flash_decode_mla_ref,
            q_lat.contiguous(), q_rope.contiguous(), ckv_pool.to(dt),
            krope_pool.to(dt), view.page_table, positions,
            page_size=view.page_size, scale=mla_scale(cfg),
            window=cfg.swa_window)
        out = torch.einsum("bshr,rhv->bshv", out_lat, p["w_uv"].to(dt))
    elif mode in ("train", "prefill"):
        S = x.shape[1]
        if mode == "prefill":
            if S > cache["ckv"].shape[1]:
                raise ValueError(f"slab MLA: {S} latents overrun a "
                                 f"{cache['ckv'].shape[1]}-long cache")
            cache["ckv"][:, :S] = ckv
            cache["krope"][:, :S] = krope
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"].to(dt))
        v = torch.einsum("bsr,rhv->bshv", ckv, p["w_uv"].to(dt))
        k = torch.cat([k_nope, krope[:, :, None, :].expand(
            -1, -1, k_nope.shape[2], -1)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k, v = _seq_keys(k, v.contiguous(), comm)
        T = k.shape[1]
        out = chunked_attention(q, k, v, q_positions=range(T - S, T),
                                kv_positions=range(T), window=cfg.swa_window)
    else:
        S, max_len = x.shape[1], cache["ckv"].shape[1]
        start = int(cache_pos)
        if start + S > max_len:
            raise ValueError(f"slab MLA: {S} latents at {start} overrun a "
                             f"{max_len}-long cache")
        cache["ckv"][:, start:start + S] = ckv
        cache["krope"][:, start:start + S] = krope
        ckv_c, krope_c = cache["ckv"].to(dt), cache["krope"].to(dt)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"].to(dt))
        scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv_c.float())
                  + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                 krope_c.float()))
        scores = scores / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        kv_pos = torch.arange(max_len, device=x.device)
        qpos = torch.arange(start, start + S, device=x.device)
        mask = kv_pos[None, :] <= qpos[:, None]
        if cfg.swa_window:
            mask &= kv_pos[None, :] > qpos[:, None] - cfg.swa_window
        scores = torch.where(mask[None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out_lat = torch.einsum("bhst,btr->bshr", probs.to(dt), ckv_c)
        out = torch.einsum("bshr,rhv->bshv", out_lat, p["w_uv"].to(dt))
    B, S, H, v = out.shape
    return out.reshape(B, S, H * v) @ p["wo"].to(dt).reshape(H * v, -1)
