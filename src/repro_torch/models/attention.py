"""Attention for the paged serving path (GQA with qk-norm and RoPE).

Port of the paged branch of ``repro.models.attention``: K/V live in a
shared token-major page pool ``(num_pages * page_size, kv_heads,
head_dim)`` with no batch axis, and a per-slot page table
(``PagedView``) maps each slot's logical positions to physical pool
rows.  ``repro_torch.serve.kvcache`` owns allocation; this module owns
the read and write paths.  Page 0 is the trash page: never allocated,
the write sink of idle slots and out-of-range positions.

The slab cache, cross-attention, ``chunked_attention`` and MLA are not
ported here; they join with the slices that need them.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.paged_decode import paged_flash_decode
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm

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


def init_attention(cfg, *, generator, device="cpu"):
    """fp32 master weights in the reference's layout: wq (d, h, hd),
    wk/wv (d, hk, hd), wo (h, hd, d), qk-norm scales (hd,)."""
    d, hk, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    h, mask = _padded_heads(cfg)
    kw = dict(generator=generator, device=device)
    wq = dense_init(d, h * hd, **kw).reshape(d, h, hd)
    wk = dense_init(d, hk * hd, **kw).reshape(d, hk, hd)
    wv = dense_init(d, hk * hd, **kw).reshape(d, hk, hd)
    wo = dense_init(h * hd, d, **kw).reshape(h, hd, d)
    if mask is not None:
        m = torch.from_numpy(mask).to(device)
        wq = wq * m[None, :, None]
        wo = wo * m[:, None, None]
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), device=device)
        p["bk"] = torch.zeros((hk, hd), device=device)
        p["bv"] = torch.zeros((hk, hd), device=device)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), device=device)}
        p["k_norm"] = {"scale": torch.ones((hd,), device=device)}
    return p


def make_cache(cfg, dtype, *, pool, device="cpu"):
    """One layer's paged pool: token-major k and v, (N, hk, hd)."""
    num_pages, page_size = pool
    n = num_pages * page_size
    shape = (n, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, nh, hd = w.shape
    return (x @ w.reshape(d, nh * hd)).unflatten(-1, (nh, hd))


def apply_attention(cfg, p, x, *, positions, cache, paged: PagedView,
                    write_idx, rope):
    """Decode-mode paged self-attention (decode steps and prefill chunks).

    x: (B, S, d); positions: (B, S) per-slot; cache: {"k", "v"} pools,
    updated in place at ``write_idx`` (``paged_write_indices``); rope:
    ``rope_angles(positions, ...)``.  Order as in the reference: qk-norm
    on q and k, RoPE, append, attention, wo."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    k = apply_rope(k, rope)
    q = apply_rope(q, rope)
    k_pool = _paged_append(cache["k"], write_idx, k)
    v_pool = _paged_append(cache["v"], write_idx, v)
    out = paged_flash_decode(q, k_pool.to(x.dtype), v_pool.to(x.dtype),
                             paged.page_table, positions,
                             page_size=paged.page_size,
                             window=cfg.swa_window)
    _, head_mask = _padded_heads(cfg)
    if head_mask is not None:
        out = out * torch.from_numpy(head_mask).to(out)[None, None, :, None]
    B, S, h, hd = out.shape
    return out.reshape(B, S, h * hd) @ p["wo"].reshape(h * hd, -1)
