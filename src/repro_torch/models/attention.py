"""Attention for the serving and training paths: GQA (qk-norm, RoPE)
and MLA (serving only).

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
- the slab cache of the lockstep engine (GQA only): k and v of
  ``(B, max_len, kv_heads, head_dim)``, all slots at the same depth (a
  scalar ``cache_pos``).  Its attention is ``chunked_attention``, which
  on the card runs the flash-attention kernel.

GQA's train branch has no cache: the queries attend causally over their
own keys through ``chunked_attention``.  Cross-attention and MLA's slab
and train branches are not ported here; they join with the slices that
need them.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode import (paged_flash_decode,
                                              paged_flash_decode_mla)
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

    CUDA tensors run the flash-attention kernel, for the one form the
    slab path gives: ``kv_positions = range(T)`` and ``q_positions =
    range(off, off + S)`` with ``off + S == kv_valid_len`` (or ``== T``
    without one), given as ``range``s and an int.  The keys are sliced
    to the valid length (a strided view, not a copy) and the queries are
    then right-aligned against them, which is the kernel's masking.  Any
    other form raises (positions on the card cannot be checked without
    a host sync in every layer).  ``chunk`` is the CPU loop's; the
    kernel tiles itself."""
    if q.device.type == "cuda":
        return _flash_slab(q, k, v, q_positions=q_positions,
                           kv_positions=kv_positions, causal=causal,
                           window=window, kv_valid_len=kv_valid_len)
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
    """``chunked_attention`` on the card: the slab form, checked on the
    host, as one flash-attention call on the valid keys."""
    S, T = q.shape[1], k.shape[1]
    valid = T if kv_valid_len is None else kv_valid_len
    if not (isinstance(q_positions, range) and isinstance(kv_positions, range)
            and isinstance(valid, int) and kv_positions == range(T)
            and 0 < valid <= T and q_positions == range(valid - S, valid)):
        raise ValueError(
            "chunked_attention on the card takes the slab form only: "
            "kv_positions == range(T) and q_positions == range(off, off + "
            "S) with off + S == kv_valid_len (or T), as ranges and an int; "
            f"got q_positions={q_positions!r}, kv_positions="
            f"{kv_positions!r}, kv_valid_len={kv_valid_len!r} (S={S}, "
            f"T={T})")
    return flash_attention(q, k[:, :valid], v[:, :valid], causal=causal,
                           window=window)


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


def init_attention(cfg, *, generator, device="cpu", dtype):
    """Weights in the reference's layout, projections cast to ``dtype``
    as drawn: wq (d, h, hd), wk/wv (d, hk, hd), wo (h, hd, d), qk-norm
    scales (hd,) in fp32."""
    d, hk, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    h, mask = _padded_heads(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)
    wq = dense_init(d, h * hd, **kw).reshape(d, h, hd)
    wk = dense_init(d, hk * hd, **kw).reshape(d, hk, hd)
    wv = dense_init(d, hk * hd, **kw).reshape(d, hk, hd)
    wo = dense_init(h * hd, d, **kw).reshape(h, hd, d)
    if mask is not None:
        m = torch.from_numpy(mask).to(device, dtype)
        wq = wq * m[None, :, None]
        wo = wo * m[:, None, None]
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias:
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


def _qkv(cfg, p, x, rope):
    """q (B, S, h, hd), k and v (B, S, hk, hd) of x: projections, bias,
    qk-norm, then RoPE on q and k by ``rope`` (``rope_angles``).  Each
    weight is cast to x's dtype at use (a no-op for a serving model)."""
    dt = x.dtype
    q = _proj(x, p["wq"].to(dt))
    k = _proj(x, p["wk"].to(dt))
    v = _proj(x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return apply_rope(q, rope), apply_rope(k, rope), v


def apply_attention(cfg, p, x, *, positions, cache, rope, paged=None,
                    write_idx=None, mode="decode", cache_pos=0):
    """Self-attention over the serving cache, or without one in training.
    Order as in the reference: qk-norm on q and k, RoPE, cache write,
    attention, the padded-head mask, wo.

    Train (``mode="train"``, no cache, ``paged`` None): x (B, S, d) at
    positions 0..S-1, causal attention of the S queries over their own
    S keys through ``chunked_attention`` (the flash kernel on the card,
    differentiable).

    Paged (``paged`` given; decode steps and prefill chunks): x (B, S,
    d), positions (B, S) per slot; cache {"k", "v"} pools, updated in
    place at ``write_idx`` (``paged_write_indices``); attention through
    ``paged_flash_decode``.

    Slab (``paged`` None): cache {"k", "v"} of (B, max_len, hk, hd),
    updated in place.  ``mode="prefill"`` writes the S new keys at 0 and
    attends over them; ``mode="decode"`` writes them at the scalar
    ``cache_pos`` and attends over the cache's first cache_pos + S keys.
    Both through ``chunked_attention`` (the flash kernel on the card).
    rope: ``rope_angles`` of the call's positions."""
    q, k, v = _qkv(cfg, p, x, rope)
    if mode == "train":
        S = x.shape[1]
        out = chunked_attention(q, k, v, q_positions=range(S),
                                kv_positions=range(S), window=cfg.swa_window)
    elif paged is not None:
        k_pool = _paged_append(cache["k"], write_idx, k)
        v_pool = _paged_append(cache["v"], write_idx, v)
        out = paged_flash_decode(q, k_pool.to(x.dtype), v_pool.to(x.dtype),
                                 paged.page_table, positions,
                                 page_size=paged.page_size,
                                 window=cfg.swa_window)
    else:
        S, max_len = x.shape[1], cache["k"].shape[1]
        start = 0 if mode == "prefill" else int(cache_pos)
        if start + S > max_len:
            raise ValueError(f"slab attention: {S} keys at {start} overrun "
                             f"a {max_len}-long cache")
        cache["k"][:, start:start + S] = k
        cache["v"][:, start:start + S] = v
        if mode == "prefill":
            out = chunked_attention(q, k, v, q_positions=range(S),
                                    kv_positions=range(S),
                                    window=cfg.swa_window)
        else:
            out = chunked_attention(
                q, cache["k"].to(x.dtype), cache["v"].to(x.dtype),
                q_positions=range(start, start + S),
                kv_positions=range(max_len), window=cfg.swa_window,
                kv_valid_len=start + S)
    _, head_mask = _padded_heads(cfg)
    if head_mask is not None:
        out = out * torch.from_numpy(head_mask).to(out)[None, None, :, None]
    B, S, h, hd = out.shape
    return out.reshape(B, S, h * hd) @ p["wo"].to(out.dtype).reshape(h * hd,
                                                                      -1)


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


def make_mla_cache(cfg, dtype, *, pool, device="cpu"):
    """One MLA layer's paged pool: token-major latent ``ckv`` (N,
    kv_lora) and the shared rope key ``krope`` (N, rope)."""
    num_pages, page_size = pool
    n = num_pages * page_size
    m = cfg.mla
    return {"ckv": torch.zeros((n, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((n, m.qk_rope_head_dim), dtype=dtype,
                                 device=device)}


def _mla_qkv(cfg, p, x, rope):
    """(q_nope, q_rope, ckv, krope) of x: (B, S, d); q_nope (B, S, H,
    nope), q_rope (B, S, H, rope) and krope (B, S, rope) rotated by
    ``rope`` (the angles of ``rope_freqs(rope_dim)``), ckv (B, S,
    kv_lora) normalised."""
    m = cfg.mla
    ql = rmsnorm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps)
    q = _proj(ql, p["w_uq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], rope)
    dkv = x @ p["w_dkv"]
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


def apply_mla(cfg, p, x, *, positions, cache, paged: PagedView, write_idx,
              rope):
    """Decode-mode paged MLA (decode steps and prefill chunks), absorbed.

    x: (B, S, d); positions: (B, S) per-slot; cache: {"ckv", "krope"}
    pools, updated in place at ``write_idx``; rope: the angles of
    ``rope_freqs(qk_rope_head_dim)``.  As in the reference: append the
    latent and rope key, project q_nope into the latent through w_uk,
    attend in the latent space (scores q_lat . ckv + q_rope . krope, V
    = the latent itself), then w_uv and wo."""
    q_nope, q_rope, ckv, krope = _mla_qkv(cfg, p, x, rope)
    ckv_pool = _paged_append(cache["ckv"], write_idx, ckv)
    krope_pool = _paged_append(cache["krope"], write_idx, krope)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"])
    out_lat = paged_flash_decode_mla(
        q_lat.contiguous(), q_rope.contiguous(), ckv_pool.to(x.dtype),
        krope_pool.to(x.dtype), paged.page_table, positions,
        page_size=paged.page_size, scale=mla_scale(cfg),
        window=cfg.swa_window)
    out = torch.einsum("bshr,rhv->bshv", out_lat, p["w_uv"])
    B, S, H, v = out.shape
    return out.reshape(B, S, H * v) @ p["wo"].reshape(H * v, -1)
