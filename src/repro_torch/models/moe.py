"""Fine-grained mixture-of-experts (DeepSeekMoE / Jamba style), one device.

Port of ``repro.models.moe`` without a mesh: ``apply_moe`` is the
reference's capacity-based dense dispatch (``apply_moe_dense``), for
serving and training, and ``update_router_bias`` the trainer's
aux-free balancing step.  The expert-parallel path (``apply_moe_ep``)
joins with the multi-card slices.

Router: softmax over experts, top-k, weights renormalised over the
selection (or DeepSeek-V3's sigmoid scores, selected with a balance
bias that carries no weight), plus the Switch-style load-balance
auxiliary loss.  The router reads in fp32, so its weight (and bias)
stay fp32 in a bf16 model (``FP32_WEIGHTS``).  Gradients reach the
router through the selected weights and the aux loss, and the experts
through their products; the selection carries none, and the balance
bias none at all (the reference's ``stop_gradient``): its trainable
master gets no ``.grad``, which the train step reads as zero.

Dispatch: each (token, slot) pair takes the next free row of its
expert's (C, d) buffer in token-major order (a cumulative count); pairs
past the capacity C are dropped (weight 0).  The experts run as batched
matmuls over their (E, C, d) buffers, and each kept pair gathers its
row back, weighted.  Shared experts run densely on every token.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, init_mlp, truncated_normal

# weights the reference reads in fp32 whatever the compute dtype
FP32_WEIGHTS = ("router", "router_bias")


def init_moe(cfg, *, generator, device="cpu", dtype):
    """Weights of one MoE layer in the reference's layout: router (d, E),
    experts {w_up, w_gate (E, d, f), w_down (E, f, d)}, optional
    router_bias (E,) and shared MLP.  Each expert matrix is drawn in its
    (E, d_in, d_out) layout with std 1/sqrt(d_in), in fp32, and cast to
    ``dtype`` as it is drawn; the router stays fp32."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_expert
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {"router": truncated_normal((d, E), 0.02, generator=generator,
                                    device=device)}
    if m.router_type == "sigmoid":
        p["router_bias"] = torch.zeros((E,), device=device)
    experts = {"w_up": truncated_normal((E, d, f), 1 / np.sqrt(d), **kw),
               "w_down": truncated_normal((E, f, d), 1 / np.sqrt(f), **kw)}
    if cfg.mlp_gated:
        experts["w_gate"] = truncated_normal((E, d, f), 1 / np.sqrt(d), **kw)
    p["experts"] = experts
    if m.num_shared_experts:
        p["shared"] = init_mlp(d, m.num_shared_experts * f,
                               gated=cfg.mlp_gated, **kw)
    return p


def _routing(cfg, p, xf):
    """xf: (N, d) -> (top-k weights (N, k) fp32, top-k expert ids (N, k),
    aux loss)."""
    m = cfg.moe
    logits = xf.float() @ p["router"].float()
    if m.router_type == "sigmoid":
        # DeepSeek-V3: select by score + balance bias, weight by the
        # bias-free scores renormalised over the selection
        scores = torch.sigmoid(logits)                         # (N, E)
        bias = p["router_bias"].detach()                       # no gradient
        _, top_idx = torch.topk(scores + bias[None, :], m.top_k)
        top_w = scores.gather(1, top_idx)
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)                  # (N, E)
        top_w, top_idx = torch.topk(probs, m.top_k)            # (N, k)
        top_w = top_w / top_w.sum(-1, keepdim=True)
    one_hot = F.one_hot(top_idx, m.num_experts).float()
    f = one_hot.sum(1).mean(0)                           # fraction routed
    aux = m.num_experts * (f * probs.mean(0)).sum() * m.router_aux_coef
    return top_w, top_idx, aux


def _expert_ffn(experts, buf):
    """Dense batched FFN over an (E, C, d) expert buffer; each weight is
    cast to the buffer's dtype at use."""
    dt = buf.dtype
    up = torch.bmm(buf, experts["w_up"].to(dt))
    if "w_gate" in experts:
        h = F.silu(torch.bmm(buf, experts["w_gate"].to(dt))) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, experts["w_down"].to(dt))


def capacity(cfg, n_tokens, capacity_factor) -> int:
    """Rows of each expert's buffer for a call of ``n_tokens`` tokens:
    ``min(N, ceil8(int(cf * N * k / E)))``, at least 1."""
    m = cfg.moe
    C = max(1, int(capacity_factor * n_tokens * m.top_k / m.num_experts))
    return min(n_tokens, -(-C // 8) * 8)


def apply_moe_dense(cfg, p, x, *, capacity_factor):
    """x: (B, S, d) -> (y, aux): the reference's scatter/gather path."""
    m = cfg.moe
    B, S, d = x.shape
    dt = x.dtype
    N = B * S
    xf = x.reshape(N, d)
    top_w, top_idx, aux = _routing(cfg, p, xf)
    k, E = m.top_k, m.num_experts
    C = capacity(cfg, N, capacity_factor)

    # row of each (token, slot) pair within its expert, token-major
    flat_e = top_idx.reshape(N * k)
    pos = F.one_hot(flat_e, E).cumsum(0) - 1
    flat_pos = pos.gather(1, flat_e[:, None])[:, 0]
    keep = flat_pos < C
    flat_w = top_w.reshape(N * k) * keep
    # a dropped pair adds a zero row at its expert's row 0; adding (not
    # assigning) keeps the token that holds row 0
    safe_pos = torch.where(keep, flat_pos, torch.zeros_like(flat_pos))
    tok_idx = torch.arange(N, device=x.device).repeat_interleave(k)
    upd = xf[tok_idx] * keep[:, None].to(dt)
    buf = torch.zeros((E, C, d), dtype=dt, device=x.device)
    buf.index_put_((flat_e, safe_pos), upd, accumulate=True)

    out_buf = _expert_ffn(p["experts"], buf)
    # (N*k) slots are token-major: a reshape-sum over k recombines them
    y = out_buf[flat_e, safe_pos] * flat_w[:, None].to(dt)
    y = y.reshape(N, k, d).sum(1).reshape(B, S, d)
    if m.num_shared_experts:
        y = y + apply_mlp(p["shared"], x, gated=cfg.mlp_gated)
    return y, aux


def apply_moe(cfg, p, x):
    """x: (B, S, d) -> (y, aux) with the config's capacity factor."""
    return apply_moe_dense(cfg, p, x,
                           capacity_factor=cfg.moe.capacity_factor)


def update_router_bias(cfg, p, counts, *, gamma=1e-3):
    """DeepSeek-V3's aux-free balancing step (the reference's
    ``update_router_bias``): the bias of an expert routed fewer tokens
    than the mean rises by ``gamma``, of one routed more falls by it.
    counts: (E,) tokens routed to each expert this step.  Accumulates in
    fp32 whatever the bias's and the counts' dtypes (a bf16 bias near 8
    cannot resolve a 1e-3 step), and returns the new bias in the bias's
    dtype; ``p`` is not modified."""
    bias = p["router_bias"]
    counts = torch.as_tensor(counts, device=bias.device).float()
    step = torch.sign(counts.mean() - counts) * torch.tensor(
        gamma, dtype=torch.float32)
    return (bias.detach().float() + step.to(bias.device)).to(bias.dtype)
