"""Fine-grained mixture-of-experts (DeepSeekMoE / Jamba style).

Port of ``repro.models.moe``.  ``apply_moe`` dispatches as the
reference does: without an activation mesh, the capacity-based dense
dispatch (``apply_moe_dense``), for serving and training; with one
registered (``sharding.ctx``: the mesh train step, or a serve
topology), the expert-parallel ``apply_moe_ep`` over DTensor weights.
A serving call's batch (a decode step of every slot, a prefill chunk of
one) is replicated over the replicas (``ctx.batch_split(False)``), so
it takes the replicated-tokens branch: each rank its experts' share.  ``update_router_bias`` is the
trainer's aux-free balancing step.

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

from repro_torch.models.layers import (apply_mlp, apply_mlp_mesh, init_mlp,
                                       truncated_normal)
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.comm import (all_to_all, copy_to,
                                       gather_replicated, pmean, reduce_from,
                                       shard_dims, split_replicated, use)

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


def apply_moe(cfg, p, x, *, capacity_factor=None):
    """x: (B, S, d) -> (y, aux), at the config's capacity factor unless
    one is given: expert-parallel when an activation mesh is registered,
    else the dense dispatch."""
    if capacity_factor is None:
        capacity_factor = cfg.moe.capacity_factor
    if shctx.get_activation_mesh() is not None and shctx.is_seq_cut():
        # the sequence split: the reference's replicated-token layer over
        # every token of the microbatch, this rank's block kept
        comm = shctx.get_comm()
        with shctx.seq_split(False):
            y, aux = apply_moe_ep(cfg, p, gather_replicated(x, comm, 1),
                                  capacity_factor=capacity_factor)
        return split_replicated(y, comm, 1), aux
    if shctx.get_activation_mesh() is not None:
        return apply_moe_ep(cfg, p, x, capacity_factor=capacity_factor)
    return apply_moe_dense(cfg, p, x, capacity_factor=capacity_factor)


# ==========================================================================
# expert parallelism over the mesh
# ==========================================================================

def _ep_factors(cfg, comm):
    """(ep_data, ep_model): E splits over ``"model"`` when it divides,
    and over ``"data"`` too when E / |model| divides by |data| (the
    experts' rule then reads ("data", "model")); otherwise the experts
    stay model-split and their FFN dim splits over ``"data"``."""
    E = cfg.moe.num_experts
    msz, dsz = comm.size("model"), comm.size("data")
    ep_model = msz if (msz > 1 and E % msz == 0) else 1
    ep_data = dsz if (ep_model == msz and dsz > 1
                      and (E // ep_model) % dsz == 0) else 1
    return ep_data, ep_model


def _route_local(cfg, p, xf, capacity_factor):
    """Routing of this rank's tokens xf (N, d), its capacity counted on
    them: (flat_e, safe_pos, keep, flat_w, aux, C)."""
    m = cfg.moe
    N = xf.shape[0]
    k, E = m.top_k, m.num_experts
    top_w, top_idx, aux = _routing(cfg, p, xf)
    C = max(1, int(capacity_factor * N * k / E))
    C = min(max(N, 8), -(-C // 8) * 8)
    flat_e = top_idx.reshape(N * k)
    pos = F.one_hot(flat_e, E).cumsum(0) - 1
    flat_pos = pos.gather(1, flat_e[:, None])[:, 0]
    keep = flat_pos < C
    flat_w = top_w.reshape(N * k) * keep
    safe_pos = torch.where(keep, flat_pos, torch.zeros_like(flat_pos))
    return flat_e, safe_pos, keep, flat_w, aux, C


def _pack(xf, flat_e, safe_pos, keep, C, rows, *, start=0, k=1):
    """Tokens into expert rows [start, start + rows): (buf (rows, C, d),
    the mask of the N * k slots that landed), one scatter per top-k
    slot."""
    N, d = xf.shape
    sel = keep & (flat_e >= start) & (flat_e < start + rows)
    le = torch.where(sel, flat_e - start, torch.zeros_like(flat_e))
    le, pos, selk = le.reshape(N, k), safe_pos.reshape(N, k), sel.reshape(N, k)
    buf = xf.new_zeros((rows, C, d))
    for j in range(k):
        buf = buf.index_put((le[:, j], pos[:, j]),
                            xf * selk[:, j, None].to(xf.dtype),
                            accumulate=True)
    return buf, sel


def _combine(out, flat_e, safe_pos, flat_w, sel, k, dt, *, start=0,
             local_rows=None):
    """Each slot's expert output gathered back from ``out`` (rows, C, d)
    and weight-summed over the k slots; ``local_rows`` maps an expert id
    to its row (default ``flat_e - start``)."""
    N = flat_e.shape[0] // k
    rows = local_rows if local_rows is not None else flat_e - start
    le = torch.where(sel, rows, torch.zeros_like(rows)).reshape(N, k)
    pos = safe_pos.reshape(N, k)
    w = (flat_w * sel).reshape(N, k)
    y = None
    for j in range(k):
        yj = out[le[:, j], pos[:, j]] * w[:, j, None].to(dt)
        y = yj if y is None else y + yj
    return y


def apply_moe_ep(cfg, p, x, *, capacity_factor):
    """Expert-parallel MoE of DTensor masters ``p`` under the registered
    mesh; x (B, S, d) is this rank's rows (its pod x data share of the
    batch, or all of it when the batch does not split), replicated over
    ``"model"``.  Routing and capacity are per rank (``_route_local``),
    as in the reference, so at a capacity that drops tokens the result
    differs from the dense dispatch.  Three branches:

      * full expert-parallel (E over data x model, batch split): pack
        every expert's rows locally, ``all_to_all`` over ``"data"``,
        run this model rank's slice, and send only that slice back;
      * expert-FSDP (E over model, the FFN dim over data): gather the
        f-shards over ``"data"``; tokens stay;
      * replicated tokens (the batch does not split, or the experts
        split over model only): every rank runs its expert slice on
        its tokens and the partial sums add over the expert axes.

    The slot weights and the tokens enter the expert path through "f"
    over the expert axes (each rank's experts see part of them), the
    output leaves through "g"; the router stays replicated.  The shared
    experts run densely outside (tensor-parallel).  ``aux`` is the mean
    over the batch axes."""
    comm = shctx.get_comm()
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    d = x.shape[-1]
    dt = x.dtype
    ep_data, ep_model = _ep_factors(cfg, comm)
    dsz, msz = comm.size("data"), comm.size("model")
    split = shctx.is_batch_split() and bool(comm.dp_axes)
    f_tp = (ep_data == 1 and dsz > 1 and m.d_expert % dsz == 0
            and msz > 1 and E % msz == 0)
    rp = {"router": use(p["router"], comm)}
    if "router_bias" in p:
        rp["router_bias"] = use(p["router_bias"], comm)
    xf = x.reshape(-1, d)
    flat_e, safe_pos, keep, flat_w, aux, C = _route_local(
        cfg, rp, xf, capacity_factor)
    mi = comm.index("model")
    experts = p["experts"]
    if ep_data > 1 and split:
        # full expert-parallel: the data axis is inside the exchange,
        # so only pods sum the experts' gradients
        ew = {n: use(w, comm, keep=("data", "model"),
                     sums=tuple(a for a in comm.dp_axes if a != "data"))
              for n, w in experts.items()}
        red = ("model",)
        xe, we = copy_to(xf, comm, red), copy_to(flat_w, comm, red)
        buf, _ = _pack(xe, flat_e, safe_pos, keep, C, E, k=k)
        buf = all_to_all(buf, comm, "data", 0, 1)     # (E / D, D * C, d)
        e_loc = E // (ep_data * ep_model)
        out = _expert_ffn(ew, buf[mi * e_loc:(mi + 1) * e_loc])
        # the model-local slice only goes back: row di * e_loc + r is
        # expert (di * M + mi) * e_loc + r of this rank's tokens
        out_back = all_to_all(out, comm, "data", 1, 0)
        mi_of_e = (flat_e // e_loc) % ep_model
        row = (flat_e // (e_loc * ep_model)) * e_loc + flat_e % e_loc
        y = _combine(out_back, flat_e, safe_pos, we, keep & (mi_of_e == mi),
                     k, dt, local_rows=row)
    else:
        # expert-FSDP (f-shards gathered over data) or replicated tokens
        red = ("model", "data") if ep_data > 1 else ("model",)
        # an expert axis that does not split a weight (experts
        # replicated over "model") sums its partial gradients
        ew = {n: use(w, comm, keep=red, tp_axes=tuple(
            a for a in red if a not in shard_dims(w, comm)))
            for n, w in experts.items()}
        e_loc = E // (ep_data * ep_model)
        start = mi * e_loc
        if ep_data > 1:
            start = (comm.index("data") * ep_model + mi) * e_loc
        xe, we = copy_to(xf, comm, red), copy_to(flat_w, comm, red)
        buf, sel = _pack(xe, flat_e, safe_pos, keep, C, e_loc, start=start,
                         k=k)
        y = _combine(_expert_ffn(ew, buf), flat_e, safe_pos, we, sel, k, dt,
                     start=start)
    y = reduce_from(y, comm, red).reshape(x.shape)
    aux = pmean(aux, comm, shctx.batch_axes(comm))
    if m.num_shared_experts:
        y = y + apply_mlp_mesh(p["shared"], x, comm, gated=cfg.mlp_gated)
    return y, aux


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
