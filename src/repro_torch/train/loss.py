"""Losses.  Labels use -1 for masked positions (padding, image tokens).

Port of ``repro.train.loss``: token batches, an encoder-decoder's
target tokens, a VLM's image rows (IGNORE labels in front of the text),
and the multi-token-prediction term.

On a mesh (``lm_loss_mesh``) the logits may be this rank's
vocabulary block (``out["vocab_start"]``): the log-sum-exp takes the
max over the blocks (an all-reduce of the max) and the sum of their
exponentials (an all-reduce over ``"model"``), and the picked logit is
the one block's that holds the label -- the (B, S, V) logits are never
gathered.  Each rank's rows are its share of the batch: the CE is the
sum over all ranks' positions over their count, and what a rank
returns is its share of the objective (its CE sum over the global
count, its aux loss over the ranks sharing the batch), whose gradients
summed over the batch axes are the global loss's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.comm import all_reduce, reduce_from

IGNORE = -1
MODEL = ("model",)


def make_labels(cfg, batch):
    """Next-token labels aligned with the model's logit sequence."""
    tokens = batch.get("tgt_tokens", batch.get("tokens"))
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1],
                                                       IGNORE)], dim=1)
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        n_img = batch["vision_embeds"].shape[1]
        labels = torch.cat([labels.new_full((tokens.shape[0], n_img),
                                            IGNORE), labels], dim=1)
    return labels


def ce_sum(logits, labels, comm=None, vocab_start=None):
    """(sum of the CE over positions where labels != IGNORE, their count)
    of fp32 logits; ``vocab_start`` not None: ``logits`` is the block of
    the vocabulary from that row, split over ``"model"`` of ``comm``."""
    mask = labels != IGNORE
    if vocab_start is None:
        safe = torch.where(mask, labels, torch.zeros_like(labels))
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    else:
        top = all_reduce(logits.detach().amax(-1), comm, MODEL,
                         op=dist.ReduceOp.MAX)
        logz = top + torch.log(reduce_from(
            torch.exp(logits - top[..., None]).sum(-1), comm, MODEL))
        local = labels - vocab_start
        mine = mask & (local >= 0) & (local < logits.shape[-1])
        safe = torch.where(mine, local, torch.zeros_like(local))
        picked = reduce_from(torch.gather(
            logits, -1, safe[..., None].long())[..., 0] * mine, comm, MODEL)
    return ((logz - picked) * mask).sum(), mask.sum()


def cross_entropy(logits, labels):
    """Mean CE over positions where labels != IGNORE.  logits fp32."""
    total, count = ce_sum(logits, labels)
    return total / count.clamp(min=1)


def mtp_labels(batch, n):
    """The MTP head's labels: position i predicts token i + 2; ``n`` of
    them (the head's logit sequence)."""
    tokens = batch.get("tgt_tokens", batch.get("tokens"))
    return torch.cat([tokens[:, 2:], torch.full_like(tokens[:, :2], IGNORE)],
                     dim=1)[:, :n]


def lm_loss(cfg, out, batch, *, mtp_weight=0.1):
    """Total training loss: CE + MoE aux + ``mtp_weight`` x the MTP CE
    (where ``out`` has ``"mtp_logits"``: the head at position i
    predicts token i + 2).  Returns (total, metrics)."""
    labels = make_labels(cfg, batch)
    loss = cross_entropy(out["logits"], labels)
    metrics = {"ce": loss, "aux": out["aux"]}
    total = loss + out["aux"]
    if "mtp_logits" in out:
        mtp_ce = cross_entropy(out["mtp_logits"], mtp_labels(
            batch, out["mtp_logits"].shape[1]))
        total = total + mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return total, metrics


# --------------------------------------------------------------------------
# on a mesh
# --------------------------------------------------------------------------

def _global_mean(total, count, comm):
    """(this rank's share total / global count, the global mean
    detached): sums and counts added over the batch axes."""
    axes = shctx.batch_axes(comm)
    n = all_reduce(count.detach().float().clone(), comm, axes).clamp(min=1)
    return total / n, all_reduce(total.detach().clone(), comm, axes) / n


def _own(labels, comm):
    """This rank's block of (B, S) labels when the sequence is cut over
    ``"data"`` (``ctx.seq_split``), else all of them."""
    if not shctx.is_seq_split():
        return labels
    start, s = shctx.seq_block(comm, labels.shape[1])
    return labels[:, start:start + s]


def lm_loss_mesh(cfg, out, batch, comm, *, mtp_weight=0.1):
    """``lm_loss`` on a mesh: (this rank's share of the objective, the
    global metrics).  ``out`` is ``apply_model``'s mesh output; the MoE
    aux is already the mean over the batch axes (``apply_moe_ep``).
    Under the sequence split the logits are this rank's block of the
    positions, and so are the labels read here."""
    start = out.get("vocab_start")
    share, ce = _global_mean(*ce_sum(out["logits"], _own(make_labels(
        cfg, batch), comm), comm, start), comm)
    aux = out["aux"]
    share = share + aux / shctx.dp_share(comm)
    metrics = {"ce": ce, "aux": aux.detach() if isinstance(
        aux, torch.Tensor) else aux}
    total = ce + metrics["aux"]
    if "mtp_logits" in out:
        n = (batch.get("tgt_tokens", batch.get("tokens")).shape[1]
             if shctx.is_seq_split() else out["mtp_logits"].shape[1])
        mtp_share, mtp_ce = _global_mean(*ce_sum(
            out["mtp_logits"], _own(mtp_labels(batch, n), comm), comm,
            start), comm)
        share = share + mtp_weight * mtp_share
        total = total + mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = total
    return share, metrics
