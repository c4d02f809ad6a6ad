"""Losses.  Labels use -1 for masked positions (padding).

Port of ``repro.train.loss`` for decoder-only token batches.  The
vision branch of ``make_labels`` waits with the frontends (which
``models.check_ported`` refuses, so no model reaches it), and the
multi-token-prediction term of ``lm_loss`` with the MTP head (ROADMAP
A.8), which raises by name.
"""
from __future__ import annotations

import torch

IGNORE = -1


def make_labels(cfg, batch):
    """Next-token labels aligned with the model's logit sequence."""
    tokens = batch.get("tgt_tokens", batch.get("tokens"))
    return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], IGNORE)],
                     dim=1)


def cross_entropy(logits, labels):
    """Mean CE over positions where labels != IGNORE.  logits fp32."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    ce = (logz - picked) * mask
    return ce.sum() / mask.sum().clamp(min=1)


def lm_loss(cfg, out, batch, *, mtp_weight=0.1):
    """Total training loss: CE + MoE aux.  Returns (total, metrics)."""
    if "mtp_logits" in out:
        raise ValueError("lm_loss: the multi-token-prediction term is not "
                         "ported (it joins with the MTP head)")
    labels = make_labels(cfg, batch)
    loss = cross_entropy(out["logits"], labels)
    return loss + out["aux"], {"ce": loss, "aux": out["aux"]}
