"""Losses.  Labels use -1 for masked positions (padding, image tokens).

Port of ``repro.train.loss``: token batches, an encoder-decoder's
target tokens, a VLM's image rows (IGNORE labels in front of the text),
and the multi-token-prediction term.
"""
from __future__ import annotations

import torch

IGNORE = -1


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


def cross_entropy(logits, labels):
    """Mean CE over positions where labels != IGNORE.  logits fp32."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    ce = (logz - picked) * mask
    return ce.sum() / mask.sum().clamp(min=1)


def lm_loss(cfg, out, batch, *, mtp_weight=0.1):
    """Total training loss: CE + MoE aux + ``mtp_weight`` x the MTP CE
    (where ``out`` has ``"mtp_logits"``: the head at position i
    predicts token i + 2).  Returns (total, metrics)."""
    labels = make_labels(cfg, batch)
    loss = cross_entropy(out["logits"], labels)
    metrics = {"ce": loss, "aux": out["aux"]}
    total = loss + out["aux"]
    if "mtp_logits" in out:
        tokens = batch.get("tgt_tokens", batch.get("tokens"))
        mtp_labels = torch.cat(
            [tokens[:, 2:], torch.full_like(tokens[:, :2], IGNORE)],
            dim=1)[:, :out["mtp_logits"].shape[1]]
        mtp_ce = cross_entropy(out["mtp_logits"], mtp_labels)
        total = total + mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return total, metrics
