"""Token sampling: greedy / temperature / top-k / nucleus (top-p).

Port of ``repro.serve.sampling``.  Draws come from an explicit
``torch.Generator`` on the logits' device (Gumbel-max, so a draw is one
device computation with no host round-trip).  The reference's
``jax.random`` keys give other numbers from the same seed; greedy
decoding is what the two packages are held equal on.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0     # 0 = greedy
    top_k: int = 0               # 0 = off
    top_p: float = 1.0           # 1 = off


def filter_logits(logits, sc: SamplingConfig):
    """Temperature / top-k / nucleus filtering of (B, V) logits.

    Top-k masks its tail to -inf first; the nucleus cutoff is then
    clamped into the FINITE region (a cumsum that tops out just below
    ``top_p`` must not land on a -inf entry and disable the nucleus),
    and ties at the cutoff break deterministically (stable descending
    sort, lower token id first): the kept set is exactly the first
    ``cutoff_idx + 1`` sorted entries."""
    if sc.temperature <= 0.0:
        return logits
    logits = logits / sc.temperature
    if sc.top_k > 0:
        kth = torch.topk(logits, sc.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if sc.top_p < 1.0:
        V = logits.shape[-1]
        order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
        sorted_logits = torch.gather(logits, -1, order)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < sc.top_p).sum(dim=-1)
        n_finite = torch.isfinite(sorted_logits).sum(dim=-1)
        cutoff_idx = torch.minimum(cutoff_idx, (n_finite - 1).clamp_min(0))
        keep_sorted = (torch.arange(V, device=logits.device)[None, :]
                       <= cutoff_idx[:, None])
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        logits = torch.where(keep, logits, -torch.inf)
    return logits


def sample(logits, generator, sc: SamplingConfig):
    """logits: (B, V) fp32 -> token ids (B,) int32."""
    if sc.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(filter_logits(logits, sc) + gumbel,
                        dim=-1).to(torch.int32)


def masked_sample(logits, generator, done, pad_id, sc: SamplingConfig):
    """Sample next tokens with retired lanes pinned to ``pad_id`` -- the
    on-device EOS masking of the fused decode tick."""
    t = sample(logits, generator, sc)
    return torch.where(done, torch.full_like(t, pad_id), t)
