"""Synthetic token streams and batches (numpy port of
``repro.data.synthetic`` and of ``repro.launch.train.make_batch``)."""
from __future__ import annotations

import numpy as np


def synthetic_tokens(rng: np.random.Generator, batch, seq_len, vocab):
    """Zipf-ish synthetic tokens: floor(vocab ** u), u ~ U[0, 1),
    clipped to the vocabulary -- heavy-tailed like real text."""
    u = rng.random((batch, seq_len), dtype=np.float32)
    ranks = np.floor(np.float32(vocab) ** u).astype(np.int32)
    return np.clip(ranks, 0, vocab - 1)


def make_batch(cfg, rng: np.random.Generator, batch, seq):
    """A decoder-only training batch ``{"tokens": (batch, seq) int32}``
    drawn from ``rng``.  The reference's encoder-decoder and vision
    batches wait with those frontends (``models.check_ported``)."""
    return {"tokens": synthetic_tokens(rng, batch, seq, cfg.vocab_size)}
