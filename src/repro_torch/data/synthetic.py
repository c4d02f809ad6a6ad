"""Synthetic datasets with the paper's dataset shapes, and token streams
(numpy port of ``repro.data.synthetic`` and of
``repro.launch.train.make_batch``).

The paper's datasets (MNIST, CIFAR10, Adult, Acoustic, HIGGS) are not
redistributable offline, so ``make_dataset`` generates seeded
teacher-labelled data with the same feature / class / sample geometry
as the reference: a frozen random tanh "teacher" MLP labels
Gaussian-mixture inputs.  It draws with a numpy ``Generator``; the
reference draws from JAX's random stream, which numpy cannot reproduce,
so the values differ from the reference's while the geometry, shapes,
dtypes and classes are the same.  Parity tests hand one set of numpy
arrays to both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# name -> (n_features | image hw+c, n_classes, n_train)
PAPER_DATASET_SHAPES = {
    "adult":    {"features": 123, "classes": 2, "train": 32_561},
    "acoustic": {"features": 50, "classes": 3, "train": 78_823},
    "mnist":    {"features": 784, "classes": 10, "train": 60_000,
                 "image": (28, 28, 1)},
    "cifar10":  {"features": 3072, "classes": 10, "train": 50_000,
                 "image": (32, 32, 3)},
    "higgs":    {"features": 28, "classes": 2, "train": 10_900_000,
                 "subsample": 200_000},   # keep CPU runs tractable
}


@dataclasses.dataclass
class Dataset:
    name: str
    x: np.ndarray          # (N, features) or (N, H, W, C)
    y: np.ndarray          # (N,)
    num_classes: int


def _teacher_labels(rng, x, n_classes):
    d = x.shape[1]
    w1 = rng.standard_normal((d, 64), dtype=np.float32) / np.sqrt(d)
    w2 = rng.standard_normal((64, n_classes), dtype=np.float32) / 8.0
    return np.argmax(np.tanh(x @ w1) @ w2, axis=-1)


def make_dataset(name: str, *, seed: int = 0, as_images: bool = False,
                 n: int | None = None) -> Dataset:
    """``n`` samples (default: the train set, HIGGS subsampled) of a
    Gaussian mixture of 8 centres (x 1.5) plus unit noise, labelled by
    the argmax of the teacher; ``as_images`` reshapes MNIST and CIFAR10
    to NHWC."""
    spec = PAPER_DATASET_SHAPES[name]
    n = n or spec.get("subsample", spec["train"])
    rng = np.random.default_rng(seed)
    d = spec["features"]
    centers = rng.standard_normal((8, d), dtype=np.float32) * 1.5
    comp = rng.integers(0, 8, n)
    x = centers[comp] + rng.standard_normal((n, d), dtype=np.float32)
    y = _teacher_labels(rng, x, spec["classes"])
    if as_images and "image" in spec:
        x = x.reshape((n,) + spec["image"])
    return Dataset(name, x, y.astype(np.int32), spec["classes"])


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
