"""The ``Layout`` record of a train state (port of the record half of
``repro.core.train_state``).

A ``Layout`` says what each data-parallel worker physically holds: the
kind of sharding, the mesh axes the workers span, their count, and the
flattened parameter count.  The checkpoint store writes it into
``meta.json`` and reads it back, so the two packages agree on it field
for field (``to_json`` / ``from_json``).

The port's strategies (``flat``, ``bucketed``, ``hierarchical``) all
keep the state replicated on every rank, so ``"replicated"`` is the one
kind here.  The ZeRO kinds (``zero1``, ``zero2``, ``zero3``,
``zero1_hier``, ``zero3_hier``), their flat shards and bucket-major
permutation wait for ROADMAP A.4: a layout of such a kind raises by
name.  As in the reference, a replicated layout built for a mesh
records ``num_shards = p``, so two world sizes are two layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

LAYOUT_KINDS = {"replicated"}
# the reference's sharded kinds, not ported yet
ZERO_KINDS = ("zero1", "zero2", "zero3", "zero1_hier", "zero3_hier")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static descriptor of how a train state's leaves are laid out.

    kind          -- "replicated" (the ZeRO kinds wait for ROADMAP A.4).
    axes          -- mesh axis names the workers span (the batch axes);
                     () for the one-process sequential state.
    num_shards    -- p, the data-parallel world size (1 without a mesh).
    total         -- element count of the flattened parameter tree (a
                     tied table counted once).
    padded_total  -- ``total`` (a replicated state has no padding).
    bucket_bytes  -- None: replicated leaves have no bucket-major order.
    strategy      -- registry name of the strategy that built the state
                     (None for the sequential state).
    """
    kind: str = "replicated"
    axes: tuple = ()
    num_shards: int = 1
    total: int = 0
    padded_total: int = 0
    bucket_bytes: Optional[int] = None
    strategy: Optional[str] = None

    def __post_init__(self):
        if self.kind in ZERO_KINDS:
            raise ValueError(
                f"layout kind {self.kind!r} (sharded optimizer state, "
                "gradients or params) is not ported yet: it waits for "
                "ROADMAP A.4; the port keeps replicated states")
        if self.kind not in LAYOUT_KINDS:
            raise ValueError(f"unknown layout kind {self.kind!r}")

    def to_json(self) -> dict:
        """The portable identity of this layout (checkpoint meta)."""
        return {"kind": self.kind, "axes": list(self.axes),
                "num_shards": self.num_shards, "total": self.total,
                "padded_total": self.padded_total,
                "bucket_bytes": self.bucket_bytes,
                "strategy": self.strategy}

    @staticmethod
    def from_json(d: dict) -> "Layout":
        return Layout(kind=d["kind"], axes=tuple(d["axes"]),
                      num_shards=int(d["num_shards"]), total=int(d["total"]),
                      padded_total=int(d["padded_total"]),
                      bucket_bytes=d.get("bucket_bytes"),
                      strategy=d.get("strategy"))


def replicated_layout(masters, mesh=None, strategy=None) -> Layout:
    """The replicated layout of a state whose trainable masters are
    ``masters`` ({name: tensor}): without a mesh, the reference's
    ``init_train_state(mesh=None)`` record ``("replicated", (), 1,
    total, total)``; on a data-parallel mesh, what its
    ``ReplicatedStrategy.layout`` records -- the batch axes,
    ``num_shards = p`` and the strategy's name."""
    total = sum(int(p.numel()) for p in masters.values())
    if mesh is None:
        return Layout("replicated", (), 1, total, total)
    from repro_torch.core.collectives import dp_batch_axes, dp_world_size
    return Layout("replicated", dp_batch_axes(mesh), dp_world_size(mesh),
                  total, total, strategy=strategy)
