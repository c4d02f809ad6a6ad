"""The train-state contract of data-parallel training (port of
``repro.core.train_state``).

The paper keeps a full model replica and full optimizer state on every
MPI rank (§3.3.3), which caps model size at one device's memory.  The
ZeRO ladder removes that wall by sharding, per rank, first the
optimizer state (zero1), then the gradients (zero2), then the params
themselves (zero3).  ``Layout`` says what each worker physically holds,
so the train step, the collectives and the checkpoint store agree:
the sharding kind, the mesh axes the shards span (their order numbers
the workers), the shard count, the flattened (and padded) element
counts, and -- because the overlap scheduler stores shards
bucket-major -- the bucket size that generated the permutation.  The
checkpoint store writes it into ``meta.json`` (``to_json`` /
``from_json``, field for field the reference's) and reshards between
any two layouts on restore.

A state is ``train.step.TrainState``: ``params`` is the model (its
masters are views of the flat master vector in a sharded state),
``opt_state`` the optimizer's dict -- over ``{"flat": shard}`` in a
sharded state, so its moments are ``opt_state["m"]["flat"]`` as in the
reference -- ``step``, ``layout`` and, sharded, ``flat``
(``core.flat.FlatMasters``).  As in the reference, a replicated layout
built for a mesh records ``num_shards = p``, so two world sizes are
two layouts.

The host-side resharding primitives (``assemble_full_flat``,
``split_flat_shards``) are the reference's, on numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import (_all_gather, dp_batch_axes,
                                          dp_world_size)
from repro_torch.core.overlap import BucketPlan, plan_buckets

SHARDED_KINDS = {"zero1", "zero2", "zero3"}
LAYOUT_KINDS = {"replicated"} | SHARDED_KINDS


def register_layout_kind(kind: str, *, sharded: bool):
    """Make a new layout kind legal (strategy registration calls this,
    so a custom strategy carries its own kind through the state and the
    checkpoint store).  Re-registering an existing kind the other way
    is rejected: a sharded strategy that forgets to set its own
    ``kind`` (and so inherits "replicated") fails HERE."""
    if not kind or not isinstance(kind, str):
        raise ValueError(f"layout kind must be a non-empty str, got {kind!r}")
    if kind in LAYOUT_KINDS and (kind in SHARDED_KINDS) != sharded:
        raise ValueError(
            f"layout kind {kind!r} is already registered as "
            f"{'sharded' if kind in SHARDED_KINDS else 'replicated'}; a "
            "sharded strategy must declare its own kind (set the `kind` "
            "class attribute) instead of re-flagging an existing one")
    LAYOUT_KINDS.add(kind)
    if sharded:
        SHARDED_KINDS.add(kind)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static descriptor of how a train state's leaves are laid out.

    kind          -- "replicated" | "zero1" | "zero2" | "zero3" | a
                     registered kind ("zero1_hier", "zero3_hier").
    axes          -- mesh axis names the shards span, in the order that
                     numbers the workers; () without a mesh.
    num_shards    -- p, the data-parallel world size (1 without a mesh).
    total         -- element count of the flattened parameter tree (a
                     tied table counted once).
    padded_total  -- ``total`` padded up to a multiple of num_shards
                     (sharded), or ``total`` (replicated).
    bucket_bytes  -- None: shards are contiguous slices of the flat
                     vector.  Set: shards are bucket-major under
                     ``plan_buckets(..., align=num_shards)``.
    param_spec    -- params-sharded layouts (zero3) only: the
                     ``core.flat.FlatSpec`` that rebuilds the masters
                     from the flat vector.
    param_dtypes  -- params-sharded layouts only: each master's dtype
                     ("float32" or "bfloat16"), in ``param_spec``'s
                     order.
    strategy      -- registry name of the strategy that built the state
                     (None for the sequential state).
    """
    kind: str = "replicated"
    axes: tuple = ()
    num_shards: int = 1
    total: int = 0
    padded_total: int = 0
    bucket_bytes: Optional[int] = None
    param_spec: Any = None
    param_dtypes: tuple = ()
    strategy: Optional[str] = None

    def __post_init__(self):
        if self.kind not in LAYOUT_KINDS:
            raise ValueError(f"unknown layout kind {self.kind!r}")

    @property
    def sharded(self) -> bool:
        return self.kind in SHARDED_KINDS

    @property
    def params_flat(self) -> bool:
        """True when the params persist as the flat 1/p shard (zero3 and
        any params-sharded strategy), signalled by ``param_spec``."""
        return self.param_spec is not None

    @property
    def shard_len(self) -> int:
        return self.padded_total // max(self.num_shards, 1)

    def plan(self) -> Optional[BucketPlan]:
        """The bucket plan generating the shard permutation, or None for
        the contiguous layout.  Itemsize 4 whatever the masters' dtype,
        as in the reference, so a bf16 state's buckets are the fp32
        state's and the permutation depends on the layout alone."""
        if self.bucket_bytes is None:
            return None
        return plan_buckets(self.padded_total, bucket_bytes=self.bucket_bytes,
                            itemsize=4, align=self.num_shards)

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
    return Layout("replicated", dp_batch_axes(mesh), dp_world_size(mesh),
                  total, total, strategy=strategy)


def init_train_state(optimizer, model, mesh=None, dp=None):
    """The ``TrainState`` ``make_dp_train_step(..., dp)`` consumes, built
    by the registered strategy's ``init`` (``mesh=None``: the replicated
    state of the sequential step).  ``model``'s masters are taken over:
    a sharded state makes them views of its flat master vector."""
    from repro_torch.core.data_parallel import DPConfig
    from repro_torch.core.strategy import get_strategy
    from repro_torch.train.step import start_state
    if mesh is None:
        return start_state(model, optimizer)
    dp = dp if dp is not None else DPConfig()
    return get_strategy(dp.strategy).init(optimizer, model, mesh, dp)


def assemble_full_flat(shards, layout: Layout) -> np.ndarray:
    """Worker shards (worker order) -> full padded contiguous vector,
    undoing the bucket-major permutation where the layout has one.
    Host-side numpy: the resharding primitive of the checkpoint store."""
    n = layout.num_shards
    plan = layout.plan()
    if plan is None:
        return np.concatenate(shards)
    full = np.empty(sum(s.size for s in shards), shards[0].dtype)
    offs, _ = plan.shard_offsets(n)
    for k in range(plan.n_buckets):
        pk = plan.lengths[k] // n
        for w in range(n):
            full[plan.starts[k] + w * pk:plan.starts[k] + (w + 1) * pk] = \
                shards[w][offs[k]:offs[k] + pk]
    return full


def split_flat_shards(full_padded, layout: Layout) -> list:
    """Full padded contiguous vector -> worker shards (worker order);
    inverse of :func:`assemble_full_flat`."""
    n = layout.num_shards
    plan = layout.plan()
    if plan is None:
        per = full_padded.size // n
        return [full_padded[w * per:(w + 1) * per] for w in range(n)]
    shards = [np.empty(full_padded.size // n, full_padded.dtype)
              for _ in range(n)]
    offs, _ = plan.shard_offsets(n)
    for k in range(plan.n_buckets):
        pk = plan.lengths[k] // n
        for w in range(n):
            shards[w][offs[k]:offs[k] + pk] = \
                full_padded[plan.starts[k] + w * pk:
                            plan.starts[k] + (w + 1) * pk]
    return shards


def rank_workers(mesh, axes) -> list:
    """The worker number over ``axes`` of every rank, by rank."""
    names = mesh.mesh_dim_names
    grid = mesh.mesh.numpy()
    out = [0] * grid.size
    for idx in np.ndindex(grid.shape):
        coord = dict(zip(names, idx))
        w = 0
        for a in axes:
            w = w * grid.shape[names.index(a)] + coord[a]
        out[int(grid[idx])] = w
    return out


def gather_shards(shard, mesh, axes) -> list:
    """Every worker's shard of a flat sharded leaf, on the host in
    worker order (a bf16 leaf as fp32, exactly): an all-gather over the
    default group (a collective, so every rank calls it), then ordered
    by ``rank_workers``."""
    world = dist.get_world_size()
    buf = shard.new_empty(world * shard.numel())
    _all_gather(buf, shard.contiguous(), None)
    host = buf.to("cpu").float().numpy().reshape(world, -1)
    shards = [None] * world
    for r, w in enumerate(rank_workers(mesh, axes)):
        shards[w] = host[r].copy()
    return shards


def host_params(state, mesh=None) -> dict:
    """Host copy of the FULL masters, ``{name: numpy array}``, whatever
    the layout -- always a copy; numpy has no bf16, so bf16 masters come
    back as fp32 arrays of the same values.  For a params-flat layout
    (zero3) the shards are gathered to every rank's host and
    reassembled there (``gather_shards`` + ``assemble_full_flat``; a
    collective, so every rank of ``mesh`` calls it), and each leaf is
    cast to its ``param_dtypes`` entry (bf16 leaves to fp32)."""
    from repro_torch.train.step import trainable
    layout = state.layout
    if not layout.params_flat:
        return {k: p.detach().to("cpu", torch.float32 if p.dtype ==
                                 torch.bfloat16 else p.dtype,
                                 copy=True).numpy()
                for k, p in trainable(state.params).items()}
    shards = gather_shards(state.flat.shard, mesh, layout.axes)
    flat = assemble_full_flat(shards, layout)
    return {name: flat[a:b].reshape(shp).astype(
        np.float32 if dt == "bfloat16" else dt, copy=True)
            for (name, a, b, shp), dt in zip(layout.param_spec.slices(),
                                             layout.param_dtypes)}


def check_layout(layout: Layout, expected_kind: str, dp, mesh):
    """Loud contract check: a state built for one strategy, world size
    or shard order fed to another's step raises, pointing at the way
    back (rebuild it, or reshard through the checkpoint store)."""
    from repro_torch.core.strategy import get_strategy
    if not isinstance(layout, Layout):
        raise TypeError(
            "make_dp_train_step takes a TrainState: build one with "
            "init_train_state(optimizer, model, mesh, dp)")
    if layout.kind != expected_kind:
        raise ValueError(
            f"TrainState layout kind {layout.kind!r} does not match "
            f"DPConfig strategy {dp.strategy!r} (expected "
            f"{expected_kind!r}); rebuild with init_train_state(...) or "
            "reshard via checkpoint.restore_sharded_checkpoint")
    if layout.sharded and layout.num_shards != dp_world_size(mesh):
        raise ValueError(
            f"TrainState sharded over {layout.num_shards} workers but "
            f"mesh has {dp_world_size(mesh)}; reshard via the checkpoint "
            "store")
    want = get_strategy(dp.strategy).bucket_layout(dp)
    if layout.sharded and layout.bucket_bytes != want:
        raise ValueError(
            f"TrainState shard layout is "
            f"{'bucket-major' if layout.bucket_bytes else 'contiguous'} "
            f"(bucket_bytes={layout.bucket_bytes}) but DPConfig("
            f"overlap={dp.overlap!r}, bucket_bytes={dp.bucket_bytes}, "
            f"microbatches={dp.microbatches}) expects bucket_bytes={want}; "
            "rebuild with init_train_state(...) or reshard via the "
            "checkpoint store")
