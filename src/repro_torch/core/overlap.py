"""Bucket-level overlap scheduler for the gradient and parameter
collectives (port of ``repro.core.overlap`` on ``torch.distributed``).

The paper hides the MPI allreduce behind compute ("the communication
... is overlapped with the computation of the next batch", §3.3.3).
This module runs a flat vector's collectives bucket by bucket:

  1. the flat (padded) vector is partitioned into size-bounded buckets
     (``plan_buckets``, the reference's partition exactly: the
     bucket-major shard layout a checkpoint records depends on it);
  2. ``run_pipeline`` issues bucket *k+1*'s collective as an async work
     handle (``async_op=True``) BEFORE it waits on bucket *k* and runs
     its epilogue -- at most one collective in flight while the previous
     bucket finishes, the classic double buffer.  ``serialize=True``
     issues each bucket only after the previous one has finished: the
     same buckets, no overlap (the baseline).

Every collective writes straight into its bucket's slice of the output
(the shard, or the full vector the masters are views of), so a bucket's
epilogue is at most a cast and a division.  On NCCL a handle's
``wait()`` only orders the compute stream behind the collective's, so
the host runs ahead; under gloo the collective runs on gloo's own
threads while the host issues the next one.

The reference's HLO tools (``asyncify_hlo``, ``async_overlap_report``,
``lowered_hlo_text``) read XLA's text and have no twin here: eager
PyTorch issues its collectives itself, and the order of ``issue`` and
``finish`` calls is what the tests observe.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.collectives import (
    _all_gather, _all_reduce, _dp_group, _reduce_scatter, axes_size,
    axis_group, dp_batch_axes, dp_world_size, flatten_padded, group_size,
    unflatten_padded, wire_dtype,
)


# --------------------------------------------------------------------------
# bucket partitioning (the reference's, exactly)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static partition of a padded flat vector into aligned buckets.

    ``starts[k]``/``lengths[k]`` tile ``[0, padded_total)`` exactly;
    every length is a multiple of ``align`` (so a per-bucket
    reduce-scatter over ``align`` workers needs no further padding, and
    the concatenated per-bucket shards have total length
    ``padded_total // align`` -- identical to the unbucketed shard).
    ``total`` is the unpadded element count."""
    starts: tuple
    lengths: tuple
    align: int
    total: int
    padded_total: int

    @property
    def n_buckets(self) -> int:
        return len(self.starts)

    def shard_offsets(self, n_workers: int):
        """Offset of each bucket's shard piece in the concatenated
        per-worker shard (bucket-major layout)."""
        offs, off = [], 0
        for ln in self.lengths:
            offs.append(off)
            off += ln // n_workers
        return tuple(offs), off


def plan_buckets(total: int, *, bucket_bytes: int, itemsize: int = 4,
                 align: int = 1, leaf_sizes=None) -> BucketPlan:
    """Partition a ``total``-element flat vector (padded up to a
    multiple of ``align``) into ~``bucket_bytes`` buckets whose lengths
    are multiples of ``align``.  With ``leaf_sizes`` the buckets follow
    the tensors' boundaries instead (the ``flat`` per-tensor strategy);
    ``align`` must be 1 in that mode."""
    if total <= 0:
        raise ValueError("plan_buckets: empty vector")
    if leaf_sizes is not None:
        if align != 1:
            raise ValueError("per-leaf buckets cannot be aligned")
        starts, off = [], 0
        for sz in leaf_sizes:
            starts.append(off)
            off += sz
        return BucketPlan(tuple(starts), tuple(leaf_sizes), 1, total, off)
    padded = total + (-total) % align
    per = max(align, (max(1, bucket_bytes // itemsize) // align) * align)
    starts, lengths, off = [], [], 0
    while off < padded:
        ln = min(per, padded - off)
        starts.append(off)
        lengths.append(ln)
        off += ln
    return BucketPlan(tuple(starts), tuple(lengths), align, total, padded)


def whole_plan(padded_total: int, align: int) -> BucketPlan:
    """One bucket of the whole padded vector: the contiguous layout
    (``collectives.local_shard``), as one collective."""
    return BucketPlan((0,), (padded_total,), align, padded_total,
                      padded_total)


# --------------------------------------------------------------------------
# the double-buffered pipeline
# --------------------------------------------------------------------------

def run_pipeline(n_buckets, issue, finish, *, serialize=False):
    """Run ``n_buckets`` (issue -> finish) stages double-buffered.

    ``issue(k)`` starts bucket *k*'s collective and returns what
    ``finish(k, pending)`` needs (its work handle and buffer);
    ``finish`` waits on it and folds the result into the output.  In
    overlapped mode bucket *k+1* is issued before bucket *k* is
    finished; ``serialize=True`` issues each bucket only after the
    previous one has finished."""
    if serialize:
        for k in range(n_buckets):
            finish(k, issue(k))
        return
    pending = issue(0)
    for k in range(1, n_buckets):
        nxt = issue(k)
        finish(k - 1, pending)
        pending = nxt
    finish(n_buckets - 1, pending)


# --------------------------------------------------------------------------
# reduce-scatter / all-gather of a flat vector, bucket by bucket
# --------------------------------------------------------------------------

def _stages(mesh, axes):
    """The groups one reduce-scatter crosses, in order, and the worker
    count: one group for axes in the mesh's own order; for the
    intra-major order ``("data", "pod")`` of the hier strategies, the
    intra-pod group then the cross-pod one (worker ``i * n_pods + k``
    at data index i, pod k)."""
    if tuple(axes) == ("data", "pod"):
        return [mesh.get_group("data"), mesh.get_group("pod")], \
            axes_size(mesh, axes)
    return [axis_group(mesh, axes)], axes_size(mesh, axes)


def reduce_scatter_flat(flat, mesh, axes, plan: BucketPlan, *, mean=True,
                        compress="none", serialize=False, async_op=False):
    """Reduce-scatter the padded flat vector ``flat`` (``flat.numel() ==
    plan.padded_total``) into this worker's *bucket-major* shard (for a
    one-bucket plan, its contiguous shard), bucket-pipelined.  The wire
    carries ``compress``'s dtype and the shard is fp32 then; ``mean``
    divides the sum by the worker count.  Over the hier axes each
    bucket is reduce-scattered inside the pod first, then its piece
    across pods (the cross-pod link moves 1/n_intra of the bucket).
    ``async_op=True`` (a one-bucket plan) issues the collective and
    returns a function that waits for it and returns the shard."""
    groups, n = _stages(mesh, axes)
    offs, shard_len = plan.shard_offsets(n)
    wdt = wire_dtype(flat.dtype, compress)
    out = torch.empty(shard_len, dtype=torch.float32 if compress == "bf16"
                      else flat.dtype, device=flat.device)
    wire = flat if wdt == flat.dtype else flat.to(wdt)

    direct = wdt == out.dtype     # the last stage writes into ``out``

    def issue(k):
        src = wire[plan.starts[k]:plan.starts[k] + plan.lengths[k]]
        for i, g in enumerate(groups):
            last = i == len(groups) - 1
            dst = (out[offs[k]:offs[k] + plan.lengths[k] // n]
                   if last and direct else
                   torch.empty(src.numel() // group_size(g), dtype=wdt,
                               device=src.device))
            work = _reduce_scatter(dst, src, g, async_op=True)
            if not last:
                work.wait()
            src = dst
        return work, src

    def finish(k, pending):
        work, piece = pending
        work.wait()
        dst = out[offs[k]:offs[k] + plan.lengths[k] // n]
        if not direct:
            dst.copy_(piece)
        if mean:
            dst.div_(n)

    if async_op:
        if plan.n_buckets != 1:
            raise ValueError("async_op takes a one-bucket plan")
        pending = issue(0)

        def wait():
            finish(0, pending)
            return out
        return wait
    run_pipeline(plan.n_buckets, issue, finish, serialize=serialize)
    return out


def all_gather_flat(shard, mesh, axes, plan: BucketPlan, *, out=None,
                    compress="none", serialize=False):
    """All-gather a bucket-major shard back into the full padded flat
    vector (written into ``out`` when given: the buffer the masters are
    views of), bucket-pipelined.  ``compress="bf16"`` gathers in bf16
    and casts into ``out``.  Over the hier axes the small cross-pod
    gather runs first, then the intra-pod one."""
    groups, n = _stages(mesh, axes)
    groups = groups[::-1]
    offs, _ = plan.shard_offsets(n)
    if out is None:
        out = torch.empty(plan.padded_total, dtype=shard.dtype,
                          device=shard.device)
    wdt = wire_dtype(shard.dtype, compress)
    wire = shard if wdt == shard.dtype else shard.to(wdt)

    direct = wdt == out.dtype

    def issue(k):
        src = wire[offs[k]:offs[k] + plan.lengths[k] // n]
        for i, g in enumerate(groups):
            last = i == len(groups) - 1
            dst = (out[plan.starts[k]:plan.starts[k] + plan.lengths[k]]
                   if last and direct else
                   torch.empty(src.numel() * group_size(g), dtype=wdt,
                               device=src.device))
            work = _all_gather(dst, src, g, async_op=True)
            if not last:
                work.wait()
            src = dst
        return work, src

    def finish(k, pending):
        work, full = pending
        work.wait()
        if not direct:
            out[plan.starts[k]:plan.starts[k] + plan.lengths[k]].copy_(full)

    run_pipeline(plan.n_buckets, issue, finish, serialize=serialize)
    return out


def plan_local_shard(flat, worker: int, n: int, plan: BucketPlan):
    """Worker ``worker``'s bucket-major shard of a replicated padded
    vector -- the slice layout ``reduce_scatter_flat`` produces (the
    bucketed analogue of ``collectives.local_shard``), as a new
    tensor."""
    pieces = [flat[s + worker * (ln // n):s + (worker + 1) * (ln // n)]
              for s, ln in zip(plan.starts, plan.lengths)]
    return torch.cat(pieces)


# --------------------------------------------------------------------------
# the reference's entry points over lists of tensors
# --------------------------------------------------------------------------

def overlapped_reduce_scatter(tensors, mesh, axes, *,
                              bucket_bytes=64 * 2 ** 20, compress="none",
                              serialize=False, plan=None):
    """Bucket-pipelined ``reduce_scatter_mean``: the tensors flattened
    and padded to the worker count, reduce-scattered into this worker's
    bucket-major shard.  Returns ``(shard, spec, plan)``; rebuild with
    ``overlapped_all_gather`` under the same plan."""
    if not tensors:
        raise ValueError("overlapped_reduce_scatter: empty tensor list")
    n = axes_size(mesh, axes)
    flat, spec = flatten_padded(tensors, n)
    if plan is None:
        plan = plan_buckets(flat.numel(), bucket_bytes=bucket_bytes,
                            itemsize=flat.element_size(), align=n)
    shard = reduce_scatter_flat(flat, mesh, axes, plan, compress=compress,
                                serialize=serialize)
    return shard, spec, plan


def overlapped_all_gather(shard, mesh, axes, spec, plan: BucketPlan, *,
                          serialize=False):
    """Inverse of ``overlapped_reduce_scatter`` / ``plan_local_shard``:
    gather every bucket's pieces and rebuild the tensors (views of one
    new flat vector)."""
    return unflatten_padded(all_gather_flat(shard, mesh, axes, plan,
                                            serialize=serialize), spec)


def overlapped_allreduce(tensors, mesh, *, strategy="bucketed",
                         bucket_bytes=64 * 2 ** 20, compress="none",
                         serialize=False):
    """Bucket-pipelined gradient averaging for the replicated strategies,
    IN PLACE on ``tensors`` (as ``collectives.allreduce_mean``): the same
    per-element sum over the ranks, / p, issued bucket by bucket.
    ``flat`` takes one bucket a tensor; ``hierarchical`` on a pod x data
    mesh runs reduce-scatter(data) -> all-reduce(pod) -> all-gather(data)
    a bucket; ``zero1`` the reduce-scatter / all-gather round trip."""
    if not tensors:
        return tensors
    axes = dp_batch_axes(mesh)
    p = dp_world_size(mesh)
    if strategy == "zero1":
        shard, spec, plan = overlapped_reduce_scatter(
            tensors, mesh, axes, bucket_bytes=bucket_bytes,
            compress=compress, serialize=serialize)
        for t, g in zip(tensors, overlapped_all_gather(
                shard, mesh, axes, spec, plan, serialize=serialize)):
            t.copy_(g)
        return tensors
    hier = strategy == "hierarchical" and len(axes) > 1
    n_intra = mesh.size(mesh.mesh_dim_names.index("data")) if hier else 1
    wdt = wire_dtype(tensors[0].dtype, compress)
    flat, spec = flatten_padded(tensors, 1, dtype=wdt)
    if strategy == "flat" or (strategy == "hierarchical" and not hier):
        plan = plan_buckets(flat.numel(), bucket_bytes=bucket_bytes,
                            leaf_sizes=[t.numel() for t in tensors])
    else:
        plan = plan_buckets(flat.numel(), bucket_bytes=bucket_bytes,
                            itemsize=flat.element_size(), align=n_intra)
    if plan.padded_total > flat.numel():
        flat = torch.cat([flat, flat.new_zeros(plan.padded_total
                                               - flat.numel())])
    group = _dp_group(mesh)

    def issue(k):
        b = flat[plan.starts[k]:plan.starts[k] + plan.lengths[k]]
        if not hier:
            return _all_reduce(b, group, async_op=True), b
        intra, inter = mesh.get_group("data"), mesh.get_group("pod")
        sh = b.new_empty(b.numel() // n_intra)
        _reduce_scatter(sh, b, intra, async_op=True).wait()
        _all_reduce(sh, inter, async_op=True).wait()
        return _all_gather(b, sh, intra, async_op=True), b

    def finish(k, pending):
        work, b = pending
        work.wait()
        b.div_(p)

    run_pipeline(plan.n_buckets, issue, finish, serialize=serialize)
    for t, avg in zip(tensors, unflatten_padded(flat, spec)):
        t.copy_(avg)
    return tensors
