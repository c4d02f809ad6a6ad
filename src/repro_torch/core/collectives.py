"""Allreduce strategies -- the paper's MPI collective on
``torch.distributed`` (port of ``repro.core.collectives``).

The paper's §3.3.3 argument: synchronous averaging scales because MPI's
all-to-all reduction runs in log(p) time on high-performance
interconnects.  A JAX mesh becomes a
``torch.distributed.device_mesh.DeviceMesh`` with the dimension names
``("data",)`` or ``("pod", "data")``; the group of an axis is
``mesh.get_group(name)``.  The strategies:

  * ``flat``         -- one ``all_reduce`` per tensor (MPI_Allreduce per
                       gradient);
  * ``bucketed``     -- the tensors concatenated into a few large 1-D
                       buckets, one collective per bucket (Horovod's
                       "tensor fusion");
  * ``hierarchical`` -- reduce-scatter over the intra-pod ``data`` axis,
                       all-reduce of the 1/|data| shard over ``pod``,
                       all-gather over ``data``: the cross-pod link
                       moves 1/|data| of the volume.  A single-pod mesh
                       degenerates to ``flat``.

Every function averages IN PLACE: the tensors passed (the masters'
``.grad``, or the masters themselves) hold the mean afterwards, and the
same tensors are returned.  gloo has no ``ReduceOp.AVG``, so each sums
and divides by p.  ``compress="bf16"`` halves the wire volume: the
values are cast to bf16, summed in bf16 and written back in their own
dtype.  Ranks are processes; the data-parallel mesh spans every rank.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

DP_AXES = ("pod", "data")
WIRE_DTYPES = {"none": None, "bf16": torch.bfloat16}


def dp_batch_axes(mesh) -> tuple:
    """The mesh axes the batch (and the paper's allreduce) span."""
    return tuple(a for a in DP_AXES if a in mesh.mesh_dim_names)


def dp_world_size(mesh) -> int:
    """Number of data-parallel workers (the paper's p)."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in dp_batch_axes(mesh))


def check_dp_mesh(mesh):
    """A data-parallel mesh is ``("data",)`` or ``("pod", "data")`` and
    spans every rank of the default group."""
    names = tuple(mesh.mesh_dim_names or ())
    if names not in (("data",), ("pod", "data")):
        raise ValueError(f"a data-parallel mesh has the dimensions "
                         f"('data',) or ('pod', 'data'), got {names}")
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError(f"the data-parallel mesh holds {mesh.mesh.numel()} "
                         f"of {dist.get_world_size()} ranks; it must span "
                         "every rank")


def _dp_group(mesh):
    """The group spanning the batch axes: the data axis's, or the
    default group for a pod x data mesh (which spans every rank)."""
    axes = dp_batch_axes(mesh)
    return mesh.get_group(axes[0]) if len(axes) == 1 else None


def _wire(t, compress):
    dt = WIRE_DTYPES[compress]
    return t if dt is None or t.dtype == dt else t.to(dt)


def allreduce_flat(tensors, mesh, *, compress="none"):
    """One ``all_reduce(SUM)`` per tensor over the batch axes, then / p."""
    group, p = _dp_group(mesh), dp_world_size(mesh)
    for t in tensors:
        w = _wire(t, compress)
        dist.all_reduce(w, group=group)
        w.div_(p)
        if w is not t:
            t.copy_(w)
    return tensors


def allreduce_bucketed(tensors, mesh, *, bucket_bytes=64 * 2 ** 20,
                       compress="none"):
    """The tensors concatenated (in order) into one flat vector in the
    wire dtype, zero-padded to whole buckets of ``bucket_bytes //
    itemsize`` elements (one bucket of the whole, unpadded, when that is
    smaller); one ``all_reduce`` per bucket, then / p, then copied
    back."""
    if not tensors:
        return tensors
    group, p = _dp_group(mesh), dp_world_size(mesh)
    dt = WIRE_DTYPES[compress] or tensors[0].dtype
    total = sum(t.numel() for t in tensors)
    per = _bucket_elems(total, bucket_bytes, dt)
    n_buckets = -(-total // per)
    flat = torch.zeros(n_buckets * per, dtype=dt, device=tensors[0].device)
    off = 0
    for t in tensors:
        flat[off:off + t.numel()].copy_(t.reshape(-1))
        off += t.numel()
    for bucket in flat.view(n_buckets, per):
        dist.all_reduce(bucket, group=group)
    flat.div_(p)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return tensors


def _bucket_elems(total, bucket_bytes, dtype):
    return max(1, min(total, bucket_bytes // dtype.itemsize))


# newer torch names the single-tensor collectives ``*_single``; older
# releases only have ``*_tensor``
def _reduce_scatter(out, inp, group):
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def _all_gather(out, inp, group):
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def allreduce_hierarchical(tensors, mesh, *, compress="none"):
    """reduce-scatter(data) -> all-reduce(pod) -> all-gather(data), per
    tensor, then / p.  Wire cost per rank: 2 (n-1)/n V inside a pod and
    V/n across pods, against V across pods for ``flat`` (n = |data|)."""
    intra, inter = mesh.get_group("data"), mesh.get_group("pod")
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    p = dp_world_size(mesh)
    for t in tensors:
        w = _wire(t, compress).reshape(-1)
        size = w.numel()
        flat = torch.zeros(size + (-size) % n, dtype=w.dtype,
                           device=w.device)
        flat[:size].copy_(w)
        shard = flat.new_empty(flat.numel() // n)
        _reduce_scatter(shard, flat, intra)
        dist.all_reduce(shard, group=inter)
        _all_gather(flat, shard, intra)
        t.copy_(flat[:size].view_as(t).div_(p))
    return tensors


def allreduce_mean(tensors, mesh, *, strategy="flat", compress="none",
                   bucket_bytes=64 * 2 ** 20):
    """Average the list ``tensors`` over the ranks of ``mesh``'s batch
    axes, in place, with the named strategy; returns the same list."""
    if compress not in WIRE_DTYPES:
        raise ValueError(f"compress must be one of {sorted(WIRE_DTYPES)}, "
                         f"got {compress!r}")
    if strategy == "flat" or (strategy == "hierarchical"
                              and len(dp_batch_axes(mesh)) == 1):
        return allreduce_flat(tensors, mesh, compress=compress)
    if strategy == "bucketed":
        return allreduce_bucketed(tensors, mesh, bucket_bytes=bucket_bytes,
                                  compress=compress)
    if strategy == "hierarchical":
        return allreduce_hierarchical(tensors, mesh, compress=compress)
    if strategy == "zero1":
        raise ValueError("the zero1 reduce-scatter / all-gather round trip "
                         "waits with the sharded-optimizer strategies "
                         "(ROADMAP A.4)")
    raise ValueError(f"unknown allreduce strategy {strategy!r}")


def wire_bytes(tensors, *, strategy="flat", compress="none",
               bucket_bytes=64 * 2 ** 20, n_intra=1):
    """Bytes one rank hands its collectives in a sync of ``tensors``:
    the tensors in the wire dtype, with the last bucket's padding
    (``bucketed``) or each tensor's padding to n_intra (``hierarchical``
    on a pod x data mesh)."""
    if not tensors:
        return 0
    dt = WIRE_DTYPES[compress] or tensors[0].dtype
    sizes = [t.numel() for t in tensors]
    if strategy == "bucketed":
        per = _bucket_elems(sum(sizes), bucket_bytes, dt)
        return -(-sum(sizes) // per) * per * dt.itemsize
    if strategy == "hierarchical":
        return sum(s + (-s) % n_intra for s in sizes) * dt.itemsize
    return sum(sizes) * dt.itemsize


def broadcast_from_rank0(tensors, mesh):
    """Overwrite ``tensors`` on every rank with rank 0's (rank 0 of the
    mesh's data axes), in place -- so that every replica starts equal."""
    check_dp_mesh(mesh)
    src = int(mesh.mesh.flatten()[0])
    for t in tensors:
        dist.broadcast(t, src=src)
    return tensors
