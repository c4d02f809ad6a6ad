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
                       degenerates to ``flat``;
  * ``zero1``        -- the reduce-scatter half (``reduce_scatter_mean``)
                       then the all-gather half (``all_gather_tree``):
                       the same wire volume as a ring allreduce.  The
                       sharded strategies (``core.strategy``) run the
                       optimizer update between the halves, on this
                       rank's 1/p shard.

Every function averages IN PLACE: the tensors passed (the masters'
``.grad``, or the masters themselves) hold the mean afterwards, and the
same tensors are returned.  gloo has no ``ReduceOp.AVG``, so each sums
and divides by p.  ``compress="bf16"`` halves the wire volume: the
values are cast to bf16, summed in bf16 and written back in their own
dtype.  Ranks are processes; the data-parallel mesh spans every rank.

The ZeRO halves work on one flat vector: ``flatten_padded`` concatenates
the tensors in order, zero-padded to a multiple of the worker count p,
and worker w owns the contiguous slice ``[w per, (w+1) per)``
(``local_shard``).  Workers are numbered over ``axes`` row-major in the
order given (``worker_index``): ``("pod", "data")`` is the rank order,
and the hier strategies' intra-major ``("data", "pod")`` numbers the
rank at data index i of pod k as ``i * n_pods + k`` -- the worker whose
slice the two-level reduce-scatter (inside the pod, then across pods)
leaves on it.  gloo and NCCL both take the collectives on CUDA tensors
(gloo stages them through host memory itself).
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


def wire_dtype(dtype, compress) -> torch.dtype:
    """The dtype a tensor of ``dtype`` crosses the wire in."""
    if compress not in WIRE_DTYPES:
        raise ValueError(f"compress must be one of {sorted(WIRE_DTYPES)}, "
                         f"got {compress!r}")
    return WIRE_DTYPES[compress] or dtype


def _wire(t, compress):
    dt = wire_dtype(t.dtype, compress)
    return t if t.dtype == dt else t.to(dt)


def group_size(group) -> int:
    return dist.get_world_size(group)


def axes_size(mesh, axes) -> int:
    """The number of workers the mesh axes ``axes`` span."""
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in axes)


def axis_group(mesh, axes):
    """The one process group spanning ``axes`` in the mesh's own
    (row-major) order: an axis's group, or the default group for
    ``("pod", "data")`` (the mesh spans every rank)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if axes == tuple(mesh.mesh_dim_names):
        return None
    raise ValueError(f"no single group spans the axes {axes} of a mesh "
                     f"{mesh.mesh_dim_names}")


def worker_index(mesh, axes) -> int:
    """This rank's worker number over ``axes``, row-major in the order
    given (the reference's ``axis_index(axes)``)."""
    names = mesh.mesh_dim_names
    coord = dict(zip(names, mesh.get_coordinate()))
    w = 0
    for a in axes:
        w = w * mesh.size(names.index(a)) + coord[a]
    return w


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
    dt = wire_dtype(tensors[0].dtype, compress)
    per = _bucket_elems(sum(t.numel() for t in tensors), bucket_bytes, dt)
    flat, spec = flatten_padded(tensors, per, dtype=dt)
    for bucket in flat.view(-1, per):
        dist.all_reduce(bucket, group=group)
    flat.div_(p)
    for t, avg in zip(tensors, unflatten_padded(flat, spec)):
        t.copy_(avg)
    return tensors


def _bucket_elems(total, bucket_bytes, dtype):
    return max(1, min(total, bucket_bytes // dtype.itemsize))


# newer torch names the single-tensor collectives ``*_single``; older
# releases only have ``*_tensor``
def _reduce_scatter(out, inp, group, *, async_op=False):
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    return fn(out, inp, group=group, async_op=async_op)


def _all_gather(out, inp, group, *, async_op=False):
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    return fn(out, inp, group=group, async_op=async_op)


def _all_reduce(t, group, *, async_op=False):
    return dist.all_reduce(t, group=group, async_op=async_op)


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
    wire_dtype(torch.float32, compress)         # checks the name
    if not tensors:
        return tensors
    if strategy == "flat" or (strategy == "hierarchical"
                              and len(dp_batch_axes(mesh)) == 1):
        return allreduce_flat(tensors, mesh, compress=compress)
    if strategy == "bucketed":
        return allreduce_bucketed(tensors, mesh, bucket_bytes=bucket_bytes,
                                  compress=compress)
    if strategy == "hierarchical":
        return allreduce_hierarchical(tensors, mesh, compress=compress)
    if strategy == "zero1":
        # the full round trip (the sharded strategies split the halves)
        axes = dp_batch_axes(mesh)
        shard, spec = reduce_scatter_mean(tensors, mesh, axes,
                                          compress=compress)
        for t, g in zip(tensors, all_gather_tree(shard, mesh, axes, spec)):
            t.copy_(g)
        return tensors
    raise ValueError(f"unknown allreduce strategy {strategy!r}")


# --------------------------------------------------------------------------
# the ZeRO halves: reduce-scatter / all-gather of one flat vector, so the
# optimizer update can run on this rank's 1/p shard between them
# --------------------------------------------------------------------------

def flatten_padded(tensors, n, *, dtype=None):
    """The tensors concatenated in order into one new 1-D vector (in
    ``dtype``, default the first tensor's), zero-padded to a multiple of
    ``n``.  Returns ``(flat, spec)``; ``unflatten_padded`` inverts it."""
    if not tensors:
        raise ValueError("flatten_padded: empty tensor list")
    shapes = tuple(tuple(t.shape) for t in tensors)
    sizes = tuple(t.numel() for t in tensors)
    total = sum(sizes)
    flat = torch.zeros(total + (-total) % n, dtype=dtype or tensors[0].dtype,
                       device=tensors[0].device)
    off = 0
    for t, sz in zip(tensors, sizes):
        flat[off:off + sz].copy_(t.reshape(-1))
        off += sz
    return flat, (shapes, sizes, total)


def unflatten_padded(flat, spec) -> list:
    """Views of ``flat`` in the shapes ``flatten_padded`` recorded."""
    shapes, sizes, _ = spec
    out, off = [], 0
    for shp, sz in zip(shapes, sizes):
        out.append(flat[off:off + sz].view(shp))
        off += sz
    return out


def local_shard(flat, mesh, axes):
    """This worker's contiguous slice of a replicated padded vector --
    the slice ``reduce_scatter_mean`` hands it (a view)."""
    n = axes_size(mesh, axes)
    per = flat.numel() // n
    w = worker_index(mesh, axes)
    return flat[w * per:(w + 1) * per]


def reduce_scatter_mean(tensors, mesh, axes=None, *, compress="none"):
    """ZeRO-1 first half: reduce-scatter the flattened tensors so this
    worker ends with the contiguous 1/p slice of their *mean* it owns
    (``local_shard``).  Returns ``(shard, spec)``; reconstruct with
    ``all_gather_tree``.  ``compress="bf16"`` reduces in bf16 on the
    wire and returns the shard in fp32 (the fp32 master shard).  Over
    the hier axes ``("data", "pod")`` it is the two-level
    ``hier_reduce_scatter_mean``."""
    from repro_torch.core.overlap import reduce_scatter_flat, whole_plan
    if not tensors:
        raise ValueError("reduce_scatter_mean: empty tensor list")
    axes = dp_batch_axes(mesh) if axes is None else tuple(axes)
    n = axes_size(mesh, axes)
    flat, spec = flatten_padded(tensors, n)
    return reduce_scatter_flat(flat, mesh, axes, whole_plan(flat.numel(), n),
                               compress=compress), spec


def all_gather_tree(shard, mesh, axes, spec) -> list:
    """ZeRO-1 second half: gather the workers' shards back into the
    full (unpadded) tensors.  Inverse of ``reduce_scatter_mean``."""
    from repro_torch.core.overlap import all_gather_flat, whole_plan
    n = axes_size(mesh, axes)
    flat = all_gather_flat(shard, mesh, axes,
                           whole_plan(shard.numel() * n, n))
    return unflatten_padded(flat, spec)


def hier_reduce_scatter_mean(tensors, mesh, *, compress="none"):
    """Two-level ZeRO-1 first half on a (pod, data) mesh:
    reduce-scatter over the intra-pod ``data`` axis, then the
    1/n_intra piece over ``pod``, so the worker at (pod k, data i) ends
    with contiguous slice ``i * n_pods + k`` of the mean.  The
    cross-pod link moves only 1/n_intra of the volume."""
    return reduce_scatter_mean(tensors, mesh, ("data", "pod"),
                               compress=compress)


def hier_all_gather_tree(shard, mesh, spec) -> list:
    """Two-level ZeRO-1 second half: the small cross-pod gather first,
    then the intra-pod one.  Inverse of ``hier_reduce_scatter_mean``."""
    return all_gather_tree(shard, mesh, ("data", "pod"), spec)


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
