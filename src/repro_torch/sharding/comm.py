"""Collectives of the mesh step, with their backward passes.

A ``MeshComm`` wraps a ``DeviceMesh`` of named axes (``"pod"``,
``"data"``, ``"model"``): each axis's process group, this rank's index
on it and its size.  A collective over several axes runs over each in
turn (a sum over pod x data is a sum over data, then over pod); an
axis of size 1, or one the mesh lacks, is skipped.

The autograd forms follow Megatron's conjugate pairs.  Activations
outside a tensor-parallel region are replicated over ``"model"``, and
so are their gradients:

  * ``copy_to(x, axes)`` -- "f": identity forward, all-reduce (sum) of
    the gradient backward; where a replicated tensor enters a region
    whose ranks each see part of the work;
  * ``reduce_from(x, axes)`` -- "g": all-reduce forward, identity
    backward; where a region's partial sums leave it;
  * ``pmean(x, axes)``: mean forward, mean of the gradients backward;
  * ``all_to_all(x, axis, split, concat)``: the tiled exchange, whose
    backward is the reverse exchange;
  * ``gather_seq(x, axis, dim)``: the blocks of ``axis`` gathered along
    ``dim``, whose backward reduce-scatters the gradient (each rank
    holds its own part of it: the sequence split's keys and values);
  * ``gather_replicated`` / ``split_replicated``: into and out of a
    region that every rank of ``axis`` computes alike (gradient
    replicated there): gather forward, own block backward; own block
    forward, gather backward;
  * ``use(param, ...)``: a DTensor master at its compute layout (gathered
    over ``"data"``, and over ``"model"`` unless the caller keeps the
    model shard), whose backward reduce-scatters (or all-reduces) the
    gradient over the batch axes -- FSDP's gather and reduce-scatter.

gloo takes all-reduce, all-gather and reduce-scatter on CUDA tensors
(it stages them through host memory itself), but not ``all_to_all``:
``_all_to_all`` stages that one through host memory explicitly when
ranks share a card over gloo.  Compute never leaves the tensor's device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

DP_AXES = ("pod", "data")


class MeshComm:
    """The process groups of a mesh's axes and this rank's coordinate."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(self.names, mesh.mesh.shape))
        coord = mesh.get_coordinate()
        self.coord = dict(zip(self.names, coord)) if coord is not None \
            else {a: 0 for a in self.names}
        self._groups = {}

    def size(self, axis) -> int:
        return int(self.sizes.get(axis, 1))

    def index(self, axis) -> int:
        return int(self.coord.get(axis, 0))

    def group(self, axis):
        if axis not in self._groups:
            self._groups[axis] = self.mesh.get_group(axis)
        return self._groups[axis]

    def live(self, axes) -> tuple:
        """The axes of ``axes`` this mesh splits (size > 1)."""
        return tuple(a for a in axes if self.size(a) > 1)

    @property
    def dp_axes(self) -> tuple:
        return tuple(a for a in DP_AXES if a in self.names)

    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.size(a)
        return n

    def dp_index(self) -> int:
        """This rank's worker number over pod x data (pod-major)."""
        w = 0
        for a in self.dp_axes:
            w = w * self.size(a) + self.index(a)
        return w


# --------------------------------------------------------------------------
# raw collectives (no autograd)
# --------------------------------------------------------------------------

def all_reduce(t, comm, axes, op=dist.ReduceOp.SUM):
    """``t`` reduced in place over each axis of ``axes``; returns it."""
    for a in comm.live(axes):
        dist.all_reduce(t, op=op, group=comm.group(a))
    return t


def all_gather(t, comm, axis, dim):
    """The blocks of ``axis``'s ranks concatenated along ``dim``, in the
    axis's index order."""
    n = comm.size(axis)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=comm.group(axis))
    return out.movedim(0, dim)


def reduce_scatter(t, comm, axis, dim):
    """The sum over ``axis``'s ranks of ``t``, split along ``dim``: this
    rank's block."""
    n = comm.size(axis)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=comm.group(axis))
    return out.movedim(0, dim)


def own_block(t, comm, axis, dim):
    """This rank's block of ``t`` along ``dim`` over ``axis``."""
    n = comm.size(axis)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, comm.index(axis) * size, size)


def _all_to_all(x, group):
    """``all_to_all_single`` of a contiguous tensor over ``group`` (equal
    blocks along dim 0).  gloo implements it for CPU tensors only, so a
    CUDA tensor under gloo (ranks sharing one card) is staged through
    host memory here, explicitly; NCCL exchanges it on the card."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.cpu()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def tiled_all_to_all(x, comm, axis, split, concat):
    """The reference's ``lax.all_to_all(tiled=True)``: ``x``'s dim
    ``split`` cut into one block per rank of ``axis``, block j sent to
    rank j, and the blocks received concatenated along ``concat`` in
    rank order."""
    n = comm.size(axis)
    if n == 1:
        return x
    y = x.movedim(split, 0).contiguous()
    out = _all_to_all(y, comm.group(axis))
    chunks = out.view((n, y.shape[0] // n) + tuple(y.shape[1:]))
    t = chunks.movedim(1, split + 1)          # (n, x's layout, block at split)
    t = t.movedim(0, concat)
    return t.flatten(concat, concat + 1)


# --------------------------------------------------------------------------
# autograd forms
# --------------------------------------------------------------------------

def _fresh(t):
    """A contiguous copy that an in-place collective may overwrite (the
    gradient handed to a backward may be shared)."""
    return torch.clone(t, memory_format=torch.contiguous_format)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_fresh(g), ctx.comm, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        return all_reduce(_fresh(x), comm, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        ctx.n = 1
        for a in comm.live(axes):
            ctx.n *= comm.size(a)
        return all_reduce(_fresh(x), comm, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_fresh(g), ctx.comm, ctx.axes) / ctx.n, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, split, concat):
        ctx.args = (comm, axis, concat, split)
        return tiled_all_to_all(x, comm, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return tiled_all_to_all(g, *ctx.args), None, None, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim):
        ctx.args = (comm, axis, dim)
        return all_gather(x, comm, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, *ctx.args), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim):
        ctx.args = (comm, axis, dim)
        return all_gather(x, comm, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return own_block(g, *ctx.args).contiguous(), None, None, None


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim):
        ctx.args = (comm, axis, dim)
        return own_block(x, comm, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None


def gather_seq(x, comm, dim, axis="data"):
    if comm.size(axis) == 1:
        return x
    return _GatherSeq.apply(x, comm, axis, dim)


def gather_replicated(x, comm, dim, axis="data"):
    if comm.size(axis) == 1:
        return x
    return _GatherReplicated.apply(x, comm, axis, dim)


def split_replicated(x, comm, dim, axis="data"):
    if comm.size(axis) == 1:
        return x
    return _SplitReplicated.apply(x, comm, axis, dim)


def copy_to(x, comm, axes):
    return _CopyTo.apply(x, comm, tuple(axes)) if comm.live(axes) else x


def reduce_from(x, comm, axes):
    return _ReduceFrom.apply(x, comm, tuple(axes)) if comm.live(axes) else x


def pmean(x, comm, axes):
    return _PMean.apply(x, comm, tuple(axes)) if comm.live(axes) else x


def all_to_all(x, comm, axis, split, concat):
    if comm.size(axis) == 1:
        return x
    return _AllToAll.apply(x, comm, axis, split, concat)


# --------------------------------------------------------------------------
# a DTensor master at its compute layout
# --------------------------------------------------------------------------

def shard_dims(param, comm) -> dict:
    """{axis: tensor dim} of the mesh axes a DTensor master is split
    over."""
    from torch.distributed.tensor import Shard
    out = {}
    for axis, pl in zip(comm.names, param.placements):
        if isinstance(pl, Shard):
            out[axis] = pl.dim
    return out


class _Use(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, comm, gathers, sums, tp_axes):
        ctx.comm, ctx.gathers, ctx.sums, ctx.tp_axes = (comm, gathers, sums,
                                                        tp_axes)
        x = local
        for axis, dim in gathers:
            x = all_gather(x, comm, axis, dim)
        return x if x is not local else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        if ctx.tp_axes:
            g = all_reduce(_fresh(g), comm, ctx.tp_axes)
        gathered = set()
        for axis, dim in reversed(ctx.gathers):
            gathered.add(axis)
            g = (reduce_scatter(g, comm, axis, dim) if axis in ctx.sums
                 else own_block(g, comm, axis, dim).contiguous())
        rest = tuple(a for a in ctx.sums if a not in gathered)
        if comm.live(rest):
            g = all_reduce(_fresh(g), comm, rest)
        return g, None, None, None, None


def use(param, comm=None, *, keep=(), sums=None, tp_axes=()):
    """A DTensor master as a local tensor at its compute layout, with the
    gradient it passes back; any other tensor, or any tensor without a
    ``comm`` (no mesh), as it is -- so the model code reads every weight
    through ``use`` on one device and on a mesh alike.

    Forward: the local block, gathered over every mesh axis that splits
    it except those in ``keep`` (the innermost mesh axis first, so a dim
    split over ("data", "model") comes back in data-major order).
    Backward, into the local block: the gradient all-reduced over
    ``tp_axes`` first (a replicated weight used inside a tensor-parallel
    region, whose ranks each contribute part of its gradient); then,
    for each gathered axis, reduce-scattered over it if it is in
    ``sums`` (the batch axes: the ranks saw different rows) or cut to
    this rank's block (an axis whose ranks computed the same gradient);
    then all-reduced over the axes of ``sums`` that do not split it.
    ``sums`` defaults to the batch axes (``batch_axes()``)."""
    if comm is None:
        return param
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding import ctx as shctx
    if not isinstance(param, DTensor):
        return param
    if sums is None:
        sums = shctx.batch_axes(comm)
    dims = shard_dims(param, comm)
    gathers = tuple((a, dims[a]) for a in reversed(comm.names)
                    if a in dims and a not in keep and comm.size(a) > 1)
    local = param.to_local()
    return _Use.apply(local, comm, gathers, tuple(comm.live(sums)),
                      tuple(comm.live(tp_axes)))


@torch.no_grad()
def full_tensor(param, comm):
    """The whole tensor of a DTensor master (or moment) on every rank,
    gathered from the blocks; no autograd."""
    dims = shard_dims(param, comm)
    x = param.to_local()
    for a in reversed(comm.names):
        if a in dims:
            x = all_gather(x, comm, a, dims[a])
    return x
