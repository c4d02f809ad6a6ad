"""The flat master vector of a sharded train state.

A ZeRO state shards ONE flat vector: every trainable master
concatenated in the reference's flatten order -- JAX's ``tree_leaves``
of the reference's param tree: dict keys sorted at every level, list
indices by number, and a decoder's super-block layers stacked per
``decoder/blocks/layer{j}`` over the repetitions (``bridge.
reference_groups``).  In that order port worker w's shard is the
reference worker w's shard element for element, which is what lets a
ZeRO checkpoint of either package restore in the other.

Within a stacked leaf, the port's layer of repetition r is one
contiguous slice, so every master can be a VIEW of the vector
(``bind_masters``) and every gradient a view of a flat gradient buffer
(``bind_grads``; autograd then accumulates into it in place, as DDP's
``gradient_as_bucket_view`` does).  A tied table is one master, once.
The vector is padded to a multiple of the worker count; the padding
stays zero.  Its dtype is the masters' (fp32, or bf16 for bf16
masters): the masters are views of it, so they share one dtype.

zero3 frees the vector's storage between steps (``free``,
``untyped_storage().resize_(0)``, as FSDP does) and re-grows it for
the next gather (``regrow``); the views come back with it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import bridge


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Where each master lives in the flat vector: ``names[i]`` (a port
    parameter name) at ``offsets[i]`` with ``shapes[i]``, in the
    reference's flatten order; ``total`` elements, unpadded."""
    names: tuple
    offsets: tuple
    shapes: tuple
    total: int

    @property
    def sizes(self) -> tuple:
        return tuple(int(torch.Size(s).numel()) for s in self.shapes)

    def slices(self):
        """(name, start, stop, shape) for every master."""
        for name, off, shp, sz in zip(self.names, self.offsets, self.shapes,
                                      self.sizes):
            yield name, off, off + sz, shp


def flat_spec(model, masters) -> FlatSpec:
    """The ``FlatSpec`` of ``model``'s trainable ``masters`` ({name:
    tensor}): groups by reference path in the reference's order, and the
    ``n_rep`` members of a stacked leaf one after another."""
    groups = bridge.reference_groups(model, masters)
    names, offsets, shapes, off = [], [], [], 0
    for path in sorted(groups, key=bridge.reference_order):
        for name in groups[path][0]:
            names.append(name)
            offsets.append(off)
            shapes.append(tuple(masters[name].shape))
            off += masters[name].numel()
    return FlatSpec(tuple(names), tuple(offsets), tuple(shapes), off)


def flat_dtype(masters) -> torch.dtype:
    """The flat vector's dtype: the masters' one dtype.  The reference
    takes the result type of the leaves and casts each leaf back; here
    the masters are views of the vector, which cannot differ in dtype,
    so masters of mixed dtypes raise."""
    dtypes = {p.dtype for p in masters.values()}
    if len(dtypes) != 1:
        raise ValueError("a sharded state's masters are views of one flat "
                         "vector and must share one dtype; got "
                         f"{sorted(str(d) for d in dtypes)}")
    return dtypes.pop()


def views(spec: FlatSpec, flat) -> dict:
    """{name: view of ``flat``} in the masters' shapes."""
    return {name: flat[a:b].view(shp) for name, a, b, shp in spec.slices()}


@torch.no_grad()
def gather_into(spec: FlatSpec, named, flat):
    """Copy the tensors ``named`` ({name: tensor}) into their slices of
    ``flat``."""
    for name, a, b, _ in spec.slices():
        flat[a:b].copy_(named[name].reshape(-1))
    return flat


def bind_masters(spec: FlatSpec, masters, flat):
    """Make every master a view of ``flat`` (its values move with the
    vector from now on; the master's own storage is released)."""
    for name, view in views(spec, flat).items():
        masters[name].data = view


def bind_grads(spec: FlatSpec, masters, gflat):
    """Point every master's ``.grad`` at its slice of ``gflat``, so the
    backward accumulates into the flat gradient in place."""
    for name, view in views(spec, gflat).items():
        masters[name].grad = view


def unbind_grads(masters):
    for p in masters.values():
        p.grad = None


@dataclasses.dataclass
class FlatMasters:
    """A sharded state's master vector: ``full`` (``padded_total``
    elements of the masters' dtype, the masters views of its first
    ``spec.total``), this
    rank's ``worker`` number over the layout's axes and, for a
    params-sharded layout (zero3), ``shard``: this worker's slice, the
    only copy of the masters that persists between steps (``full``'s
    storage is freed then)."""
    spec: FlatSpec
    full: torch.Tensor
    worker: int
    shard: Optional[torch.Tensor] = None

    def free(self):
        """Release ``full``'s storage (the views stay, without memory)."""
        self.full.untyped_storage().resize_(0)

    def regrow(self):
        """Give ``full`` its storage back (values undefined until the
        next gather writes them)."""
        st = self.full.untyped_storage()
        want = self.full.numel() * self.full.element_size()
        if st.nbytes() != want:
            st.resize_(want)
