"""The activation mesh and the serve topology.

Port of ``repro.sharding.ctx``, its training and serving halves.  The
reference registers a mesh before tracing and pins activations to it
with ``with_sharding_constraint``; model code asks
``get_activation_mesh()`` whether a mesh is set (``apply_moe`` then
takes the expert-parallel path).  Here the mesh step registers its
``DeviceMesh`` for the length of a forward and backward, and the layer
code reads the same question to take its mesh forms (``models.transformer.apply_layer``).  Nothing
is handed to a compiler: the layouts the reference's constraints pin
are the ones the mesh forms compute in --

  * ``constrain_bsd`` / ``constrain_tokens``: the residual stream and
    token-major tensors hold this rank's rows, the batch cut over pod x
    data by ``rules.batch_spec``, replicated over ``"model"``; where the
    rows do not divide pod x data and the sequence divides ``"data"``,
    the reference's order of tests cuts the SEQUENCE over ``"data"``
    instead (``seq_split``), replicated over ``"pod"``; else the batch
    is replicated;
  * ``constrain_ecd``: the MoE buffers' experts over data x model, else
    model (``moe._ep_factors``);
  * ``constrain_logits``: the vocabulary over ``"model"`` when the table
    is split so (``layers.vocab_shard``).

``activation_mesh(mesh)`` is the scoped form and restores the previous
mesh on exit, even when the body raises; ``batch_split(flag)`` records,
for the same scope, whether the batch was cut over pod x data (a batch
that does not divide is replicated, and then no gradient is summed over
the batch axes), and ``seq_split(flag)`` whether each row's sequence is
cut over ``"data"`` instead: then the ``"data"`` ranks hold different
tokens and sum their gradients (``batch_axes``).

The sequence split.  Rank r of ``"data"`` (of D) holds positions [r s,
(r + 1) s) of every row, s = S / D (``seq_block``); a layer called with
``seq_cut`` set reads what it needs of the other blocks:

  * attention gathers its keys and values over ``"data"`` (the gather's
    backward is the reduce-scatter) and keeps the prefix [0, (r + 1) s):
    the block's queries are then right-aligned causal against it, the
    flash kernel's own convention (``seq_prefix``);
  * Mamba and RWKV-6 gather the sequence, scan it whole and keep their
    block (replicated compute of the scan);
  * the MoE gathers the tokens into the replicated-token form the
    reference's expert-parallel layer takes for a batch that does not
    divide (its routing, capacity and aux over all of the microbatch's
    tokens, every data rank alike) and keeps its block of the output
    (``gather_replicated`` / ``split_replicated``);
  * the loss sums the CE over the block's tokens (the global mean over
    the count summed over ``"data"``).

Serving registers a ``ServeTopology`` as well (``serve_topology(topo)``,
which scopes its mesh as the activation mesh too): replica groups over
pod x data and tensor-parallel decode over ``"model"``.  The layer code
then takes its mesh forms in the serving modes as well
(``layer_comm``).  The reference's paged-pool constraints become the
code that computes those layouts --

  * ``constrain_paged_kv`` / ``constrain_paged_latent``: a pooled leaf is
    cut over ``"model"`` on the dim ``rules.pool_spec`` names (k / v:
    kv heads where they divide, else head_dim; MLA's latent and rope
    widths), and a rank holds that block only (``Placed``, whose
    ``split`` records the dim of each leaf);
  * ``replicate_update``: a rank writes exactly its block of each new
    entry (``own_update``);
  * ``replicate_for_kernel``: where the kernel needs the whole feature
    axis (the head_dim fallback, MLA's latent), the pages the call's
    slots map are gathered over ``"model"`` into a compact pool
    (``gather_pages``) and the kernel runs on it, replicated.

A lockstep slab cache on a mesh is ``Placed`` too (``rules.cache_spec``:
its rows this rank's pod x data share, its sequence or state dim over
``"model"``); a layer reads it gathered over ``"model"`` and writes its
block back (``gather_placed`` / ``scatter_placed``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.sharding.comm import (MeshComm, all_gather, gather_seq,
                                       own_block)

_MESH = None          # the registered DeviceMesh
_COMM = None          # its MeshComm
_SPLIT = True         # the batch is cut over pod x data
_SEQ = False          # each row's sequence is cut over "data" instead
_CUT = False          # the activations in this scope are sequence blocks
_TOPO = None          # the registered ServeTopology


def set_activation_mesh(mesh) -> None:
    global _MESH, _COMM
    _MESH = mesh
    _COMM = None if mesh is None else (
        _COMM if _COMM is not None and _COMM.mesh is mesh else MeshComm(mesh))


def get_activation_mesh():
    return _MESH


def get_comm():
    """The ``MeshComm`` of the registered mesh, or None."""
    return _COMM


@contextlib.contextmanager
def activation_mesh(mesh):
    """Scope ``mesh`` as the activation mesh (``None`` clears it); the
    previous mesh is restored on exit."""
    prev = _MESH
    set_activation_mesh(mesh)
    try:
        yield mesh
    finally:
        set_activation_mesh(prev)


@contextlib.contextmanager
def batch_split(flag: bool):
    """Scope whether this rank's rows are its pod x data share of the
    batch (True) or the whole batch (False)."""
    global _SPLIT
    prev = _SPLIT
    _SPLIT = bool(flag)
    try:
        yield
    finally:
        _SPLIT = prev


def is_batch_split() -> bool:
    return _SPLIT


@contextlib.contextmanager
def seq_split(flag: bool):
    """Scope whether each row's sequence is cut over ``"data"`` (module
    docstring): the step of a batch whose rows do not divide."""
    global _SEQ
    prev = _SEQ
    _SEQ = bool(flag)
    try:
        yield
    finally:
        _SEQ = prev


def is_seq_split() -> bool:
    return _SEQ


@contextlib.contextmanager
def seq_cut(flag: bool):
    """Scope whether the layer activations are this rank's sequence
    block (a layer's call; the encoder of a split step runs whole)."""
    global _CUT
    prev = _CUT
    _CUT = bool(flag)
    try:
        yield
    finally:
        _CUT = prev


def is_seq_cut() -> bool:
    return _CUT


def seq_block(comm, n: int) -> tuple:
    """(start, length) of this rank's block of a sequence of ``n`` cut
    over ``"data"``."""
    s = n // comm.size("data")
    return comm.index("data") * s, s


def seq_prefix(t, comm, dim=1):
    """The sequence blocks of ``t`` gathered over ``"data"`` up to the
    end of this rank's block, along ``dim``: the keys a block's causal
    queries can see."""
    start, s = seq_block(comm, t.shape[dim] * comm.size("data"))
    return gather_seq(t, comm, dim).narrow(dim, 0, start + s)


def batch_axes(comm) -> tuple:
    """The axes whose ranks hold different tokens: pod x data when the
    batch is split, ``"data"`` when the sequence is, none when the batch
    is replicated."""
    if _SPLIT:
        return comm.dp_axes
    return ("data",) if _SEQ and "data" in comm.names else ()


def dp_share(comm) -> int:
    """How many ranks share the batch's rows: |pod x data| when the
    batch is split, else 1."""
    return comm.dp_size() if _SPLIT else 1


# --------------------------------------------------------------------------
# serving on a mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeTopology:
    """How a serving engine maps onto a mesh.

    replica_axes -- the data-parallel replica groups (pod, data): each
                    holds a whole copy of the paged pool;
    model_axis   -- tensor-parallel decode: pool leaves, attention heads,
                    the ffn and the vocabulary split here (None: a mesh
                    without one)."""
    mesh: object
    replica_axes: tuple
    model_axis: object

    @classmethod
    def from_mesh(cls, mesh) -> "ServeTopology":
        names = tuple(mesh.mesh_dim_names)
        return cls(mesh=mesh,
                   replica_axes=tuple(a for a in ("pod", "data")
                                      if a in names),
                   model_axis="model" if "model" in names else None)

    def _size(self, axis) -> int:
        names = tuple(self.mesh.mesh_dim_names)
        return int(self.mesh.mesh.shape[names.index(axis)])

    @property
    def replicas(self) -> int:
        n = 1
        for a in self.replica_axes:
            n *= self._size(a)
        return n

    @property
    def model_parallel(self) -> int:
        return self._size(self.model_axis) if self.model_axis else 1


def get_serve_topology():
    return _TOPO


@contextlib.contextmanager
def serve_topology(topo):
    """Scope a serve topology and its mesh as the activation mesh
    (``None`` clears both); the previous values are restored on exit,
    even when the body raises."""
    global _TOPO
    prev_mesh, prev_topo = _MESH, _TOPO
    set_activation_mesh(None if topo is None else topo.mesh)
    _TOPO = topo
    try:
        yield topo
    finally:
        set_activation_mesh(prev_mesh)
        _TOPO = prev_topo


@contextlib.contextmanager
def serving(topo, split=False):
    """An engine's scope for its model calls: ``serve_topology(topo)``
    with ``batch_split(split)``; nothing on one device (``topo`` None)."""
    if topo is None:
        yield
        return
    with serve_topology(topo), batch_split(split):
        yield


def layer_comm(mode):
    """The ``MeshComm`` a layer call runs its mesh forms over: the
    activation mesh's in training, and in the serving modes when a serve
    topology is registered; else None."""
    return _COMM if (mode == "train" or _TOPO is not None) else None


class Placed(dict):
    """A layer's cache leaves as this rank's blocks: ``split[name]`` is
    the dim of leaf ``name`` cut over ``"model"`` (a leaf not in it is
    whole on every rank of the model group)."""

    def __init__(self, leaves, split):
        super().__init__(leaves)
        self.split = dict(split)


def place_cache(shapes, spec, comm, device) -> list:
    """Zeros of this rank's blocks of a serving cache: ``shapes`` the
    whole cache's leaves (one dict a layer, e.g. on the meta device),
    ``spec(i, name, shape)`` a leaf's rule (``rules.pool_spec``,
    ``rules.cache_spec``); each layer a ``Placed`` -- an
    encoder-decoder's ``{"self": ..., "cross": ...}`` layer a dict of
    two, each leaf's ``name`` then ``"self/k"`` and so on."""
    from repro_torch.sharding.rules import local_slices

    def place(i, layer, prefix=""):
        leaves, split = {}, {}
        for name, t in layer.items():
            sp = spec(i, prefix + name, tuple(t.shape))
            if "model" in sp:
                split[name] = sp.index("model")
            block = t[local_slices(tuple(t.shape), sp, comm.sizes,
                                   comm.coord)]
            leaves[name] = torch.zeros(block.shape, dtype=t.dtype,
                                       device=device)
        return Placed(leaves, split)

    return [{k: place(i, sub, k + "/") for k, sub in layer.items()}
            if "cross" in layer else place(i, layer)
            for i, layer in enumerate(shapes)]


def own_update(t, comm, dim):
    """This rank's block along ``dim`` of a new entry every rank of the
    model group computed whole -- what the rank writes into its block of
    a pooled leaf."""
    return own_block(t, comm, "model", dim)


def gather_pages(pools, page_table, page_size, comm, dims):
    """The pages ``page_table`` (B, W) maps, of each pooled leaf block in
    ``pools`` (token-major), gathered whole over ``"model"`` along its
    split dim in ``dims`` (None: a leaf already whole): a compact pool
    of B * W pages each, page b * W + j holding slot b's block j, and
    its (B, W) table."""
    B, W = page_table.shape
    dev = page_table.device
    rows = (page_table.long()[..., None] * page_size
            + torch.arange(page_size, device=dev)).reshape(-1)
    out = [p.index_select(0, rows) if d is None else
           all_gather(p.index_select(0, rows), comm, "model", d)
           for p, d in zip(pools, dims)]
    table = torch.arange(B * W, dtype=torch.int32, device=dev).view(B, W)
    return out, table


def gather_placed(cache, comm) -> dict:
    """A slab layer's leaves gathered over ``"model"`` (new tensors)."""
    return {k: all_gather(t, comm, "model", cache.split[k])
            if k in cache.split else t for k, t in cache.items()}


def scatter_placed(cache, full, comm):
    """Write this rank's block of each gathered leaf of ``full`` back
    into ``cache``."""
    for k, dim in cache.split.items():
        cache[k].copy_(own_block(full[k], comm, "model", dim))
