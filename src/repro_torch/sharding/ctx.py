"""The activation mesh.

Port of the training half of ``repro.sharding.ctx``.  The reference
registers a mesh before tracing and pins activations to it with
``with_sharding_constraint``; model code asks ``get_activation_mesh()``
whether a mesh is set (``apply_moe`` then takes the expert-parallel
path).  Here the mesh step registers its ``DeviceMesh`` for the length
of a forward and backward, and the layer code reads the same question
to take its mesh forms (``models.transformer.apply_layer``).  Nothing
is handed to a compiler: the layouts the reference's constraints pin
are the ones the mesh forms compute in --

  * ``constrain_bsd`` / ``constrain_tokens``: the residual stream and
    token-major tensors hold this rank's rows, the batch cut over pod x
    data by ``rules.batch_spec`` (replicated where it does not divide),
    replicated over ``"model"``; the reference's sequence split of a
    batch of one (``long_500k``) belongs to the dry run and is not taken;
  * ``constrain_ecd``: the MoE buffers' experts over data x model, else
    model (``moe._ep_factors``);
  * ``constrain_logits``: the vocabulary over ``"model"`` when the table
    is split so (``layers.vocab_shard``).

``activation_mesh(mesh)`` is the scoped form and restores the previous
mesh on exit, even when the body raises; ``batch_split(flag)`` records,
for the same scope, whether the batch was cut over pod x data (a batch
that does not divide is replicated, and then no gradient is summed over
the batch axes).  ``ServeTopology`` and the paged-pool constraints wait
for mesh serving.
"""
from __future__ import annotations

import contextlib

from repro_torch.sharding.comm import MeshComm

_MESH = None          # the registered DeviceMesh
_COMM = None          # its MeshComm
_SPLIT = True         # the batch is cut over pod x data


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


def batch_axes(comm) -> tuple:
    """The axes whose ranks hold different rows: pod x data when the
    batch is split, none when it is replicated."""
    return comm.dp_axes if _SPLIT else ()


def dp_share(comm) -> int:
    """How many ranks share the batch's rows: |pod x data| when the
    batch is split, else 1."""
    return comm.dp_size() if _SPLIT else 1
