"""Process groups and data-parallel meshes for the port's launchers.

Ranks are processes.  A launcher runs under ``python -m
torch.distributed.run`` (torchrun), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; ``init_from_env``
joins that group with an explicit backend and builds the mesh:

  * ``nccl`` -- one rank a card (rank r on card LOCAL_RANK);
  * ``gloo`` -- on the CPU, or several ranks sharing one card (the
    tensors stay on the card, the collectives stage them through host
    memory).

Nothing falls back from NCCL to gloo: the backend is the caller's.

The full config trains on the production mesh (``make_production_mesh``:
(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
"model")`` over two pods), ``make_serve_mesh`` builds the same layout at
any scale, and ``make_dp_mesh`` the data-parallel mesh of the reduced
path.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")


def make_dp_mesh(pods: int = 1):
    """The data-parallel mesh over every rank of the default group:
    ``("data",)``, or ``("pod", "data")`` with ``pods`` pods."""
    world = dist.get_world_size()
    if pods < 1 or world % pods:
        raise ValueError(f"--pods {pods} must divide the {world} ranks")
    shape, names = (((world,), ("data",)) if pods == 1
                    else ((pods, world // pods), ("pod", "data")))
    return init_device_mesh(_dev_type(), shape, mesh_dim_names=names)


PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def _dev_type():
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def check_production_world(multi_pod: bool, world: int):
    """Raise unless ``world`` ranks fill the production mesh."""
    shape, _ = PRODUCTION_SHAPE[bool(multi_pod)]
    need = math.prod(shape)
    if world != need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, have {world} -- run under "
            f"torchrun with {need} processes")


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production mesh over the default group: (data 16, model 16)
    on 256 ranks, or (pod 2, data 16, model 16) on 512 with
    ``multi_pod``.  Raises at any other world size.  ``device_type`` is
    where the ranks' tensors live (a DTensor moves its block to the
    mesh's device type): by default the card under nccl, else the CPU;
    gloo ranks sharing a card pass ``"cuda"``."""
    shape, names = PRODUCTION_SHAPE[bool(multi_pod)]
    check_production_world(multi_pod, dist.get_world_size())
    return init_device_mesh(device_type or _dev_type(), shape,
                            mesh_dim_names=names)


def make_serve_mesh(n_data: int, n_model: int, *, device_type=None):
    """A ``(data, model)`` mesh at any scale over the default group
    (``make_production_mesh()`` is its 16 x 16 instance); raises unless
    the world is ``n_data * n_model`` ranks.  ``device_type`` as for
    ``make_production_mesh``."""
    need, world = n_data * n_model, dist.get_world_size()
    if world != need:
        raise RuntimeError(f"mesh ({n_data}, {n_model}) needs {need} "
                           f"ranks, have {world}")
    return init_device_mesh(device_type or _dev_type(), (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def init_from_env(backend: str, device="cuda", *, pods: int = 1,
                  mesh=None):
    """Join torchrun's group with ``backend`` and return (mesh, device):
    this rank's device is card LOCAL_RANK under nccl, and under gloo the
    CPU or card LOCAL_RANK modulo the cards present.  The mesh is
    ``make_dp_mesh(pods)``, or ``mesh(device type)`` when a mesh function
    is given (e.g. one calling ``make_production_mesh``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        if key not in os.environ:
            raise RuntimeError(f"{key} is not set: run under python -m "
                               "torch.distributed.run (torchrun)")
    dev = resolve_device(device)
    local = int(os.environ["LOCAL_RANK"])
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend runs on the card; use --backend "
                         "gloo with --device cpu")
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local >= n_cards:
            raise RuntimeError(f"nccl takes one rank a card: local rank "
                               f"{local} of {n_cards} card(s); use --backend "
                               "gloo to share a card")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return (make_dp_mesh(pods) if mesh is None else mesh(dev.type)), dev
