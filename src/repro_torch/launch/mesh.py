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
"""
from __future__ import annotations

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
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev_type, shape, mesh_dim_names=names)


def init_from_env(backend: str, device="cuda", *, pods: int = 1):
    """Join torchrun's group with ``backend`` and return (mesh, device):
    this rank's device is card LOCAL_RANK under nccl, and under gloo the
    CPU or card LOCAL_RANK modulo the cards present."""
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
    return make_dp_mesh(pods), dev
