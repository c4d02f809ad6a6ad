"""Data distribution -- the paper's §3.3.1 work distribution on
``torch.distributed`` (port of ``repro.data.pipeline``).

The paper: "the default process (rank zero) reads the samples from the
disk and splits them across processes".  ``rank0_scatter`` is that
MPI_Scatter: rank 0 holds the global batch and sends each rank a
contiguous 1/p slice of dim 0, in the rank order of the mesh's data
axes.  Equal splits only, like the paper ("each device is considered
of equal compute capacity"), so a batch that does not split evenly is
refused.  As MPI_Scatter's receive counts do, every other rank passes a
batch of the global shapes and dtypes; only rank 0's values are read.

``ShardedLoader`` adds the epoch / shuffle machinery: the reference's
deterministic per-epoch permutation (``default_rng(seed + epoch)``),
drop-last.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import check_dp_mesh, dp_world_size


class Scattered(dict):
    """This rank's rows of a global batch, as ``rank0_scatter`` returns
    them; a data-parallel step takes it as it is, where it scatters a
    plain (global) batch itself."""


def rank0_scatter(mesh, batch, *, device) -> Scattered:
    """Rank r of the mesh's data axes (row-major over ``("pod",
    "data")``) receives rows [r B/p, (r+1) B/p) of every array of rank
    0's ``batch``, as tensors on ``device``.  gloo scatters host tensors,
    which are then moved to ``device``; NCCL scatters tensors on the
    rank's card."""
    check_dp_mesh(mesh)
    p = dp_world_size(mesh)
    order = mesh.mesh.flatten().tolist()     # global rank at position i
    src = order[0]
    via = (torch.device("cpu") if dist.get_backend() == "gloo"
           else torch.device("cuda", torch.cuda.current_device()))
    out = Scattered()
    for k in sorted(batch):
        t = torch.as_tensor(batch[k])
        if t.shape[0] % p:
            raise ValueError(f"batch[{k!r}] has {t.shape[0]} rows, which do "
                             f"not split evenly over {p} data-parallel "
                             "ranks")
        recv = torch.empty((t.shape[0] // p,) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=via)
        send = None
        if dist.get_rank() == src:
            rows = t.to(via).chunk(p)
            send = [None] * p
            for i, r in enumerate(order):
                send[r] = rows[i].contiguous()
        dist.scatter(recv, send, src=src)
        out[k] = recv.to(device)
    return out


class ShardedLoader:
    """Deterministic epoch-shuffled minibatch loader over numpy arrays.
    Without a mesh it yields global batches (dicts of numpy arrays);
    with one, each rank's ``rank0_scatter`` share on ``device`` (the
    card unless the caller says "cpu")."""

    def __init__(self, data, batch_size: int, *, mesh=None, seed: int = 0,
                 drop_last: bool = True, device="cuda"):
        self.data = data                     # dict of (N, ...) arrays
        self.n = len(next(iter(data.values())))
        self.batch_size = batch_size
        self.mesh = mesh
        self.seed = seed
        self.drop_last = drop_last
        self.device = device

    def epoch(self, epoch_idx: int):
        rng = np.random.default_rng(self.seed + epoch_idx)
        perm = rng.permutation(self.n)
        nb = self.n // self.batch_size if self.drop_last else \
            -(-self.n // self.batch_size)
        for b in range(nb):
            idx = perm[b * self.batch_size:(b + 1) * self.batch_size]
            batch = {k: v[idx] for k, v in self.data.items()}
            if self.mesh is not None:
                batch = rank0_scatter(self.mesh, batch, device=self.device)
            yield batch

    def steps_per_epoch(self):
        return self.n // self.batch_size
