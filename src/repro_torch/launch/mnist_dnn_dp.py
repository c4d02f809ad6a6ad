"""End-to-end run of the paper's own experiment (Figure 1), ported:
MNIST-DNN (784-200-100-10, Table-1 width) trained with synchronous
data-parallel allreduce across p ranks -- rank-0 scatter of each
batch, per-step gradient averaging (or periodic weight averaging).

    # two ranks on the CPU
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.mnist_dnn_dp \\
        --device cpu --backend gloo

    # one rank a card (NCCL); or several ranks sharing one card (gloo)
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.mnist_dnn_dp \\
        --backend gloo --strategy bucketed

    # ZeRO-3: the optimizer state, gradients and params 1/p a rank
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.mnist_dnn_dp \
        --device cpu --backend gloo --strategy zero3

    # the one-process sequential reference (no torchrun)
    PYTHONPATH=src python -m repro_torch.launch.mnist_dnn_dp --sequential

Port of ``examples/mnist_dnn_dp.py``: the synthetic MNIST of
``data.make_dataset`` (seed 0), batches of ``ShardedLoader`` (seed 0)
scattered from rank 0, the weights of ``init_paper_net`` (seed 0) --
broadcast from rank 0 by the ``Trainer`` -- and momentum 0.2 / 0.9.
Rank 0 prints ``describe()``, each epoch's loss and the accuracy on the
first 1024 samples.  ``--dump DIR`` makes every rank write its params
after each step (``DIR/step{s}_rank{r}.npz``).  ``--ckpt DIR`` saves
after each epoch (rank 0 writes, in the reference's format) and ends
with the reference's restart demo -- the paper's ULFM story, reload and
continue: a fresh trainer restores the last step and rank 0 prints
``restart: restored step N OK (max|Δ|=...)`` against the live masters.
The default device is the card; without one it raises unless --device
cpu is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.api import Trainer
from repro_torch.configs.paper_nets import MNIST_DNN
from repro_torch.core import DPConfig, available_strategies, get_strategy
from repro_torch.data import ShardedLoader, make_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import BACKENDS, init_from_env
from repro_torch.models import apply_paper_net, init_paper_net
from repro_torch.train import cross_entropy, trainable


def loss_fn(model, batch):
    return cross_entropy(apply_paper_net(MNIST_DNN, model, batch["x"]),
                         batch["y"])


def eval_model(trainer, dev):
    """The trainer's model with its full params: itself, or -- where the
    params are sharded (zero3) -- a copy loaded from ``trainer.params``
    (a gather every rank takes part in)."""
    if not trainer.state.layout.params_flat:
        return trainer.state.params
    model = init_paper_net(MNIST_DNN, device=dev)
    full = trainer.params
    with torch.no_grad():
        for k, p in trainable(model).items():
            p.copy_(torch.from_numpy(full[k]))
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after this many steps (0: run every epoch)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--samples", type=int, default=8192)
    ap.add_argument("--strategy", default="flat",
                    choices=sorted(available_strategies()))
    ap.add_argument("--pods", type=int, default=1,
                    help=">1 builds a (pod, data) mesh -- the multi-pod "
                         "layout hierarchical stages its collectives over")
    ap.add_argument("--sync", default="grads", choices=["grads", "weights"])
    ap.add_argument("--sync-period", type=int, default=1)
    ap.add_argument("--backend", default="nccl", choices=BACKENDS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sequential", action="store_true",
                    help="run the one-process sequential reference "
                         "(mesh=None) instead, without torchrun")
    ap.add_argument("--dump", default="",
                    help="directory: each rank writes its params there "
                         "after each step")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory: save after each epoch, "
                         "then restore into a fresh trainer")
    args = ap.parse_args(argv)
    if args.sync != "grads" and get_strategy(args.strategy).sharded:
        ap.error(f"--strategy {args.strategy} shards the optimizer state "
                 "and needs --sync grads")

    if args.sequential:
        mesh, dev, rank = None, resolve_device(args.device), 0
    else:
        mesh, dev = init_from_env(args.backend, args.device, pods=args.pods)
        rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else None}"
        f" on {dev} ({'sequential reference' if mesh is None else args.backend})")

    net = MNIST_DNN
    ds = make_dataset("mnist", n=args.samples)
    loader = ShardedLoader({"x": ds.x, "y": ds.y}, args.batch, mesh=mesh,
                           device=dev)
    dp = DPConfig(sync=args.sync, sync_period=args.sync_period,
                  strategy=args.strategy)

    def create():
        return Trainer.create(loss_fn=loss_fn,
                              params=init_paper_net(net, seed=0, device=dev),
                              optimizer=optim.momentum(0.2, 0.9), dp=dp,
                              mesh=mesh, device=dev)

    trainer = create()
    say("trainer:", json.dumps(trainer.describe(), sort_keys=True))

    steps = 0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for batch in loader.epoch(epoch):
            losses.append(float(trainer.step(batch)["loss"]))
            steps += 1
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                np.savez(os.path.join(args.dump,
                                      f"step{steps}_rank{rank}.npz"),
                         **trainer.params)
            if steps == args.steps:
                break
        with torch.no_grad():
            logits = apply_paper_net(net, eval_model(trainer, dev),
                                     torch.from_numpy(ds.x[:1024]).to(dev))
        acc = float((logits.argmax(-1).cpu().numpy() == ds.y[:1024]).mean())
        sync = trainer.sync_ms()
        say(f"epoch {epoch}: loss {np.mean(losses):.4f}  acc {acc:.3f}  "
            f"({time.perf_counter() - t0:.1f}s"
            + (f", sync {np.median(sync):.3f} ms median" if sync else "")
            + ")", flush=True)
        if args.ckpt:
            trainer.save(args.ckpt)
        if steps == args.steps:
            break
    if args.ckpt:
        # restart demo (the paper's ULFM story: reload + continue) -- a
        # fresh trainer restores every master and moment
        fresh = create()
        at = fresh.restore(args.ckpt)
        live = trainer.params
        err = max(float(np.abs(p - live[k]).max())
                  for k, p in fresh.params.items())
        say(f"restart: restored step {at} OK (max|Δ|={err:.1e})")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
