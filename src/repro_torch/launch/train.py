"""Training launcher for the port: the one-device train step.

    # the reduced config in fp32 on the CPU (plain PyTorch attention)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --steps 3 --batch 4 --seq 64

    # full-width, full-depth qwen3-1.7b on the card: bf16 compute on fp32
    # masters, AdamW, every attention call through the flash kernel
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 10 --batch 2 --seq 4096 --microbatches 2

    # the reduced config data-parallel over two ranks (the paper's
    # synchronous allreduce through the Trainer facade), under torchrun
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --backend gloo --dp-strategy bucketed \\
        --steps 3 --batch 4 --seq 64

Port of ``repro.launch.train``.  Without --reduced the full config
trains in its compute dtype (bf16) on fp32 masters; with it, the smoke
config in fp32.  The weights are drawn from seed 0; the batch of step
i is ``make_batch`` of a generator seeded by (--data-seed, i).  Each
step prints its loss; the end prints tokens/s over the steps after the
first and the peak device memory.  The default device is the card; a
machine without one raises unless --device cpu is given.

``--dp-strategy`` (which, as in the reference, requires --reduced)
trains through ``api.Trainer`` over every rank torchrun starts, with
``--backend`` nccl (one rank a card) or gloo (the CPU, or ranks
sharing one card): rank 0 prints ``describe()``, the losses (averaged
over the ranks) and the time in the gradient sync.  Checkpoints and
fault injection join with ROADMAP A.3 and A.9.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHITECTURES, get_config, smoke_config
from repro_torch.core import DPConfig, available_strategies
from repro_torch.data import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import BACKENDS, init_from_env
from repro_torch.models import check_train_ported
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHITECTURES))
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke variant in fp32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-clip", type=float, default=0.0,
                    help="global-norm clip (0: off)")
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine"])
    ap.add_argument("--no-remat", action="store_true",
                    help="keep every layer's activations instead of "
                         "recomputing them in the backward")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-seed", type=int, default=0,
                    help="seed of the per-step synthetic batch stream")
    ap.add_argument("--dp-strategy", default="",
                    choices=["", *available_strategies()],
                    help="reduced mode: train data-parallel over the "
                         "torchrun ranks with this registered strategy")
    ap.add_argument("--sync", default="grads",
                    choices=["grads", "weights", "none"])
    ap.add_argument("--sync-period", type=int, default=1)
    ap.add_argument("--compress", default="none", choices=["none", "bf16"])
    ap.add_argument("--pods", type=int, default=1,
                    help=">1 builds a (pod, data) mesh")
    ap.add_argument("--bucket-bytes", type=int, default=64 * 2 ** 20,
                    help="target bucket size of the bucketed strategy")
    ap.add_argument("--backend", default="nccl", choices=BACKENDS)
    args = ap.parse_args(argv)
    if args.dp_strategy and not args.reduced:
        ap.error("--dp-strategy requires --reduced (as in the reference: "
                 "the full config trains on the one-device step)")
    if args.dp_strategy and (args.grad_clip or args.schedule != "constant"):
        ap.error("--grad-clip and --schedule cosine are options of the "
                 "one-device step; the data-parallel step has neither, as "
                 "in the reference")

    cfg = (smoke_config(args.arch).with_overrides(dtype="float32")
           if args.reduced else get_config(args.arch))
    try:
        check_train_ported(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    tc = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                     microbatches=args.microbatches, remat=not args.no_remat,
                     grad_clip=args.grad_clip, schedule=args.schedule)
    if args.dp_strategy:
        return run_dp(args, cfg, tc)
    dev = resolve_device(args.device)
    state = init_train_state(cfg, tc, seed=0, device=dev)
    step, _ = make_train_step(cfg, tc)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_after_first = None
    for i in range(args.steps):
        batch = make_batch(cfg, np.random.default_rng([args.data_seed, i]),
                           args.batch, args.seq)
        state, metrics = step(state, batch)
        print(f"step {i:4d}  loss {float(metrics['loss']):.4f}", flush=True)
        if i == 0:
            t_after_first = time.perf_counter()
    if args.steps > 1:
        wall = time.perf_counter() - t_after_first   # float(loss) synced
        tokens = (args.steps - 1) * args.batch * args.seq
        print(f"{tokens / wall:.1f} tokens/s over steps 1..{args.steps - 1} "
              f"({wall:.3f} s, {dev.type})")
    if dev.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
              f"({torch.cuda.get_device_name(dev)})")
    else:
        print("peak device memory: not measured (cpu)")


def run_dp(args, cfg, tc):
    """Reduced-mode data-parallel training through the Trainer facade,
    on every rank torchrun started; rank 0 reports."""
    from repro_torch.api import Trainer
    mesh, dev = init_from_env(args.backend, args.device, pods=args.pods)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    dp = DPConfig(sync=args.sync, sync_period=args.sync_period,
                  strategy=args.dp_strategy, compress=args.compress,
                  bucket_bytes=args.bucket_bytes,
                  microbatches=args.microbatches)
    trainer = Trainer.create(cfg, optimizer=tc.optimizer, lr=tc.lr, dp=dp,
                             mesh=mesh, train_cfg=tc, seed=0, device=dev)
    say("trainer:", json.dumps(trainer.describe(), sort_keys=True),
        flush=True)
    for i in range(args.steps):
        # every rank draws the batch; only rank 0's is read (and scattered)
        batch = make_batch(cfg, np.random.default_rng([args.data_seed, i]),
                           args.batch, args.seq)
        metrics = trainer.step(batch)
        say(f"step {i:4d}  loss {float(metrics['loss']):.4f}", flush=True)
    sync = trainer.sync_ms()
    if sync:
        say(f"sync: median {np.median(sync):.3f} ms over {len(sync)} syncs "
            f"({dev.type})")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
