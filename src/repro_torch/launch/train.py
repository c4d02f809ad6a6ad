"""Training launcher for the port: the one-device train step.

    # the reduced config in fp32 on the CPU (plain PyTorch attention)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --steps 3 --batch 4 --seq 64

    # full-width, full-depth qwen3-1.7b on the card: bf16 compute on fp32
    # masters, AdamW, every attention call through the flash kernel
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 10 --batch 2 --seq 4096 --microbatches 2

Port of ``repro.launch.train`` for one device.  Without --reduced the
full config trains in its compute dtype (bf16) on fp32 masters; with
it, the smoke config in fp32.  The weights are drawn from seed 0; the
batch of step i is ``make_batch`` of a generator seeded by
(--data-seed, i).  Each step prints its loss; the end prints tokens/s
over the steps after the first and the peak device memory.  The
default device is the card; a machine without one raises unless
--device cpu is given.  Checkpoints, data parallelism and fault
injection join with ROADMAP A.2-A.4 and A.9.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHITECTURES, get_config, smoke_config
from repro_torch.data import make_batch
from repro_torch.device import resolve_device
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
    args = ap.parse_args(argv)

    cfg = (smoke_config(args.arch).with_overrides(dtype="float32")
           if args.reduced else get_config(args.arch))
    try:
        check_train_ported(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    dev = resolve_device(args.device)
    tc = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                     microbatches=args.microbatches, remat=not args.no_remat,
                     grad_clip=args.grad_clip, schedule=args.schedule)
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


if __name__ == "__main__":
    main()
