"""Quickstart: build an architecture, train a few steps, generate (port
of ``examples/quickstart.py``).

    # on the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --arch qwen3-1.7b

    # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu \\
        --arch rwkv6-1.6b --steps 5

The reduced (smoke) variant of the architecture in fp32, weights from
seed 0, so it runs in seconds; the same code drives the full config.
Training goes through the ``Trainer`` facade, the one entry point that
hides strategy resolution, the train state and checkpointing: a batch
of 4 x 64 tokens (``data.make_batch``'s forms for the VLM and the
encoder-decoder), Adam at lr 1e-3, the loss printed every 5 steps.
One process runs the sequential step, the reference's host mesh of one
device; ``--dp-strategy`` names any registered strategy, as there.  A
text decoder then generates 8 greedy tokens for two 16-token prompts
through the lockstep ``ServeEngine`` cast from the trained masters
(``Trainer.serve``).  The default device is the card; without one it
raises unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import Trainer
from repro_torch.configs import ARCHITECTURES, smoke_config
from repro_torch.core import DPConfig
from repro_torch.data import make_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b",
                    choices=sorted(ARCHITECTURES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dp-strategy", default="flat",
                    help="any registered strategy name "
                         "(repro_torch.core.available_strategies())")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch).with_overrides(dtype="float32")
    print(f"arch={cfg.name} (reduced): {cfg.num_layers}L d={cfg.d_model} "
          f"family={cfg.family}")
    batch = make_batch(cfg, np.random.default_rng(0), 4, 64)

    # the one-object training surface: strategy, state layout and
    # checkpointing live behind Trainer; change dp.strategy and nothing
    # else changes
    trainer = Trainer.create(
        cfg, optimizer="adam", lr=1e-3,
        dp=DPConfig(sync="grads", strategy=args.dp_strategy), seed=0,
        device=args.device)
    desc = trainer.describe()
    print(f"params: {desc['params'] / 1e6:.2f}M")
    print(f"trainer: strategy={desc['strategy']} "
          f"world={desc['world_size']} opt_bytes/dev="
          f"{desc['memory_per_device_bytes']['opt_state']:.0f}")

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        losses.append(float(trainer.step(batch)["loss"]))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.4f}")
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")
    if not np.isfinite(losses).all():
        raise SystemExit(f"quickstart: losses {losses} are not finite")

    out = None
    if cfg.frontend == "none" and not cfg.is_encoder_decoder:
        eng = trainer.serve(engine="legacy", batch_size=2, max_len=96)
        out = eng.generate(batch["tokens"][:2, :16], 8).cpu().numpy()
        print("generated token ids:", out.tolist())
    return {"losses": losses, "generated": out}


if __name__ == "__main__":
    main()
