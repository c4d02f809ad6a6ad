"""Where the training time goes: one traced train step.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        [--out profile_train.json]

Builds ``chip_smoke.py``'s phase-13 run -- full-width, full-depth
qwen3-1.7b, bf16 compute on fp32 masters, AdamW, per-layer remat, one
batch of 2 x 4096 synthetic tokens (seed 0) in 2 microbatches -- takes
one untimed step, then traces one step with
``torch.profiler`` (``profile_serve.trace``): host wall, the device's
busy time and idle share, kernel launches, and the kernels that take
the most device time, with the device time summed by kind (the flash
kernel, matrix products, everything else).  Needs the card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.profile_serve import _emit, trace
from repro_torch.train import TrainConfig, init_train_state, make_train_step

BATCH, SEQ, MICRO = 2, 4096, 2      # chip_smoke.py's phase-13 step
# substrings of kernel names, by kind (the first that matches)
KINDS = (("flash kernel", ("attention_kernel", "flash_fwd_kernel")),
         ("matrix products", ("gemm", "nvjet", "xmma", "cutlass")))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = get_config("qwen3-1.7b")
    tc = TrainConfig(optimizer="adamw", lr=3e-4, microbatches=MICRO,
                     remat=True)
    state = init_train_state(cfg, tc, seed=0, device=dev)
    step, _ = make_train_step(cfg, tc)
    batch = make_batch(cfg, np.random.default_rng(0), BATCH, SEQ)
    losses = []
    # the masters and the optimizer state are updated in place
    one_step = lambda: losses.append(float(step(state, batch)[1]["loss"]))
    one_step()                                             # warm-up
    report = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
              "tokens": BATCH * SEQ, "microbatches": MICRO,
              "train_step": trace(one_step, dev, top=15, by_kind=KINDS)}
    report["losses"] = losses
    return _emit(report, args.out)


if __name__ == "__main__":
    main()
