"""Serving launcher for the port: continuous batching (or the lockstep
slab engine, ``--engine legacy``) on the card.

    # full-width qwen3-1.7b in bf16 on the card, random weights from a seed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --batch 8 --requests 16 --prompt-len 128 --new-tokens 64 --report

    # the reduced config in fp32 on the CPU (plain PyTorch kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --device cpu --batch 4 --prompt-len 32 --new-tokens 16

    # the attention-free RWKV-6 stack, reduced, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --reduced --device cpu --batch 2 --prompt-len 40 --new-tokens 8

    # Jamba (Mamba + attention layers, MoE), reduced, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
        --reduced --device cpu --batch 2 --prompt-len 40 --new-tokens 8

    # the lockstep slab engine (whole-prompt prefill, then one decode
    # step per token, every attention call through the flash kernel)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --device cpu --engine legacy --batch 2 --prompt-len 40 \\
        --new-tokens 12

    # serve what launch/train.py checkpointed (the reduced config, CPU)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --device cpu --restore /tmp/ck

    # DeepSeek-V3 (MLA, sigmoid-router MoE of 256 experts), full width,
    # cut to its first 4 layers, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --batch 8 --requests 16 --report

Without --reduced the full-width config serves in bf16 (Jamba cut to
one 8-layer super-block, DeepSeek-V3 to its 3 dense layers and first
MoE layer: ``configs.one_card_config``); with it, the smoke config in
fp32.  The weights are drawn from --seed, or with --restore read from
a checkpoint either package's training wrote (the sharded store or the
legacy npz; --step, default the latest).  Prompts come from
``synthetic_tokens`` seeded by --seed.  The default device is the card;
a machine without one raises unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHITECTURES, one_card_config, smoke_config
from repro_torch.data import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.serve import (SamplingConfig, make_engine,
                               make_engine_from_checkpoint)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHITECTURES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "legacy"],
                    help="continuous batching over the paged pool, or the "
                         "lockstep slab engine (GQA stacks with an MLP)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=4,
                    help="serving slots (decode batch width)")
    ap.add_argument("--requests", type=int, default=None,
                    help="total requests to submit (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, prompts and sampling seed")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--report", action="store_true",
                    help="print per-phase dispatch and host-sync counters")
    ap.add_argument("--restore", default="",
                    help="serve the params of this checkpoint dir "
                         "(written by launch/train.py of either package) "
                         "instead of random weights")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if not args.requests:
        args.requests = args.batch

    if args.engine == "legacy" and args.requests > args.batch:
        raise SystemExit(
            f"--requests {args.requests} > --batch {args.batch}: the "
            "legacy lockstep engine has no queue (all slots start and "
            "retire together); use the continuous engine or raise "
            "--batch")

    if args.reduced:
        cfg = smoke_config(args.arch).with_overrides(dtype="float32")
    else:
        cfg = one_card_config(args.arch)
    sampling = SamplingConfig(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    decode_chunk = 8
    max_len = -(-(args.prompt_len + args.new_tokens + decode_chunk)
                // args.page_size) * args.page_size
    engine_kw = {}
    if args.engine == "continuous":
        engine_kw = dict(page_size=args.page_size, decode_chunk=decode_chunk)
    engine_kw.update(engine=args.engine, batch_size=args.batch,
                     max_len=max_len, eos_id=args.eos_id, sampling=sampling,
                     seed=args.seed, device=device)
    if args.restore:
        eng = make_engine_from_checkpoint(args.restore, cfg, step=args.step,
                                          **engine_kw)
        print(f"serving checkpoint step {eng.restored_step} from "
              f"{args.restore}")
    else:
        eng = make_engine(cfg, init_model(cfg, seed=args.seed,
                                          device=device), **engine_kw)
    n_req = args.requests
    prompts = synthetic_tokens(np.random.default_rng(args.seed), n_req,
                               args.prompt_len, cfg.vocab_size)
    t0 = time.time()
    if args.engine == "legacy":
        outs = eng.generate(prompts, args.new_tokens).cpu().tolist()
        dt = time.time() - t0
        n_tok = sum(len(o) for o in outs)
        print(f"{n_req} seqs x {args.new_tokens} tokens in {dt:.2f}s "
              f"({n_tok/dt:.1f} tok/s incl. compile)")
        if args.report:
            # the lockstep slab has no phase split: one prefill
            # dispatch, then a blocking round-trip per token
            spt = eng.host_syncs / max(1, n_tok)
            print(f"report: legacy {eng.dispatches} dispatches / "
                  f"{eng.host_syncs} host syncs ({spt:.3f} syncs/token)")
        print(outs)
        return outs
    outs = [o.tolist() for o in eng.generate(list(prompts), args.new_tokens)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_tok = sum(len(o) for o in outs)
    st = eng.stats()
    print(f"{n_req} requests x {args.new_tokens} tokens in "
          f"{dt:.2f}s ({n_tok/dt:.1f} tok/s incl. compile, "
          f"{st['syncs_per_token']:.3f} host syncs/token, "
          f"pool {st['pool_pages_in_use']} pages live, "
          f"{st['pool_bytes']} pool bytes, "
          f"{st['state_bytes']} recurrent state bytes)")
    if args.report:
        kernel = "cuda" if device.type == "cuda" else "plain"
        print(f"report: decode_kernel={kernel} "
              f"prefill {st['prefill_dispatches']} dispatches / "
              f"{st['prefill_host_syncs']} host syncs "
              f"({st['prefill_host_syncs'] / n_req:.2f} "
              f"syncs/request), "
              f"decode {st['decode_dispatches']} dispatches / "
              f"{st['decode_host_syncs']} host syncs "
              f"({st['decode_host_syncs'] / max(1, n_tok):.3f} "
              f"syncs/token)")
    print(outs)
    return outs


if __name__ == "__main__":
    main()
