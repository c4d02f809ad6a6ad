"""Continuous-batching serving example (port of ``examples/
serve_batched.py``): a queue of mixed-length requests streams through a
fixed number of slots over a paged KV cache -- admission on retirement,
chunked prefill, fused decode -- and each request's greedy tokens equal
its solo generation exactly, which the example checks.

    # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_batched \\
        --arch jamba-v0.1-52b

    # on the CPU; --legacy runs the lockstep ServeEngine instead
    PYTHONPATH=src python -m repro_torch.launch.serve_batched --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_batched --device cpu \\
        --legacy

The reduced (smoke) config in fp32, weights from seed 0.  The queue:
``--requests`` prompts of 5, 12 and 19 tokens in turn (request i drawn
from seed i), more than ``--slots``, so later requests are admitted the
moment an earlier one retires.  ``max_len`` gives every slot 256
tokens of headroom, but the pool holds pages only for what is live:
the line after the outputs sets its resident bytes beside the
static-slab equivalent.  The solo check serves each request alone on a
fresh one-slot scheduler over the same weights.  ``--legacy`` serves
``--slots`` prompts of 16 tokens through the lockstep slab engine.
The default device is the card; without one it raises unless --device
cpu is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHITECTURES, smoke_config
from repro_torch.data import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.serve import ContinuousScheduler, ServeEngine

PREFILL_CHUNK, DECODE_CHUNK = 16, 4


def _text_archs():
    return [a for a in sorted(ARCHITECTURES)
            if ARCHITECTURES[a].frontend == "none"
            and not ARCHITECTURES[a].is_encoder_decoder]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=_text_archs())
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--legacy", action="store_true",
                    help="run the lockstep ServeEngine instead")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch).with_overrides(dtype="float32")
    device = resolve_device(args.device)
    model = init_model(cfg, seed=0, device=device)

    if args.legacy:
        prompts = synthetic_tokens(np.random.default_rng(0), args.slots, 16,
                                   cfg.vocab_size)
        eng = ServeEngine(cfg, model, batch_size=args.slots, max_len=64)
        t0 = time.time()
        out = eng.generate(prompts, args.new_tokens).cpu().numpy()
        dt = time.time() - t0
        print(f"legacy lockstep: {args.slots} seqs x {args.new_tokens} "
              f"tokens in {dt:.2f}s")
        for i, row in enumerate(out.tolist()):
            print(f"  seq{i}: {row}")
        return [row for row in out]

    # mixed-length queue: more requests than slots, so later requests
    # are admitted the moment an earlier one retires
    lengths = [5 + 7 * (i % 3) for i in range(args.requests)]
    prompts = [synthetic_tokens(np.random.default_rng(i), 1, n,
                                cfg.vocab_size)[0]
               for i, n in enumerate(lengths)]
    bs = args.page_size
    live = max(lengths) + args.new_tokens + 4
    num_pages = args.slots * (-(-live // bs)) + 1

    def scheduler(slots, pages):
        return ContinuousScheduler(
            cfg, model, slots=slots, max_len=256, page_size=bs,
            num_pages=pages, prefill_chunk=PREFILL_CHUNK,
            decode_chunk=DECODE_CHUNK)

    sched = scheduler(args.slots, num_pages)
    t0 = time.time()
    outs = sched.generate(prompts, args.new_tokens)
    dt = time.time() - t0
    st = sched.stats()
    n_tok = sum(len(o) for o in outs)
    print(f"arch={args.arch} (reduced) slots={args.slots} "
          f"requests={args.requests} prompts={lengths}")
    print(f"generated {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s; {st['syncs_per_token']:.3f} host "
          f"syncs/token; ttft {min(st['ttft_s']) * 1e3:.0f}-"
          f"{max(st['ttft_s']) * 1e3:.0f}ms)")
    for i, row in enumerate(outs):
        print(f"  req{i} (prompt {lengths[i]:2d}): {row.tolist()}")
    print(f"paged pool: {st['pool_bytes'] / 1e6:.2f} MB resident vs "
          f"{st['slab_bytes_equiv'] / 1e6:.2f} MB static-slab equivalent")

    solo_pages = -(-live // bs) + 1
    for i, (p, row) in enumerate(zip(prompts, outs)):
        solo = scheduler(1, solo_pages).generate([p], args.new_tokens)[0]
        if not np.array_equal(solo, row):
            raise SystemExit(f"req{i}: batched tokens {row.tolist()} differ "
                             f"from its solo generation {solo.tolist()}")
    print(f"every request's greedy tokens equal its solo generation "
          f"({len(prompts)} requests)")
    return outs


if __name__ == "__main__":
    main()
