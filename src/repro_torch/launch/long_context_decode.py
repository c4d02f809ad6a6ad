"""Long-context decode (port of ``examples/long_context_decode.py``):
why the long_500k shape is native for SSM / hybrid architectures -- the
recurrent state is O(1) in context length while a dense transformer's
KV cache grows linearly.

    # on the card: RWKV-6's prefill chunks through the wkv6 kernel
    PYTHONPATH=src python -m repro_torch.launch.long_context_decode \\
        --context 4096

    # Jamba (Mamba chunks through mamba_scan, attention through the
    # flash kernel), on the CPU
    PYTHONPATH=src python -m repro_torch.launch.long_context_decode \\
        --arch jamba-v0.1-52b --device cpu --context 1024

The reduced (smoke) config in fp32, weights from seed 0, one prompt of
``--context`` synthetic tokens (seed 0).  The prompt goes through the
lockstep slab cache in ``--chunk``-token chunks -- the first a
``"prefill"`` call, the rest ``"decode"`` calls of ``--chunk`` tokens --
so prefill extends the recurrent state (and Jamba's attention cache)
instead of re-reading the prompt; then ``--new-tokens`` greedy tokens
decode one at a time.  The recurrent state and cache bytes are
allocated once for the whole context.  The last line sets them beside
the KV cache a dense model would need at this context, at the FULL
config of deepseek-coder-33b in bf16: one sequence as a static slab,
and 8 serving slots at mixed depths (context x (i + 1) / 8) as a slab
and as the paged pool of 16-token pages (``perf_model``).  With
``--report`` a line gives the kernels' launch counts of the run.  The
default device is the card; without one it raises unless --device cpu
is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import perf_model
from repro_torch.data import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import apply_model, init_cache, init_model


def state_bytes(tree) -> int:
    """Bytes of every tensor of a cache (lists and dicts of tensors)."""
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(state_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b",
                    choices=["rwkv6-1.6b", "jamba-v0.1-52b"])
    ap.add_argument("--context", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--report", action="store_true",
                    help="print the kernels' launch counts of the run")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch).with_overrides(dtype="float32")
    device = resolve_device(args.device)
    model = init_model(cfg, seed=0, device=device)
    prompt = torch.from_numpy(synthetic_tokens(
        np.random.default_rng(0), 1, args.context,
        cfg.vocab_size)).to(device)

    # the recurrent state is allocated once; attention layers (Jamba)
    # still keep a cache, sized to the full context
    cache = init_cache(cfg, torch.float32, batch=1,
                       max_len=args.context + args.new_tokens, device=device)
    n_state = state_bytes(cache)
    print(f"{args.arch} (reduced): context={args.context}")
    print(f"  recurrent-state+cache bytes: {n_state / 1e6:.1f} MB")

    reset_launch_counts()
    # chunked prefill: the state carries across chunks
    t0 = time.time()
    pos = 0
    with torch.no_grad():
        for s in range(0, args.context, args.chunk):
            toks = prompt[:, s:s + args.chunk]
            out = apply_model(cfg, model, toks, cache=cache, cache_pos=pos,
                              mode="prefill" if s == 0 else "decode")
            pos += toks.shape[1]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"  prefilled {pos} tokens in {time.time() - t0:.1f}s "
              "(chunked, state carried)")

        tok = out["logits"][:, -1].argmax(-1)[:, None]
        gen = [int(tok[0, 0])]
        for _ in range(args.new_tokens - 1):
            out = apply_model(cfg, model, tok, cache=cache, cache_pos=pos,
                              mode="decode")
            pos += 1
            tok = out["logits"][:, -1].argmax(-1)[:, None]
            gen.append(int(tok[0, 0]))
    print(f"  decoded: {gen}")
    counts = launch_counts()
    if args.report:
        print(f"  report: kernel launches {dict(sorted(counts.items()))}")

    # a dense transformer's KV cache at the FULL config scale, as a
    # static slab (every slot reserves max_len) and as the paged pool
    # the serving path allocates: pages for the tokens that exist
    full = get_config("deepseek-coder-33b")
    tok_bytes = perf_model.kv_bytes_per_token(full)        # bf16
    slab = args.context * tok_bytes
    # 8 serving slots at mixed depths, each with this context as headroom
    contexts = [args.context * (i + 1) // 8 for i in range(8)]
    paged = perf_model.paged_pool_bytes(contexts, 16, tok_bytes)
    print(f"  [contrast] deepseek-coder-33b KV at this context: "
          f"{slab / 1e6:.1f} MB/sequence slab (vs O(1) SSM state); "
          f"8 mixed-depth serving slots: {8 * slab / 1e6:.1f} MB slab -> "
          f"{paged / 1e6:.1f} MB paged pool")
    return {"state_bytes": n_state, "generated": gen,
            "launches": dict(counts)}


if __name__ == "__main__":
    main()
