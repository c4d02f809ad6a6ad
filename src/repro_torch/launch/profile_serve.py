"""Where the serving time goes: host wall vs device time per phase.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch qwen3-1.7b|rwkv6-1.6b|jamba-v0.1-52b|deepseek-v3-671b \\
        [--engine continuous|legacy] [--out profile_serve.json]

Serves the same traffic as ``chip_smoke.py``'s serving phases (16
requests of 64-512 prompt tokens, 64 new greedy tokens, 8 slots) with
the full-width config of ``--arch`` (Jamba cut to one 8-layer
super-block, DeepSeek-V3 to its first 4 layers:
``configs.one_card_config``), then traces one prefill chunk (32 tokens
into slot 0 at position 256, its recurrent rows included) and one
fused decode tick with
``torch.profiler``: host wall time, the device's busy time (sum of
kernel times on the one stream), its idle share, kernel launches, and
the kernels that take the most device time.  With ``--engine legacy``
(qwen3-1.7b: GQA with an MLP) it serves ``chip_smoke.py``'s phase-11
traffic instead -- 8 requests of 512 prompt tokens, 64 new greedy
tokens, through the lockstep ``ServeEngine`` -- and traces one slab
prefill of the 8 x 512 prompts and one slab decode step at position
512.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHITECTURES, one_card_config
from repro_torch.data import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.models import apply_model, init_model
from repro_torch.models.attention import PagedView
from repro_torch.serve import ContinuousScheduler, ServeEngine


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def trace(fn, device, top=8, by_kind=()):
    """Host wall (ms) of fn() ending in a synchronize, and the kernels
    the profiler saw on the device: the ``top`` that took the most
    device time and, with ``by_kind`` = ((kind, name substrings), ...),
    the device ms of each kind (the first that matches; "other" for the
    rest)."""
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / wall),
           "kernel_launches": sum(e.count for e in kernels),
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "device_ms": _device_us(e) / 1e3}
                           for e in sorted(kernels, key=_device_us,
                                           reverse=True)[:top]]}
    if by_kind:
        kinds = {kind: 0.0 for kind, _ in by_kind} | {"other": 0.0}
        for e in kernels:
            kind = next((kind for kind, subs in by_kind
                         if any(s in e.key for s in subs)), "other")
            kinds[kind] += _device_us(e) / 1e3
        out["device_ms_by_kind"] = kinds
    return out


def profile_legacy(cfg, model, dev, seed):
    """The lockstep slab engine on phase 11's traffic, then one traced
    slab prefill and one traced slab decode step."""
    batch, prompt_len, new = 8, 512, 64
    max_len = prompt_len + new + 16
    prompts = torch.from_numpy(synthetic_tokens(
        np.random.default_rng(seed), batch, prompt_len, cfg.vocab_size))
    ServeEngine(cfg, model, batch_size=batch,
                max_len=max_len).generate(prompts[:2, :64], 4)  # warm-up
    eng = ServeEngine(cfg, model, batch_size=batch, max_len=max_len)
    t0 = time.perf_counter()
    out = eng.generate(prompts, new)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    report = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
              "engine": "legacy", "num_layers": cfg.num_layers,
              "serve_wall_s": wall, "tokens_per_s": out.numel() / wall,
              "dispatches": eng.dispatches, "host_syncs": eng.host_syncs}
    toks = prompts.to(dev)
    last = toks[:, -1:]
    with torch.inference_mode():
        report["slab_prefill"] = trace(
            lambda: apply_model(cfg, model, toks, cache=eng.cache,
                                cache_pos=0, mode="prefill",
                                last_only=True), dev)
        report["slab_decode_step"] = trace(
            lambda: apply_model(cfg, model, last, cache=eng.cache,
                                cache_pos=prompt_len, mode="decode"), dev)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b",
                    choices=sorted(ARCHITECTURES))
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "legacy"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_serve measures the card: --device cuda")
    cfg = one_card_config(args.arch)
    if args.engine == "legacy":
        report = profile_legacy(cfg, init_model(cfg, seed=args.seed,
                                                device=dev), dev, args.seed)
        return _emit(report, args.out)
    slots, n_req, new, ps, chunk, K = 8, 16, 64, 16, 32, 8
    max_len = -(-(512 + new + K) // ps) * ps
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(64, 513, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    model = init_model(cfg, seed=args.seed, device=dev)

    def scheduler():
        return ContinuousScheduler(cfg, model, slots=slots, max_len=max_len,
                                   page_size=ps, prefill_chunk=chunk,
                                   decode_chunk=K)

    scheduler().generate(prompts[:2], 4)                   # warm-up
    sch = scheduler()
    t0 = time.perf_counter()
    sch.generate(prompts, new)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = sch.stats()
    report = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
              "num_layers": cfg.num_layers,
              "serve_wall_s": wall,
              "tokens_per_s": st["tokens_out"] / wall,
              "ttft_p50_s": float(np.median(st["ttft_s"])),
              "prefill_dispatches": st["prefill_dispatches"],
              "decode_dispatches": st["decode_dispatches"]}

    # one decode tick with all slots busy, and one prefill chunk
    sch = scheduler()
    for p in prompts[:slots]:
        sch.submit(p, new)
    sch._admit()
    with torch.inference_mode():
        report["decode_tick"] = trace(sch._decode_tick, dev)
        kv = sch.kv
        kv.free(0)
        kv.alloc(0, 256 + chunk)
        view = PagedView(kv.table([0]), ps)
        toks = torch.from_numpy(prompts[0][:chunk]).to(dev)[None]
        pos = torch.full((1,), 256, dtype=torch.int32, device=dev)
        report["prefill_chunk"] = trace(
            lambda: apply_model(cfg, model, toks, cache=kv.slot_cache(0),
                                cache_pos=pos, paged=view, logits=False), dev)
    return _emit(report, args.out)


def _emit(report, out):
    print(json.dumps(report, indent=1))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
