"""Where the time goes inside the two scan kernels, and their host cost.

    PYTHONPATH=src python -m repro_torch.launch.probe_scans \\
        [--out probe_scans.json]

At the serving path's shapes (a 32-token prefill chunk in bf16: ``wkv6``
at B 1, H 32, K 64; ``mamba_scan`` at Bb 1, dI 8192, dS 16 with B and C
strided column slices of one projection; and a multi-chunk call of each):

1. builds ``csrc/wkv6.cu`` and ``csrc/mamba_scan.cu`` with
   ``-DSCAN_PROBE`` (``csrc/scan_probe.cuh``: clock64 stamps between the
   kernels' phases), runs each call, and prints every phase's cycles --
   the mean and the max over the blocks -- and their microseconds at the
   SM clock ``nvidia-smi`` reads just after;
2. on the default build: the device time of a call (CUDA events, as
   ``chip_smoke.py``'s phase 2 times it, beside the floor of that timing:
   a one-element fill timed alike) and the host time of a wrapper call
   (a loop of enqueues, no synchronize in it).

Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import mamba_ref, mamba_scan
from repro_torch.kernels.wkv6 import wkv6, wkv6_chunked

# the phases each kernel's probe marks, by slot (csrc/*.cu PROBE_MARK)
PHASES = {
    "wkv6": ["staging", "cumsum + decayed operands", "scores",
             "y products + state update", "cluster barrier",
             "rank-ordered sum + y store", "final cluster barrier"],
    "mamba_scan": ["staging", "step loop", "store y", "store state"],
}


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, iters=20):
    """Median device ms of fn() over iters calls (L2 flushed, the card
    spinning ~5 ms before the start event), as chip_smoke.py times."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(10_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, calls=400):
    """Host microseconds per call of fn() enqueued back to back."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return per


def wkv_call(dev, B, T, H=32, K=64, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, K)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    wl = torch.from_numpy(-np.exp(rng.standard_normal((B, T, H, K))).astype(
        np.float32)).to(dev)
    u = torch.from_numpy(rng.standard_normal((H, K)).astype(np.float32)).to(dev)
    s0 = torch.from_numpy(rng.standard_normal((B, H, K, K)).astype(
        np.float32)).to(dev)
    args = (r, k, v, wl, u, s0)

    def err():
        y, s = wkv6(*args)
        yw, sw = wkv6_chunked(*args)
        return max((y.float() - yw.float()).abs().max().item(),
                   (s - sw).abs().max().item())
    return (lambda: wkv6(*args)), err


def mamba_call(dev, Bb, T, dI=8192, dS=16, R=256, seed=0):
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((Bb, T, dI)).astype(
        np.float32)).to(dev, bf)
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (Bb, T, dI)))).astype(np.float32)).to(dev, bf)
    A = torch.from_numpy(-np.exp(rng.standard_normal((dI, dS))).astype(
        np.float32)).to(dev)
    proj = torch.from_numpy(rng.standard_normal((Bb, T, R + 2 * dS)).astype(
        np.float32)).to(dev, bf)
    D = torch.from_numpy(rng.standard_normal(dI).astype(np.float32)).to(dev)
    h0 = torch.from_numpy(rng.standard_normal((Bb, dI, dS)).astype(
        np.float32)).to(dev)
    args = (x, dt, A, proj[..., R:R + dS], proj[..., R + dS:], D, h0)

    def err():
        y, s = mamba_scan(*args)
        yw, sw = mamba_ref(*args)
        return max((y.float() - yw).abs().max().item(),
                   (s - sw).abs().max().item())
    return (lambda: mamba_scan(*args)), err


def probe(stem, fn):
    """Phase cycles of one call of fn() on the probe build of stem."""
    build.set_probe(stem, True)
    fn()
    fn()
    torch.cuda.synchronize()
    lib = build.load_library(stem)
    read = getattr(lib, f"{stem}_probe_read")
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    table = np.zeros((4096, 8), dtype=np.int64)
    rc = read(table.ctypes.data, table.shape[0])
    if rc != 0:
        raise RuntimeError(f"{stem}_probe_read failed: {rc}")
    clock_mhz = float(smi("clocks.sm"))
    build.set_probe(stem, False)
    rows = table[table.sum(axis=1) > 0]
    out = {"blocks": int(rows.shape[0]), "sm_clock_mhz": clock_mhz,
           "phases": []}
    for i, name in enumerate(PHASES[stem]):
        col = rows[:, i].astype(np.float64)
        out["phases"].append({
            "phase": name, "mean_cycles": float(col.mean()),
            "max_cycles": float(col.max()),
            "mean_us": float(col.mean() / clock_mhz),
            "max_us": float(col.max() / clock_mhz)})
    total = rows[:, :len(PHASES[stem])].sum(axis=1).astype(np.float64)
    out["total_mean_us"] = float(total.mean() / clock_mhz)
    out["total_max_us"] = float(total.max() / clock_mhz)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_scans measures the card")
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    print(f"card: {card}")
    report = {"card": card, "calls": []}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    # the floor of this timing: a one-element fill, one block, timed alike
    tiny = torch.empty(1, device=dev)
    report["floor_ms"] = time_ms(tiny.zero_, flush)
    print(f"timing floor (a one-element fill, timed as below): "
          f"{report['floor_ms']:.4f} ms")
    calls = [
        ("wkv6", "chunk B=1 T=32 H=32 K=64 bf16", wkv_call(dev, 1, 32)),
        ("wkv6", "ragged B=2 T=80 H=32 K=64 bf16", wkv_call(dev, 2, 80)),
        ("mamba_scan", "chunk Bb=1 T=32 dI=8192 dS=16 bf16",
         mamba_call(dev, 1, 32)),
        ("mamba_scan", "ragged Bb=2 T=75 dI=8192 dS=16 bf16",
         mamba_call(dev, 2, 75)),
    ]
    for stem, name, (fn, err) in calls:
        row = {"kernel": stem, "call": name, "probe": probe(stem, fn)}
        row["max_abs_err"] = err()
        row["device_ms"] = time_ms(fn, flush)
        row["host_us_per_call"] = host_us(fn)
        report["calls"].append(row)
        print(f"{stem} {name}: device {row['device_ms']:.4f} ms, host "
              f"{row['host_us_per_call']:.1f} us a call, max |err| "
              f"{row['max_abs_err']:.2e}; probe ({row['probe']['blocks']} "
              f"blocks, SM {row['probe']['sm_clock_mhz']:.0f} MHz, total "
              f"mean {row['probe']['total_mean_us']:.2f} us, max "
              f"{row['probe']['total_max_us']:.2f} us):")
        for ph in row["probe"]["phases"]:
            print(f"    {ph['phase']:20s} mean {ph['mean_cycles']:9.0f} cyc "
                  f"{ph['mean_us']:7.3f} us   max {ph['max_cycles']:9.0f} "
                  f"cyc {ph['max_us']:7.3f} us")
    print(json.dumps(report))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
