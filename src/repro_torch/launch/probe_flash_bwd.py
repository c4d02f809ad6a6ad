"""The flash backward's two dQ designs side by side on the card.

    PYTHONPATH=src python -m repro_torch.launch.probe_flash_bwd \\
        [--out probe_flash_bwd.json]

At the five bf16 training forms of ``chip_smoke.py``'s phase 2 (qwen3,
DeepSeek's MLA, seamless non-causal and causal, a mesh rank's qwen3),
times ``flash_attention_bwd`` in its two dQ designs
(``csrc/flash_attention_bwd.cu``, ``ordered_dq``): "ordered", dQ summed
over the key blocks in key order inside the gradient kernel, and "dq
kernel", dQ by a kernel of the same warp-specialised shape that
recomputes S and dP, then the dK/dV kernel alone.  The shipped build
takes the first at q/k widths 64 and 128 and the second at MLA's 192;
the probe build ``-DFLASH_BWD_OTHER_DQ`` takes the other at every width.
In turns: shipped, probe, probe, shipped.  Each time is
the median of 10 calls by CUDA events after an L2 flush; each design's
kernels apart by torch.profiler; each design's gradients against
``flash_attention_bwd_tiled`` (max |err| / max |grad|) and two calls
bitwise.  Prints the card's name and power limit.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (_launch, flash_attention_bwd,
                                                 flash_attention_bwd_tiled)

STEM, MACRO = "flash_attention_bwd", "FLASH_BWD_OTHER_DQ"
# name, B, S = T, h, hk, hd, causal (hdv = hd, 128 at hd 192)
FORMS = [("qwen3", 1, 4096, 16, 8, 128, True),
         ("mla", 1, 4096, 128, 128, 192, True),
         ("seamless non-causal", 1, 4096, 16, 16, 64, False),
         ("seamless causal", 1, 4096, 16, 16, 64, True),
         ("mesh rank", 2, 512, 8, 4, 128, True)]
KERNELS = r"\b(bwd_rowstats|bwd_ws|bwd_dq_out|bwd_dq_ws)<"


def time_ms(fn, flush, iters=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def design_of(hd, build_name):
    """The dQ design a build runs at q/k width ``hd``."""
    ordered = hd <= 128
    return "ordered" if ordered == (build_name == "shipped") else "dq kernel"


def use(build_name):
    """Load the shipped build or the probe build ("other")."""
    build.set_probe(STEM, build_name == "other", MACRO)
    build.load_library(STEM)


def inputs(case):
    """The form's q, k, v, dout, out, lse (one seed) and the tiled
    version's gradients."""
    _, B, S, h, hk, hd, causal = case
    hdv = 128 if hd == 192 else hd
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda",
                                 dtype=torch.bfloat16)
                     for shape in ((B, S, h, hd), (B, S, hk, hd),
                                   (B, S, hk, hdv), (B, S, h, hdv)))
    out, lse = _launch(q, k, v, causal, 0, with_lse=True)
    want = flash_attention_bwd_tiled(q, k, v, out, lse, dout, causal=causal)
    return (q, k, v, out, lse, dout), want


def measure(build_name, case, args, want, flush):
    use(build_name)
    causal = case[-1]

    def call():
        return flash_attention_bwd(*args, causal=causal)

    got, again = call(), call()
    err = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item() for a, b in zip(got, want))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again
    ms = time_ms(call, flush)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    split = {m.group(1): ev.device_time_total / ev.count / 1e3
             for ev in prof.key_averages()
             if (m := re.search(KERNELS, ev.key))}
    return {"ms": ms, "kernels_ms": split, "rel_err": err,
            "bitwise_repeat": bitwise}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_bwd needs the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    build.load_libraries(["flash_attention", STEM])
    build.set_probe(STEM, True, MACRO)
    build.load_libraries([STEM])        # both builds before any timing
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for case in FORMS:
        row = {"form": case[0], "case": list(case[1:])}
        args_, want = inputs(case)
        for turn, build_name in enumerate(("shipped", "other", "other",
                                           "shipped")):
            got = measure(build_name, case, args_, want, flush)
            design = design_of(case[5], build_name)
            row.setdefault(design, []).append(got)
            print(f"  {case[0]:20s} {design:9s} turn {turn}: "
                  f"{got['ms']:.4f} ms  "
                  + "  ".join(f"{k} {v:.4f}"
                              for k, v in sorted(got["kernels_ms"].items()))
                  + f"  err {got['rel_err']:.2e}  bitwise "
                  f"{got['bitwise_repeat']}", flush=True)
        rows.append(row)
        del args_, want
        torch.cuda.empty_cache()
    build.set_probe(STEM, False, MACRO)
    result = {"card": card, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
