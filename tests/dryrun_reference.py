"""The dry run's records beside the reference's StableHLO walk, as a
markdown table.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dryrun_reference.py \\
        build/results/dryrun_single.json [--pairs all|split] [--chips N]

For every ``ok`` record of the port's dry run (``python -m
repro_torch.launch.dryrun``), lowers the reference's step of the same
pair (``repro.launch.dryrun.lower_pair``) on a one-device mesh and
walks it (``repro.roofline.hlocost.stablehlo_cost``): the reference's
global FLOPs, which the port's ``flops_global`` is set over.  Prints one
row a pair: that ratio, rank 0's peak in GiB and whether it fits 80 GiB,
the collective bytes by kind, and the roofline on ``H100_SXM``
(``repro_torch.roofline.analysis``) with ``--chips`` cards.  Every number
is computed, none measured.  The reference's module sets ``XLA_FLAGS``
when it is imported, so this runs as a script of its own, never inside
a test process.  ``--pairs split`` keeps the pairs whose microbatch rows
do not divide the mesh's pod x data (the sequence split).
"""
import argparse
import dataclasses
import json
import os
import sys

import jax
import numpy as np
from jax.sharding import Mesh

from repro.launch.dryrun import lower_pair
from repro.roofline.hlocost import stablehlo_cost
from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch.dryrun import run_config
from repro_torch.roofline.analysis import H100_SXM, roofline_terms

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def reference_flops(pairs, cache):
    """{pair key: the reference's global FLOPs} on a one-device mesh,
    kept in the JSON file ``cache`` (read first, written as they land)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    out = json.loads(open(cache).read()) if os.path.exists(cache) else {}
    for key in pairs:
        if key in out:
            continue
        arch, shape = key.split("|")
        lowered, _, _ = lower_pair(arch, shape, mesh)
        c = stablehlo_cost(lowered.as_text())
        out[key] = c["flops"]
        print(f"{key}: reference {c['flops']:.4e} (unresolved "
              f"{c['unresolved_loops']})", file=sys.stderr, flush=True)
        with open(cache, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
    return out


def split_pair(key, dp):
    arch, shape = key.split("|")
    s = INPUT_SHAPES[shape]
    rows = s.global_batch // run_config(arch, shape).microbatches
    return s.mode == "train" and rows % dp != 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("records")
    ap.add_argument("--pairs", default="all", choices=("all", "split"))
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--dp", type=int, default=16,
                    help="the mesh's pod x data (split pairs)")
    ap.add_argument("--cache", default="build/results/reference_flops.json",
                    help="the reference's counts, kept between runs")
    args = ap.parse_args()
    records = json.loads(open(args.records).read())
    keys = [k for k, r in sorted(records.items()) if r.get("ok")
            and "flops" in r and (args.pairs == "all"
                                  or split_pair(k, args.dp))]
    ref = reference_flops(keys, args.cache)
    hw = dataclasses.replace(H100_SXM, chips=args.chips)
    print("| pair | flops_global port / reference | peak GiB a rank | fits "
          "80 GiB | collective bytes a rank (AG / AR / RS / A2A) | "
          "t_compute s | t_memory s | t_collective s | dominant |")
    print("|---|---|---|---|---|---|---|---|---|")
    for key in keys:
        r = records[key]
        t = roofline_terms(r, hw)
        dom = max(("t_compute", "t_memory", "t_collective"), key=t.get)
        coll = " / ".join(f"{r['collective_bytes'].get(k, 0):.3g}"
                          for k in KINDS)
        print(f"| {key.replace('|', ' ')} | "
              f"{r['flops_global'] / ref[key]:.4f} | "
              f"{r['peak_bytes'] / 2**30:.2f} | "
              f"{'yes' if r['fits'] else 'no'} | {coll} | "
              f"{t['t_compute']:.3g} | {t['t_memory']:.3g} | "
              f"{t['t_collective']:.3g} | {dom[2:]} |")


if __name__ == "__main__":
    main()
