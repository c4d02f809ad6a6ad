"""Merge the one-device FLOP and byte counts into the dry run's records.

Port of ``repro.launch.recost``.  For each ``ok`` record of
``build/results/dryrun_<mesh>.json`` that lacks them (every one with
``--force``), runs the pair's step on one device on the meta device
(``launch.dryrun.build_step``, no mesh) and records ``flops_global``,
``dot_bytes_global`` and ``unresolved_loops`` (``roofline.cost``).  No
process group is needed.

  python -m repro_torch.launch.recost [--mesh single|multi] [--force]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch.dryrun import WORLD, build_step, pair_config
from repro_torch.roofline.analysis import RESULTS_DIR
from repro_torch.roofline.cost import count


def recost(path, *, force=False) -> dict:
    """Recount the records at ``path`` in place; returns them."""
    path = pathlib.Path(path)
    results = json.loads(path.read_text())
    for key, entry in results.items():
        if not entry.get("ok") or ("flops_global" in entry and not force):
            continue
        arch, shape = key.split("|")
        t0 = time.time()
        cfg, tc = pair_config(arch, shape)
        fn, args = build_step(cfg, tc, INPUT_SHAPES[shape])
        _, c = count(fn, *args, track_memory=False)
        del fn, args
        entry["flops_global"] = c["flops"]
        entry["dot_bytes_global"] = c["dot_bytes"]
        entry["unresolved_loops"] = c["unresolved_loops"]
        print(f"{key:45s} flops={c['flops']:.3e} "
              f"dot_bytes={c['dot_bytes']:.3e} "
              f"unresolved={c['unresolved_loops']} "
              f"({time.time() - t0:.1f}s)", flush=True)
        path.write_text(json.dumps(results, indent=1, sort_keys=True))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="single", choices=sorted(WORLD))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None,
                    help="records file (default build/results/"
                         "dryrun_<mesh>.json)")
    args = ap.parse_args(argv)
    recost(args.out or RESULTS_DIR / f"dryrun_{args.mesh}.json",
           force=args.force)


if __name__ == "__main__":
    main()
