"""Roofline analysis of the dry run's records.

Port of ``repro.roofline.analysis``.  Reads the records of
``launch.dryrun`` (``build/results/dryrun_<mesh>.json``) and derives,
per (arch x shape):

    compute term    = FLOPs_per_dev / peak_FLOPs_per_card
    memory term     = dot_bytes_per_dev / HBM_bw_per_card
    collective term = collective_bytes_per_dev / link_bw

the per-device FLOPs and bytes being the one-device counts
(``flops_global`` / ``dot_bytes_global``) over the card count, and the
collective bytes rank 0's; plus MODEL_FLOPS = 6 N D (train; 2 N D
prefill and decode, N the active parameters) and the useful ratio
MODEL_FLOPS_per_dev / FLOPs_per_dev, which shows remat, redundancy and
dispatch waste.

Hardware: ``H100_SXM``, NVIDIA's H100 SXM5 datasheet -- 989 TFLOP/s
dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink a direction, 80 GiB.  The
records carry no overlap report (an eager step has no dataflow graph to
walk), so the collective term is charged whole: the reference's degrade
of a record without one, hidden = 0.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from repro_torch.configs import INPUT_SHAPES, config_for_shape
from repro_torch.core.perf_model import (H100_BF16_FLOPS, H100_HBM_BW,
                                         H100_NVLINK4)

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "results"


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = H100_BF16_FLOPS          # dense bf16 per card
    hbm_bw: float = H100_HBM_BW                  # bytes/s per card
    ici_bw: float = H100_NVLINK4.bw_bytes        # bytes/s a direction
    chips: int = 256
    hbm_bytes: int = 80 * 2 ** 30                # device memory per card


H100_SXM = HW()


def model_flops(arch: str, shape_name: str) -> float:
    """Global model FLOPs per step: 6 N_active tokens (train), 2
    N_active tokens (prefill, decode: one token a sequence)."""
    cfg = config_for_shape(arch, shape_name)
    shape = INPUT_SHAPES[shape_name]
    n_act = cfg.param_count(active_only=True)
    if shape.mode == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch


def roofline_terms(entry: dict, hw: HW = H100_SXM) -> dict:
    """entry: one dry-run record.  FLOPs and bytes are the one-device
    counts (``flops_global`` / ``dot_bytes_global``) over the card
    count, else the per-device ``flops`` / ``bytes_accessed``; the
    collective bytes are rank 0's.  With an ``async_overlap`` report the
    overlappable share of the collective time, capped by the compute
    term, is hidden (the reference's rule); without one nothing is."""
    coll = sum(entry.get("collective_bytes", {}).values())
    flops_dev = entry.get("flops_global", entry.get("flops", 0) * hw.chips) \
        / hw.chips
    bytes_dev = entry.get("dot_bytes_global",
                          entry.get("bytes_accessed", 0) * hw.chips) \
        / hw.chips
    t_compute = flops_dev / hw.peak_flops
    t_coll_raw = coll / hw.ici_bw
    ovl = entry.get("async_overlap", {})
    report_bytes = ovl.get("report_bytes", 0)
    hidden_frac = (ovl.get("overlappable_bytes", 0) / report_bytes
                   if report_bytes else 0.0)
    t_hidden = min(hidden_frac * t_coll_raw, t_compute)
    return {
        "t_compute": t_compute,
        "t_memory": bytes_dev / hw.hbm_bw,
        "t_collective": t_coll_raw - t_hidden,
        "t_collective_raw": t_coll_raw,
        "t_collective_hidden": t_hidden,
    }


def analyse_pair(arch: str, shape_name: str, entry: dict,
                 hw: HW = H100_SXM) -> dict:
    terms = roofline_terms(entry, hw)
    roof = {k: terms[k] for k in ("t_compute", "t_memory", "t_collective")}
    dom = max(roof, key=roof.get)
    mf = model_flops(arch, shape_name) / hw.chips      # per device
    flops_dev = terms["t_compute"] * hw.peak_flops
    ratio = mf / flops_dev if flops_dev else float("nan")
    bound = {"t_compute": "compute", "t_memory": "memory",
             "t_collective": "collective"}[dom]
    step_time = max(roof.values())
    mfu = mf / hw.peak_flops / step_time if step_time else 0.0
    return {
        "arch": arch, "shape": shape_name, **terms,
        "dominant": bound,
        "model_flops_per_dev": mf,
        "useful_ratio": ratio,
        "roofline_mfu": mfu,   # model-flops utilisation at the roofline bound
    }


def suggestion(row: dict) -> str:
    if row["dominant"] == "collective":
        return ("collective-bound: cut volume (hierarchical reduce, bf16 "
                "grads) or overlap collectives with compute")
    if row["dominant"] == "memory":
        return ("memory-bound: raise arithmetic intensity (bigger per-step "
                "tiles/microbatch, fusion, bf16 residency)")
    if row["useful_ratio"] < 0.5:
        return ("compute-bound with low useful ratio: kill redundant FLOPs "
                "(remat policy, head-padding instead of hd-sharding, "
                "dispatch einsum waste)")
    return "compute-bound near roofline: only kernel-level wins remain"


def full_table(results_path=None, hw: HW = H100_SXM):
    """``analyse_pair`` of every counted (``ok``, with ``flops``) record
    of ``results_path`` (default: the single-pod mesh's records)."""
    results_path = results_path or RESULTS_DIR / "dryrun_single.json"
    data = json.loads(pathlib.Path(results_path).read_text())
    rows = []
    for key, entry in sorted(data.items()):
        if not entry.get("ok") or "flops" not in entry:
            continue
        arch, shape = key.split("|")
        rows.append(analyse_pair(arch, shape, entry, hw))
    return rows


def render_markdown(rows) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | useful | roofline-MFU | next lever |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.2e} | "
            f"{r['t_memory']:.2e} | {r['t_collective']:.2e} | "
            f"{r['dominant']} | {r['useful_ratio']:.3f} | "
            f"{r['roofline_mfu']:.3f} | {suggestion(r)} |")
    return "\n".join(out)
