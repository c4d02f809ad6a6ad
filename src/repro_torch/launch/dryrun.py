"""Multi-pod dry run: count every (arch x input shape x mesh) on meta.

Port of ``repro.launch.dryrun``.  For each pair it runs the port's REAL
step (the mesh train step for train_4k, the slab prefill step for
prefill_32k, the decode step for the decode shapes) on the meta device,
where every op computes shapes and nothing else, with its inputs from
``data.specs`` and its state placed by the production rules on the
256-rank single-pod mesh or the 512-rank two-pod mesh.  The world is
PyTorch's fake process group: this process is rank 0, the collectives
return at once, and every rank's blocks are alike (the rules cut only
dims that divide), so rank 0's counts are every rank's.  Per pair
(``roofline.cost``):

  * rank 0's FLOPs, dot bytes and collective bytes by kind on the mesh
    (``flops``, ``bytes_accessed``, ``collective_bytes``);
  * the same step on one device, unsharded (``flops_global``,
    ``dot_bytes_global``, ``unresolved_loops``: the reference's
    pre-SPMD StableHLO walk);
  * rank 0's memory: the argument bytes, the peak of the live storages
    and ``fits`` against the card's memory (``roofline.analysis.H100_SXM``);
  * for train, the DP memory report and each strategy's modeled comm
    time on H100 fabrics.

Records accumulate in ``build/results/dryrun_<mesh>.json`` (``build/``
is gitignored); reruns skip ``ok`` pairs (``--force`` to redo).  The
reference's ``compile_s``, ``generated_code_size_in_bytes``,
``hlo_chars``, ``f32_upcast_bytes_est`` and ``async_overlap`` have no
counterpart: there is no compiled module, no XLA CPU emitter, and no
dataflow graph to walk in an eager step.

Usage (any machine, no card needed):
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCHITECTURES, INPUT_SHAPES,
                                 LONG_500K_SKIPS, config_for_shape)
from repro_torch.data.specs import batch_struct
from repro_torch.roofline.analysis import H100_SXM, RESULTS_DIR, fits
from repro_torch.roofline.cost import count
from repro_torch.train.step import TrainConfig

WORLD = {"single": 256, "multi": 512}

# --------------------------------------------------------------------------
# per-pair run configuration (the reference's, memory-driven)
# --------------------------------------------------------------------------

BASELINE = bool(os.environ.get("REPRO_BASELINE"))

# the reference's optimized settings; REPRO_BASELINE=1 restores its
# pre-optimization configuration
OPTIMIZED_CFG = {} if BASELINE else {
    "deepseek-coder-33b": {"pad_heads_to": 64},   # 56 -> 64 exact padding
    "qwen2.5-32b": {"pad_heads_to": 48},          # 40 -> 48
    "deepseek-v3-671b": {"moe.capacity_factor": 1.0},
}
OPTIMIZED_RUN = {} if BASELINE else {
    "jamba-v0.1-52b": {"microbatches": 8},        # halves the FSDP gathers
}


def run_config(arch: str, shape_name: str) -> TrainConfig:
    big = arch in ("deepseek-coder-33b", "qwen2.5-32b", "granite-20b",
                   "jamba-v0.1-52b")
    if arch == "deepseek-v3-671b":
        # bf16 end to end with SGD: the reference's only fit of 671 B
        tc = TrainConfig(optimizer="sgd", lr=1e-3, microbatches=16,
                         grad_dtype="bfloat16", param_dtype="bfloat16")
    elif big:
        tc = TrainConfig(optimizer="adamw", microbatches=16,
                         param_dtype="float32")
    else:
        tc = TrainConfig(optimizer="adamw", microbatches=4,
                         param_dtype="float32")
    over = OPTIMIZED_RUN.get(arch)
    return dataclasses.replace(tc, **over) if over else tc


def _apply_cfg_overrides(arch: str, cfg):
    over = OPTIMIZED_CFG.get(arch)
    if not over:
        return cfg
    plain = {k: v for k, v in over.items() if not k.startswith("moe.")}
    moekw = {k[4:]: v for k, v in over.items() if k.startswith("moe.")}
    if plain:
        cfg = cfg.with_overrides(**plain)
    if moekw and cfg.moe is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moekw))
    return cfg


def pair_config(arch: str, shape_name: str):
    """(the model config, the TrainConfig) the dry run counts a pair at."""
    return (_apply_cfg_overrides(arch, config_for_shape(arch, shape_name)),
            run_config(arch, shape_name))


# --------------------------------------------------------------------------
# the fake world
# --------------------------------------------------------------------------

def fake_world(world: int) -> None:
    """Make this process rank 0 of PyTorch's fake process group of
    ``world`` ranks (re-made when another group is up)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(mesh_name: str):
    """The production mesh of ``mesh_name`` ("single": (16, 16), "multi":
    (2, 16, 16)) over a fake world of its size."""
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(WORLD[mesh_name])
    return make_production_mesh(multi_pod=mesh_name == "multi",
                                device_type="cpu")


# --------------------------------------------------------------------------
# the steps, placed
# --------------------------------------------------------------------------

def _rows(t, comm, split):
    """This replica's rows of a batch-major tensor (all when the batch
    does not split over pod x data)."""
    from repro_torch.sharding.comm import own_block
    if split:
        for a in comm.dp_axes:
            t = own_block(t, comm, a, 0)
    return t


def build_step(cfg, tc, shape, mesh=None):
    """(fn, args) of the pair's real step on the meta device: the train
    step of a state placed on ``mesh`` (``init_train_state(mesh=,
    device="meta")``) and the global batch; or the slab prefill / decode
    step of the serve-placed model with this rank's rows and its blocks
    of the slab (``rules.cache_spec``), under the serve topology.
    ``mesh`` None: the same step on one device, unsharded.  A decode
    step appends at ``seq_len - 1``, so it reads the whole context."""
    from repro_torch.bridge import mesh_placer
    from repro_torch.models import batch_inputs, init_model
    from repro_torch.models.model import compute_dtype, init_cache
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.sharding import ctx as shctx
    from repro_torch.train import init_train_state, make_train_step
    mode = shape.mode
    if mode == "train":
        state = init_train_state(cfg, tc, mesh=mesh, device="meta")
        step, _ = make_train_step(cfg, tc, mesh=mesh)
        return step, (state, batch_struct(cfg, shape))
    place = None if mesh is None else mesh_placer(cfg, mesh, mode="serve")
    model = init_model(cfg, device="meta", place=place)
    B, S = shape.global_batch, shape.seq_len
    topo = comm = None
    split = False
    if mesh is None:
        cache = init_cache(cfg, compute_dtype(cfg), batch=B, max_len=S,
                           cross_len=S, device="meta")
    else:
        from repro_torch.sharding.comm import MeshComm
        from repro_torch.sharding.rules import (ShardingConfig, batch_spec,
                                                cache_spec)
        comm, topo = MeshComm(mesh), shctx.ServeTopology.from_mesh(mesh)
        split = batch_spec(mesh, B) != (None,)
        sh = ShardingConfig.for_mode("serve")
        shapes = init_cache(cfg, compute_dtype(cfg), batch=B, max_len=S,
                            cross_len=S, device="meta")
        cache = shctx.place_cache(shapes, lambda i, name, shp: cache_spec(
            cfg, comm.sizes, f"layers/{i}/{name}", shp, B, sh), comm,
            "meta")
    rows = (lambda t: t) if comm is None else (    # noqa: E731
        lambda t: _rows(t, comm, split))
    if mode == "prefill":
        prefill = make_prefill_step(cfg)
        tokens, fronts = batch_inputs(batch_struct(cfg, shape))
        fronts = {k: rows(v) for k, v in fronts.items()}

        def fn(model, tokens, cache, fronts):
            with shctx.serving(topo, split):
                return prefill(model, tokens, cache, **fronts)
        return fn, (model, rows(tokens), cache, fronts)
    decode = make_decode_step(cfg)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")

    def fn(model, tokens, cache):
        with shctx.serving(topo, split):
            return decode(model, tokens, cache, S - 1)
    return fn, (model, rows(tokens), cache)


# --------------------------------------------------------------------------
# the counts
# --------------------------------------------------------------------------

def _dp_entries(cfg, tc, mesh) -> dict:
    """The train record's DP memory report and each registered
    strategy's modeled comm time for the fp32 gradients, on NVLink 4
    within a pod and InfiniBand NDR across pods."""
    from repro_torch import optim as optim_lib
    from repro_torch.core import (available_strategies, dp_world_size,
                                  get_strategy, perf_model)
    n_dp = dp_world_size(mesh)
    opt = optim_lib.get_optimizer(tc.optimizer, tc.lr)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {
        "dp_memory": {k: round(v, 4) for k, v in perf_model.dp_memory_report(
            cfg.param_count(), opt.state_factor, n_dp).items()},
        "dp_comm_model_s": {
            name: round(get_strategy(name).comm_time(
                4.0 * cfg.param_count(), p=n_dp,
                n_intra=int(sizes.get("data", n_dp)),
                n_pods=int(sizes.get("pod", 1)),
                microbatches=tc.microbatches,
                fabric=perf_model.H100_NVLINK4,
                inter=perf_model.H100_NDR_IB), 4)
            for name in available_strategies()}}


def analyse(cfg, tc, shape, mesh, hw=H100_SXM) -> dict:
    """The record's counts: rank 0's step on ``mesh`` and the same step
    on one device (module docstring)."""
    t0 = time.time()
    fn, args = build_step(cfg, tc, shape, mesh)
    _, c = count(fn, *args)
    del fn, args
    fn, args = build_step(cfg, tc, shape)
    _, g = count(fn, *args, track_memory=False)
    args_held = c["argument_bytes_held"]
    return {
        "count_s": round(time.time() - t0, 1),
        "flops": c["flops"],
        "bytes_accessed": c["dot_bytes"],
        "flops_global": g["flops"],
        "dot_bytes_global": g["dot_bytes"],
        "unresolved_loops": g["unresolved_loops"],
        "collective_bytes": c["collective_bytes"],
        "argument_size_in_bytes": c["argument_bytes"],
        "output_size_in_bytes": c["output_bytes"],
        "temp_size_in_bytes": c["peak_bytes"] - args_held,
        "peak_bytes": c["peak_bytes"],
        "fits": fits(c["peak_bytes"], hw),
    }


def count_pair(arch: str, shape_name: str, mesh, *,
               lower_only=False) -> dict:
    """One pair's record on ``mesh``: the reference's keys where they
    carry over (module docstring).  ``lower_only`` places the state and
    the inputs and runs no step."""
    shape = INPUT_SHAPES[shape_name]
    cfg, tc = pair_config(arch, shape_name)
    t0 = time.time()
    entry = {"ok": True,
             "params": cfg.param_count(),
             "params_active": cfg.param_count(active_only=True),
             "run_config": {"optimizer": tc.optimizer,
                            "microbatches": tc.microbatches,
                            "param_dtype": tc.param_dtype}}
    if shape.mode == "train":
        entry.update(_dp_entries(cfg, tc, mesh))
    if lower_only:
        _, args = build_step(cfg, tc, shape, mesh)
        entry["place_s"] = round(time.time() - t0, 1)
        return entry
    entry.update(analyse(cfg, tc, shape, mesh))
    return entry


def pairs_for(arch=None, shape=None):
    archs = [arch] if arch else list(ARCHITECTURES)
    shapes = [shape] if shape else list(INPUT_SHAPES)
    return [(a, s) for a in archs for s in shapes
            if not (s == "long_500k" and a in LONG_500K_SKIPS)]


def run(pairs, mesh_name, out_path, *, force=False, lower_only=False):
    """Count ``pairs`` on the ``mesh_name`` production mesh, writing
    each record into the JSON at ``out_path`` as it lands (kept records
    are read first; an ``ok`` one is skipped unless ``force``).  A pair
    that raises gets ``{"ok": False, "error", "trace"}``.  Returns the
    records."""
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = (json.loads(out_path.read_text()) if out_path.exists()
               else {})
    mesh = make_mesh(mesh_name)
    for arch, shape in pairs:
        key = f"{arch}|{shape}"
        if results.get(key, {}).get("ok") and not force:
            print(f"[skip] {key}")
            continue
        print(f"[dryrun:{mesh_name}] {key} ...", flush=True)
        try:
            entry = count_pair(arch, shape, mesh, lower_only=lower_only)
        except Exception as e:  # noqa: BLE001 -- record failures, go on
            entry = {"ok": False, "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-2000:]}
            print(entry["error"])
        results[key] = entry
        out_path.write_text(json.dumps(results, indent=1, sort_keys=True))
        shown = {k: v for k, v in entry.items() if k != "trace"}
        print(f"[done] {key}: {json.dumps(shown)[:400]}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES))
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=sorted(WORLD))
    ap.add_argument("--all", action="store_true",
                    help="every pair (the default when neither --arch "
                         "nor --shape is given)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--lower-only", action="store_true",
                    help="place the state and inputs, run no step")
    ap.add_argument("--out", default=None,
                    help="records file (default build/results/"
                         "dryrun_<mesh>.json)")
    args = ap.parse_args(argv)
    out = args.out or RESULTS_DIR / f"dryrun_{args.mesh}.json"
    pairs = pairs_for(None if args.all else args.arch,
                      None if args.all else args.shape)
    try:
        run(pairs, args.mesh, out, force=args.force,
            lower_only=args.lower_only)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
