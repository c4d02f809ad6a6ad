"""The paper's §3.3.2 performance model, made quantitative (port of
``repro.core.perf_model``; ``dataclasses`` and ``math`` only).

Paper: per epoch, compute = (m/p)·n²·l FLOP-ish units, communication =
n²·l words, with log(p)-depth allreduce.  Generalised here:

    T(p) = T_compute(p) + T_comm(p)
    T_compute(p) = (m/p) · F_sample / F_rate
    T_comm(p)    = n_sync · ( alpha·ceil(log2 p) + 2·(p-1)/p · V / BW )

where V = parameter bytes (weight averaging) or gradient bytes
(per-step averaging), n_sync = syncs per epoch, alpha = per-message
latency, BW = per-link bandwidth (ring-allreduce volume term).  The
arithmetic is the reference's, term for term, so the two packages give
the same numbers for the same arguments.

Presets.  ``INFINIBAND_FDR``, ``TPU_V5E_ICI``, ``TPU_DCN``,
``PCIE_D2H``, ``CKPT_DISK``, ``TPU_V5E_HBM_BW`` and ``TPU_V5E_FLOPS``
are the reference's constants under the reference's names: the paper's
cluster, a TPU v5e pod and its host.  They are kept so the two packages
agree on the defaults; none of them describes the H100 this port runs
on.  The ``H100_*`` presets below do, each with its source.
The config-reading functions (``kv_bytes_per_token``,
``moe_expert_bytes``, ``mesh_decode_bytes_per_device``) take the port's
configs (``repro_torch.configs``).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Fabric:
    name: str
    bw_bytes: float          # per-link bandwidth, B/s
    alpha: float             # per-collective latency, s


# ---- the reference's presets (not this card's) ----------------------------
# The paper's cluster: Haswell + FDR InfiniBand (~6.8 GB/s, ~1.5 us MPI lat)
INFINIBAND_FDR = Fabric("infiniband-fdr", 6.8e9, 1.5e-6)
# TPU v5e: ~50 GB/s/link ICI, ~1 us
TPU_V5E_ICI = Fabric("tpu-v5e-ici", 50e9, 1.0e-6)
# cross-pod DCN (multi-pod axis)
TPU_DCN = Fabric("tpu-dcn", 6.25e9, 10e-6)

# TPU v5e per-chip: HBM bandwidth and bf16 peak (serving roofline)
TPU_V5E_HBM_BW = 819e9
TPU_V5E_FLOPS = 197e12

# ---- NVIDIA H100 SXM presets -----------------------------------------------
# NVLink 4: 900 GB/s per GPU both ways, 450 GB/s a direction (NVIDIA H100
# SXM datasheet).  The per-collective latency is an ASSUMPTION (a typical
# small-message NCCL all-reduce inside one node); nothing has measured it
# on this machine, which holds one card.
H100_NVLINK4 = Fabric("h100-nvlink4", 450e9, 10e-6)
# HBM3: 3.35 TB/s; dense bf16 tensor-core peak: 989 TFLOP/s (NVIDIA H100
# SXM datasheet; the bounds of chip_smoke.py use the same two numbers)
H100_HBM_BW = 3.35e12
H100_BF16_FLOPS = 989e12
# the card's host link: PCIe Gen5 x16, 128 GB/s both ways, 64 GB/s a
# direction (NVIDIA H100 SXM datasheet); the latency is an ASSUMPTION
H100_PCIE5_D2H = Fabric("h100-pcie-gen5-x16", 64e9, 5e-6)
# across nodes: one ConnectX-7 InfiniBand NDR port a card, 400 Gb/s = 50
# GB/s a direction (NVIDIA DGX H100 datasheet: 8 ports for 8 cards); the
# latency is an ASSUMPTION
H100_NDR_IB = Fabric("h100-ndr-infiniband", 50e9, 10e-6)


def dnn_flops_per_sample(layer_sizes) -> float:
    """fwd+bwd multiply-accumulate FLOPs for an MLP (paper's n²·l term)."""
    fwd = sum(2.0 * a * b for a, b in zip(layer_sizes[:-1], layer_sizes[1:]))
    return 3.0 * fwd                       # bwd ≈ 2x fwd


def dnn_comm_bytes(layer_sizes, dtype_bytes=4) -> float:
    n = sum(a * b + b for a, b in zip(layer_sizes[:-1], layer_sizes[1:]))
    return dtype_bytes * n


def epoch_time(p, *, samples, flops_per_sample, flops_rate, comm_bytes,
               fabric: Fabric, syncs_per_epoch=1.0):
    """Paper model: strong-scaling epoch time at p workers."""
    t_comp = (samples / p) * flops_per_sample / flops_rate
    t_comm = 0.0
    if p > 1:
        t_comm = syncs_per_epoch * (
            fabric.alpha * math.ceil(math.log2(p))
            + 2.0 * (p - 1) / p * comm_bytes / fabric.bw_bytes)
    return t_comp, t_comm


def speedup_curve(ps, **kw):
    t1_comp, t1_comm = epoch_time(1, **kw)
    t1 = t1_comp + t1_comm
    out = {}
    for p in ps:
        tc, tm = epoch_time(p, **kw)
        out[p] = {"t_compute": tc, "t_comm": tm, "speedup": t1 / (tc + tm),
                  "efficiency": t1 / (tc + tm) / p}
    return out


def allreduce_comm_time(v_bytes, *, p, fabric: Fabric = TPU_V5E_ICI):
    """Ring-allreduce step wire time: 2·(p-1)/p·V behind one log(p)
    latency tree -- the per-step cost of the replicated strategies.
    Zero at p <= 1: one rank moves nothing over a wire."""
    if p <= 1:
        return 0.0
    return (fabric.alpha * math.ceil(math.log2(p))
            + 2.0 * (p - 1) / p * v_bytes / fabric.bw_bytes)


def hierarchical_comm_time(v_bytes, *, n_intra, n_pods,
                           intra: Fabric = TPU_V5E_ICI,
                           inter: Fabric = TPU_DCN):
    """Two-stage reduce (``core.collectives.allreduce_hierarchical``):
    reduce-scatter + all-gather inside the pod (2·(n-1)/n·V on the fast
    link) plus an all-reduce of V/n across pods."""
    t_intra = 2.0 * (n_intra - 1) / n_intra * v_bytes / intra.bw_bytes
    t_inter = 0.0
    if n_pods > 1:
        t_inter = (2.0 * (n_pods - 1) / n_pods * (v_bytes / n_intra)
                   / inter.bw_bytes + inter.alpha * math.ceil(
                       math.log2(n_pods)))
    return t_intra + t_inter


def flat_multipod_comm_time(v_bytes, *, n_intra, n_pods,
                            inter: Fabric = TPU_DCN):
    """A flat allreduce over pod x data has the slowest link as the ring
    bottleneck: the full V crosses the pod link."""
    n = n_intra * n_pods
    return 2.0 * (n - 1) / n * v_bytes / inter.bw_bytes


# --------------------------------------------------------------------------
# zero1 / zero2 / zero3 (sharded state)
# --------------------------------------------------------------------------

def zero1_comm_time(v_bytes, *, p, fabric: Fabric = TPU_V5E_ICI):
    """zero1 step wire time: reduce-scatter of grads ((p-1)/p·V) plus
    all-gather of updated params ((p-1)/p·V) -- the 2·(p-1)/p·V a ring
    allreduce moves, behind two latency trees."""
    if p <= 1:
        return 0.0
    return (2.0 * (p - 1) / p * v_bytes / fabric.bw_bytes
            + 2.0 * fabric.alpha * math.ceil(math.log2(p)))


def zero1_hier_comm_time(v_bytes, *, n_intra, n_pods, microbatches=1,
                         intra: Fabric = TPU_V5E_ICI,
                         inter: Fabric = TPU_DCN):
    """zero1_hier step wire time: zero1's volume, staged -- reduce-scatter
    + all-gather of V inside the pod (2·(n_intra-1)/n_intra·V), and only
    the 1/n_intra shard across pods (2·(n_pods-1)/n_pods·V/n_intra).
    ``microbatches`` is accepted for signature parity (one reduce-scatter
    a step)."""
    del microbatches
    if n_intra * n_pods <= 1:
        return 0.0
    t = 0.0
    if n_intra > 1:
        t += (2.0 * (n_intra - 1) / n_intra * v_bytes / intra.bw_bytes
              + 2.0 * intra.alpha * math.ceil(math.log2(n_intra)))
    if n_pods > 1:
        t += (2.0 * (n_pods - 1) / n_pods * (v_bytes / n_intra)
              / inter.bw_bytes
              + 2.0 * inter.alpha * math.ceil(math.log2(n_pods)))
    return t


def zero1_flat_multipod_comm_time(v_bytes, *, n_intra, n_pods,
                                  inter: Fabric = TPU_DCN):
    """The baseline zero1_hier beats: one zero1 ring over pod x data,
    bottlenecked by its slowest link, which carries the full volume."""
    n = n_intra * n_pods
    if n <= 1:
        return 0.0
    return (2.0 * (n - 1) / n * v_bytes / inter.bw_bytes
            + 2.0 * inter.alpha * math.ceil(math.log2(n)))


def zero2_comm_time(v_bytes, *, p, microbatches=1,
                    fabric: Fabric = TPU_V5E_ICI):
    """zero2 step wire time: one reduce-scatter a MICROBATCH plus the
    param all-gather -- (m+1)·(p-1)/p·V against zero1's 2·(p-1)/p·V."""
    if p <= 1:
        return 0.0
    return ((microbatches + 1.0) * (p - 1) / p * v_bytes / fabric.bw_bytes
            + (microbatches + 1.0) * fabric.alpha * math.ceil(math.log2(p)))


def zero3_comm_time(v_bytes, *, p, microbatches=1,
                    fabric: Fabric = TPU_V5E_ICI):
    """zero3 step wire time: per microbatch the params are gathered for
    the forward, re-gathered for the backward (remat) and the gradient
    reduce-scattered -- 3·m·(p-1)/p·V; no all-gather after the update."""
    if p <= 1:
        return 0.0
    return (3.0 * microbatches * (p - 1) / p * v_bytes / fabric.bw_bytes
            + 3.0 * microbatches * fabric.alpha * math.ceil(math.log2(p)))


def zero3_hier_comm_time(v_bytes, *, n_intra, n_pods, microbatches=1,
                         intra: Fabric = TPU_V5E_ICI,
                         inter: Fabric = TPU_DCN):
    """zero3_hier step wire time: zero3's 3·m passes, each staged over
    the two-level mesh -- the pod's fast link carries
    (n_intra-1)/n_intra·V a pass, the pod link only the 1/n_intra
    piece."""
    if n_intra * n_pods <= 1:
        return 0.0
    passes = 3.0 * microbatches
    t = 0.0
    if n_intra > 1:
        t += passes * ((n_intra - 1) / n_intra * v_bytes / intra.bw_bytes
                       + intra.alpha * math.ceil(math.log2(n_intra)))
    if n_pods > 1:
        t += passes * ((n_pods - 1) / n_pods * (v_bytes / n_intra)
                       / inter.bw_bytes
                       + inter.alpha * math.ceil(math.log2(n_pods)))
    return t


# --------------------------------------------------------------------------
# checkpointing: step-path overhead and publish lag
# --------------------------------------------------------------------------

#: the reference's device->host link: one PCIe Gen3 x16 link
PCIE_D2H = Fabric("pcie-gen3-x16", 12.0e9, 5e-6)
#: the reference's checkpoint volume: sustained sequential writes of one
#: NVMe-class disk (an assumption of the reference, not a measurement)
CKPT_DISK = Fabric("ckpt-disk", 2.0e9, 100e-6)


def ckpt_overhead(state_bytes, *, step_time_s, every=1,
                  d2h: Fabric = PCIE_D2H, disk: Fabric = CKPT_DISK) -> dict:
    """Sync vs async checkpoint cost for ``state_bytes`` of per-host
    state saved every ``every`` steps.  A synchronous save blocks the
    step path for copy + write (``sync_s``); the async checkpointer
    blocks only for the device->host copy (``async_s``) and publishes
    in the background, trailing the run by ``publish_lag_s`` = write
    time (``publish_lag_steps`` in steps).  ``*_overhead`` are the
    fractional step-time taxes, amortised over ``every``."""
    copy_s = d2h.alpha + state_bytes / d2h.bw_bytes
    write_s = disk.alpha + state_bytes / disk.bw_bytes
    return {
        "sync_s": copy_s + write_s,
        "async_s": copy_s,
        "publish_lag_s": write_s,
        "publish_lag_steps": write_s / step_time_s,
        "sync_overhead": (copy_s + write_s) / (every * step_time_s),
        "async_overhead": copy_s / (every * step_time_s),
    }


# --------------------------------------------------------------------------
# serving (decode) roofline
# --------------------------------------------------------------------------

def kv_bytes_per_token(cfg, dtype_bytes=2) -> float:
    """Per-token KV-cache bytes across the stack: K+V per attention
    layer (MLA: the compressed latent + rope key); O(1) recurrent state
    is left out (it does not grow with context)."""
    per = 0.0
    for (mixer, _ffn) in cfg.layer_pattern():
        if mixer != "attn":
            continue
        if cfg.attention == "mla":
            per += cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        else:
            per += 2.0 * cfg.num_kv_heads * cfg.head_dim
    return dtype_bytes * per


def decode_step_time(param_bytes, kv_bytes_per_seq, *, batch,
                     flops_per_token=0.0, hbm_bw=TPU_V5E_HBM_BW,
                     flops_rate=TPU_V5E_FLOPS, kernel_time_s=0.0):
    """One fused decode step: streams every live parameter byte once
    (shared across the batch) plus each slot's KV; compute is
    2·N_active FLOPs a token; the step costs max(memory, compute) and
    no less than ``kernel_time_s``, a measured floor (dispatch and
    launch overhead the roofline cannot see)."""
    t_mem = (param_bytes + batch * kv_bytes_per_seq) / hbm_bw
    t_comp = batch * flops_per_token / flops_rate
    return max(t_mem, t_comp, kernel_time_s)


def calibrate_kernel_time(bench_rows, *, arch, phase="ar_step",
                          batch=None, per_token=True):
    """Measured kernel-time floor from decode-microbenchmark rows: the
    fastest matching ``phase`` row for ``arch``; ``per_token`` divides a
    fused chunk's time down to one decode step; ``batch`` also matches
    the lane count."""
    times = [r["time_s"] / (r.get("tokens", 1) if per_token else 1)
             for r in bench_rows
             if r.get("arch") == arch and r.get("phase") == phase
             and (batch is None or r.get("batch") == batch)]
    if not times:
        raise ValueError(f"no {phase!r} rows for arch={arch!r}")
    return min(times)


def spec_expected_tokens(acceptance, k) -> float:
    """Expected tokens emitted a verify step of k-token speculative
    decode, ``1 + a + a² + ... + a^(k-1)`` at per-draft acceptance
    ``a`` (clamped to [0, 1])."""
    a = min(max(float(acceptance), 0.0), 1.0)
    k = int(k)
    if k <= 1:
        return 1.0
    return float(sum(a ** i for i in range(k)))


def decode_tokens_per_s(param_bytes, kv_bytes_per_seq, *, batch,
                        flops_per_token=0.0, hbm_bw=TPU_V5E_HBM_BW,
                        flops_rate=TPU_V5E_FLOPS,
                        host_sync_s=0.0, tokens_per_sync=1,
                        kernel_time_s=0.0, acceptance=0.0, spec_k=0):
    """Serving-roofline decode throughput of the whole batch:
    ``host_sync_s`` / ``tokens_per_sync`` model the blocking host
    round trip a chunk of decode steps pays; ``spec_k`` / ``acceptance``
    scale the step's compute by k (the streamed bytes stay) and its
    emitted tokens by ``spec_expected_tokens``."""
    per_step = decode_step_time(
        param_bytes, kv_bytes_per_seq, batch=batch,
        flops_per_token=flops_per_token * (spec_k if spec_k else 1),
        hbm_bw=hbm_bw, flops_rate=flops_rate,
        kernel_time_s=kernel_time_s)
    per_step = per_step + host_sync_s / max(1, tokens_per_sync)
    e = spec_expected_tokens(acceptance, spec_k) if spec_k else 1.0
    return batch * e / per_step


def prefill_time(n_tokens, *, flops_per_token, param_bytes=0.0,
                 flops_rate=TPU_V5E_FLOPS, hbm_bw=TPU_V5E_HBM_BW):
    """One request's prefill: max(compute at 2·N FLOPs a prompt token,
    one pass over the params)."""
    return max(n_tokens * flops_per_token / flops_rate,
               param_bytes / hbm_bw)


def ttft_model(prompt_tokens, *, flops_per_token, prefix_hit_rate=0.0,
               queue_s=0.0, param_bytes=0.0,
               flops_rate=TPU_V5E_FLOPS, hbm_bw=TPU_V5E_HBM_BW):
    """Time to first token = queueing + prefill of the prompt tokens the
    prefix cache MISSED, floored at one token (the last prompt position
    is always recomputed)."""
    miss = max(1.0, (1.0 - prefix_hit_rate) * prompt_tokens)
    return queue_s + prefill_time(miss, flops_per_token=flops_per_token,
                                  param_bytes=param_bytes,
                                  flops_rate=flops_rate, hbm_bw=hbm_bw)


def paged_pool_bytes(contexts, page_size, kv_tok_bytes) -> float:
    """Resident KV bytes with paged allocation: each live sequence holds
    ceil(ctx/page)·page tokens of pages."""
    return float(sum(
        -(-int(c) // page_size) * page_size * kv_tok_bytes
        for c in contexts))


def moe_expert_bytes(cfg, dtype_bytes=2) -> float:
    """Resident ROUTED-expert weight bytes across the stack (shared
    experts and the router count as dense)."""
    m = getattr(cfg, "moe", None)
    if m is None:
        return 0.0
    n_moe = sum(1 for (_mix, ffn) in cfg.layer_pattern() if ffn == "moe")
    per_layer = m.num_experts * cfg._mlp_mats * cfg.d_model * m.d_expert
    return float(dtype_bytes) * n_moe * per_layer


def mesh_decode_bytes_per_device(cfg, contexts, page_size, *,
                                 model_parallel, expert_parallel=True,
                                 dtype_bytes=2) -> float:
    """HBM bytes ONE device streams a fused decode step on a serve mesh:
    dense weights and the paged pool 1/mp each; the routed experts 1/mp
    only under expert-parallel dispatch."""
    total = float(dtype_bytes) * cfg.param_count()
    experts = moe_expert_bytes(cfg, dtype_bytes)
    dense = total - experts
    pool = paged_pool_bytes(contexts, page_size,
                            kv_bytes_per_token(cfg, dtype_bytes))
    mp = max(1, int(model_parallel))
    return (dense / mp + (experts / mp if expert_parallel else experts)
            + pool / mp)


# --------------------------------------------------------------------------
# the bucket-level overlap scheduler (core.overlap)
# --------------------------------------------------------------------------

def bucket_comm_time(v_bytes, *, p, fabric: Fabric = TPU_V5E_ICI,
                     strategy="flat"):
    """Wire time for ONE bucket of ``v_bytes`` under ``strategy``, as the
    registered strategy models it (``Strategy.bucket_comm_time``)."""
    from repro_torch.core.strategy import get_strategy  # local: no cycle
    return get_strategy(strategy).bucket_comm_time(v_bytes, p=p,
                                                   fabric=fabric)


def serial_step_time(t_compute, v_bytes, *, p, n_buckets=1,
                     fabric: Fabric = TPU_V5E_ICI, strategy="flat"):
    """No overlap: the full backward, then every bucket's collective
    back to back (``DPConfig(overlap=False)`` and ``"serial"``)."""
    if n_buckets < 1:
        raise ValueError("n_buckets must be >= 1")
    per = bucket_comm_time(v_bytes / n_buckets, p=p, fabric=fabric,
                           strategy=strategy)
    return t_compute + n_buckets * per


def overlapped_step_time(t_compute, v_bytes, *, p, n_buckets=1,
                         fabric: Fabric = TPU_V5E_ICI, strategy="flat"):
    """Double-buffered buckets (``core.overlap.run_pipeline``): the
    pipeline fill (one chunk's compute), max(compute, comm) a bucket in
    the steady state, and the drain (the last bucket's collective)."""
    if n_buckets < 1:
        raise ValueError("n_buckets must be >= 1")
    per_comm = bucket_comm_time(v_bytes / n_buckets, p=p, fabric=fabric,
                                strategy=strategy)
    per_comp = t_compute / n_buckets
    return (per_comp                                    # pipeline fill
            + (n_buckets - 1) * max(per_comp, per_comm)  # steady state
            + per_comm)                                  # drain


def overlap_speedup(t_compute, v_bytes, *, p, n_buckets,
                    fabric: Fabric = TPU_V5E_ICI, strategy="flat"):
    """serial / overlapped step time for the same bucketing (>= 1)."""
    kw = dict(p=p, n_buckets=n_buckets, fabric=fabric, strategy=strategy)
    t_o = overlapped_step_time(t_compute, v_bytes, **kw)
    return serial_step_time(t_compute, v_bytes, **kw) / t_o if t_o else 1.0


# --------------------------------------------------------------------------
# memory
# --------------------------------------------------------------------------

def opt_state_bytes_per_device(n_params, state_factor, *, n_workers=1,
                               strategy="replicated"):
    """Per-rank optimizer-state bytes (the state is fp32 whatever the
    masters' dtype; ``repro_torch.optim``): the full state on every rank
    of a replicated strategy, the 1/n_workers shard (padded to equal
    shards) under every sharded one."""
    if strategy != "replicated" and n_workers > 1:
        from repro_torch.core.strategy import get_strategy  # local: no cycle
        if get_strategy(strategy).sharded:
            padded = n_params + (-n_params) % n_workers
            return 4.0 * state_factor * (padded // n_workers)
    return 4.0 * state_factor * n_params


def dp_memory_report(n_params, state_factor, n_workers, *,
                     param_bytes=4, grad_bytes=4):
    """Per-rank training-state memory across the ZeRO ladder, one row
    for every distinct ``memory_key`` of the strategy registry
    (``core.strategy.memory_rows``; the replicated strategies share the
    ``replicated`` row): params / persistent-gradient / optimizer-state
    bytes, their total, and the total's ratio to the replicated row.
    ``param_bytes`` / ``grad_bytes`` are the masters' and the gradients'
    element sizes (2 for bf16 masters and gradients).  Transient buffers
    (a microbatch's gradient, a gathered bucket) are not counted."""
    if n_workers < 1:
        raise ValueError("n_workers must be >= 1")
    from repro_torch.core.strategy import memory_rows  # local: no cycle
    rows = {}
    sharded_keys = []
    for key, entry in memory_rows(n_params, state_factor, n_workers,
                                  param_bytes=param_bytes,
                                  grad_bytes=grad_bytes):
        if key != "replicated":
            sharded_keys.append(key)
        rows[f"params_{key}"] = float(entry["params"])
        rows[f"grads_{key}"] = float(entry["grads"])
        rows[f"opt_state_{key}"] = float(entry["opt_state"])
        rows[f"total_{key}"] = float(entry["params"] + entry["grads"]
                                     + entry["opt_state"])
    total_rep = rows["total_replicated"]
    for key in sharded_keys:
        rows[f"ratio_{key}"] = (rows[f"total_{key}"] / total_rep
                                if total_rep else 1.0)
    rows["opt_state_ratio"] = (rows["opt_state_zero1"]
                               / rows["opt_state_replicated"]
                               if rows["opt_state_replicated"] else 1.0)
    return rows
