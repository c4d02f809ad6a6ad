"""The port's cost model (``repro_torch.core.perf_model``) and the
strategies' perf-model entries against the reference's, on the CPU.

* Parity: every function of the two modules at the same arguments,
  every registered strategy's ``comm_time`` / ``bucket_comm_time`` /
  ``memory_entry`` against the reference strategy of the same name, and
  the config readers over all ten architectures (the port's config
  against the reference's) -- relative 1e-12: the arithmetic is the
  same, term for term.
* Twins of the reference's perf-model tests (``test_properties``,
  ``test_overlap``, ``test_elastic``, ``test_strategy``,
  ``test_paged_decode``, ``test_spec_decode``, ``test_zero1``,
  ``test_zero23``); the hypothesis-driven one runs over fixed cases.
* ``Trainer.describe()["comm_time_s"]`` on four gloo ranks of a (pod,
  data) mesh, equal to the reference strategy's model of that mesh.
"""
import math

import pytest

from torch_ranks import run_ranks

from repro.configs import get_config as jax_config
from repro.core import perf_model as ref_pm
from repro.core.strategy import get_strategy as ref_strategy
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.core import perf_model as pm
from repro_torch.core.strategy import (available_strategies, get_strategy,
                                       memory_rows)

RTOL = 1e-12
FABRICS = ("INFINIBAND_FDR", "TPU_V5E_ICI", "TPU_DCN", "PCIE_D2H",
           "CKPT_DISK")
NET = (784, 200, 100, 10)          # MNIST-DNN, the paper's Table 1
ROWS = [
    {"arch": "a", "phase": "ar_step", "batch": 4, "tokens": 8,
     "time_s": 0.08, "flags": "baseline"},
    {"arch": "a", "phase": "ar_step", "batch": 4, "tokens": 8,
     "time_s": 0.064, "flags": "tuned"},
    {"arch": "a", "phase": "prefill", "batch": 4, "tokens": 1,
     "time_s": 0.002, "flags": "baseline"},
    {"arch": "b", "phase": "ar_step", "batch": 2, "tokens": 8,
     "time_s": 0.4, "flags": "baseline"},
]


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
        return
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0), (a, b)


def _fab(mod, name):
    return getattr(mod, name)


# (function name, kwargs builder(module) -> (args, kwargs)); fabrics are
# named so each side gets its own module's preset
def _epoch_kw(mod, fabric="INFINIBAND_FDR"):
    return dict(samples=60000,
                flops_per_sample=mod.dnn_flops_per_sample(NET),
                flops_rate=1e10, comm_bytes=mod.dnn_comm_bytes(NET),
                fabric=_fab(mod, fabric), syncs_per_epoch=3.0)


FUNCTION_CASES = [
    ("dnn_flops_per_sample", lambda m: ((NET,), {})),
    ("dnn_comm_bytes", lambda m: ((NET,), {"dtype_bytes": 2})),
    ("epoch_time", lambda m: ((1,), _epoch_kw(m))),
    ("epoch_time", lambda m: ((24,), _epoch_kw(m, "TPU_V5E_ICI"))),
    ("speedup_curve", lambda m: (((1, 2, 8, 64),), _epoch_kw(m))),
    ("allreduce_comm_time", lambda m: ((4e9,), {"p": 1})),
    ("allreduce_comm_time", lambda m: ((4e9,), {"p": 6})),
    ("allreduce_comm_time", lambda m: ((3.3e8,), dict(
        p=8, fabric=_fab(m, "INFINIBAND_FDR")))),
    ("hierarchical_comm_time", lambda m: ((2e8,), dict(n_intra=16,
                                                      n_pods=2))),
    ("hierarchical_comm_time", lambda m: ((2e8,), dict(
        n_intra=4, n_pods=1, intra=_fab(m, "TPU_DCN")))),
    ("flat_multipod_comm_time", lambda m: ((2e8,), dict(n_intra=16,
                                                       n_pods=3))),
    ("zero1_comm_time", lambda m: ((4e9,), {"p": 1})),
    ("zero1_comm_time", lambda m: ((4e9,), {"p": 12})),
    ("zero1_hier_comm_time", lambda m: ((4e9,), dict(n_intra=16,
                                                    n_pods=2))),
    ("zero1_hier_comm_time", lambda m: ((4e9,), dict(
        n_intra=1, n_pods=4, microbatches=3))),
    ("zero1_hier_comm_time", lambda m: ((4e9,), dict(n_intra=1,
                                                    n_pods=1))),
    ("zero1_flat_multipod_comm_time", lambda m: ((4e9,), dict(
        n_intra=8, n_pods=4))),
    ("zero1_flat_multipod_comm_time", lambda m: ((4e9,), dict(
        n_intra=1, n_pods=1))),
    ("zero2_comm_time", lambda m: ((4e9,), dict(p=8, microbatches=4))),
    ("zero2_comm_time", lambda m: ((4e9,), dict(p=1))),
    ("zero3_comm_time", lambda m: ((4e9,), dict(p=5, microbatches=2))),
    ("zero3_hier_comm_time", lambda m: ((1.32e11,), dict(
        n_intra=16, n_pods=4, microbatches=2))),
    ("zero3_hier_comm_time", lambda m: ((1.32e11,), dict(
        n_intra=16, n_pods=4, intra=_fab(m, "TPU_DCN")))),
    ("ckpt_overhead", lambda m: ((2.065e10,), dict(step_time_s=1.6,
                                                   every=10))),
    ("ckpt_overhead", lambda m: ((1e9,), dict(
        step_time_s=0.5, d2h=_fab(m, "PCIE_D2H"),
        disk=_fab(m, "CKPT_DISK")))),
    ("decode_step_time", lambda m: ((3.4e9, 6.1e7), dict(batch=8))),
    ("decode_step_time", lambda m: ((3.4e9, 6.1e7), dict(
        batch=256, flops_per_token=3.4e9, kernel_time_s=1e-4))),
    ("calibrate_kernel_time", lambda m: ((ROWS,), dict(arch="a"))),
    ("calibrate_kernel_time", lambda m: ((ROWS,), dict(
        arch="b", batch=2, per_token=False))),
    ("spec_expected_tokens", lambda m: ((0.6, 4), {})),
    ("spec_expected_tokens", lambda m: ((1.7, 3), {})),
    ("spec_expected_tokens", lambda m: ((0.4, 1), {})),
    ("decode_tokens_per_s", lambda m: ((3.4e9, 6.1e7), dict(
        batch=8, flops_per_token=3.4e9, host_sync_s=2e-3,
        tokens_per_sync=8, acceptance=0.6, spec_k=4))),
    ("decode_tokens_per_s", lambda m: ((1e9, 1e6), dict(batch=8))),
    ("prefill_time", lambda m: ((4096,), dict(flops_per_token=3.4e9,
                                              param_bytes=3.4e9))),
    ("prefill_time", lambda m: ((4,), dict(flops_per_token=3.4e9,
                                           param_bytes=3.4e9))),
    ("ttft_model", lambda m: ((512,), dict(
        flops_per_token=3.4e9, prefix_hit_rate=0.75, queue_s=0.01,
        param_bytes=3.4e9))),
    ("ttft_model", lambda m: ((512,), dict(flops_per_token=3.4e9,
                                           prefix_hit_rate=1.0))),
    ("paged_pool_bytes", lambda m: (([5, 40, 19, 512], 16, 114688.0), {})),
    ("bucket_comm_time", lambda m: ((4e8,), dict(p=8))),
    ("bucket_comm_time", lambda m: ((4e8,), dict(p=8, strategy="zero3"))),
    ("bucket_comm_time", lambda m: ((4e8,), dict(
        p=4, strategy="zero1_hier", fabric=_fab(m, "INFINIBAND_FDR")))),
    ("serial_step_time", lambda m: ((0.1, 4e9), dict(p=16, n_buckets=8,
                                                     strategy="zero2"))),
    ("overlapped_step_time", lambda m: ((0.1, 4e9), dict(
        p=16, n_buckets=8, strategy="zero1"))),
    ("overlapped_step_time", lambda m: ((10.0, 4e6), dict(
        p=2, n_buckets=32, strategy="flat"))),
    ("overlap_speedup", lambda m: ((0.1, 4e9), dict(p=64, n_buckets=32))),
    ("opt_state_bytes_per_device", lambda m: ((178_110, 2), dict(
        n_workers=8, strategy="zero3"))),
    ("opt_state_bytes_per_device", lambda m: ((178_110, 2), dict(
        n_workers=8, strategy="flat"))),
    ("opt_state_bytes_per_device", lambda m: ((178_111, 1), dict(
        n_workers=8))),
    ("dp_memory_report", lambda m: ((178_110, 2, 8), {})),
    ("dp_memory_report", lambda m: ((7_241_732_096, 0, 1), dict(
        param_bytes=2, grad_bytes=2))),
    ("dp_memory_report", lambda m: ((33_300_000_001, 1, 32), dict(
        param_bytes=2))),
]


def test_every_function_has_a_case():
    names = {n for n in dir(ref_pm) if callable(getattr(ref_pm, n))
             and not n[0].isupper() and n not in ("annotations",)
             and getattr(getattr(ref_pm, n), "__module__", "")
             == ref_pm.__name__}
    covered = {n for n, _ in FUNCTION_CASES} | {
        "kv_bytes_per_token", "moe_expert_bytes",
        "mesh_decode_bytes_per_device"}
    assert names == covered, names ^ covered
    for name in FABRICS + ("TPU_V5E_HBM_BW", "TPU_V5E_FLOPS"):
        assert getattr(pm, name) == getattr(ref_pm, name) or (
            dataclass_equal(getattr(pm, name), getattr(ref_pm, name)))


def dataclass_equal(a, b):
    return (a.name, a.bw_bytes, a.alpha) == (b.name, b.bw_bytes, b.alpha)


@pytest.mark.parametrize("i", range(len(FUNCTION_CASES)),
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FUNCTION_CASES)])
def test_function_matches_reference(i):
    name, build = FUNCTION_CASES[i]
    a, kw = build(pm)
    ra, rkw = build(ref_pm)
    _close(getattr(pm, name)(*a, **kw), getattr(ref_pm, name)(*ra, **rkw))


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_config_readers_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    ctx = [5, 40, 19, 512, 3000]
    _close(pm.kv_bytes_per_token(cfg), ref_pm.kv_bytes_per_token(jcfg))
    _close(pm.kv_bytes_per_token(cfg, 4), ref_pm.kv_bytes_per_token(jcfg, 4))
    _close(pm.moe_expert_bytes(cfg), ref_pm.moe_expert_bytes(jcfg))
    for mp, ep in ((1, True), (8, True), (8, False)):
        _close(pm.mesh_decode_bytes_per_device(
            cfg, ctx, 16, model_parallel=mp, expert_parallel=ep),
            ref_pm.mesh_decode_bytes_per_device(
                jcfg, ctx, 16, model_parallel=mp, expert_parallel=ep))


# every strategy at single-fabric, multi-pod and hierarchical arguments
COMM_ARGS = [
    dict(p=1), dict(p=8), dict(p=8, microbatches=4),
    dict(n_intra=16, n_pods=2), dict(n_intra=4, n_pods=1, microbatches=2),
    dict(p=32, n_intra=16, n_pods=2, microbatches=3),
    dict(p=16, fabric="INFINIBAND_FDR", inter="TPU_DCN"),
    dict(n_intra=8, n_pods=4, fabric="INFINIBAND_FDR", inter="CKPT_DISK"),
]


def _named(mod, kw):
    return {k: getattr(mod, v) if k in ("fabric", "inter") else v
            for k, v in kw.items()}


def test_registries_agree():
    from repro.core.strategy import available_strategies as ref_names
    assert available_strategies() == ref_names()
    for name in available_strategies():
        s, r = get_strategy(name), ref_strategy(name)
        assert (s.kind, s.sharded, s.params_sharded, s.memory_key) == (
            r.kind, r.sharded, r.params_sharded, r.memory_key), name


@pytest.mark.parametrize("name", ["flat", "bucketed", "hierarchical",
                                  "zero1", "zero2", "zero3", "zero1_hier",
                                  "zero3_hier"])
def test_strategy_comm_time_matches_reference(name):
    s, r = get_strategy(name), ref_strategy(name)
    for kw in COMM_ARGS:
        _close(s.comm_time(4.0 * 178_110, **_named(pm, kw)),
               r.comm_time(4.0 * 178_110, **_named(ref_pm, kw)))
    for p in (1, 2, 8, 64):
        for fab in ("TPU_V5E_ICI", "INFINIBAND_FDR"):
            if name == "hierarchical":
                for mod, strat in ((pm, s), (ref_pm, r)):
                    with pytest.raises(ValueError, match="pod split"):
                        strat.bucket_comm_time(4e8, p=p,
                                               fabric=getattr(mod, fab))
                continue
            _close(s.bucket_comm_time(4e8, p=p, fabric=getattr(pm, fab)),
                   r.bucket_comm_time(4e8, p=p, fabric=getattr(ref_pm, fab)))
    for n, f, w, pb, gb in ((178_110, 2, 8, 4, 4), (178_111, 1, 3, 2, 2),
                            (7_241_732_096, 0, 1, 2, 2)):
        _close(s.memory_entry(n, f, w, param_bytes=pb, grad_bytes=gb),
               r.memory_entry(n, f, w, param_bytes=pb, grad_bytes=gb))


def test_memory_rows_match_reference():
    from repro.core.strategy import memory_rows as ref_rows
    for args in ((178_110, 2, 8), (33_300_000_000, 2, 32)):
        got, want = memory_rows(*args, param_bytes=2), ref_rows(
            *args, param_bytes=2)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want):
            _close(a, b)


def test_h100_presets_are_the_datasheet_numbers():
    # NVIDIA H100 SXM datasheet: NVLink 900 GB/s both ways, HBM3
    # 3.35 TB/s, bf16 dense 989 TFLOP/s, PCIe Gen5 128 GB/s both ways
    assert pm.H100_NVLINK4.bw_bytes == 450e9
    assert pm.H100_HBM_BW == 3.35e12
    assert pm.H100_BF16_FLOPS == 989e12
    assert pm.H100_PCIE5_D2H.bw_bytes == 64e9
    # one rank moves nothing: the model gives 0 at p = 1
    assert pm.allreduce_comm_time(1e9, p=1, fabric=pm.H100_NVLINK4) == 0.0


# --------------------------------------------------------------------------
# twins of the reference's perf-model tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("logp", range(1, 7))
def test_perf_model_compute_scales_inverse_p(logp):
    """Twin of ``test_properties.py``'s hypothesis test, over every p it
    draws from."""
    p = 2 ** logp
    kw = dict(samples=60000,
              flops_per_sample=pm.dnn_flops_per_sample(NET),
              flops_rate=1e10, comm_bytes=pm.dnn_comm_bytes(NET),
              fabric=pm.INFINIBAND_FDR)
    t1c, _ = pm.epoch_time(1, **kw)
    tpc, tpm = pm.epoch_time(p, **kw)
    assert math.isclose(tpc, t1c / p, rel_tol=1e-9)
    assert tpm >= 0.0


def test_hierarchical_beats_flat_multipod():
    v = 4 * 50e6  # 50M params fp32
    t_h = pm.hierarchical_comm_time(v, n_intra=16, n_pods=2)
    t_f = pm.flat_multipod_comm_time(v, n_intra=16, n_pods=2)
    assert t_h < t_f


def test_overlapped_step_time_one_bucket_equals_serial():
    kw = dict(p=16, n_buckets=1, fabric=pm.TPU_V5E_ICI)
    for strat in ("flat", "bucketed", "zero1"):
        t_s = pm.serial_step_time(0.1, 4e9, strategy=strat, **kw)
        t_o = pm.overlapped_step_time(0.1, 4e9, strategy=strat, **kw)
        assert abs(t_s - t_o) < 1e-12, (strat, t_s, t_o)


def test_overlapped_never_slower_than_serial():
    for p in (2, 8, 64):
        for n_buckets in (1, 2, 8, 32, 128):
            for t_comp in (0.0, 1e-3, 0.1, 10.0):
                for v in (4e6, 4e9, 4e11):
                    for strat in ("flat", "zero1"):
                        kw = dict(p=p, n_buckets=n_buckets,
                                  fabric=pm.INFINIBAND_FDR, strategy=strat)
                        t_s = pm.serial_step_time(t_comp, v, **kw)
                        t_o = pm.overlapped_step_time(t_comp, v, **kw)
                        assert t_o <= t_s + 1e-12
                        assert pm.overlap_speedup(t_comp, v,
                                                  **kw) >= 1.0 - 1e-12


def test_bucket_comm_time_zero1_consistency():
    v, p = 4 * 33.3e9, 16
    fab = pm.TPU_V5E_ICI
    assert pm.bucket_comm_time(v, p=p, fabric=fab, strategy="zero1") \
        == pm.zero1_comm_time(v, p=p, fabric=fab)
    t = pm.overlapped_step_time(0.0, v, p=p, n_buckets=1, fabric=fab,
                                strategy="zero1")
    assert abs(t - pm.zero1_comm_time(v, p=p, fabric=fab)) < 1e-12
    assert pm.bucket_comm_time(v, p=1, fabric=fab) == 0.0
    with pytest.raises(ValueError, match="n_buckets"):
        pm.serial_step_time(0.1, v, p=p, n_buckets=0)


def test_ckpt_overhead_model():
    r = pm.ckpt_overhead(1e9, step_time_s=1.0, every=10)
    assert r["async_s"] < r["sync_s"]
    assert abs(r["sync_s"] - (r["async_s"] + r["publish_lag_s"])) < 1e-12
    assert r["async_overhead"] < r["sync_overhead"]
    assert r["publish_lag_steps"] == pytest.approx(r["publish_lag_s"])
    r1 = pm.ckpt_overhead(1e9, step_time_s=1.0, every=1)
    assert r1["sync_overhead"] == pytest.approx(10 * r["sync_overhead"])


def test_zero3_hier_comm_model_dcn_saving():
    v = 4 * 33_000_000_000
    flat = pm.zero3_comm_time(v, p=64, fabric=pm.TPU_DCN)
    hier = pm.zero3_hier_comm_time(v, n_intra=16, n_pods=4)
    assert hier < flat
    assert pm.zero3_hier_comm_time(v, n_intra=1, n_pods=1) == 0.0
    dcn_only = pm.zero3_hier_comm_time(v, n_intra=16, n_pods=4,
                                       intra=pm.TPU_DCN)
    assert dcn_only > hier


def test_perf_model_is_registry_driven():
    rpt = pm.dp_memory_report(33_300_000_000, 2, 32)
    for part in ("params", "grads", "opt_state", "total", "ratio"):
        assert rpt[f"{part}_zero1_hier"] == rpt[f"{part}_zero1"], part
    v = 4 * 33.3e9
    t_hier = pm.zero1_hier_comm_time(v, n_intra=16, n_pods=2)
    t_flat = pm.zero1_flat_multipod_comm_time(v, n_intra=16, n_pods=2)
    assert 0 < t_hier < t_flat
    t1 = pm.zero1_hier_comm_time(v, n_intra=16, n_pods=1)
    assert t1 == pytest.approx(pm.zero1_comm_time(v, p=16))
    with pytest.raises(ValueError, match="registered"):
        pm.bucket_comm_time(v, p=8, strategy="nope")


def test_calibrate_kernel_time_selects_best_row():
    assert pm.calibrate_kernel_time(ROWS, arch="a") \
        == pytest.approx(0.064 / 8)
    assert pm.calibrate_kernel_time(ROWS, arch="a", per_token=False) \
        == pytest.approx(0.064)
    assert pm.calibrate_kernel_time(ROWS, arch="b", batch=2) \
        == pytest.approx(0.05)
    with pytest.raises(ValueError):
        pm.calibrate_kernel_time(ROWS, arch="a", batch=16)


def test_decode_step_time_kernel_floor():
    base = pm.decode_step_time(1e9, 1e6, batch=8)
    assert pm.decode_step_time(1e9, 1e6, batch=8, kernel_time_s=0.0) == base
    assert pm.decode_step_time(1e9, 1e6, batch=8,
                               kernel_time_s=base * 10) == base * 10
    slow = pm.decode_tokens_per_s(1e9, 1e6, batch=8, kernel_time_s=base * 10)
    assert slow == pytest.approx(8 / (base * 10))


def test_spec_expected_tokens_values():
    f = pm.spec_expected_tokens
    assert f(0.6, 4) == pytest.approx(1 + 0.6 + 0.36 + 0.216)
    assert f(1.0, 4) == pytest.approx(4.0)
    assert f(0.6, 2) == pytest.approx(1.6)
    assert f(0.0, 4) == pytest.approx(1.0)
    assert f(0.5, 1) == pytest.approx(1.0)
    assert f(2.0, 3) == pytest.approx(3.0)


def test_decode_tokens_per_s_acceptance_term():
    kw = dict(batch=8, flops_per_token=0.0)
    base = pm.decode_tokens_per_s(1e9, 1e6, **kw)
    for a, k in ((0.6, 4), (1.0, 2), (0.3, 3)):
        spec = pm.decode_tokens_per_s(1e9, 1e6, acceptance=a, spec_k=k, **kw)
        assert spec / base == pytest.approx(pm.spec_expected_tokens(a, k))
    kw2 = dict(batch=8, flops_per_token=1e12)
    base2 = pm.decode_tokens_per_s(1e9, 1e6, **kw2)
    spec2 = pm.decode_tokens_per_s(1e9, 1e6, acceptance=0.6, spec_k=4, **kw2)
    assert spec2 / base2 < pm.spec_expected_tokens(0.6, 4)


def test_perf_model_zero1_memory_is_one_nth():
    n_params, n = 178_110, 8
    rep = pm.opt_state_bytes_per_device(n_params, 2, n_workers=n,
                                        strategy="replicated")
    z1 = pm.opt_state_bytes_per_device(n_params, 2, n_workers=n,
                                       strategy="zero1")
    assert abs(z1 / rep - 1.0 / n) < 1e-3
    rpt = pm.dp_memory_report(n_params, 2, n)
    assert abs(rpt["opt_state_ratio"] - 1.0 / n) < 1e-3
    assert rpt["total_zero1"] < rpt["total_replicated"]
    assert pm.zero1_comm_time(4 * n_params, p=n) > 0.0


def test_dp_memory_report_zero3_is_one_pth():
    n_params, f, p = 178_110, 2, 8
    rpt = pm.dp_memory_report(n_params, f, p)
    assert abs(rpt["ratio_zero3"] - 1.0 / p) < 1e-2
    assert abs((rpt["params_zero3"] + rpt["opt_state_zero3"])
               / (rpt["params_replicated"] + rpt["opt_state_replicated"])
               - 1.0 / p) < 1e-2
    assert rpt["total_zero3"] < rpt["total_zero2"] < rpt["total_zero1"] \
        < rpt["total_replicated"]
    assert rpt["grads_zero2"] == rpt["grads_zero3"] < rpt["grads_zero1"]
    v = 4.0 * n_params
    t1 = pm.zero1_comm_time(v, p=p)
    assert pm.zero2_comm_time(v, p=p, microbatches=1) == t1
    assert pm.zero2_comm_time(v, p=p, microbatches=4) > t1
    assert pm.zero3_comm_time(v, p=p) == pytest.approx(1.5 * t1)
    for strat in ("zero2", "zero3"):
        assert pm.bucket_comm_time(v, p=p, strategy=strat) > 0
        assert pm.bucket_comm_time(v, p=1, strategy=strat) == 0.0


def test_bf16_masters_memory_row():
    """The model of what bf16 masters and gradients save: 2 + 2 bytes a
    param against fp32's 4 + 4, optimizer state fp32 either way."""
    n = 7_241_732_096                      # llava-next-mistral-7b
    fp32 = pm.dp_memory_report(n, 2, 1)
    bf16 = pm.dp_memory_report(n, 2, 1, param_bytes=2, grad_bytes=2)
    assert fp32["total_replicated"] == 16.0 * n
    assert bf16["total_replicated"] == 12.0 * n
    assert pm.dp_memory_report(n, 0, 1, param_bytes=2, grad_bytes=2)[
        "total_replicated"] == 4.0 * n


# --------------------------------------------------------------------------
# Trainer.describe()["comm_time_s"] on gloo ranks (test_strategy.py:169)
# --------------------------------------------------------------------------

DESCRIBE = """
from repro_torch import optim
from repro_torch.api import Trainer
from repro_torch.configs.paper_nets import MNIST_DNN
from repro_torch.core import DPConfig
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.models import apply_paper_net, init_paper_net

mesh = make_dp_mesh(2)
rng = np.random.default_rng(0)
batch = {"x": rng.standard_normal((16, 784)).astype(np.float32),
         "y": rng.integers(0, 10, 16)}

def loss_fn(model, b):
    logits = apply_paper_net(MNIST_DNN, model, b["x"])
    return torch.nn.functional.cross_entropy(logits, b["y"].long())

out = {}
for name in ("zero1_hier", "flat", "hierarchical", "zero3"):
    t = Trainer.create(loss_fn=loss_fn, params=init_paper_net(
        MNIST_DNN, seed=0, device="cpu"), optimizer=optim.adam(1e-3),
        dp=DPConfig(strategy=name, microbatches=2), mesh=mesh,
        device="cpu")
    m = t.step(batch)
    out[name] = dict(t.describe(), loss=float(m["loss"]))
print(json.dumps(out))
"""


def test_describe_comm_time_on_gloo_ranks(tmp_path):
    res = run_ranks(DESCRIBE, 4, tmp_path)
    for name, d in res[0].items():
        assert d == res[1][name] == res[2][name] == res[3][name]
        n = d["params"]
        want = ref_strategy(name).comm_time(4.0 * n, p=4, n_intra=2,
                                            n_pods=2, microbatches=2)
        assert d["comm_time_s"] > 0 and math.isclose(
            d["comm_time_s"], want, rel_tol=RTOL), (name, d)
        assert d["world_size"] == 4 and math.isfinite(d["loss"])
    padded = n + (-n) % 4
    assert res[0]["zero1_hier"]["memory_per_device_bytes"]["opt_state"] \
        == 4.0 * 2 * (padded // 4)
