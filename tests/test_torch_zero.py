"""The ZeRO ladder and the overlap scheduler in the port, on gloo ranks
on the CPU: twins of the reference's ``tests/test_zero1.py``,
``tests/test_zero23.py``, ``tests/test_strategy.py`` and
``tests/test_overlap.py``.

* zero1 / zero2 / zero3 equal the sequential large-batch step on the
  reference's 8 workers (MNIST-DNN, 5 steps) within its bars, with
  overlap off, on and ``"serial"``, with and without microbatches;
  ``compress="bf16"`` is lossy but bounded and keeps fp32 master shards;
  every strategy averages gradients alike;
* residency: the moments are 1/p a rank; zero2 keeps no gradient
  between steps; between zero3 steps (and right after its init) no
  tensor a rank holds -- params and their storages included -- is
  larger than ``shard_len``, and no live tensor reaches the model's
  size;
* zero1_hier / zero3_hier on the (2, 4) pod x data mesh: the worker
  numbering is the reference's intra-major one, the two-level
  reduce-scatter leaves each worker its ``local_shard`` slice, and both
  equal the sequential step with overlap off, on and serial;
* the registry holds all eight strategies; a custom sharded strategy
  round-trips through the ``Trainer``; restoring an unregistered one
  lists the names; layout mismatches raise;
* ``plan_buckets`` equals the reference's on a hypothesis grid; in
  place of the reference's HLO-pair tests, a spy on ``issue`` /
  ``finish``: with overlap on, bucket k+1 is issued before bucket k is
  finished; ``"serial"`` strictly alternates.

The reference emulates 8 devices in one process; here each worker is a
process (``tests/torch_ranks.py``), and each mesh runs once, in a
module-scoped fixture whose ranks run every case.
"""
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings, strategies as st

from torch_ranks import run_ranks

from repro.core.overlap import plan_buckets as jax_plan_buckets
from repro_torch.core import (DPConfig, Layout, ShardedStrategy,
                              available_strategies, get_strategy,
                              plan_buckets, register_strategy)
from repro_torch.core.collectives import allreduce_mean, reduce_scatter_mean
from repro_torch.core.strategy import FlatStrategy

N_PARAMS = 784 * 200 + 200 + 200 * 100 + 100 + 100 * 10 + 10
STEPS = 5
# the reference's bars (tests/test_zero1.py, tests/test_zero23.py)
SGD_TOL, ADAM_TOL, BF16_TOL = 1e-6, 1e-5, 5e-2

COMMON = """
import gc
from repro_torch import optim
from repro_torch.api import Trainer
from repro_torch.configs.paper_nets import MNIST_DNN
from repro_torch.core import DPConfig, allreduce_mean
from repro_torch.core import overlap as overlap_mod
from repro_torch.core.strategy import Zero1Strategy, register_strategy
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.models import apply_paper_net, init_paper_net
from repro_torch.train import cross_entropy, trainable

mesh = make_dp_mesh({pods})
rng = np.random.default_rng(0)
batch = {{"x": rng.standard_normal((64, 784), dtype=np.float32),
          "y": rng.integers(0, 10, 64).astype(np.int32)}}

def loss_fn(m, b):
    return cross_entropy(apply_paper_net(MNIST_DNN, m, b["x"]), b["y"])

def trainer(dp=None, opt=None, mesh=mesh, seed=RANK):
    # each rank draws other weights: create broadcasts rank 0's
    return Trainer.create(loss_fn=loss_fn,
                          params=init_paper_net(MNIST_DNN, seed=seed,
                                                device="cpu"),
                          optimizer=opt or optim.adam(1e-3), dp=dp,
                          mesh=mesh, device="cpu")

def flat(p):
    return np.concatenate([p[k].ravel() for k in sorted(p)])

def err(a, b):
    return float(np.abs(flat(a) - flat(b)).max())

def seq_params(opt, steps={steps}):
    t = trainer(mesh=None, seed=0, opt=opt)
    for _ in range(steps):
        t.step(batch)
    return t.params

def run(strategy, opt=None, steps={steps}, **kw):
    t = trainer(DPConfig(strategy=strategy, bucket_bytes=1 << 16, **kw),
                opt=opt)
    for _ in range(steps):
        m = t.step(batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert t.state.step == steps
    return t

def big_live(total):
    # every live tensor's storage, as the reference's jax.live_arrays()
    # sweep: none may reach the model's size
    gc.collect()
    out = []
    for o in gc.get_objects():
        try:
            if isinstance(o, torch.Tensor) and \\
                    o.untyped_storage().nbytes() >= 4 * total:
                out.append(list(o.shape))
        except Exception:
            pass
    return out

out = {{}}
"""

SINGLE = COMMON + """
adam, sgd = optim.adam(1e-3), optim.sgd(0.1)
ref = {{"adam": seq_params(adam), "sgd": seq_params(sgd)}}

# test_zero1.py:54 -- zero1 == sequential, per optimizer
for name in ("sgd", "adam"):
    opt = sgd if name == "sgd" else adam
    out[f"zero1_{{name}}"] = err(run("zero1", opt).params, ref[name])

# test_zero1.py:73 -- the moments are physically 1/8 a rank
t = run("zero1", steps=2)
lay = t.state.layout
out["zero1_layout"] = [lay.kind, lay.total, lay.padded_total, lay.shard_len]
out["zero1_moments"] = sorted({{t.state.opt_state[k]["flat"].numel()
                                for k in ("m", "v")}})

# test_zero1.py:95 -- every strategy averages the gradients alike
model = init_paper_net(MNIST_DNN, seed=0, device="cpu")
mine = {{k: v[RANK * 8:(RANK + 1) * 8] for k, v in batch.items()}}
loss_fn(model, {{"x": torch.from_numpy(mine["x"]),
                 "y": torch.from_numpy(mine["y"])}}).backward()
grads = [p.grad.clone() for p in model.parameters()]
avg = {{}}
for s in ("flat", "bucketed", "hierarchical", "zero1"):
    gs = [g.clone() for g in grads]
    allreduce_mean(gs, mesh, strategy=s)
    avg[s] = np.concatenate([g.numpy().ravel() for g in gs])
out["avg_grads"] = {{s: float(np.abs(a - avg["flat"]).max())
                    for s, a in avg.items()}}

# test_zero1.py:119 and test_zero23.py:90 -- microbatches, sgd
for s in ("zero1", "zero2", "zero3"):
    for ov in (False, True, "serial"):
        out[f"micro_{{s}}_{{ov}}"] = err(
            run(s, sgd, microbatches=4, overlap=ov).params, ref["sgd"])

# test_zero23.py:73 -- zero2 / zero3 == sequential, overlap off/on/serial
for s in ("zero2", "zero3"):
    for ov in (False, True, "serial"):
        out[f"seq_{{s}}_{{ov}}"] = err(run(s, overlap=ov).params,
                                       ref["adam"])

# test_zero1.py:137 and test_zero23.py:109 -- the bf16 wire
for s, mb in (("zero1", 1), ("zero1", 2), ("zero3", 1)):
    t = run(s, compress="bf16", microbatches=mb)
    out[f"bf16_{{s}}_{{mb}}"] = err(t.params, ref["adam"])
    out[f"bf16_{{s}}_{{mb}}_dtypes"] = sorted({{
        str(t.state.opt_state[k]["flat"].dtype) for k in ("m", "v")}} | (
        {{str(t.state.flat.shard.dtype)}} if s == "zero3" else set()))

# test_overlap.py:77 / :148 -- overlap on == off == serial
for s in ("flat", "bucketed", "zero1"):
    base = run(s).params
    out[f"ov_{{s}}"] = [err(run(s, overlap=ov).params, base)
                        for ov in (True, "serial")]

# test_zero23.py:135 -- zero3 residency between steps
t = run("zero3", steps=2)
lay, st = t.state.layout, t.state
held = [st.flat.shard] + [st.opt_state[k]["flat"] for k in ("m", "v")]
params = list(trainable(st.params).values())
out["z3_residency"] = {{
    "shard_len": lay.shard_len, "total": lay.total,
    "state_max": max(x.numel() for x in held),
    "param_storage_max": max(p.untyped_storage().nbytes() for p in params),
    "full_storage": st.flat.full.untyped_storage().nbytes(),
    "grads": sum(p.grad is not None for p in params),
    "big_live": big_live(lay.total)}}
del t, st, held, params

# test_zero23.py:176 -- zero2's gradient shard is the only gradient
t = run("zero2", steps=2, microbatches=4)
out["z2_grads"] = [sum(p.grad is not None
                       for p in trainable(t.state.params).values()),
                   sorted({{t.state.opt_state[k]["flat"].numel()
                           for k in ("m", "v")}}), t.state.layout.shard_len]
del t

# test_zero23.py:200 -- per-shard init: nothing full-size survives init
t = trainer(DPConfig(strategy="zero3"))
out["z3_init"] = {{"big_live": big_live(t.state.layout.total),
                  "shard": t.state.flat.shard.numel(),
                  "loss": float(t.step(batch)["loss"])}}
del t

# the in-place gradient views: autograd accumulates into the flat buffer
from repro_torch.core import flat as flat_lib
t = trainer(DPConfig(strategy="zero1"))
ms = trainable(t.state.params)
g = torch.zeros(t.state.layout.padded_total)
flat_lib.bind_grads(t.state.flat.spec, ms, g)
loss_fn(t.state.params, {{"x": torch.from_numpy(batch["x"][:8]),
                          "y": torch.from_numpy(batch["y"][:8])}}).backward()
out["grad_views"] = [
    sum(p.grad.untyped_storage().data_ptr() == g.untyped_storage().data_ptr()
        for p in ms.values()), len(ms), float(g.abs().sum()) > 0]
flat_lib.unbind_grads(ms)

# test_zero23.py:305 -- a layout mismatch raises
from repro_torch.core import make_dp_train_step
s1 = trainer(DPConfig(strategy="zero1")).state
step3 = make_dp_train_step(loss_fn, adam, mesh, DPConfig(strategy="zero3"))
stepb = make_dp_train_step(loss_fn, adam, mesh, DPConfig(
    strategy="zero1", overlap=True, bucket_bytes=1 << 16))
msgs = []
for fn, arg in ((step3, s1), (stepb, s1), (step3, s1._replace(layout=None))):
    try:
        fn(arg, batch)
        msgs.append(None)
    except (ValueError, TypeError) as e:
        msgs.append(f"{{type(e).__name__}}: {{e}}")
out["mismatch"] = msgs

# test_zero23.py:340 -- the sequential and replicated steps share a state
from repro_torch.core import make_sequential_step
step = make_dp_train_step(loss_fn, sgd, mesh, DPConfig(strategy="flat"))
seqs = make_sequential_step(loss_fn, sgd)
s = trainer(DPConfig(strategy="flat"), opt=sgd).state
s, _ = step(s, batch)
s, _ = seqs(s, batch)
s, _ = step(s, batch)
out["shared_contract"] = s.step

# the spy: issue / finish order of the bucket pipeline
events = []
real = overlap_mod.run_pipeline

def spy(n, issue, finish, *, serialize=False):
    def i(k):
        events.append(("issue", k))
        return issue(k)
    def f(k, p):
        events.append(("finish", k))
        return finish(k, p)
    return real(n, i, f, serialize=serialize)

overlap_mod.run_pipeline = spy
for ov in (True, "serial"):
    t = trainer(DPConfig(strategy="zero1", overlap=ov, bucket_bytes=1 << 16))
    events.clear()
    t.step(batch)
    out[f"spy_{{ov}}"] = list(events)
overlap_mod.run_pipeline = real

# test_strategy.py:247 -- a custom sharded strategy through the Trainer
import json as js, pathlib
class ToyZero(Zero1Strategy):
    name = "toy_zero1"
    kind = "toy_zero1"

register_strategy(ToyZero())
d = os.environ["CKPT"]
toy = run("toy_zero1", steps=3)
base = run("zero1", steps=3)
toy.save(d + "/toy")
meta = js.loads((pathlib.Path(d) / "toy/step_0000000003.shards"
                 / "meta.json").read_text())
fresh = trainer(DPConfig(strategy="toy_zero1", bucket_bytes=1 << 16))
at = fresh.restore(d + "/toy")
out["toy"] = {{"err": err(toy.params, base.params), "meta": meta["layout"],
              "restored": [at, err(fresh.params, toy.params),
                           float(np.abs(
                               fresh.state.opt_state["m"]["flat"].numpy()
                               - toy.state.opt_state["m"]["flat"].numpy())
                               .max())],
              "loss": float(fresh.step(batch)["loss"])}}
# test_strategy.py:304 -- an unregistered strategy's checkpoint lists names
if RANK == 0:
    meta = js.loads(js.dumps(meta))
    meta["layout"]["strategy"] = "vanished_plugin"
    (pathlib.Path(d) / "toy/step_0000000003.shards" / "meta.json"
     ).write_text(js.dumps(meta))
dist.barrier()
try:
    fresh.restore(d + "/toy")
    out["vanished"] = None
except ValueError as e:
    out["vanished"] = str(e)

# test_strategy.py:337 -- a zero3 template never holds the full vector
z3 = run("zero3", steps=2)
z3.save(d + "/z3")
want = z3.params
del z3, t, toy, base, fresh, s1, s, arg, ms, g   # every full-size holder
tpl = trainer(DPConfig(strategy="zero3"), seed=100 + RANK)
out["z3_template"] = {{"big_live": big_live(tpl.state.layout.total),
                      "at": tpl.restore(d + "/z3"),
                      "err": err(tpl.params, want),
                      "loss": float(tpl.step(batch)["loss"])}}
d3 = trainer(DPConfig(strategy="zero3")).describe()
dr = trainer(DPConfig(strategy="flat")).describe()
out["describe"] = [d3["layout"], d3["memory_per_device_bytes"],
                   dr["memory_per_device_bytes"]]
print(json.dumps(out))
"""

MULTI = COMMON + """
from repro_torch.core.collectives import (hier_reduce_scatter_mean,
                                          local_shard, worker_index)
from repro_torch.core.overlap import (plan_buckets, plan_local_shard,
                                      reduce_scatter_flat)

# the worker numbering: data index i of pod k is worker i * n_pods + k
coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
out["worker"] = [coord["pod"], coord["data"],
                 worker_index(mesh, ("data", "pod")),
                 worker_index(mesh, ("pod", "data"))]
# the two-level reduce-scatter leaves each worker its local_shard slice
# of the mean (contiguous, and bucket-major under a plan)
vals = [torch.from_numpy(np.random.default_rng(r).standard_normal(1001)
                         .astype(np.float32)) for r in range(WORLD)]
mean = torch.stack(vals).double().mean(0).float()
sh, spec = hier_reduce_scatter_mean([vals[RANK]], mesh)
padded = torch.cat([mean, mean.new_zeros((-1001) % WORLD)])
want = local_shard(padded, mesh, ("data", "pod"))
plan = plan_buckets(1001, bucket_bytes=64, align=WORLD)
flat_in = torch.cat([vals[RANK], vals[RANK].new_zeros((-1001) % WORLD)])
shb = reduce_scatter_flat(flat_in, mesh, ("data", "pod"), plan)
wantb = plan_local_shard(padded, worker_index(mesh, ("data", "pod")),
                         WORLD, plan)
out["hier_shard"] = [float((sh - want).abs().max()),
                     float((shb - wantb).abs().max())]

adam = optim.adam(1e-3)
ref = seq_params(adam)
# test_strategy.py:136 -- zero1_hier == sequential on the pod x data mesh
t = run("zero1_hier")
lay = t.state.layout
out["hier_layout"] = [lay.kind, list(lay.axes), lay.num_shards,
                      t.state.opt_state["m"]["flat"].numel(), lay.shard_len]
out["hier_seq"] = err(t.params, ref)
# test_overlap.py:94 / :139 -- overlap on == off == serial, multi-pod
base = {{s: run(s).params for s in ("hierarchical", "zero1_hier",
                                    "zero3_hier")}}
out["hier_ov"] = {{s: [err(run(s, overlap=ov).params, b)
                      for ov in (True, "serial")]
                  for s, b in base.items()}}
out["hier_seq3"] = err(base["zero3_hier"], ref)
out["hier_micro"] = {{s: err(run(s, microbatches=2, overlap=True).params,
                            ref) for s in ("zero1_hier", "zero3_hier")}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    return run_ranks(SINGLE.format(pods=1, steps=STEPS), 8, tmp,
                     env={"CKPT": str(tmp)}, timeout=300)


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    return run_ranks(MULTI.format(pods=2, steps=STEPS), 8,
                     tmp_path_factory.mktemp("zero_hier"), timeout=300)


# --------------------------------------------------------------------------
# tests/test_zero1.py twins
# --------------------------------------------------------------------------

@pytest.mark.parametrize("optname,tol", [("sgd", SGD_TOL),
                                         ("adam", ADAM_TOL)])
def test_zero1_matches_sequential(single, optname, tol):
    assert max(r[f"zero1_{optname}"] for r in single) < tol


def test_zero1_opt_state_physically_sharded(single):
    padded = N_PARAMS + (-N_PARAMS) % 8
    for r in single:
        assert r["zero1_layout"] == ["zero1", N_PARAMS, padded, padded // 8]
        assert r["zero1_moments"] == [padded // 8]


@pytest.mark.parametrize("strategy", ["bucketed", "hierarchical", "zero1"])
def test_all_strategies_identical_averaged_grads(single, strategy):
    assert max(r["avg_grads"][strategy] for r in single) < 1e-6


@pytest.mark.parametrize("strategy", ["zero1", "zero2", "zero3"])
@pytest.mark.parametrize("overlap", [False, True, "serial"])
def test_microbatch_accumulation_matches_sequential(single, strategy,
                                                    overlap):
    """tests/test_zero1.py:119 (zero1, 1e-6) and tests/test_zero23.py:90
    (zero2 / zero3, 1e-5): 4 microbatches == one big batch under SGD."""
    tol = SGD_TOL if (strategy, overlap) == ("zero1", False) else ADAM_TOL
    assert max(r[f"micro_{strategy}_{overlap}"] for r in single) < tol


@pytest.mark.parametrize("case", ["zero1_1", "zero1_2", "zero3_1"])
def test_bf16_wire_bounded_with_fp32_masters(single, case):
    errs = [r[f"bf16_{case}"] for r in single]
    assert 0 < max(errs) < BF16_TOL          # really went through bf16
    assert all(r[f"bf16_{case}_dtypes"] == ["torch.float32"]
               for r in single)


def test_bf16_reduce_scatter_returns_fp32_shard():
    """tests/test_zero1.py:166 on one rank: the bf16 wire rounds, the
    shard comes back in fp32 (the world of one is a copy, so the
    rounding is all there is)."""
    import os
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_dp_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_dp_mesh(1)
        g = [torch.from_numpy(np.random.default_rng(0).standard_normal(
            (8, 1000)).astype(np.float32))]
        full, _ = reduce_scatter_mean(g, mesh)
        half, _ = reduce_scatter_mean(g, mesh, compress="bf16")
        assert half.dtype == torch.float32
        err = float((full - half).abs().max())
        assert 0 < err < BF16_TOL
        assert torch.equal(full, g[0].reshape(-1))
    finally:
        dist.destroy_process_group()


def test_empty_tree_guards():
    assert allreduce_mean([], None, strategy="zero1") == []
    assert allreduce_mean([], None, strategy="bucketed") == []
    with pytest.raises(ValueError, match="compress"):
        allreduce_mean([torch.zeros(2)], None, compress="fp8")
    with pytest.raises(ValueError, match="empty"):
        reduce_scatter_mean([], None)
    with pytest.raises(ValueError, match="empty"):
        plan_buckets(0, bucket_bytes=1024)


# --------------------------------------------------------------------------
# tests/test_zero23.py twins
# --------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["zero2", "zero3"])
@pytest.mark.parametrize("overlap", [False, True, "serial"])
def test_matches_sequential(single, strategy, overlap):
    assert max(r[f"seq_{strategy}_{overlap}"] for r in single) < ADAM_TOL


def test_zero3_physical_residency_one_pth(single):
    for r in single:
        z = r["z3_residency"]
        assert z["shard_len"] == (N_PARAMS + (-N_PARAMS) % 8) // 8
        assert z["state_max"] == z["shard_len"]
        # the masters are views of a storage freed between steps
        assert z["param_storage_max"] == 0 and z["full_storage"] == 0
        assert z["grads"] == 0
        assert z["big_live"] == []


def test_zero2_grad_shard_is_persistent_state(single):
    for r in single:
        n_grads, moments, shard_len = r["z2_grads"]
        assert n_grads == 0 and moments == [shard_len]


def test_zero3_per_shard_init_live_buffers(single):
    for r in single:
        assert r["z3_init"]["big_live"] == []
        assert r["z3_init"]["shard"] == (N_PARAMS + (-N_PARAMS) % 8) // 8
        assert np.isfinite(r["z3_init"]["loss"])


def test_backward_accumulates_into_the_flat_gradient(single):
    """Every master's ``.grad`` is a view of the flat buffer, and the
    backward filled it in place (none was replaced)."""
    for r in single:
        n_views, n_masters, filled = r["grad_views"]
        assert n_views == n_masters == 6 and filled


def test_layout_mismatch_raises(single):
    kinds, bucket, tuple_state = single[0]["mismatch"]
    assert kinds.startswith("ValueError") and "zero3" in kinds \
        and "zero1" in kinds
    assert bucket.startswith("ValueError") and "bucket" in bucket.lower()
    assert tuple_state.startswith("TypeError") and "TrainState" in tuple_state


def test_sequential_and_replicated_share_contract(single):
    assert all(r["shared_contract"] == 3 for r in single)


def test_describe_reports_one_pth_memory(single):
    kind, z3, rep = single[0]["describe"]
    assert kind == "zero3"
    shard = (N_PARAMS + (-N_PARAMS) % 8) // 8
    assert z3 == {"params": 4 * shard, "grads": 4 * shard,
                  "opt_state": 8.0 * shard}
    assert rep == {"params": 4 * N_PARAMS, "grads": 4 * N_PARAMS,
                   "opt_state": 8.0 * N_PARAMS}


# --------------------------------------------------------------------------
# tests/test_overlap.py twins
# --------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["flat", "bucketed", "zero1"])
def test_overlap_equivalence_single_pod(single, strategy):
    assert max(max(r[f"ov_{strategy}"]) for r in single) < ADAM_TOL


def test_overlap_issues_next_bucket_before_finishing(single):
    """overlap=True: bucket k+1 is issued before bucket k is finished
    (the reduce-scatter's and the all-gather's pipelines, 11 buckets of
    64 KiB each); "serial": every bucket finishes before the next is
    issued."""
    ev = [tuple(e) for e in single[0]["spy_True"]]
    n = plan_buckets(N_PARAMS, bucket_bytes=1 << 16, align=8).n_buckets
    assert n == 11
    one = [("issue", 0)]
    for k in range(1, n):
        one += [("issue", k), ("finish", k - 1)]
    one += [("finish", n - 1)]
    assert ev == one * 2
    ser = [tuple(e) for e in single[0]["spy_serial"]]
    assert ser == [(a, k) for k in range(n)
                   for a in ("issue", "finish")] * 2


def test_overlap_equivalence_hier_multipod(multi):
    for r in multi:
        for s, errs in r["hier_ov"].items():
            assert max(errs) < ADAM_TOL, s


# --------------------------------------------------------------------------
# zero1_hier / zero3_hier on the (2, 4) pod x data mesh
# --------------------------------------------------------------------------

def test_hier_worker_numbering_is_intra_major(multi):
    """The reference's ``dp_axes`` order ("data", "pod"): the rank at
    data index i of pod k is worker i * 2 + k; in mesh order it is the
    rank itself."""
    for rank, r in enumerate(multi):
        pod, data, hier, plain = r["worker"]
        assert (pod, data) == divmod(rank, 4)
        assert hier == data * 2 + pod and plain == rank


def test_hier_reduce_scatter_lands_on_local_shard(multi):
    """Shard identity: the two-level reduce-scatter leaves each worker
    the slice ``local_shard`` (and, bucketed, ``plan_local_shard``)
    assigns it under the intra-major numbering."""
    for r in multi:
        assert max(r["hier_shard"]) < 1e-6


def test_zero1_hier_matches_sequential_on_pod_data_mesh(multi):
    padded = N_PARAMS + (-N_PARAMS) % 8
    for r in multi:
        assert r["hier_layout"] == ["zero1_hier", ["data", "pod"], 8,
                                    padded // 8, padded // 8]
        assert r["hier_seq"] < ADAM_TOL
        assert r["hier_seq3"] < ADAM_TOL
        assert max(r["hier_micro"].values()) < ADAM_TOL


# --------------------------------------------------------------------------
# the registry (tests/test_strategy.py:63)
# --------------------------------------------------------------------------

def test_registry_lists_all_eight_and_rejects_duplicates():
    names = available_strategies()
    assert names[:8] == ("flat", "bucketed", "hierarchical", "zero1",
                         "zero2", "zero3", "zero1_hier", "zero3_hier")
    with pytest.raises(ValueError, match="already registered"):
        register_strategy(FlatStrategy())
    register_strategy(get_strategy("flat"), overwrite=True)
    with pytest.raises(TypeError):
        register_strategy("flat")

    class Forgot(ShardedStrategy):
        name = "forgot_kind"

    with pytest.raises(ValueError, match="declare its own kind"):
        register_strategy(Forgot())
    assert "forgot_kind" not in available_strategies()
    assert not Layout("replicated", (), 1, 4, 4).sharded
    for name in names[3:8]:
        s = get_strategy(name)
        assert s.sharded and s.kind == name
        assert Layout(s.kind, ("data",), 2, 7, 8).sharded
    assert get_strategy("zero3").params_sharded
    assert get_strategy("zero3_hier").params_sharded
    with pytest.raises(ValueError) as ei:
        get_strategy("definitely_not_registered")
    assert "zero1_hier" in str(ei.value) and "register" in str(ei.value)


def test_hier_strategies_validate_overlap():
    """tests/test_elastic.py:455: overlap=True is a first-class
    configuration of both hier kinds."""
    dp = DPConfig(strategy="zero1_hier", overlap=True, bucket_bytes=1 << 16)
    for name in ("zero1_hier", "zero3_hier"):
        get_strategy(name).validate(dp, None)
        assert get_strategy(name).bucket_layout(dp) == 1 << 16
    with pytest.raises(ValueError, match="sync='grads'"):
        get_strategy("zero1").validate(DPConfig(sync="weights"), None)


def test_custom_sharded_strategy_roundtrips_through_trainer(single):
    for r in single:
        toy = r["toy"]
        assert toy["err"] == 0.0          # the same algorithm, bit for bit
        assert toy["meta"]["strategy"] == "toy_zero1"
        assert toy["meta"]["kind"] == "toy_zero1"
        assert toy["restored"] == [3, 0.0, 0.0]
        assert np.isfinite(toy["loss"])


def test_restore_of_unregistered_strategy_lists_names(single):
    for r in single:
        msg = r["vanished"]
        assert "vanished_plugin" in msg and "zero1_hier" in msg \
            and "register" in msg


def test_zero3_template_never_holds_the_full_vector(single):
    for r in single:
        z = r["z3_template"]
        assert z["big_live"] == [] and z["at"] == 2 and z["err"] == 0.0
        assert np.isfinite(z["loss"])


# --------------------------------------------------------------------------
# plan_buckets: the reference's partition exactly
# --------------------------------------------------------------------------

def _same_plan(kw):
    got, want = plan_buckets(**kw), jax_plan_buckets(**kw)
    assert (got.starts, got.lengths, got.align, got.total,
            got.padded_total) == (want.starts, want.lengths, want.align,
                                  want.total, want.padded_total)
    for n in {1, kw.get("align", 1)}:
        assert got.shard_offsets(n) == want.shard_offsets(n)
    return got


@settings(max_examples=200, deadline=None)
@given(total=st.integers(1, 1 << 22), align=st.integers(1, 64),
       bucket_bytes=st.integers(1, 1 << 24),
       itemsize=st.sampled_from([2, 4]))
def test_plan_buckets_equals_reference(total, align, bucket_bytes, itemsize):
    assume(total * itemsize // bucket_bytes < 50_000)     # bucket count
    _same_plan(dict(total=total, align=align, bucket_bytes=bucket_bytes,
                    itemsize=itemsize))


@pytest.mark.parametrize("total,align,bucket_bytes", [
    (178_110, 8, 1 << 16), (64, 8, 1 << 30), (7, 4, 16),
    (1 << 20, 1, 1 << 18), (8, 8, 4), (513, 8, 512),
])
def test_plan_buckets_roundtrip(total, align, bucket_bytes):
    plan = _same_plan(dict(total=total, align=align,
                           bucket_bytes=bucket_bytes))
    assert plan.padded_total == total + (-total) % align
    off = 0
    for s, ln in zip(plan.starts, plan.lengths):
        assert s == off and ln > 0 and ln % align == 0
        off += ln
    assert off == plan.padded_total
    offs, shard_len = plan.shard_offsets(align)
    assert shard_len == plan.padded_total // align
    assert offs[0] == 0 and len(offs) == plan.n_buckets


def test_plan_buckets_per_leaf():
    sizes = [200, 784 * 200, 100, 200 * 100, 10, 100 * 10]
    plan = _same_plan(dict(total=sum(sizes), bucket_bytes=1,
                           leaf_sizes=sizes))
    assert plan.lengths == tuple(sizes)
    with pytest.raises(ValueError):
        plan_buckets(10, bucket_bytes=1, align=4, leaf_sizes=[10])
