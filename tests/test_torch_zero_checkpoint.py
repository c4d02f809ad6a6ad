"""ZeRO checkpoints in the port, on gloo ranks on the CPU: twins of the
reference's cross-layout claims (``tests/test_checkpoint.py:99`` and
``:139``, ``tests/test_strategy.py:200``, ``tests/test_elastic.py:387``)
and of its store's publish protocol for per-worker files.

* replicated <-> zero1, zero1 -> zero3 (contiguous and bucket-major),
  zero1_hier <-> zero1 and zero3_hier -> zero1 -> zero3_hier, at 4
  workers: the resharded state equals the one trained in the target
  layout within 1e-5 and trains on; a same-layout restore is bitwise;
* across world sizes: 4 workers' zero1 (bucket-major) and zero3
  checkpoints restore on 2 ranks into zero3 and into ``flat``, and
  in one process into the sequential state, bitwise;
* every rank writes its own ``worker_%05d.npz``; rank 0 publishes only
  once every worker's file is there, so a missing one leaves the step
  unpublished and ``resume_elastic`` falls back past it; an async save
  of a sharded state waits for room in its queue instead of dropping.
"""
import json

import numpy as np
import pytest

from torch_ranks import run_ranks

from repro_torch import optim
from repro_torch.checkpoint import published_steps, save_sharded_checkpoint
from repro_torch.checkpoint import store
from repro_torch.elastic import AsyncCheckpointer, resume_elastic

# the reference's bar for a resharded state against one trained in the
# target layout (tests/test_checkpoint.py:99)
TOL = 1e-5

COMMON = """
from repro_torch import optim
from repro_torch.api import Trainer
from repro_torch.configs.paper_nets import MNIST_DNN
from repro_torch.core import DPConfig
from repro_torch.core.train_state import assemble_full_flat, gather_shards
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.models import apply_paper_net, init_paper_net
from repro_torch.train import cross_entropy, trainable

d = os.environ["CKPT"]
rng = np.random.default_rng(0)
batch = {"x": rng.standard_normal((64, 784), dtype=np.float32),
         "y": rng.integers(0, 10, 64).astype(np.int32)}

def loss_fn(m, b):
    return cross_entropy(apply_paper_net(MNIST_DNN, m, b["x"]), b["y"])

def trainer(dp, mesh, seed=RANK):
    return Trainer.create(loss_fn=loss_fn,
                          params=init_paper_net(MNIST_DNN, seed=seed,
                                                device="cpu"),
                          optimizer=optim.adam(1e-3), dp=dp, mesh=mesh,
                          device="cpu")

def trained(dp, mesh, steps=3):
    t = trainer(dp, mesh)
    for _ in range(steps):
        t.step(batch)
    return t

def moments(t):
    # the canonical (flatten-order, unpadded) moments, on every rank
    st = t.state
    if st.layout.sharded:
        return {k: assemble_full_flat(gather_shards(
                    st.opt_state[k]["flat"], t.mesh, st.layout.axes),
                    st.layout)[:st.layout.total] for k in ("m", "v")}
    from repro_torch.core.flat import flat_spec
    spec = flat_spec(st.params, trainable(st.params))
    return {k: np.concatenate([st.opt_state[k][n].numpy().ravel()
                               for n in spec.names]) for k in ("m", "v")}

def gap(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)
"""

WRITE = COMMON + """
mesh = make_dp_mesh(1)
pod = make_dp_mesh(2)
B = dict(bucket_bytes=1 << 16)
out = {}
flat_t = trained(DPConfig(strategy="flat"), mesh)
z1 = trained(DPConfig(strategy="zero1"), mesh)
flat_t.save(d + "/rep")
z1.save(d + "/z1")

# tests/test_checkpoint.py:99 -- replicated -> zero1 and back
t = trainer(DPConfig(strategy="zero1"), mesh, seed=50 + RANK)
at = t.restore(d + "/rep")
out["rep_to_z1"] = [at, t.state.opt_state["step"], gap(t.params, z1.params),
                    gap(moments(t), moments(z1))]
t = trainer(DPConfig(strategy="flat"), mesh, seed=50 + RANK)
at = t.restore(d + "/z1")
out["z1_to_rep"] = [at, gap(t.params, flat_t.params),
                    gap(moments(t), moments(flat_t)),
                    float(t.step(batch)["loss"])]

# tests/test_checkpoint.py:139 -- zero1 -> zero3, contiguous and
# bucket-major
for name, dp in (("z3", DPConfig(strategy="zero3")),
                 ("z3b", DPConfig(strategy="zero3", overlap=True, **B))):
    t = trainer(dp, mesh, seed=50 + RANK)
    t.restore(d + "/z1")
    ref = trained(dp, mesh)
    out[f"z1_to_{name}"] = [gap(t.params, ref.params),
                            t.state.flat.shard.numel(),
                            t.state.layout.shard_len]

# same layout: bitwise, each rank from its own worker file
zb = trained(DPConfig(strategy="zero1", overlap=True, **B), mesh)
zb.save(d + "/z1b")
z3 = trained(DPConfig(strategy="zero3"), mesh)
z3.save(d + "/z3")
t = trainer(DPConfig(strategy="zero1", overlap=True, **B), mesh,
            seed=50 + RANK)
t.restore(d + "/z1b")
out["z1b_same"] = [gap(t.params, zb.params), gap(moments(t), moments(zb))]

# tests/test_strategy.py:200 -- zero1_hier <-> zero1 on the pod mesh
th = trained(DPConfig(strategy="zero1_hier"), pod)
t1 = trained(DPConfig(strategy="zero1"), pod)
th.save(d + "/hier")
fresh = trainer(DPConfig(strategy="zero1_hier"), pod, seed=50 + RANK)
fresh.restore(d + "/hier")
tz = trainer(DPConfig(strategy="zero1"), pod, seed=50 + RANK)
tz.restore(d + "/hier")
out["hier"] = [gap(fresh.params, th.params),
               gap(moments(fresh), moments(th)),
               gap(tz.params, t1.params), gap(moments(tz), moments(t1)),
               float(tz.step(batch)["loss"])]

# tests/test_elastic.py:387 -- zero3_hier (bucket-major) on the pod mesh
# reshards into zero1 on the flat mesh, and back
h3 = trained(DPConfig(strategy="zero3_hier", overlap=True, **B), pod)
h3.save(d + "/h3")
t = trainer(DPConfig(strategy="zero1"), mesh, seed=50 + RANK)
t.restore(d + "/h3")
back = trainer(DPConfig(strategy="zero3_hier", overlap=True, **B), pod,
               seed=60 + RANK)
t.save(d + "/h3_z1")
back.restore(d + "/h3_z1")
out["h3"] = [gap(t.params, z1.params), gap(back.params, h3.params),
             gap(moments(back), moments(h3))]

canon = {"z1b_params": zb.params, "z3_params": z3.params}
mz1b, mz3 = moments(zb), moments(z3)
if RANK == 0:
    np.savez(d + "/canon.npz",
             **{f"z1b/params/{k}": v for k, v in zb.params.items()},
             **{f"z3/params/{k}": v for k, v in canon["z3_params"].items()},
             **{f"z1b/{k}": v for k, v in mz1b.items()},
             **{f"z3/{k}": v for k, v in mz3.items()})
print(json.dumps(out))
"""

READ = COMMON + """
mesh = make_dp_mesh(1)
want = dict(np.load(d + "/canon.npz"))
out = {}
for src in ("z1b", "z3"):
    for name, dp in (("zero3", DPConfig(strategy="zero3")),
                     ("flat", DPConfig(strategy="flat"))):
        t = trainer(dp, mesh, seed=70 + RANK)
        at = t.restore(f"{d}/{src}")
        p, m = t.params, moments(t)
        out[f"{src}->{name}"] = [at] + [
            float(np.abs(p[k] - want[f"{src}/params/{k}"]).max()) for k in p
        ] + [float(np.abs(m[k] - want[f"{src}/{k}"]).max()) for k in m]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero_ckpt")
    res = run_ranks(WRITE, 4, d, env={"CKPT": str(d)}, timeout=300)
    return d, res


def test_cross_layout_replicated_zero1_roundtrip(ckpts):
    for r in ckpts[1]:
        at, opt_step, p, m = r["rep_to_z1"]
        assert (at, opt_step) == (3, 3) and p < TOL and m < TOL
        at, p, m, loss = r["z1_to_rep"]
        assert at == 3 and p < TOL and m < TOL and np.isfinite(loss)


@pytest.mark.parametrize("target", ["z3", "z3b"])
def test_cross_layout_zero1_to_zero3_and_bucket_major(ckpts, target):
    for r in ckpts[1]:
        err, n, shard_len = r[f"z1_to_{target}"]
        assert err < TOL and n == shard_len


def test_same_layout_restore_is_bitwise(ckpts):
    assert all(r["z1b_same"] == [0.0, 0.0] for r in ckpts[1])


def test_zero1_hier_checkpoint_cross_layout(ckpts):
    d, res = ckpts
    meta = json.loads((d / "hier" / "step_0000000003.shards" / "meta.json")
                      .read_text())
    assert meta["layout"]["strategy"] == "zero1_hier"
    assert meta["layout"]["axes"] == ["data", "pod"]
    for r in res:
        same_p, same_m, p, m, loss = r["hier"]
        assert same_p == same_m == 0.0
        assert p < TOL and m < TOL and np.isfinite(loss)


def test_zero3_hier_checkpoint_cross_layout(ckpts):
    d, res = ckpts
    names = sorted(f.name for f in (d / "h3" / "step_0000000003.shards")
                   .iterdir())
    assert names == ["meta.json", "replicated.npz"] + [
        f"worker_{w:05d}.npz" for w in range(4)]
    for r in res:
        to_z1, back, back_m = r["h3"]
        assert to_z1 < TOL and back == back_m == 0.0


def test_restore_across_world_sizes_bitwise(ckpts, tmp_path):
    """4 workers' zero1 (bucket-major) and zero3 checkpoints, on 2 ranks
    into zero3 and flat, and in one process into the sequential state:
    masters and moments equal the writers' bitwise."""
    d, _ = ckpts
    res = run_ranks(READ, 2, tmp_path, env={"CKPT": str(d)})
    for r in res:
        for key, (at, *gaps) in r.items():
            assert at == 3 and max(gaps) == 0.0, key
    from repro_torch.api import Trainer
    from repro_torch.configs.paper_nets import MNIST_DNN
    from repro_torch.models import apply_paper_net, init_paper_net
    from repro_torch.train import cross_entropy
    want = dict(np.load(d / "canon.npz"))
    for src in ("z1b", "z3"):
        t = Trainer.create(
            loss_fn=lambda m, b: cross_entropy(
                apply_paper_net(MNIST_DNN, m, b["x"]), b["y"]),
            params=init_paper_net(MNIST_DNN, seed=9, device="cpu"),
            optimizer=optim.adam(1e-3), device="cpu")
        assert t.restore(d / src) == 3
        for k, v in t.params.items():
            np.testing.assert_array_equal(v, want[f"{src}/params/{k}"])


# --------------------------------------------------------------------------
# the per-worker publish protocol
# --------------------------------------------------------------------------

def _sharded_snap(step, workers, n=2):
    meta = {"step": step, "layout": {"kind": "zero1", "axes": ["data"],
                                     "num_shards": n, "total": 4,
                                     "padded_total": 4, "bucket_bytes": None,
                                     "strategy": "zero1"},
            "treedef": "", "leaves": {}}
    return store.StateSnapshot(
        step, meta, {"step": np.asarray(step, np.int32)},
        per_worker={w: {"opt_state/m/flat": np.zeros(2, np.float32)}
                    for w in workers}, n_workers=n, token=f"t{step}")


def test_publish_waits_for_every_worker_file(tmp_path, monkeypatch):
    """Rank 0 publishes a sharded step only once every worker's file is
    in the staging directory: with worker 1's file missing (its rank
    died mid-save) the step stays unpublished, and the newest published
    step is still the one before."""
    monkeypatch.setattr(store, "PUBLISH_TIMEOUT_S", 0.3)
    store.write_state_snapshot(tmp_path, _sharded_snap(2, [0, 1]))
    assert published_steps(tmp_path) == [2]
    with pytest.raises(TimeoutError, match=r"worker files \[1\]"):
        store.write_state_snapshot(tmp_path, _sharded_snap(4, [0]))
    assert published_steps(tmp_path) == [2]
    assert store.latest_step(tmp_path) == 2
    # the other rank's file, written later, completes nothing on its own
    late = _sharded_snap(4, [1])
    late.writer = False
    store.write_state_snapshot(tmp_path, late)
    assert published_steps(tmp_path) == [2]
    # a later publish sweeps the abandoned staging of step 4
    store.write_state_snapshot(tmp_path, _sharded_snap(6, [0, 1]))
    assert published_steps(tmp_path) == [2, 6]
    assert not [f for f in tmp_path.iterdir() if f.name.startswith("tmp-")]


def test_sweep_spares_later_staging_of_other_ranks(tmp_path):
    """A sharded publish sweeps only the staging of steps up to its own:
    another rank may already be writing a later step."""
    later = tmp_path / "tmp-step_0000000009-tok.shards"
    later.mkdir(parents=True)
    stale = tmp_path / "tmp-step_0000000001-old.shards"
    stale.mkdir()
    store.write_state_snapshot(tmp_path, _sharded_snap(3, [0, 1]))
    assert later.exists() and not stale.exists()


def test_async_sharded_save_waits_instead_of_dropping(tmp_path,
                                                     monkeypatch):
    """Ranks that dropped different snapshots would leave steps no rank
    can publish, so a sharded save waits for room in the queue: every
    requested step publishes, none is dropped."""
    import threading
    import repro_torch.elastic.async_ckpt as ac
    gate = threading.Event()

    def slow(d, snap, *, keep_last=None):
        gate.wait(30)
        return store.write_state_snapshot(d, snap, keep_last=keep_last)

    class Fake:
        def __init__(self, step):
            self.step = step

    monkeypatch.setattr(ac, "snapshot_train_state",
                        lambda st, at, extra=None: _sharded_snap(at, [0, 1]))
    ck = AsyncCheckpointer(tmp_path, writer=slow)
    ck.save(Fake(1))
    ck.save(Fake(2))
    while not ck.stats()["queued"] == 2:       # 1 writing, 2 queued
        threading.Event().wait(0.01)
    third = threading.Thread(target=ck.save, args=(Fake(3),))
    third.start()
    third.join(0.5)
    assert third.is_alive()                    # waiting for room
    gate.set()
    third.join(30)
    assert not third.is_alive()
    ck.wait()
    st = ck.stats()
    assert (st["saves"], st["published"], st["dropped"]) == (3, 3, 0)
    assert published_steps(tmp_path) == [1, 2, 3]
    ck.close()


def test_elastic_falls_back_past_an_unpublished_sharded_step(tmp_path):
    """A torn sharded save never published, so ``resume_elastic`` resumes
    the newest step that was (the store's atomic publish, per worker)."""
    from repro_torch.train import start_state
    from torch import nn
    import torch
    model = nn.Linear(2, 2)
    st = start_state(model, optim.adam(1e-3))
    save_sharded_checkpoint(tmp_path, 1, st)
    (tmp_path / "tmp-step_0000000002-x.shards").mkdir()
    (tmp_path / "tmp-step_0000000002-x.shards" / "worker_00000.npz"
     ).write_bytes(b"trunc")
    fresh = start_state(nn.Linear(2, 2), optim.adam(1e-3))
    _, at, skipped = resume_elastic(tmp_path, fresh)
    assert at == 1 and not skipped
    for a, b in zip(fresh.params.parameters(), model.parameters()):
        assert torch.equal(a, b)
