"""The port's elastic package, on the CPU: twins of the reference's
``tests/test_elastic.py`` claims at the port's (replicated) layouts.

* async checkpointer -- the save blocks only for the device->host copy;
  publish happens on a daemon thread with a bounded last-publish-wins
  queue; the published files equal a synchronous save's; the snapshot
  is a copy, so an in-place step after ``save`` does not reach it (on
  the CPU a master's ``numpy()`` would alias it);
* store hygiene -- stale ``tmp-`` sweep, ``keep_last``, a corrupt file
  failing loudly by name and ``resume_elastic`` falling back;
* fault injection -- raise mode, the environment, a hard kill with exit
  code 113;
* the elastic resize -- 2 gloo ranks of MNIST-DNN under ``flat`` with
  Adam and a lagging async writer are hard-killed at step 6; 4 ranks
  under ``bucketed`` resume from the last published step (< 6) and their
  losses match an unkilled 4-rank run within 1e-5;
* the reference's acceptance run (``tests/test_elastic.py:369``) at a
  size the suite can hold: 2 x 2 ranks under ``zero1_hier`` (bucket-
  major, every rank's async writer lagging) killed at step 6, resumed
  as 2 ranks under ``zero3`` from what was published.

The zero3_hier cross-layout twin (``test_elastic.py:387``) and the hier
pair in the registry (``:455``) are in ``tests/test_torch_zero_checkpoint
.py`` and ``tests/test_torch_zero.py``; the perf model's claims
(``:426``, ``:439``) wait for ROADMAP A.10.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
from torch import nn

from torch_ranks import ROOT, run_ranks

from repro_torch import optim
from repro_torch.checkpoint import (CorruptCheckpointError, checkpoint_meta,
                                    latest_step, published_steps,
                                    restore_train_state,
                                    save_sharded_checkpoint)
from repro_torch.checkpoint.store import write_state_snapshot
from repro_torch.elastic import (FAULT_EXIT_CODE, AsyncCheckpointer,
                                 FaultInjector, FaultPlan, SimulatedFault,
                                 resume_elastic)
from repro_torch.train import start_state, trainable

# the reference's bar for the resized run (tests/test_elastic.py:369)
RESIZE_TOL = 1e-5


def _tiny_state():
    """A one-process replicated TrainState: params w (12) and b (3),
    Adam state -- the reference's ``_tiny_state``."""
    m = nn.Module()
    m.w = nn.Parameter(torch.arange(12, dtype=torch.float32))
    m.b = nn.Parameter(torch.ones(3))
    return start_state(m, optim.adam(1e-3))


def _slow(delay):
    def writer(ckpt_dir, snap, *, keep_last=None):
        time.sleep(delay)
        return write_state_snapshot(ckpt_dir, snap, keep_last=keep_last)
    return writer


# --------------------------------------------------------------------------
# async checkpointer daemon
# --------------------------------------------------------------------------

def test_async_save_matches_sync_bitwise(tmp_path):
    st = _tiny_state()
    sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
    save_sharded_checkpoint(sync_dir, 5, st, extra={"k": 1})
    with AsyncCheckpointer(async_dir) as ck:
        rec = ck.save(st, 5, extra={"k": 1})
        assert rec["step"] == 5 and rec["bytes"] > 0
        ck.wait()
        stats = ck.stats()
    assert stats["published"] == 1 and stats["steps_behind"] == 0
    a = sync_dir / "step_0000000005.shards"
    b = async_dir / "step_0000000005.shards"
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    for p in a.iterdir():
        if p.suffix == ".npz":
            with np.load(p) as za, np.load(b / p.name) as zb:
                assert za.files == zb.files
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k])
        else:
            assert p.read_bytes() == (b / p.name).read_bytes()


def test_async_queue_last_publish_wins(tmp_path):
    """With a slow writer and max_in_flight=1, intermediate snapshots
    are dropped, the newest always publishes, and save() returns long
    before the write completes (the blocking half is the snapshot)."""
    st = _tiny_state()
    with AsyncCheckpointer(tmp_path, writer=_slow(0.25)) as ck:
        t0 = time.monotonic()
        for s in (1, 2, 3, 4):
            rec = ck.save(st, s)
            assert rec["blocking_s"] < 0.2      # never waits on the writer
        assert time.monotonic() - t0 < 0.5      # 4 saves, no 4 x 0.25 s
        mid = ck.stats()
        assert mid["last_requested_step"] == 4
        assert (mid["steps_behind"] or 0) > 0   # publish genuinely lags
        ck.wait()
        stats = ck.stats()
    assert stats["last_published_step"] == 4    # newest always wins
    assert stats["steps_behind"] == 0
    assert stats["dropped"] >= 1                # some middle step dropped
    assert stats["saves"] == 4
    assert stats["published"] + stats["dropped"] == 4
    steps = published_steps(tmp_path)
    assert steps[-1] == 4 and len(steps) == stats["published"]


def test_async_snapshot_is_consistent_not_live(tmp_path):
    """The snapshot is frozen at save() time: an in-place update of the
    masters and moments before the (delayed) write publishes -- what
    the next optimizer step does -- must not leak into the checkpoint."""
    st = _tiny_state()
    with AsyncCheckpointer(tmp_path, writer=_slow(0.2)) as ck:
        ck.save(st, 1)
        with torch.no_grad():
            for p in trainable(st.params).values():
                p.add_(100.0)
            st.opt_state["m"]["w"].add_(1.0)
        ck.wait()
    tpl = _tiny_state()
    with torch.no_grad():
        tpl.params.w.zero_()
    got, at = restore_train_state(tmp_path, tpl, 1)
    assert at == 1
    assert torch.equal(got.params.w, torch.arange(12, dtype=torch.float32))
    assert torch.equal(got.opt_state["m"]["w"], torch.zeros(12))


def test_async_writer_error_surfaces_on_step_path(tmp_path):
    def bad_writer(ckpt_dir, snap, *, keep_last=None):
        raise OSError("disk full")

    st = _tiny_state()
    ck = AsyncCheckpointer(tmp_path, writer=bad_writer)
    ck.save(st, 1)
    with pytest.raises(RuntimeError, match="LAST PUBLISHED"):
        ck.wait()
    with pytest.raises(RuntimeError, match="LAST PUBLISHED"):
        ck.save(st, 2)


# --------------------------------------------------------------------------
# store hygiene: stale-tmp sweep, retention, corruption
# --------------------------------------------------------------------------

def test_publish_sweeps_stale_tmp_and_keeps_last(tmp_path):
    st = _tiny_state()
    (tmp_path / "tmp-step_0000000009.shards").mkdir(parents=True)
    (tmp_path / "tmp-step_0000000009.shards" / "replicated.npz"
     ).write_bytes(b"trunc")
    (tmp_path / "tmp-step_0000000010.npz").write_bytes(b"PK\x03junk")
    for s in (1, 2, 3, 4):
        save_sharded_checkpoint(tmp_path, s, st, keep_last=2)
    names = {p.name for p in tmp_path.iterdir()}
    assert not any(n.startswith("tmp-") for n in names), names
    assert published_steps(tmp_path) == [3, 4]
    assert latest_step(tmp_path) == 4


def test_keep_last_validation(tmp_path):
    with pytest.raises(ValueError):
        save_sharded_checkpoint(tmp_path, 1, _tiny_state(), keep_last=0)
    with pytest.raises(ValueError):
        AsyncCheckpointer(tmp_path, max_in_flight=0)


def test_corrupt_shard_fails_loudly_and_elastic_falls_back(tmp_path):
    st = _tiny_state()
    save_sharded_checkpoint(tmp_path, 1, st)
    with torch.no_grad():
        st.params.w.add_(1.0)
    save_sharded_checkpoint(tmp_path, 2, st)
    for bad in (tmp_path / "step_0000000002.shards").glob("*.npz"):
        bad.write_bytes(b"PK\x03\x04 truncated mid write")
    tpl = _tiny_state()
    with torch.no_grad():
        tpl.params.w.fill_(-1.0)
    # direct restore of the bad step names the unreadable file and
    # leaves the state untouched
    with pytest.raises(CorruptCheckpointError, match=r"\.npz"):
        restore_train_state(tmp_path, tpl, 2)
    assert torch.equal(tpl.params.w, torch.full((12,), -1.0))
    # the resize driver falls back to the previous published step
    got, at, skipped = resume_elastic(tmp_path, tpl)
    assert at == 1
    assert [s for s, _ in skipped] == [2]
    assert ".npz" in skipped[0][1]
    assert torch.equal(got.params.w, torch.arange(12, dtype=torch.float32))
    # every step corrupt -> loud aggregate error, not a silent zero state
    for bad in (tmp_path / "step_0000000001.shards").glob("*.npz"):
        bad.write_bytes(b"also dead")
    with pytest.raises(CorruptCheckpointError, match="every candidate"):
        resume_elastic(tmp_path, tpl)


def test_data_cursor_rides_checkpoint_meta(tmp_path):
    cur = {"data_cursor": {"data_seed": 7, "next_step": 42}}
    save_sharded_checkpoint(tmp_path, 42, _tiny_state(), extra=cur)
    assert checkpoint_meta(tmp_path, 42)["extra"]["data_cursor"] == \
        cur["data_cursor"]


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------

def test_fault_injector_raise_mode_fires_once():
    inj = FaultInjector(FaultPlan(3, mode="raise"))
    inj.after_step(1)
    inj.after_step(2)
    with pytest.raises(SimulatedFault):
        inj.after_step(3)
    inj.after_step(4)                       # fires at most once
    assert inj.fired


def test_fault_injector_env_and_validation():
    assert FaultInjector.from_env(env={}) is None
    assert FaultInjector.from_env(env={"REPRO_FAULT_STEP": "-1"}) is None
    inj = FaultInjector.from_env(env={"REPRO_FAULT_STEP": "5",
                                      "REPRO_FAULT_MODE": "raise"})
    assert inj.plan.kill_at_step == 5 and inj.plan.mode == "raise"
    with pytest.raises(ValueError):
        FaultPlan(1, mode="segfault")


def test_fault_injector_hard_kill_exit_code():
    code = textwrap.dedent("""
    from repro_torch.elastic import FaultInjector, FaultPlan
    inj = FaultInjector(FaultPlan(2))
    for i in range(10):
        print('step', i, flush=True)
        inj.after_step(i)
    print('UNREACHABLE')
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.join(ROOT, "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == FAULT_EXIT_CODE == 113, proc.stderr[-2000:]
    assert "FAULT: killing at step 2" in proc.stdout
    assert "UNREACHABLE" not in proc.stdout


# --------------------------------------------------------------------------
# kill 2 flat ranks at step 6, resume as 4 bucketed ranks
# --------------------------------------------------------------------------

COMMON = """
import time
from repro_torch import optim
from repro_torch.api import Trainer
from repro_torch.configs.paper_nets import MNIST_DNN
from repro_torch.core import DPConfig
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.models import apply_paper_net, init_paper_net
from repro_torch.train import cross_entropy

ckpt = os.environ["ELASTIC_CKPT"]
mesh = make_dp_mesh(1)

def batch_of(i):
    rng = np.random.default_rng([7, i])
    return {"x": rng.standard_normal((64, 784), dtype=np.float32),
            "y": rng.integers(0, 10, 64).astype(np.int32)}

def loss_fn(m, b):
    return cross_entropy(apply_paper_net(MNIST_DNN, m, b["x"]), b["y"])

def trainer(dp):
    return Trainer.create(loss_fn=loss_fn,
                          params=init_paper_net(MNIST_DNN, seed=0,
                                                device="cpu"),
                          optimizer=optim.adam(1e-3), dp=dp, mesh=mesh,
                          device="cpu")
"""

KILL_RUN = COMMON + """
from repro_torch.checkpoint.store import write_state_snapshot
from repro_torch.elastic import AsyncCheckpointer, FaultInjector, FaultPlan

def lagging_writer(d, snap, *, keep_last=None):
    time.sleep(0.3)                   # the writer lags ~2 steps behind
    return write_state_snapshot(d, snap, keep_last=keep_last)

t = trainer(DPConfig(strategy="flat"))
inj = FaultInjector(FaultPlan(6))
ck = AsyncCheckpointer(ckpt, writer=lagging_writer) if RANK == 0 else None
for i in range(10):
    m = t.step(batch_of(i))
    time.sleep(0.15)                  # emulated per-step compute: the
                                      # net steps in milliseconds, which
                                      # would let no write finish
    print("KLOSS", i, repr(float(m["loss"])), flush=True)
    if ck is not None:
        ck.save(t.state, i + 1)
    inj.after_step(i + 1)             # hard-kills every rank at step 6
print("UNREACHABLE")
"""

RESUME_RUN = COMMON + """
from repro_torch.checkpoint import published_steps

dp = DPConfig(strategy="bucketed", bucket_bytes=1 << 16)
pub = published_steps(ckpt)
t = trainer(dp)
at, skipped = t.restore_elastic(ckpt)
resumed = {i: float(t.step(batch_of(i))["loss"]) for i in range(at, 10)}
ref = trainer(dp)
reference = {i: float(ref.step(batch_of(i))["loss"]) for i in range(10)}
gap = max(float(np.abs(p - ref.params[k]).max())
          for k, p in t.params.items())
print(json.dumps({"pub": pub, "at": at, "skipped": skipped, "gap": gap,
                  "resumed": resumed, "reference": reference}))
"""


def test_kill_two_flat_ranks_resume_four_bucketed(tmp_path):
    """2 gloo ranks (``flat``) killed at step 6 with the async publish
    lagging; 4 ranks (``bucketed``) resume from the last published step
    through ``resume_elastic``; losses and params after the resume match
    the unkilled 4-rank run within 1e-5."""
    env = {"ELASTIC_CKPT": str(tmp_path / "elastic")}
    outs = run_ranks(KILL_RUN, 2, tmp_path, expect_rc=FAULT_EXIT_CODE,
                     env=env)
    for out in outs:
        assert "FAULT: killing at step 6" in out and "UNREACHABLE" not in out
    pub = published_steps(tmp_path / "elastic")
    assert pub and pub[-1] < 6, pub    # the writer genuinely lagged
    res = run_ranks(RESUME_RUN, 4, tmp_path, env=env)
    assert all(r == res[0] for r in res)
    r = res[0]
    assert r["pub"] == pub and r["at"] == pub[-1] and not r["skipped"]
    assert sorted(map(int, r["resumed"])) == list(range(pub[-1], 10))
    for i, loss in r["resumed"].items():
        assert abs(loss - r["reference"][i]) <= RESIZE_TOL, i
    assert r["gap"] <= RESIZE_TOL


ZERO_KILL_RUN = COMMON + """
from repro_torch.checkpoint.store import write_state_snapshot
from repro_torch.elastic import AsyncCheckpointer, FaultInjector, FaultPlan

mesh = make_dp_mesh(2)

def lagging_writer(d, snap, *, keep_last=None):
    time.sleep(0.3)                   # every rank's writer lags
    return write_state_snapshot(d, snap, keep_last=keep_last)

t = trainer(DPConfig(strategy="zero1_hier", overlap=True,
                     bucket_bytes=1 << 16))
inj = FaultInjector(FaultPlan(6))
ck = AsyncCheckpointer(ckpt, writer=lagging_writer)   # on every rank
for i in range(10):
    m = t.step(batch_of(i))
    time.sleep(0.15)
    print("KLOSS", i, repr(float(m["loss"])), flush=True)
    ck.save(t.state, i + 1)           # each rank its own worker file
    inj.after_step(i + 1)
print("UNREACHABLE")
"""

ZERO_RESUME_RUN = COMMON + """
from repro_torch.checkpoint import published_steps

dp = DPConfig(strategy="zero3")
pub = published_steps(ckpt)
t = trainer(dp)
at, skipped = t.restore_elastic(ckpt)
resumed = {i: float(t.step(batch_of(i))["loss"]) for i in range(at, 10)}
ref = trainer(dp)
reference = {i: float(ref.step(batch_of(i))["loss"]) for i in range(10)}
got, want = t.params, ref.params
gap = max(float(np.abs(p - want[k]).max()) for k, p in got.items())
print(json.dumps({"pub": pub, "at": at, "skipped": skipped, "gap": gap,
                  "resumed": resumed, "reference": reference}))
"""


def test_kill_zero1_hier_resume_as_zero3(tmp_path):
    """The reference's 2 x 16 zero1_hier -> 1 x 8 zero3 acceptance run
    (``tests/test_elastic.py:369``) needs 32 ranks; here 2 pods x 2 ranks
    under zero1_hier (bucket-major shards, every rank writing its own
    worker file through a lagging async writer) are hard-killed at step
    6, and 2 ranks under zero3 resume from the last step rank 0
    published (< 6): the losses to step 10 and the params match an
    unkilled 2-rank zero3 run within 1e-5."""
    env = {"ELASTIC_CKPT": str(tmp_path / "elastic")}
    outs = run_ranks(ZERO_KILL_RUN, 4, tmp_path, expect_rc=FAULT_EXIT_CODE,
                     env=env)
    for out in outs:
        assert "FAULT: killing at step 6" in out and "UNREACHABLE" not in out
    pub = published_steps(tmp_path / "elastic")
    assert pub and pub[-1] < 6, pub
    meta = checkpoint_meta(tmp_path / "elastic", pub[-1])
    assert meta["layout"]["kind"] == "zero1_hier"
    assert meta["layout"]["bucket_bytes"] == 1 << 16
    res = run_ranks(ZERO_RESUME_RUN, 2, tmp_path, env=env)
    assert res[0] == res[1]
    r = res[0]
    assert r["pub"] == pub and r["at"] == pub[-1] and not r["skipped"]
    assert sorted(map(int, r["resumed"])) == list(range(pub[-1], 10))
    for i, loss in r["resumed"].items():
        assert abs(loss - r["reference"][i]) <= RESIZE_TOL, i
    assert r["gap"] <= RESIZE_TOL
