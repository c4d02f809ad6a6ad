"""The port's checkpoint store against the reference's, on the CPU.

The on-disk format is the contract: a checkpoint either package writes
restores in the other.

* Reference -> port: a sharded checkpoint of the reference's sequential
  trainer restores into the port's trainer bitwise (masters, m, v,
  step) and serves bitwise-equal greedy tokens; the reference's legacy
  npz of ``(params, opt_state)`` restores and serves alike.
* Port -> reference: the port's checkpoint restores in the reference's
  ``Trainer.restore`` bitwise, and the next losses agree to 1e-5; one
  written by 2 gloo ranks restores through the reference's cross-layout
  branch, which reads the leaves by ORDER (the order trap).
* Both packages write the same ``meta.json`` layout and manifest and the
  same npz members, in the same order.
* Restore and one step equal the uninterrupted step bit for bit.
* Twins of the reference's store claims (``tests/test_checkpoint.py``),
  a reference zero1 checkpoint restored into the port, refusals by
  name, and the launchers' checkpoint flags.

The smoke config runs in fp32, as ``tests/test_torch_train.py`` runs it.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import ROOT, run_ranks

from repro import checkpoint as jax_ckpt
from repro.api import Trainer as JaxTrainer
from repro.configs import smoke_config as jax_smoke
from repro.serve import make_engine_from_checkpoint as jax_engine_from_ckpt
from repro_torch import bridge, optim
from repro_torch.api import Trainer
from repro_torch.checkpoint import (CorruptCheckpointError, latest_step,
                                    restore_checkpoint, restore_serve_params,
                                    save_checkpoint, save_sharded_checkpoint,
                                    state_tree)
from repro_torch.checkpoint.store import _flatten as port_flatten
from repro_torch.configs import smoke_config
from repro_torch.configs.paper_nets import HIGGS_DNN, MNIST_DNN
from repro_torch.core.train_state import Layout
from repro_torch.launch import mnist_dnn_dp
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import apply_paper_net, init_paper_net
from repro_torch.serve import make_engine_from_checkpoint
from repro_torch.train import cross_entropy

torch.set_num_threads(2)

LR = 1e-3
# the reference's fp32 training bar (ROADMAP A.1): a loss taken after a
# restore, by the other package, from bitwise-equal state
LOSS_TOL = 1e-5
# greedy serving: the scheduler of tests/test_torch_serve.py
SCHED = dict(batch_size=2, max_len=128, page_size=8, prefill_chunk=32,
             decode_chunk=4)
LENGTHS, NEW = [5, 40, 19], 8


def _batch(seed, cfg, b=4, s=32):
    return {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _ref_leaves(tree):
    """{reference path: numpy array} of a reference pytree."""
    return {k: np.asarray(v) for k, v in
            jax_ckpt.store._flatten(tree).items()}


def _port_leaves(state):
    """The port's keys and host copies, in the port's own order."""
    return port_flatten(state_tree(state))


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def cfgs():
    return (jax_smoke("qwen3-1.7b").with_overrides(dtype="float32"),
            smoke_config("qwen3-1.7b").with_overrides(dtype="float32"))


@pytest.fixture(scope="module")
def ref_run(cfgs, tmp_path_factory):
    """The reference's sequential trainer after 2 AdamW steps, saved
    through its sharded store and as its legacy npz."""
    jcfg, cfg = cfgs
    t = JaxTrainer.create(jcfg, optimizer="adamw", lr=LR)
    for i in range(2):
        t.step({"tokens": jnp.asarray(_batch(i, cfg)["tokens"])})
    d = tmp_path_factory.mktemp("ref")
    t.save(d / "sharded", extra={"by": "reference"})
    jax_ckpt.save_checkpoint(d / "legacy", 2, (t.state.params,
                                               t.state.opt_state))
    state = {"params": t.state.params, "opt_state": t.state.opt_state,
             "step": t.state.step}
    return t, d, _ref_leaves(state)


@pytest.fixture(scope="module")
def port_run(cfgs, ref_run, tmp_path_factory):
    """The port's sequential trainer from the reference's initial
    weights after the same 2 steps, saved; its next loss."""
    jcfg, cfg = cfgs
    from repro.models import init_model as jax_init
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    t = Trainer.create(cfg, optimizer="adamw", lr=LR, device="cpu",
                       params=bridge.params_from_jax(tree, cfg, device="cpu",
                                                     train=True))
    for i in range(2):
        t.step(_batch(i, cfg))
    d = tmp_path_factory.mktemp("port")
    t.save(d, extra={"by": "reference"})
    leaves = _port_leaves(t.state)
    nxt = float(t.step(_batch(2, cfg))["loss"])
    return d, leaves, nxt


@pytest.fixture
def one_thread():
    """For bitwise comparisons of two training runs: the CPU's
    multi-threaded backward does not sum in a fixed order (two runs of
    the smoke config in one process at 2 threads differ in the last
    bits), one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in LENGTHS]


# --------------------------------------------------------------------------
# reference -> port
# --------------------------------------------------------------------------

def test_reference_sharded_checkpoint_restores_and_serves_in_port(
        cfgs, ref_run):
    """Bitwise masters, moments and step; greedy tokens bitwise equal to
    the reference's own engine on the same checkpoint (decode_kernel
    xla)."""
    jcfg, cfg = cfgs
    _, d, want = ref_run
    t = Trainer.create(cfg, optimizer="adamw", lr=LR, seed=7, device="cpu")
    assert t.restore(d / "sharded") == 2
    assert t.state.step == 2 and t.state.opt_state["step"] == 2
    _assert_same(_port_leaves(t.state), want)
    jeng = jax_engine_from_ckpt(d / "sharded",
                                jcfg.with_overrides(decode_kernel="xla"),
                                **SCHED)
    eng = make_engine_from_checkpoint(d / "sharded", cfg, device="cpu",
                                      **SCHED)
    assert eng.restored_step == jeng.restored_step == 2
    for a, b in zip(jeng.generate(_prompts(cfg), NEW),
                    eng.generate(_prompts(cfg), NEW)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the trainer's own engine casts the same masters: the same tokens
    for a, b in zip(eng.generate(_prompts(cfg), NEW),
                    t.serve(**SCHED).generate(_prompts(cfg), NEW)):
        np.testing.assert_array_equal(a, b)


def test_reference_legacy_npz_restores_and_serves_in_port(cfgs, ref_run):
    """The reference's legacy ``(params, opt_state)`` npz (keys 0/...,
    1/...): the serve restore gives the reference's params bitwise, the
    engine the sharded checkpoint's tokens, and the train restore the
    whole state."""
    _, cfg = cfgs
    _, d, want = ref_run
    tree, at = restore_serve_params(d / "legacy", cfg)
    assert at == 2
    got = {f"params/{k}": v for k, v in port_flatten(tree).items()}
    _assert_same(got, {k: v for k, v in want.items()
                       if k.startswith("params/")})
    toks = [make_engine_from_checkpoint(d / kind, cfg, device="cpu",
                                        **SCHED).generate(_prompts(cfg), NEW)
            for kind in ("legacy", "sharded")]
    for a, b in zip(*toks):
        np.testing.assert_array_equal(a, b)
    t = Trainer.create(cfg, optimizer="adamw", lr=LR, seed=7, device="cpu")
    assert t.restore(d / "legacy") == 2
    _assert_same(_port_leaves(t.state), want)


# --------------------------------------------------------------------------
# port -> reference
# --------------------------------------------------------------------------

def test_port_checkpoint_restores_in_reference(cfgs, ref_run, port_run):
    """Bitwise params and opt_state through the reference's
    ``Trainer.restore`` (its same-layout branch); the reference's next
    loss equals the port's within 1e-5."""
    jcfg, cfg = cfgs
    d, leaves, port_next = port_run
    jt = JaxTrainer.create(jcfg, optimizer="adamw", lr=LR,
                           key=jax.random.PRNGKey(9))
    assert jt.restore(d) == 2
    _assert_same(_ref_leaves({"params": jt.state.params,
                              "opt_state": jt.state.opt_state,
                              "step": jt.state.step}), leaves)
    ref_next = float(jt.step({"tokens": jnp.asarray(
        _batch(2, cfg)["tokens"])})["loss"])
    assert abs(ref_next - port_next) <= LOSS_TOL


def test_meta_json_equal_between_packages(ref_run, port_run):
    """The same sequential smoke run in both packages: equal ``layout``,
    equal ``leaves`` (order included), equal ``extra`` and equal npz
    member names in the same order."""
    _, rd, _ = ref_run
    pd, _, _ = port_run
    metas, members = [], []
    for d in (rd / "sharded", pd):
        step = d / "step_0000000002.shards"
        metas.append(json.loads((step / "meta.json").read_text()))
        with np.load(step / "replicated.npz") as f:
            members.append(list(f.files))
        assert sorted(os.listdir(step)) == ["meta.json", "replicated.npz"]
    ref, port = metas
    for key in ("step", "layout", "extra"):
        assert port[key] == ref[key], key
    assert list(port["leaves"].items()) == list(ref["leaves"].items())
    assert members[0] == members[1] == list(ref["leaves"])


ORDER_CODE = """
from repro_torch.api import Trainer
from repro_torch.configs import smoke_config
from repro_torch.core import DPConfig
from repro_torch.launch.mesh import make_dp_mesh

cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
t = Trainer.create(cfg, optimizer="adamw", lr=1e-3,
                   dp=DPConfig(strategy="flat"), mesh=make_dp_mesh(1),
                   seed=0, device="cpu")
rng = np.random.default_rng(3)
for _ in range(2):
    t.step({"tokens": rng.integers(0, cfg.vocab_size, (4, 32))
            .astype(np.int32)})
path = t.save(os.environ["CKPT"])
if RANK == 0:
    np.savez(os.environ["CKPT"] + "-masters.npz", **t.params)
print(json.dumps({"path": path, "step": t.state.step}))
"""


def test_port_checkpoint_from_two_ranks_restores_in_reference(cfgs,
                                                              tmp_path):
    """Written by 2 gloo ranks (``flat``, num_shards 2), the checkpoint
    restores into the reference's sequential trainer (num_shards 1)
    through its cross-layout branch, which concatenates the ``params/``
    and moment leaves in manifest order and splits them in its own: the
    restored params and moments equal the written members bitwise, and
    those equal rank 0's masters through the bridge."""
    jcfg, cfg = cfgs
    ck = tmp_path / "ck"
    res = run_ranks(ORDER_CODE, 2, tmp_path, env={"CKPT": str(ck)})
    assert [r["step"] for r in res] == [2, 2]
    assert res[0]["path"] == res[1]["path"] == str(
        ck / "step_0000000002.shards")
    meta = json.loads((ck / "step_0000000002.shards" / "meta.json")
                      .read_text())
    assert meta["layout"]["num_shards"] == 2
    assert (meta["layout"]["axes"], meta["layout"]["strategy"]) == (
        ["data"], "flat")
    with np.load(ck / "step_0000000002.shards" / "replicated.npz") as f:
        written = {k: f[k] for k in f.files}
    # the members are rank 0's masters under the reference's paths
    with np.load(str(ck) + "-masters.npz") as f:
        masters = {k: torch.from_numpy(f[k]) for k in f.files}
    from repro_torch.models import init_model
    model = init_model(cfg, device="cpu", train=True)
    for path, a in bridge.named_to_numpy(model, masters).items():
        np.testing.assert_array_equal(written[f"params/{path}"], a)
    jt = JaxTrainer.create(jcfg, optimizer="adamw", lr=LR,
                           key=jax.random.PRNGKey(9))
    assert jt.state.layout.num_shards == 1
    assert jt.restore(ck) == 2
    got = _ref_leaves({"params": jt.state.params,
                       "opt_state": jt.state.opt_state,
                       "step": jt.state.step})
    _assert_same(got, {k: written[k] for k in got})


# --------------------------------------------------------------------------
# restart equality
# --------------------------------------------------------------------------

def test_restart_equals_uninterrupted_step(cfgs, tmp_path, one_thread):
    """Save after 2 steps, restore into a trainer drawn from another
    seed, take the third step: loss and every master and moment equal
    the uninterrupted run's bit for bit."""
    _, cfg = cfgs
    t = Trainer.create(cfg, optimizer="adamw", lr=LR, device="cpu")
    for i in range(2):
        t.step(_batch(i, cfg))
    t.save(tmp_path)
    want_loss = float(t.step(_batch(2, cfg))["loss"])
    fresh = Trainer.create(cfg, optimizer="adamw", lr=LR, seed=3,
                           device="cpu")
    fresh.restore(tmp_path)
    assert float(fresh.step(_batch(2, cfg))["loss"]) == want_loss
    _assert_same(_port_leaves(fresh.state), _port_leaves(t.state))


# --------------------------------------------------------------------------
# twins of the reference's store claims (tests/test_checkpoint.py)
# --------------------------------------------------------------------------

def _loss(m, b):
    return cross_entropy(apply_paper_net(MNIST_DNN, m, b["x"]), b["y"])


def _paper_trainer(net=MNIST_DNN, steps=1, optimizer=None):
    t = Trainer.create(loss_fn=_loss, params=init_paper_net(net,
                                                            device="cpu"),
                       optimizer=optimizer or optim.adam(1e-3),
                       device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(steps):
        t.step({"x": rng.standard_normal((8, 784), dtype=np.float32),
                "y": rng.integers(0, 10, 8).astype(np.int32)})
    return t


def test_truncated_tmp_files_are_invisible(tmp_path):
    """A killed worker leaves only tmp- files/dirs; latest_step must
    never pick them up, and the last published step stays restorable."""
    state = {"w": np.arange(6, dtype=np.float32)}
    save_checkpoint(tmp_path, 3, state)
    (tmp_path / "tmp-step_0000000007.npz").write_bytes(b"PK\x03garbage")
    partial = tmp_path / "tmp-step_0000000008.shards"
    partial.mkdir()
    (partial / "replicated.npz").write_bytes(b"trunc")
    assert latest_step(tmp_path) == 3
    (tmp_path / "latest").write_text("")     # kill mid-write: torn marker
    assert latest_step(tmp_path) == 3
    (tmp_path / "latest").unlink()
    assert latest_step(tmp_path) == 3
    save_checkpoint(tmp_path, 4, state)
    assert not (tmp_path / "tmp-latest").exists()
    assert latest_step(tmp_path) == 4
    save_checkpoint(tmp_path, 3, state)      # roll back for the restore
    restored, step = restore_checkpoint(tmp_path, {"w": np.zeros(6)})
    assert step == 3
    np.testing.assert_array_equal(restored["w"], state["w"])
    # a tensor leaf comes back as a tensor of the template's dtype
    restored, _ = restore_checkpoint(tmp_path, {"w": torch.zeros(6)})
    assert torch.equal(restored["w"], torch.arange(6.0))


def test_legacy_save_is_atomic_and_clean(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones(3)})
    names = {p.name for p in tmp_path.iterdir()}
    assert names == {"step_0000000001.npz", "latest"}, names


def test_latest_step_fullmatch_only(tmp_path):
    (tmp_path / "step_0000000005.npz.tmp.npz").write_bytes(b"junk")
    (tmp_path / "xstep_0000000009.npz").write_bytes(b"junk")
    assert latest_step(tmp_path) is None
    (tmp_path / "step_0000000002.npz").write_bytes(b"ok")
    assert latest_step(tmp_path) == 2


def test_sharded_save_is_atomic(tmp_path):
    """One rename publishes the step directory: no tmp- residue, and
    overwriting a step is safe; a replicated state writes no worker
    files."""
    st = _paper_trainer().state
    save_sharded_checkpoint(tmp_path, 1, st)
    save_sharded_checkpoint(tmp_path, 1, st)        # overwrite in place
    assert sorted(os.listdir(tmp_path)) == ["latest",
                                            "step_0000000001.shards"]
    assert sorted(os.listdir(tmp_path / "step_0000000001.shards")) == [
        "meta.json", "replicated.npz"]


def test_restore_rejects_param_count_mismatch(tmp_path):
    save_sharded_checkpoint(tmp_path, 1, _paper_trainer().state)
    other = Trainer.create(loss_fn=_loss, params=init_paper_net(
        HIGGS_DNN, device="cpu"), optimizer=optim.adam(1e-3), device="cpu")
    with pytest.raises(ValueError, match="params"):
        other.restore(tmp_path)


def test_failed_restore_leaves_the_state_as_it_was(tmp_path):
    """A momentum checkpoint has no ``opt_state/v``: restored into an
    adamw trainer it raises before the first tensor is written, so the
    masters, the moments and the step stay as they were (bitwise)."""
    _paper_trainer(steps=2, optimizer=optim.momentum(1e-2)).save(tmp_path)
    t = _paper_trainer(steps=1, optimizer=optim.adamw(1e-3))
    before = _port_leaves(t.state)
    with pytest.raises(ValueError, match="opt_state/v/"):
        t.restore(tmp_path)
    assert t.state.step == 1
    _assert_same(_port_leaves(t.state), before)


def test_torn_member_names_the_file(tmp_path, cfgs):
    """A serve restore reads only the ``params/`` members, but a torn
    file still fails by name."""
    _, cfg = cfgs
    t = Trainer.create(cfg, optimizer="adamw", lr=LR, device="cpu")
    t.save(tmp_path)
    npz = tmp_path / "step_0000000000.shards" / "replicated.npz"
    npz.write_bytes(npz.read_bytes()[:1000])
    with pytest.raises(CorruptCheckpointError, match="replicated.npz"):
        restore_serve_params(tmp_path, cfg)
    t.save(tmp_path / "ok")
    with pytest.raises(ValueError, match="wrong architecture"):
        restore_serve_params(tmp_path / "ok", cfg.with_overrides(
            num_layers=4))


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_reference_zero1_checkpoint_restores_into_port(tmp_path):
    """A ZeRO checkpoint of the reference (zero1 on a 1-device mesh, its
    moments one flat ``opt_state/m/flat`` leaf) restores into the port's
    sequential trainer through the cross-layout branch: masters and
    moments equal the reference's bitwise; the ZeRO layout records
    round-trip."""
    from repro.compat import auto_axis_types, make_mesh
    from repro.configs.paper_nets import MNIST_DNN as JAX_MNIST_DNN
    from repro.core import DPConfig as JaxDPConfig
    from repro.models import init_paper_net as jax_init_net
    mesh = make_mesh((1,), ("data",), axis_types=auto_axis_types(1))
    jt = JaxTrainer.create(
        loss_fn=lambda p, b: jnp.mean(p["layers"][0]["w"] ** 2),
        params=jax_init_net(JAX_MNIST_DNN, jax.random.PRNGKey(0)),
        optimizer="adam", dp=JaxDPConfig(strategy="zero1"), mesh=mesh)
    jt.step({"x": jnp.zeros((8, 784)), "y": jnp.zeros((8,), jnp.int32)})
    jt.save(tmp_path)
    t = _paper_trainer(steps=0)
    assert t.restore(tmp_path) == 1
    want = {f"layers.{i}.{k}": np.asarray(v)
            for i, layer in enumerate(jt.state.params["layers"])
            for k, v in layer.items()}
    assert t.state.opt_state["step"] == 1
    for name in ("m", "v"):
        flat = np.asarray(jt.state.opt_state[name]["flat"])
        got = np.concatenate([t.state.opt_state[name][k].numpy().ravel()
                              for k in sorted(want, key=_ref_order)])
        np.testing.assert_array_equal(got, flat[:got.size])
    for k, v in want.items():
        np.testing.assert_array_equal(t.params[k], v, err_msg=k)
    for kind in ("zero1", "zero2", "zero3", "zero1_hier", "zero3_hier"):
        d = {"kind": kind, "axes": ["data"], "num_shards": 2, "total": 7,
             "padded_total": 8, "bucket_bytes": None, "strategy": kind}
        assert Layout.from_json(d).to_json() == d
        assert Layout.from_json(d).shard_len == 4


def _ref_order(name):
    """A Table-1 master's place in the reference's flatten order."""
    return bridge.reference_order(name.replace(".", "/"))


def test_loss_fn_trainer_serve_refused():
    with pytest.raises(ValueError, match="model_cfg"):
        _paper_trainer(steps=0).serve()


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------

TRAIN = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--batch",
         "4", "--seq", "32"]


def test_train_launcher_killed_and_resumed_equals_straight_run(
        tmp_path, capsys, one_thread):
    """``--ckpt-every 2`` killed at step 4 (exit 113), rerun: it resumes
    at 4 with the data cursor (``--data-seed 3``, which the rerun does
    not pass) and its losses equal a straight 6-step run's bit for bit;
    then ``launch/serve.py --restore`` serves the last step."""
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN,
         "--steps", "6", "--data-seed", "3", "--ckpt", ck, "--ckpt-every",
         "2", "--fault-step", "4"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 113, proc.stderr[-3000:]
    assert "FAULT: killing at step 4" in proc.stdout
    assert sorted(os.listdir(ck)) == ["latest", "step_0000000002.shards",
                                      "step_0000000004.shards"]
    resumed = launch_train.main([*TRAIN, "--steps", "2", "--ckpt", ck,
                                 "--ckpt-every", "2"])
    assert "resumed from step 4" in capsys.readouterr().out
    straight = launch_train.main([*TRAIN, "--steps", "6", "--data-seed",
                                  "3"])
    assert resumed == straight[4:]
    killed = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert killed == [f"step {i:4d}  loss {straight[i]:.4f}"
                      for i in range(4)]
    outs = launch_serve.main(["--arch", "qwen3-1.7b", "--reduced",
                              "--device", "cpu", "--restore", ck,
                              "--batch", "2", "--prompt-len", "9",
                              "--new-tokens", "3"])
    assert "serving checkpoint step 6" in capsys.readouterr().out
    assert [len(o) for o in outs] == [3, 3]


def test_full_config_launcher_saves_the_legacy_npz(tmp_path, monkeypatch,
                                                  one_thread):
    """Without --reduced the launcher writes the legacy npz of
    ``(params, opt_state)`` -- keys 0/... and 1/... -- which restores
    into the one-device state (the full config cut to 2 layers here,
    through the launcher's own config lookup)."""
    small = smoke_config("qwen3-1.7b")
    monkeypatch.setattr(launch_train, "get_config", lambda a: small)
    ck = tmp_path / "ck"
    args = ["--arch", "qwen3-1.7b", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt", str(ck), "--ckpt-every", "1"]
    first = launch_train.main([*args, "--steps", "2"])
    assert sorted(os.listdir(ck)) == ["latest", "step_0000000001.npz",
                                      "step_0000000002.npz"]
    with np.load(ck / "step_0000000002.npz") as f:
        assert {k.split("/")[0] for k in f.files} == {"0", "1",
                                                      "__treedef__"}
        assert "1/step" in f.files and "0/embed/table" in f.files
    again = launch_train.main([*args, "--steps", "1"])
    straight = launch_train.main([*args[:-4], "--steps", "3"])
    assert first + again == straight


def test_mnist_launcher_restart_demo(tmp_path, capsys):
    mnist_dnn_dp.main(["--sequential", "--device", "cpu", "--samples",
                       "512", "--batch", "64", "--epochs", "2", "--steps",
                       "10", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "restart: restored step 10 OK (max|Δ|=0.0e+00)" in out
