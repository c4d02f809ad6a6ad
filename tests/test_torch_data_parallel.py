"""The paper's claims in the port, on gloo ranks on the CPU.

* §3.3.3: synchronous gradient averaging over p ranks equals sequential
  large-batch SGD -- for ``flat``, ``bucketed`` and ``hierarchical``,
  on the reference's meshes (8,) and (2, 4), through the ``Trainer``
  facade, within the reference's 1e-6 after 5 SGD steps on MNIST-DNN;
  ``compress="bf16"`` within its 5e-2.  The port's sequential step
  (``Trainer(mesh=None)``) equals the reference's within 1e-6.
* §3.3.2: under ``sync="weights"`` the ranks are bitwise equal after
  each sync step and differ between syncs; under ``sync="none"`` they
  differ.
* Reduced qwen3-1.7b through ``Trainer(model_cfg=...)`` at p = 2 with 2
  microbatches equals the one-device ``make_train_step`` over 5 AdamW
  steps.
* The ZeRO ladder at p = 2 (the hier pair on 2 pods) and the overlap
  modes equal the one-device step over 5 AdamW steps on reduced qwen3.
* Refusals by name, and both launchers under torchrun (MNIST-DNN under
  ``zero3`` on 4 ranks too).
"""
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import ROOT, run_ranks

from repro import optim as jax_optim
from repro.api import Trainer as JaxTrainer
from repro.configs.paper_nets import MNIST_DNN as JAX_MNIST_DNN
from repro.models import apply_paper_net as jax_apply
from repro.models import init_paper_net as jax_init
from repro_torch import optim
from repro_torch.api import Trainer
from repro_torch.bridge import paper_net_from_jax
from repro_torch.configs.paper_nets import MNIST_DNN
from repro_torch.core import DPConfig, make_dp_train_step
from repro_torch.launch import mnist_dnn_dp
from repro_torch.launch import train as launch_train
from repro_torch.models import apply_paper_net
from repro_torch.train import cross_entropy

torch.set_num_threads(2)

MESHES = {"single_pod": (8,), "multi_pod": (2, 4)}
STRATEGIES = ["flat", "bucketed", "hierarchical"]
STEPS = 5
TOL = 1e-6          # the reference's bar (tests/test_data_parallel.py)
BF16_TOL = 5e-2     # ... and its bar for bf16 on the wire
# AdamW parity: params whose gradient falls near eps are held to 5 lr
# (ROADMAP §C); the rest to the reference's fp32 training bar
ADAM_TOL, ILL, LR = 1e-5, 1e-6, 3e-4

CODE = """
from repro_torch import optim
from repro_torch.api import Trainer
from repro_torch.configs.paper_nets import MNIST_DNN
from repro_torch.core import DPConfig
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.models import apply_paper_net, init_paper_net
from repro_torch.train import cross_entropy

mesh = make_dp_mesh({pods})
net = MNIST_DNN
rng = np.random.default_rng(0)
batch = {{"x": rng.standard_normal((64, 784), dtype=np.float32),
          "y": rng.integers(0, 10, 64).astype(np.int32)}}

def loss_fn(m, b):
    return cross_entropy(apply_paper_net(net, m, b["x"]), b["y"])

def trainer(dp=None, mesh=mesh, seed=RANK):
    # each rank draws other weights: create broadcasts rank 0's
    return Trainer.create(loss_fn=loss_fn,
                          params=init_paper_net(net, seed=seed, device="cpu"),
                          optimizer=optim.sgd(0.1), dp=dp, mesh=mesh,
                          device="cpu")

def flat_params(t):
    return np.concatenate([v.ravel() for v in t.params.values()])

def gather(t):
    mine = torch.from_numpy(flat_params(t))
    out = [torch.empty_like(mine) for _ in range(WORLD)]
    dist.all_gather(out, mine)
    return out

def all_equal(t):
    got = gather(t)
    return all(torch.equal(got[0], g) for g in got[1:])

seq = trainer(mesh=None, seed=0)
for _ in range({steps}):
    seq.step(batch)
want = flat_params(seq)
out = {{"err": {{}}, "describe": {{}}}}
for name, dp in [("flat", DPConfig(strategy="flat")),
                 ("bucketed", DPConfig(strategy="bucketed",
                                       bucket_bytes=4096)),
                 ("hierarchical", DPConfig(strategy="hierarchical")),
                 ("bf16", DPConfig(strategy="flat", compress="bf16"))]:
    t = trainer(dp)
    losses = [float(t.step(batch)["loss"]) for _ in range({steps})]
    assert t.state.step == {steps} and all_equal(t)
    out["err"][name] = float(np.abs(flat_params(t) - want).max())
    out["describe"][name] = t.describe()
m = t.step(batch)
out["metrics"] = sorted(m)
out["norms"] = [float(m["grad_norm_local"]), float(m["grad_norm"])]

t = trainer(DPConfig(sync="weights", sync_period=2))
out["weights_equal"] = []
for _ in range(4):
    t.step(batch)
    out["weights_equal"].append(all_equal(t))
t = trainer(DPConfig(sync="none"))
for _ in range(2):
    t.step(batch)
out["none_equal"] = all_equal(t)
try:
    t.step({{k: v[:WORLD + 1] for k, v in batch.items()}})
except ValueError as e:
    out["uneven"] = str(e)
print(json.dumps(out))
"""


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    shape = MESHES[request.param]
    pods = shape[0] if len(shape) == 2 else 1
    return shape, run_ranks(CODE.format(pods=pods, steps=STEPS),
                            int(np.prod(shape)),
                            tmp_path_factory.mktemp("dp"))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_grad_sync_equals_sequential(ranks, strategy):
    shape, results = ranks
    assert max(r["err"][strategy] for r in results) <= TOL
    d = results[0]["describe"][strategy]
    assert (d["strategy"], d["sync"], d["world_size"]) == (
        strategy, "grads", int(np.prod(shape)))
    assert d["params"] == 784 * 200 + 200 + 200 * 100 + 100 + 100 * 10 + 10


def test_bf16_compression_approximates_sequential(ranks):
    _, results = ranks
    assert 0 < max(r["err"]["bf16"] for r in results) <= BF16_TOL


def test_step_metrics(ranks):
    _, results = ranks
    for r in results:
        assert r["metrics"] == ["grad_norm", "grad_norm_local", "loss"]
        local, avg = r["norms"]
        # the mean of p gradients is shorter than a rank's own
        assert 0 < avg < local


def test_weight_averaging_bitwise_at_sync_points(ranks):
    """sync_period 2: the sync fires after steps 2 and 4."""
    _, results = ranks
    assert results[0]["weights_equal"] == [False, True, False, True]


def test_no_sync_diverges(ranks):
    _, results = ranks
    assert results[0]["none_equal"] is False


def test_uneven_batch_refused(ranks):
    shape, results = ranks
    p = int(np.prod(shape))
    assert all(f"{p + 1} rows, which do not split evenly over {p}"
               in r["uneven"] for r in results)


# --------------------------------------------------------------------------
# the port's sequential step against the reference's
# --------------------------------------------------------------------------

def test_sequential_step_equals_reference():
    key = jax.random.PRNGKey(0)
    params = jax_init(JAX_MNIST_DNN, key)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 784), dtype=np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)

    def jloss(p, b):
        lg = jax_apply(JAX_MNIST_DNN, p, b["x"])
        return jnp.mean(-jax.nn.log_softmax(lg)[jnp.arange(lg.shape[0]),
                                                 b["y"]])

    ref = JaxTrainer.create(loss_fn=jloss, params=params,
                            optimizer=jax_optim.sgd(0.1), mesh=None)
    model = paper_net_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               MNIST_DNN, device="cpu")
    port = Trainer.create(
        loss_fn=lambda m, b: cross_entropy(
            apply_paper_net(MNIST_DNN, m, b["x"]), b["y"]),
        params=model, optimizer=optim.sgd(0.1), mesh=None, device="cpu")
    for _ in range(STEPS):
        jm = ref.step({"x": jnp.asarray(x), "y": jnp.asarray(y)})
        m = port.step({"x": x, "y": y})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL
    want = {f"layers.{i}.{k}": np.asarray(v)
            for i, layer in enumerate(ref.params["layers"])
            for k, v in layer.items()}
    got = port.params
    assert got.keys() == want.keys()
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= TOL
    d = port.describe()
    assert (d["strategy"], d["world_size"]) == ("flat", 1)
    assert "allreduce_bytes_per_sync" not in d


# --------------------------------------------------------------------------
# reduced qwen3-1.7b through Trainer(model_cfg=...) at p = 2
# --------------------------------------------------------------------------

QWEN_CODE = """
from repro_torch.api import Trainer
from repro_torch.configs import smoke_config
from repro_torch.core import DPConfig
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.train import (TrainConfig, make_train_step, start_state,
                               trainable)
from repro_torch.models import init_model

cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
mesh = make_dp_mesh(1)
rng = np.random.default_rng(5)
batches = [{{"tokens": rng.integers(0, cfg.vocab_size, (8, 32))
             .astype(np.int32)}} for _ in range({steps})]
t = Trainer.create(cfg, optimizer="adamw", lr={lr},
                   dp=DPConfig(strategy="{strategy}", microbatches=2,
                               bucket_bytes=1 << 20),
                   mesh=mesh, train_cfg=TrainConfig(remat=False),
                   seed=RANK, device="cpu")
dp_losses = [float(t.step(b)["loss"]) for b in batches]
out = {{}}
if RANK == 0:
    tc = TrainConfig(optimizer="adamw", lr={lr})
    step, opt = make_train_step(cfg, tc)
    model = init_model(cfg, seed=0, device="cpu", train=True)
    state = start_state(model, opt)
    losses, min_grad = [], None
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        g = {{k: p.grad.abs() for k, p in trainable(model).items()}}
        min_grad = g if min_grad is None else {{
            k: torch.minimum(min_grad[k], v) for k, v in g.items()}}
    got = t.params
    well, ill, n_ill = 0.0, 0.0, 0
    for k, p in trainable(model).items():
        gap = np.abs(got[k] - p.detach().numpy())
        mask = (min_grad[k] >= {ill}).numpy()
        well = max(well, float(gap[mask].max(initial=0)))
        ill = max(ill, float(gap.max()))
        n_ill += int((~mask).sum())
    out = {{"loss_gap": max(abs(a - b) for a, b in zip(dp_losses, losses)),
            "well": well, "ill": ill, "n_ill": n_ill,
            "n": sum(p.numel() for p in trainable(model).values()),
            "describe": t.describe()}}
print(json.dumps(out))
"""


@pytest.mark.parametrize("strategy", ["flat", "bucketed"])
def test_qwen_trainer_at_p2_equals_one_device_step(strategy, tmp_path):
    r = run_ranks(QWEN_CODE.format(steps=STEPS, lr=LR, strategy=strategy,
                                   ill=ILL), 2, tmp_path)[0]
    assert r["loss_gap"] <= ADAM_TOL
    assert r["well"] <= ADAM_TOL
    assert r["ill"] <= STEPS * LR
    assert r["n_ill"] < 1e-2 * r["n"]
    assert r["describe"]["world_size"] == 2
    assert r["describe"]["params"] == r["n"]


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def _loss(m, b):
    return cross_entropy(apply_paper_net(MNIST_DNN, m, b["x"]), b["y"])


# --------------------------------------------------------------------------
# the ZeRO ladder and the overlap scheduler on reduced qwen3 at p = 2
# --------------------------------------------------------------------------

ZERO_QWEN_CODE = """
from repro_torch.api import Trainer
from repro_torch.configs import smoke_config
from repro_torch.core import DPConfig
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.train import (TrainConfig, make_train_step, start_state,
                               trainable)
from repro_torch.models import init_model

cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
meshes = {{1: make_dp_mesh(1), 2: make_dp_mesh(2)}}
rng = np.random.default_rng(5)
batches = [{{"tokens": rng.integers(0, cfg.vocab_size, (8, 32))
             .astype(np.int32)}} for _ in range({steps})]
ref, min_grad = None, None
if RANK == 0:
    step, opt = make_train_step(cfg, TrainConfig(optimizer="adamw",
                                                 lr={lr}))
    model = init_model(cfg, seed=0, device="cpu", train=True)
    state = start_state(model, opt)
    ref_losses = []
    for b in batches:
        state, m = step(state, b)
        ref_losses.append(float(m["loss"]))
        g = {{k: p.grad.abs() for k, p in trainable(model).items()}}
        min_grad = g if min_grad is None else {{
            k: torch.minimum(min_grad[k], v) for k, v in g.items()}}
    ref = {{k: p.detach().numpy() for k, p in trainable(model).items()}}
out = {{}}
for name, pods, strategy, overlap in {cases}:
    t = Trainer.create(cfg, optimizer="adamw", lr={lr},
                       dp=DPConfig(strategy=strategy, microbatches=2,
                                   overlap=overlap, bucket_bytes=1 << 16),
                       mesh=meshes[pods], train_cfg=TrainConfig(remat=False),
                       seed=RANK, device="cpu")
    losses = [float(t.step(b)["loss"]) for b in batches]
    got = t.params
    if RANK:
        continue
    well, ill, n_ill = 0.0, 0.0, 0
    for k, w in ref.items():
        gap = np.abs(got[k] - w)
        mask = (min_grad[k] >= {ill}).numpy()
        well = max(well, float(gap[mask].max(initial=0)))
        ill = max(ill, float(gap.max()))
        n_ill += int((~mask).sum())
    out[name] = {{"loss_gap": max(abs(a - b)
                                 for a, b in zip(losses, ref_losses)),
                 "well": well, "ill": ill, "n_ill": n_ill,
                 "n": sum(w.size for w in ref.values()),
                 "layout": t.state.layout.kind}}
print(json.dumps(out))
"""

ZERO_CASES = [("zero1", 1, "zero1", False), ("zero2", 1, "zero2", False),
              ("zero3", 1, "zero3", False),
              ("zero1_hier", 2, "zero1_hier", False),
              ("zero3_hier", 2, "zero3_hier", False),
              ("overlap_True", 1, "zero2", True),
              ("overlap_serial", 1, "zero3", "serial")]


@pytest.fixture(scope="module")
def zero_qwen(tmp_path_factory):
    code = ZERO_QWEN_CODE.format(steps=STEPS, lr=LR, ill=ILL,
                                 cases=ZERO_CASES)
    return run_ranks(code, 2, tmp_path_factory.mktemp("zero_qwen"),
                     timeout=300)[0]


def _like_one_device(r):
    assert r["loss_gap"] <= ADAM_TOL
    assert r["well"] <= ADAM_TOL
    assert r["ill"] <= STEPS * LR
    assert r["n_ill"] < 1e-2 * r["n"]


@pytest.mark.parametrize("name", ["zero1", "zero2", "zero3", "zero1_hier",
                                  "zero3_hier"])
def test_zero_strategies_step_like_one_device(zero_qwen, name):
    """Reduced qwen3 through ``Trainer(model_cfg=...)`` at p = 2 with 2
    microbatches: each ZeRO strategy (the hier pair on a 2-pod mesh)
    equals the one-device step over 5 AdamW steps."""
    _like_one_device(zero_qwen[name])
    assert zero_qwen[name]["layout"] == name


@pytest.mark.parametrize("overlap", [True, "serial"])
def test_overlap_modes_step_like_one_device(zero_qwen, overlap):
    """``overlap=True`` (zero2: each microbatch's reduce-scatter behind
    the next backward) and ``"serial"`` (zero3's bucket-major gathers
    and reduce-scatters one after another) step alike."""
    _like_one_device(zero_qwen[f"overlap_{overlap}"])


@pytest.mark.parametrize("dp,match", [
    (DPConfig(sync="sometimes"), "sync must be"),
    (DPConfig(sync="weights", sync_period=0), "sync_period"),
])
def test_bad_sync_refused(dp, match):
    with pytest.raises(ValueError, match=match):
        make_dp_train_step(_loss, optim.sgd(0.1), None, dp)


def test_trainer_checkpoints_and_serve_wait_for_a3(tmp_path):
    """ROADMAP A.3 has landed: ``save`` and ``restore`` round-trip a
    loss_fn trainer's masters and moments, and ``serve`` still refuses
    it by name (a custom loss has no serving forward pass)."""
    from repro_torch.models import init_paper_net
    t = Trainer.create(loss_fn=_loss, params=init_paper_net(
        MNIST_DNN, device="cpu"), optimizer="momentum", device="cpu")
    rng = np.random.default_rng(0)
    t.step({"x": rng.standard_normal((16, 784), dtype=np.float32),
            "y": rng.integers(0, 10, 16).astype(np.int32)})
    assert t.save(tmp_path).endswith("step_0000000001.shards")
    fresh = Trainer.create(loss_fn=_loss, params=init_paper_net(
        MNIST_DNN, seed=1, device="cpu"), optimizer="momentum",
        device="cpu")
    assert fresh.restore(tmp_path) == 1
    for k, v in t.params.items():
        assert np.array_equal(fresh.params[k], v), k
        assert torch.equal(fresh.state.opt_state["m"][k],
                           t.state.opt_state["m"][k]), k
    with pytest.raises(ValueError, match="model_cfg"):
        t.serve()
    with pytest.raises(ValueError, match="model_cfg"):
        Trainer.create(loss_fn=_loss, device="cpu")


def test_trainer_params_are_a_snapshot():
    """``Trainer.params`` taken after a step keeps that step's values on
    the CPU too, where a tensor's ``numpy()`` shares its memory: the
    masters are updated in place by the next step."""
    from repro_torch.bridge import paper_net_to_numpy
    from repro_torch.models import init_paper_net
    t = Trainer.create(loss_fn=_loss, params=init_paper_net(
        MNIST_DNN, device="cpu"), optimizer=optim.sgd(0.1), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((16, 784), dtype=np.float32),
             "y": rng.integers(0, 10, 16).astype(np.int32)}
    t.step(batch)
    first = t.params
    tree = paper_net_to_numpy(t.state.params, MNIST_DNN)
    kept = {k: v.copy() for k, v in first.items()}
    w0 = tree["layers"][0]["w"].copy()
    t.step(batch)
    for k, v in first.items():
        assert np.array_equal(v, kept[k]), k
    assert np.array_equal(tree["layers"][0]["w"], w0)
    assert not np.array_equal(t.params["layers.0.w"], kept["layers.0.w"])


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.models import init_paper_net
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer.create(loss_fn=_loss,
                       params=init_paper_net(MNIST_DNN, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        mnist_dnn_dp.main(["--sequential", "--steps", "1"])


def test_dp_strategy_requires_reduced(capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen3-1.7b", "--dp-strategy", "flat",
                           "--device", "cpu"])
    assert "--dp-strategy requires --reduced" in capsys.readouterr().err


def test_launchers_refuse_zero_strategies(capsys):
    """The launchers take every registered strategy, and refuse a ZeRO
    one with weight averaging: its optimizer state is sharded."""
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced",
                           "--dp-strategy", "zero1", "--sync", "weights",
                           "--device", "cpu"])
    with pytest.raises(SystemExit):
        mnist_dnn_dp.main(["--strategy", "zero3", "--sync", "weights",
                           "--device", "cpu"])
    err = capsys.readouterr().err
    assert "--dp-strategy zero1 shards the optimizer state" in err
    assert "--strategy zero3 shards the optimizer state" in err


# --------------------------------------------------------------------------
# the launchers under torchrun
# --------------------------------------------------------------------------

def _torchrun(args, n=2, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"torchrun {args} outlasted {timeout} s")
    assert proc.returncode == 0, err[-4000:]
    return out


def _dump(d, step, rank):
    with np.load(os.path.join(d, f"step{step}_rank{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("strategy", ["flat", "hierarchical", "zero3"])
def test_mnist_launcher_under_torchrun_equals_sequential(strategy, tmp_path,
                                                         capsys):
    data = ["--samples", "1024", "--epochs", "1", "--steps", "4",
            "--device", "cpu"]
    mnist_dnn_dp.main([*data, "--sequential", "--dump",
                       str(tmp_path / "seq")])
    assert "sequential reference" in capsys.readouterr().out
    pods = ["--pods", "2"] if strategy == "hierarchical" else []
    n = 2 if strategy == "flat" else 4
    out = _torchrun(["repro_torch.launch.mnist_dnn_dp", *data, "--backend",
                     "gloo", "--strategy", strategy, *pods, "--dump",
                     str(tmp_path / "dp")], n=n)
    assert f'"strategy": "{strategy}"' in out and "epoch 0: loss" in out
    want = _dump(tmp_path / "seq", 4, 0)
    for r in range(n):
        got = _dump(tmp_path / "dp", 4, r)
        assert max(np.abs(got[k] - want[k]).max() for k in want) <= TOL


def test_train_launcher_under_torchrun_equals_one_device(capsys):
    args = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "32"]
    launch_train.main([*args, "--microbatches", "2"])
    one = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("step")]
    out = _torchrun(["repro_torch.launch.train", *args, "--backend", "gloo",
                     "--dp-strategy", "bucketed"])
    dp = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert dp == one and len(dp) == 3
    assert '"strategy": "bucketed"' in out and "sync: median" in out
