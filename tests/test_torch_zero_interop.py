"""ZeRO across the two packages, on the CPU: the gate that lets a
reference user who trains under ``zero1`` or ``zero3`` move to the
port, and back.

* Reference -> port: the reference writes zero1 (``overlap=True``, so
  its shards are bucket-major) and zero3 checkpoints of MNIST-DNN and
  of reduced qwen3 on 8 emulated devices; the port restores each into
  zero3 on 2 gloo ranks and into the sequential ``flat`` state in one
  process, and the masters and moments equal the reference's host
  copies bitwise.  With two stacked layers swapped in the flatten order
  (a mutation of the order the shards are cut from) the same restore
  is no longer bitwise.
* Port -> reference: the port writes the same four checkpoints on 4
  gloo ranks; the reference's ``restore_sharded_checkpoint`` reads each
  into zero1 on 2 emulated devices, bitwise.
* Serving: the port's ``restore_serve_params`` of the reference's zero3
  qwen3 checkpoint gives the reference engine's greedy tokens.
* The step: zero1, zero2 and zero3 on 4 gloo ranks against the
  reference's same strategy on 4 emulated devices, from the same
  weights (through ``bridge``), 5 AdamW steps in fp32: the losses within
  1e-5, and the params within 1e-5 (entries whose gradient came near
  Adam's eps within 5 lr, ROADMAP C's rule).
"""
import json

import jax
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from torch_ranks import run_ranks

from repro.configs import smoke_config as jax_smoke
from repro.serve import make_engine_from_checkpoint as jax_engine_from_ckpt
from repro_torch.api import Trainer
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config
from repro_torch.core.flat import flat_spec
from repro_torch.serve import make_engine_from_checkpoint
from repro_torch.train import trainable

LR = 1e-3
STEPS = 5
TOL = 1e-5          # the reference's fp32 training bar
SCHED = dict(batch_size=2, max_len=128, page_size=8, prefill_chunk=32,
             decode_chunk=4)
LENGTHS, NEW = [5, 40, 19], 8
KINDS = [f"{net}_{layout}" for net in ("mnist", "qwen")
         for layout in ("z1b", "z3")]

# the reference side: MNIST-DNN and reduced qwen3 in fp32, their batches,
# and each state's canonical (flatten-order, unpadded) params and moments
REF_COMMON = """
import json, os
import jax, jax.numpy as jnp, numpy as np
from repro.api import Trainer
from repro.compat import auto_axis_types, make_mesh
from repro.configs import smoke_config
from repro.configs.paper_nets import MNIST_DNN
from repro.core import DPConfig
from repro.core.train_state import assemble_full_flat
from repro.models import apply_paper_net, init_model, init_paper_net

out = os.environ["OUT"]
rng = np.random.default_rng(0)
mnist_batch = {"x": jnp.asarray(rng.standard_normal((64, 784),
                                                    dtype=np.float32)),
               "y": jnp.asarray(rng.integers(0, 10, 64).astype(np.int32))}
cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
qwen_batches = [{"tokens": jnp.asarray(np.random.default_rng([5, i]).integers(
    0, cfg.vocab_size, (8, 32)).astype(np.int32))} for i in range(5)]

def mnist_loss(p, b):
    lg = apply_paper_net(MNIST_DNN, p, b["x"])
    return jnp.mean(-jax.nn.log_softmax(lg)[jnp.arange(lg.shape[0]),
                                             b["y"]])

def trainer(net, dp, mesh):
    if net == "mnist":
        return Trainer.create(loss_fn=mnist_loss, params=init_paper_net(
            MNIST_DNN, jax.random.PRNGKey(0)), optimizer="adamw", lr=1e-3,
            dp=dp, mesh=mesh)
    return Trainer.create(cfg, optimizer="adamw", lr=1e-3, dp=dp, mesh=mesh)

def canon(state):
    lay = state.layout
    def flat(leaf):
        shards = np.split(np.asarray(leaf), lay.num_shards)
        return assemble_full_flat(shards, lay)[:lay.total]
    params = (flat(state.params) if lay.params_flat else np.concatenate(
        [np.asarray(l).ravel() for l in jax.tree_util.tree_leaves(
            state.params)]))
    return {"params": params, "m": flat(state.opt_state["m"]["flat"]),
            "v": flat(state.opt_state["v"]["flat"]),
            "step": np.asarray(state.step)}
"""

REF_WRITE = REF_COMMON + """
mesh = make_mesh((8,), ("data",), axis_types=auto_axis_types(1))
for net in ("mnist", "qwen"):
    for name, dp in (("z1b", DPConfig(strategy="zero1", overlap=True,
                                      bucket_bytes=1 << 16)),
                     ("z3", DPConfig(strategy="zero3"))):
        t = trainer(net, dp, mesh)
        for i in range(3):
            t.step(mnist_batch if net == "mnist" else qwen_batches[i])
        t.save(f"{out}/{net}_{name}")
        np.savez(f"{out}/{net}_{name}.npz", **canon(t.state))
print("OK")
"""

REF_READ = REF_COMMON + """
from repro.checkpoint import restore_sharded_checkpoint
mesh = make_mesh((2,), ("data",), axis_types=auto_axis_types(1))
for kind in os.environ["KINDS"].split(","):
    net = kind.split("_")[0]
    t = trainer(net, DPConfig(strategy="zero1"), mesh)
    st, at = restore_sharded_checkpoint(f"{out}/{kind}", t.state)
    assert st.layout.kind == "zero1" and st.layout.num_shards == 2
    np.savez(f"{out}/{kind}.ref.npz", **canon(st))
print("OK")
"""

REF_STEP = REF_COMMON + """
mesh = make_mesh((4,), ("data",), axis_types=auto_axis_types(1))
params = init_paper_net(MNIST_DNN, jax.random.PRNGKey(0))
np.savez(f"{out}/mnist_init.npz", **{
    f"layers/{i}/{k}": np.asarray(v)
    for i, layer in enumerate(params["layers"]) for k, v in layer.items()})
from repro.checkpoint.store import _flatten
np.savez(f"{out}/qwen_init.npz", **{k: np.asarray(v) for k, v in _flatten(
    init_model(cfg, jax.random.PRNGKey(0))).items()})
res = {}
for net in ("mnist", "qwen"):
    for s in ("zero1", "zero2", "zero3"):
        t = trainer(net, DPConfig(strategy=s, microbatches=2), mesh)
        losses = [float(t.step(mnist_batch if net == "mnist"
                                else qwen_batches[i])["loss"])
                  for i in range(5)]
        res[f"{net}_{s}"] = losses
        np.savez(f"{out}/{net}_{s}.step.npz", **canon(t.state))
print("RES " + json.dumps(res))
"""

# the port side
PORT_COMMON = """
from repro_torch import bridge, optim
from repro_torch.api import Trainer
from repro_torch.configs import smoke_config
from repro_torch.configs.paper_nets import MNIST_DNN
from repro_torch.core import DPConfig
from repro_torch.core.flat import flat_spec
from repro_torch.core.train_state import assemble_full_flat, gather_shards
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.models import apply_paper_net, init_paper_net
from repro_torch.train import TrainConfig, cross_entropy, trainable

out = os.environ["OUT"]
rng = np.random.default_rng(0)
mnist_batch = {"x": rng.standard_normal((64, 784), dtype=np.float32),
               "y": rng.integers(0, 10, 64).astype(np.int32)}
cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
qwen_batches = [{"tokens": np.random.default_rng([5, i]).integers(
    0, cfg.vocab_size, (8, 32)).astype(np.int32)} for i in range(5)]

def mnist_loss(m, b):
    return cross_entropy(apply_paper_net(MNIST_DNN, m, b["x"]), b["y"])

def nested(flat):
    tree = {}
    for key, a in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree

def init(net, seed):
    if net == "mnist" and seed is None:
        tree = nested(dict(np.load(f"{out}/mnist_init.npz")))
        tree = {"layers": [tree["layers"][str(i)]
                           for i in range(len(tree["layers"]))]}
        return bridge.paper_net_from_jax(tree, MNIST_DNN, device="cpu")
    if net == "mnist":
        return init_paper_net(MNIST_DNN, seed=seed, device="cpu")
    if seed is None:
        return bridge.params_from_jax(
            nested(dict(np.load(f"{out}/qwen_init.npz"))), cfg,
            device="cpu", train=True)
    from repro_torch.models import init_model
    return init_model(cfg, seed=seed, device="cpu", train=True)

def trainer(net, dp, mesh, seed=None):
    kw = dict(optimizer=optim.adamw(1e-3), dp=dp, mesh=mesh, device="cpu",
              params=init(net, seed))
    if net == "mnist":
        return Trainer.create(loss_fn=mnist_loss, **kw)
    return Trainer.create(cfg, train_cfg=TrainConfig(remat=False), **kw)

def canon(t):
    st = t.state
    lay = st.layout
    spec = flat_spec(st.params, trainable(st.params))
    p = t.params
    out = {"params": np.concatenate([p[n].ravel() for n in spec.names]),
           "step": np.asarray(st.step)}
    for k in ("m", "v"):
        out[k] = (assemble_full_flat(gather_shards(
            st.opt_state[k]["flat"], t.mesh, lay.axes), lay)[:lay.total]
            if lay.sharded else np.concatenate(
                [st.opt_state[k][n].numpy().ravel() for n in spec.names]))
    return out
"""

PORT_READ = PORT_COMMON + """
mesh = make_dp_mesh(1)
for kind in os.environ["KINDS"].split(","):
    t = trainer(kind.split("_")[0], DPConfig(strategy="zero3"), mesh,
                seed=40 + RANK)
    assert t.restore(f"{out}/{kind}") == 3
    c = canon(t)
    if RANK == 0:
        np.savez(f"{out}/{kind}.port.npz", **c)
print(json.dumps({}))
"""

PORT_WRITE = PORT_COMMON + """
mesh = make_dp_mesh(1)
for net in ("mnist", "qwen"):
    for name, dp in (("z1b", DPConfig(strategy="zero1", overlap=True,
                                      bucket_bytes=1 << 16)),
                     ("z3", DPConfig(strategy="zero3"))):
        t = trainer(net, dp, mesh, seed=RANK)
        for i in range(3):
            t.step(mnist_batch if net == "mnist" else qwen_batches[i])
        t.save(f"{out}/{net}_{name}")
        c = canon(t)
        if RANK == 0:
            np.savez(f"{out}/{net}_{name}.npz", **c)
print(json.dumps({}))
"""

PORT_STEP = PORT_COMMON + """
mesh = make_dp_mesh(1)
res = {}
for net in ("mnist", "qwen"):
    for s in ("zero1", "zero2", "zero3"):
        t = trainer(net, DPConfig(strategy=s, microbatches=2), mesh)
        res[f"{net}_{s}"] = [float(t.step(mnist_batch if net == "mnist"
                                           else qwen_batches[i])["loss"])
                             for i in range(5)]
        c = canon(t)
        if RANK == 0:
            np.savez(f"{out}/{net}_{s}.pstep.npz", **c)
    # the smallest |gradient| each entry saw, on one device, from the
    # same weights: where it came near Adam's eps rounding may move the
    # entry by up to lr a step
    if RANK == 0:
        t = trainer(net, None, None)
        ms = trainable(t.state.params)
        spec = flat_spec(t.state.params, ms)
        low = None
        for i in range(5):
            b = mnist_batch if net == "mnist" else qwen_batches[i]
            for p in ms.values():
                p.grad = None
            loss = (mnist_loss(t.state.params, {k: torch.as_tensor(v)
                                                for k, v in b.items()})
                    if net == "mnist" else t.loss_fn(
                        t.state.params, {"tokens": torch.as_tensor(
                            b["tokens"])}))
            loss.backward()
            g = np.concatenate([ms[n].grad.abs().numpy().ravel()
                                for n in spec.names])
            low = g if low is None else np.minimum(low, g)
            t.step(b)
        np.save(f"{out}/{net}_low.npy", low)
print(json.dumps(res))
"""


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _same(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def ref_ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_zero")
    import os
    os.environ["OUT"] = str(d)
    try:
        run_with_devices(REF_WRITE, 8)
    finally:
        del os.environ["OUT"]
    return d


def test_reference_zero_checkpoints_restore_into_port_zero3(ref_ckpts,
                                                            tmp_path):
    """Reference zero1 (bucket-major) and zero3, MNIST-DNN and reduced
    qwen3, 8 workers -> the port's zero3 on 2 gloo ranks: masters,
    moments and step bitwise the reference's."""
    run_ranks(PORT_READ, 2, tmp_path, env={"OUT": str(ref_ckpts),
                                           "KINDS": ",".join(KINDS)},
              timeout=300)
    for kind in KINDS:
        _same(_load(ref_ckpts / f"{kind}.port.npz"),
              _load(ref_ckpts / f"{kind}.npz"), kind)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_zero_checkpoint_restores_into_port_flat(ref_ckpts, kind):
    """... and into the sequential (replicated) state in one process."""
    net = kind.split("_")[0]
    t = _sequential(net)
    assert t.restore(ref_ckpts / kind) == 3
    _same(_canon(t), _load(ref_ckpts / f"{kind}.npz"), kind)


def test_mutated_flatten_order_is_caught(ref_ckpts, monkeypatch):
    """Mutation check: swap the two stacked layers' slices of one leaf in
    the order the store cuts the flat vector by, and the bitwise
    comparison above fails."""
    real = flat_spec

    def swapped(model, masters):
        spec = real(model, masters)
        names = list(spec.names)
        i = names.index("layers.0.mixer.wq")
        j = names.index("layers.1.mixer.wq")
        names[i], names[j] = names[j], names[i]
        return type(spec)(tuple(names), spec.offsets, spec.shapes,
                          spec.total)

    monkeypatch.setattr(store, "flat_spec", swapped)
    t = _sequential("qwen")
    t.restore(ref_ckpts / "qwen_z3")
    got, want = _canon(t), _load(ref_ckpts / "qwen_z3.npz")
    assert not np.array_equal(got["params"], want["params"])
    assert np.array_equal(np.sort(got["params"]), np.sort(want["params"]))


def test_port_zero_checkpoints_restore_in_reference(tmp_path):
    """The port's zero1 (bucket-major) and zero3 checkpoints of 4 gloo
    ranks -> the reference's ``restore_sharded_checkpoint`` into zero1 on
    2 emulated devices: bitwise what the port wrote."""
    import os
    run_ranks(PORT_WRITE, 4, tmp_path, env={"OUT": str(tmp_path)},
              timeout=300)
    os.environ.update(OUT=str(tmp_path), KINDS=",".join(KINDS))
    try:
        run_with_devices(REF_READ, 2)
    finally:
        del os.environ["OUT"], os.environ["KINDS"]
    for kind in KINDS:
        meta = json.loads((tmp_path / kind / "step_0000000003.shards"
                           / "meta.json").read_text())
        assert meta["layout"]["num_shards"] == 4
        _same(_load(tmp_path / f"{kind}.ref.npz"),
              _load(tmp_path / f"{kind}.npz"), kind)


def test_port_serves_a_reference_zero3_checkpoint(ref_ckpts):
    """``restore_serve_params`` reassembles the reference's zero3 worker
    files: the port's engine gives the reference engine's greedy tokens."""
    jcfg = jax_smoke("qwen3-1.7b").with_overrides(dtype="float32",
                                                  decode_kernel="xla")
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    prompts = [np.random.default_rng(n).integers(
        0, cfg.vocab_size, n).astype(np.int32) for n in LENGTHS]
    tree, at = store.restore_serve_params(ref_ckpts / "qwen_z3", cfg)
    assert at == 3
    flat = np.concatenate([np.asarray(a).ravel()
                           for a in store._flatten(tree).values()])
    np.testing.assert_array_equal(
        flat, _load(ref_ckpts / "qwen_z3.npz")["params"])
    jeng = jax_engine_from_ckpt(ref_ckpts / "qwen_z3", jcfg, **SCHED)
    eng = make_engine_from_checkpoint(ref_ckpts / "qwen_z3", cfg,
                                      device="cpu", **SCHED)
    for a, b in zip(jeng.generate(prompts, NEW), eng.generate(prompts, NEW)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    import os
    d = tmp_path_factory.mktemp("zero_step")
    os.environ["OUT"] = str(d)
    try:
        line = next(ln for ln in run_with_devices(REF_STEP, 4).splitlines()
                    if ln.startswith("RES "))
    finally:
        del os.environ["OUT"]
    port = run_ranks(PORT_STEP, 4, d, env={"OUT": str(d)}, timeout=300)[0]
    return d, json.loads(line[4:]), port


@pytest.mark.parametrize("net", ["mnist", "qwen"])
@pytest.mark.parametrize("strategy", ["zero1", "zero2", "zero3"])
def test_step_equals_reference_same_strategy(step_runs, net, strategy):
    d, ref, port = step_runs
    key = f"{net}_{strategy}"
    assert max(abs(a - b) for a, b in zip(port[key], ref[key])) <= TOL
    got = _load(d / f"{key}.pstep.npz")
    want = _load(d / f"{key}.step.npz")
    low = np.load(d / f"{net}_low.npy")
    gap = np.abs(got["params"] - want["params"])
    well = low >= 1e-6
    assert gap[well].max() <= TOL
    assert gap.max() <= STEPS * LR
    # few entries lean on the exemption
    assert (gap[~well] > TOL).sum() < 1e-2 * well.size
    assert int(got["step"]) == int(want["step"]) == STEPS


def _sequential(net):
    from repro_torch import optim
    from repro_torch.configs.paper_nets import MNIST_DNN
    from repro_torch.models import apply_paper_net, init_paper_net
    from repro_torch.train import TrainConfig, cross_entropy
    kw = dict(optimizer=optim.adamw(LR), device="cpu")
    if net == "mnist":
        return Trainer.create(
            loss_fn=lambda m, b: cross_entropy(
                apply_paper_net(MNIST_DNN, m, b["x"]), b["y"]),
            params=init_paper_net(MNIST_DNN, seed=3, device="cpu"), **kw)
    return Trainer.create(smoke_config("qwen3-1.7b").with_overrides(
        dtype="float32"), train_cfg=TrainConfig(remat=False), seed=3, **kw)


def _canon(t):
    st = t.state
    spec = flat_spec(st.params, trainable(st.params))
    p = t.params
    out = {"params": np.concatenate([p[n].ravel() for n in spec.names]),
           "step": np.asarray(st.step)}
    for k in ("m", "v"):
        out[k] = np.concatenate([st.opt_state[k][n].numpy().ravel()
                                 for n in spec.names])
    return out


def test_flat_spec_follows_the_reference_flatten_order():
    """The port's flat order is ``tree_leaves`` of the reference's tree:
    the reduced qwen3's masters concatenated by ``flat_spec`` equal the
    reference's leaves concatenated, from the same weights."""
    from repro.models import init_model as jax_init
    from repro_torch import bridge
    jcfg = jax_smoke("qwen3-1.7b").with_overrides(dtype="float32")
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_init(jcfg, jax.random.PRNGKey(0)))
    model = bridge.params_from_jax(tree, cfg, device="cpu", train=True)
    ms = trainable(model)
    spec = flat_spec(model, ms)
    got = torch.cat([ms[n].detach().reshape(-1) for n in spec.names])
    want = np.concatenate([a.ravel()
                           for a in jax.tree_util.tree_leaves(tree)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert spec.total == want.size
