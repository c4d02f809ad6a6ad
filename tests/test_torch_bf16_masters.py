"""bf16 masters and gradients (``TrainConfig(param_dtype="bfloat16",
grad_dtype=...)``) in the port against the reference, on the CPU, at
smoke size with the reference's weights through ``bridge``.

* (a) The one-device step (``make_train_step``) at microbatches 1 and
  2 under ``grad_dtype`` float32 and bfloat16, with SGD and momentum,
  fp32 compute on bf16 masters; AdamW by the lr-multiple rule.
* (b) The replicated (``flat``) and the ``zero3`` strategies on 2 gloo
  ranks against the reference's same strategy on 2 emulated devices.
* (c) bf16 checkpoints: the reference's (its bf16 leaves stored as the
  void dtype ``|V2``) restored by the port, and the port's (bf16 as
  fp32 values) restored by the reference's cross-layout restore --
  bitwise both ways.
* bf16 compute on bf16 masters, held as ROADMAP C.1 proposes: the
  port's loss gap to the reference's fp32 run at most 1.5x the
  reference's own bf16 gap.

Bars, with fp32 compute: losses within 1e-5 and each master within one
bf16 ulp of the reference's per step taken, and the share of masters
that are bitwise equal is nonzero.  The ulp is taken at the largest
magnitude the entry had (its start, or either package's result) or at
its tensor's largest step, whichever is larger: a bf16 gradient is
exact only to one ulp of the terms it sums (the tied table's gradient
is the sum of its two uses' bf16 gradients, which cancel to small
values whose rounding the fp32 noise of either package's terms decides,
100+ of the result's own ulps), and the step scales that error by lr
into every entry of the tensor, tiny ones included.  Two steps: from
the third on, earlier differences feed the gradients and the gap grows
past the per-step budget, while the losses still agree.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import ROOT, run_ranks

from repro.api import Trainer as JaxTrainer
from repro.checkpoint.store import _flatten as ref_flatten
from repro.configs import smoke_config as jax_smoke
from repro.core import init_train_state as jax_init_state
from repro.models import init_model as jax_init
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_train_step
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import smoke_config
from repro_torch.core.train_state import host_params
from repro_torch.train import (TrainConfig, init_train_state, make_train_step,
                               start_state, trainable)

torch.set_num_threads(2)

LOSS_TOL = 1e-5
# AdamW after its first step: g / (|g| + eps) moves an entry whose two
# gradients straddle zero by lr one way in one package and the other
# way in the other (ROADMAP C), on ~0.1 % of the entries
ADAM_LATER_LOSS_TOL = 1e-4
STEPS = 2
LR = 1e-3           # the reference's SGD rate for bf16 masters (dryrun)
B, S = 4, 32
ARCH = "qwen3-1.7b"


def _ulp(a, b, start):
    """One bf16 ulp (bf16 has 8 significant bits) at the largest of |a|,
    |b|, the entry's |start| and its tensor's largest move in ``b`` (the
    reference's run)."""
    m = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(start))
    m = np.maximum(m, np.abs(b - start).max())
    return np.exp2(np.floor(np.log2(np.maximum(m, 1e-38))) - 7)


def _ulps(a, b, start):
    """|a - b| in bf16 ulps (``_ulp``)."""
    return np.abs(a.astype(np.float64) - b) / _ulp(a, b, start)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tokens(cfg, i, batch=B):
    return np.random.default_rng([26, i]).integers(
        0, cfg.vocab_size, (batch, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ref(ref_dp_started):
    return ref_dp_started[0]


@pytest.fixture(scope="module")
def ref_dp_started(tmp_path_factory):
    """The reference's weights, and its 2-device data-parallel run
    (``REF_DP``) started in the background, so that it runs beside the
    one-device tests."""
    jcfg = jax_smoke(ARCH).with_overrides(dtype="float32")
    p32 = jax_init(jcfg, jax.random.PRNGKey(0))
    p16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), p32)
    cfg = smoke_config(ARCH).with_overrides(dtype="float32")
    out = tmp_path_factory.mktemp("bf16_dp")
    np.savez(out / "init.npz", **{k: np.asarray(v, np.float32) for k, v
                                  in ref_flatten(p16).items()})
    np.save(out / "tokens.npy", np.stack([_tokens(cfg, 10 + i, 8)
                                          for i in range(STEPS)]))
    env = dict(os.environ, OUT=str(out), CASES=json.dumps(CASES),
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF_DP)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield ((jcfg, p32, p16, jax.tree_util.tree_map(np.asarray, p16), cfg),
           out, proc)
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _hold(got, want, start, steps, tag):
    """The bars: each master within ``steps`` bf16 ulps; returns the
    share of bitwise-equal masters (asserted nonzero)."""
    worst, equal, total = 0.0, 0, 0
    for k, w in want.items():
        u = _ulps(got[k], w, start[k])
        worst = max(worst, float(u.max()))
        equal += int((got[k] == w).sum())
        total += w.size
    share = equal / total
    print(f"{tag}: worst {worst:g} ulps after {steps} steps, "
          f"{share:.6f} of the masters bitwise equal")
    assert worst <= steps, (tag, worst)
    assert share > 0, tag
    return share


# --------------------------------------------------------------------------
# (a) the one-device step
# --------------------------------------------------------------------------

def _ref_run(jcfg, params, **kw):
    """The reference's ``make_train_step`` for STEPS steps: (final
    state, losses)."""
    jstep, jopt = jax_train_step(jcfg, None, JaxTrainConfig(**kw))
    jstep = jax.jit(jstep)
    st, losses = jax_init_state(jopt, params), []
    for i in range(STEPS):
        st, m = jstep(st, {"tokens": jnp.asarray(_tokens(jcfg, i))})
        losses.append(float(m["loss"]))
    return st, losses


# microbatches 1 and 2, grad_dtype fp32 and bf16 (one microbatch keeps
# the masters' dtype whatever grad_dtype says), SGD and momentum
@pytest.mark.parametrize("opt,micro,gdt", [
    ("sgd", 1, "float32"), ("sgd", 2, "bfloat16"),
    ("momentum", 2, "float32"), ("adamw", 2, "float32"),
])
def test_one_device_step_matches_reference(ref, opt, micro, gdt):
    jcfg, _, p16, np16, cfg = ref
    kw = dict(optimizer=opt, lr=LR, microbatches=micro, remat=False,
              param_dtype="bfloat16", grad_dtype=gdt)
    jstate, jlosses = _ref_run(jcfg, p16, **kw)
    step, o = make_train_step(cfg, TrainConfig(**kw))
    model = params_from_jax(np16, cfg, device="cpu", train=True,
                            param_dtype=torch.bfloat16)
    state = start_state(model, o)
    for i in range(STEPS):
        state, m = step(state, {"tokens": _tokens(cfg, i)})
        gap = abs(float(m["loss"]) - jlosses[i])
        # AdamW's later losses follow its params, held by the lr rule
        # below (5.5e-5 measured at step 2), not by the fp32 bar
        assert gap <= (ADAM_LATER_LOSS_TOL if opt == "adamw" and i
                       else LOSS_TOL), (i, gap)
    masters = trainable(model)
    assert all(p.dtype == torch.bfloat16 for p in masters.values())
    got, want = _leaves(params_to_numpy(model, cfg)), _leaves(jstate.params)
    start = _leaves(p16)
    if opt != "adamw":
        _hold(got, want, start, STEPS, f"{opt} x{micro} {gdt}")
        return
    # AdamW: g / (|g| + eps) turns a bf16 rounding of a near-zero
    # gradient into a step of up to lr, so an entry is held to what
    # STEPS such steps can move it (ROADMAP C's rule), plus its ulps
    for k, w in want.items():
        assert np.all(np.abs(got[k] - w) <= 2 * STEPS * LR + STEPS * _ulp(
            got[k], w, start[k])), k


def test_grad_dtype_rules(ref):
    """One microbatch keeps the masters' dtype; microbatches accumulate
    in grad_dtype; the data-parallel rule (fp32 whatever grad_dtype) is
    the strategies' own."""
    from repro_torch.train import accumulate_grads, make_loss_fn
    _, _, _, np16, cfg = ref
    model = params_from_jax(np16, cfg, device="cpu", train=True,
                            param_dtype=torch.bfloat16)
    params = trainable(model)
    loss_fn = make_loss_fn(cfg, TrainConfig(remat=False))
    batch = {"tokens": _tokens(cfg, 0)}
    for n, gdt, want in ((1, torch.float32, torch.bfloat16),
                         (2, torch.float32, torch.float32),
                         (2, torch.bfloat16, torch.bfloat16)):
        _, _, grads = accumulate_grads(loss_fn, model, params, batch, n,
                                       grad_dtype=gdt)
        assert {g.dtype for g in grads.values()} == {want}, (n, gdt)
        direct = want == torch.bfloat16
        assert all((g is p.grad) == direct
                   for g, p in zip(grads.values(), params.values()))


def test_bf16_masters_are_cast_as_drawn():
    """``init_train_state`` draws bf16 masters that equal the fp32 draws
    of the same seed cast to bf16, with no fp32 copy left behind."""
    cfg = smoke_config(ARCH)
    tc = TrainConfig(param_dtype="bfloat16", optimizer="sgd")
    st16 = init_train_state(cfg, tc, seed=3, device="cpu")
    st32 = init_train_state(cfg, TrainConfig(optimizer="sgd"), seed=3,
                            device="cpu")
    m16, m32 = trainable(st16.params), trainable(st32.params)
    assert m16.keys() == m32.keys()
    for k in m16:
        assert m16[k].dtype == torch.bfloat16, k
        assert torch.equal(m16[k].detach(),
                           m32[k].detach().to(torch.bfloat16)), k
    assert st16.params.unembed_f32 is st16.params.embed    # tied, once
    host = host_params(st16)
    assert all(a.dtype == np.float32 for a in host.values())


def test_bf16_compute_on_bf16_masters(ref):
    """ROADMAP C.1's bar: with bf16 compute, the port's loss gap to the
    reference's fp32 run (fp32 masters, fp32 compute, from the fp32 draws
    the bf16 masters were cast from) is at most 1.5x the reference's own
    bf16 gap, the largest gap over the steps."""
    jcfg32, p32, p16, np16, _ = ref
    cfg16 = smoke_config(ARCH)
    assert cfg16.dtype == "bfloat16"
    kw = dict(optimizer="sgd", lr=LR, remat=False)
    runs = {"ref32": _ref_run(jcfg32, p32, **kw)[1], "ref16": _ref_run(
        jcfg32.with_overrides(dtype="bfloat16"), p16,
        param_dtype="bfloat16", **kw)[1]}
    step, o = make_train_step(cfg16, TrainConfig(param_dtype="bfloat16",
                                                 **kw))
    state = start_state(params_from_jax(np16, cfg16, device="cpu",
                                        train=True,
                                        param_dtype=torch.bfloat16), o)
    runs["port16"] = []
    for i in range(STEPS):
        state, m = step(state, {"tokens": _tokens(cfg16, i)})
        runs["port16"].append(float(m["loss"]))
    gap = lambda k: max(abs(a - b) for a, b in zip(runs[k], runs["ref32"]))
    print(f"bf16 compute: port gap {gap('port16'):.3e}, reference's own "
          f"{gap('ref16'):.3e} ({runs})")
    assert gap("ref16") > 0
    assert gap("port16") <= 1.5 * gap("ref16")


# --------------------------------------------------------------------------
# (b) flat and zero3 on 2 gloo ranks, (c) checkpoints across packages
# --------------------------------------------------------------------------

# flat at one microbatch all-reduces bf16 gradients; zero3 at two sums
# its bf16 gradient shards in fp32 (the strategies' rule)
CASES = (("flat", 1), ("zero3", 2))

REF_DP = """
import json, os
import jax, jax.numpy as jnp, numpy as np
from repro.api import Trainer
from repro.compat import auto_axis_types, make_mesh
from repro.configs import smoke_config
from repro.core import DPConfig
from repro.train.step import TrainConfig

out = os.environ["OUT"]
cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
params = {}
for key, a in np.load(f"{out}/init.npz").items():
    *parents, leaf = key.split("/")
    node = params
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = jnp.asarray(a, jnp.bfloat16)
toks = np.load(f"{out}/tokens.npy")
mesh = make_mesh((2,), ("data",), axis_types=auto_axis_types(1))
res = {}
for s, n in json.loads(os.environ["CASES"]):
    t = Trainer.create(cfg, params=params, optimizer="sgd", lr=%r,
                       dp=DPConfig(strategy=s, microbatches=n), mesh=mesh,
                       train_cfg=TrainConfig(remat=False))
    losses = [float(t.step({"tokens": jnp.asarray(b)})["loss"])
              for b in toks]
    leaves = jax.tree_util.tree_leaves(t.params)
    assert all(l.dtype == jnp.bfloat16 for l in leaves)
    np.save(f"{out}/ref_{s}.npy", np.concatenate(
        [np.asarray(l, np.float32).ravel() for l in leaves]))
    res[s] = losses
    t.save(f"{out}/ref_ckpt_{s}")
print("RES " + json.dumps(res))
""" % LR

PORT_DP = """
from repro_torch import bridge
from repro_torch.api import Trainer
from repro_torch.configs import smoke_config
from repro_torch.core import DPConfig
from repro_torch.core.flat import flat_spec
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.train import TrainConfig, trainable

out = os.environ["OUT"]
cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
init = dict(np.load(f"{out}/init.npz"))
tree = {}
for key, a in init.items():
    *parents, leaf = key.split("/")
    node = tree
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = a
toks = np.load(f"{out}/tokens.npy")
mesh = make_dp_mesh(1)

def trainer(s, n):
    model = bridge.params_from_jax(tree, cfg, device="cpu", train=True,
                                   param_dtype=torch.bfloat16)
    return Trainer.create(cfg, params=model, optimizer="sgd", lr=%r,
                          dp=DPConfig(strategy=s, microbatches=n),
                          mesh=mesh, device="cpu",
                          train_cfg=TrainConfig(remat=False))

res = {}
for s, n in json.loads(os.environ["CASES"]):
    t = trainer(s, n)
    losses = [float(t.step({"tokens": b})["loss"]) for b in toks]
    st = t.state
    names = (st.layout.param_spec.names if st.layout.params_flat
             else flat_spec(st.params, trainable(st.params)).names)
    dts = ({st.flat.shard.dtype} if st.layout.params_flat
           else {p.dtype for p in trainable(st.params).values()})
    assert dts == {torch.bfloat16}, dts
    p = t.params
    canon = np.concatenate([p[k].ravel() for k in names])
    if RANK == 0:
        np.save(f"{out}/port_{s}.npy", canon)
    res[s] = losses
    t.save(f"{out}/port_ckpt_{s}")
    if s == "zero3":                # the same layout, read back bitwise
        back = trainer(s, n)
        assert back.restore(f"{out}/port_ckpt_{s}") == len(toks)
        q = back.params
        assert all(np.array_equal(q[k], p[k]) for k in names)
print(json.dumps(res))
""" % LR


@pytest.fixture(scope="module")
def dp_runs(ref_dp_started):
    (_, _, p16, _, _), out, proc = ref_dp_started
    port = run_ranks(PORT_DP, 2, out, env={"OUT": str(out),
                                           "CASES": json.dumps(CASES)})
    so, se = proc.communicate(timeout=300)
    assert proc.returncode == 0, se[-3000:]
    ref_losses = json.loads(next(ln for ln in so.splitlines()
                                 if ln.startswith("RES "))[4:])
    return out, port, ref_losses, p16


@pytest.mark.parametrize("strategy,micro", CASES)
def test_strategy_matches_reference_on_two_ranks(dp_runs, strategy, micro):
    out, port, ref_losses, p16 = dp_runs
    key = strategy
    assert port[0][key] == port[1][key]
    for a, b in zip(port[0][key], ref_losses[key]):
        assert abs(a - b) <= LOSS_TOL, (key, port[0][key], ref_losses[key])
    start = _leaves(p16)
    cuts = np.cumsum([a.size for a in start.values()])[:-1]
    split = lambda v: {k: x.reshape(a.shape) for (k, a), x    # noqa: E731
                       in zip(start.items(), np.split(v, cuts))}
    _hold(split(np.load(out / f"port_{key}.npy")),
          split(np.load(out / f"ref_{key}.npy")), start, STEPS,
          f"{key} on 2 ranks")


def _canon_ref(params):
    return np.concatenate([np.asarray(l, np.float32).ravel()
                           for l in jax.tree_util.tree_leaves(params)])


@pytest.mark.parametrize("strategy", ["flat", "zero3"])
def test_reference_bf16_checkpoint_restores_in_the_port(ref, dp_runs,
                                                        strategy):
    """The reference's bf16 checkpoint (|V2 members) into a fresh
    one-process bf16 state of the port: bitwise the reference's masters."""
    _, _, _, np16, cfg = ref
    out = dp_runs[0]
    from repro_torch.api import Trainer
    model = params_from_jax(np16, cfg, device="cpu", train=True,
                            param_dtype=torch.bfloat16)
    t = Trainer.create(cfg, params=model, optimizer="sgd", lr=LR,
                       device="cpu", train_cfg=TrainConfig(remat=False))
    assert t.restore(out / f"ref_ckpt_{strategy}") == STEPS
    from repro_torch.core.flat import flat_spec
    names = flat_spec(t.state.params, trainable(t.state.params)).names
    assert all(p.dtype == torch.bfloat16
               for p in trainable(t.state.params).values())
    got = np.concatenate([t.params[k].ravel() for k in names])
    np.testing.assert_array_equal(got, np.load(out / f"ref_{strategy}.npy"))


@pytest.mark.parametrize("strategy", ["flat", "zero3"])
def test_port_bf16_checkpoint_restores_in_the_reference(ref, dp_runs,
                                                        strategy):
    """The port's bf16 checkpoint (fp32 values) through the reference's
    cross-layout restore into a one-device bf16 template: bitwise the
    port's masters, cast back to bf16."""
    jcfg, _, p16, _, _ = ref
    out = dp_runs[0]
    t = JaxTrainer.create(jcfg, params=p16, optimizer="sgd", lr=LR,
                          train_cfg=JaxTrainConfig(remat=False))
    assert int(t.restore(str(out / f"port_ckpt_{strategy}"))) == STEPS
    leaves = jax.tree_util.tree_leaves(t.state.params)
    assert all(l.dtype == jnp.bfloat16 for l in leaves)
    np.testing.assert_array_equal(_canon_ref(t.state.params),
                                  np.load(out / f"port_{strategy}.npy"))
