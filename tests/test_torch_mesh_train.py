"""The mesh train step (``train.step.make_train_step(..., mesh=)``) on
gloo ranks against the port's one-device step and, on the same bridged
weights, the reference's one-device step: fp32, five AdamW steps.

Meshes and configs: (data 2, model 2) -- qwen3 (its kv heads split),
DeepSeek-V3 (MLA, sigmoid router with a balance bias, MTP head, the
expert-parallel MoE), Jamba (Mamba, attention, MoE), RWKV-6, the
encoder-decoder (seamless) and the VLM (llava), and qwen3 with two
microbatches and a global-norm clip, and qwen3, DeepSeek-V3 and Jamba
in four one-row microbatches, whose rows do not divide data 2: each
row's sequence is cut over "data" instead (the sequence split:
attention over the gathered prefix, Mamba on the gathered sequence, the
MoE in the reference's replicated-token form, whose routing, capacity
and aux cover every token of the microbatch, so the one-device step
with the same microbatches is the same objective and is the side these
compare with); (1, 4) -- qwen3 (2 kv heads on 4:
replicated kv) and qwen3 at 6 heads (the head_dim fallback); (pod 2,
data 2, model 2) -- qwen3.  An MoE's aux on the mesh is each data
shard's own (the reference's expert-parallel aux), so for those configs
the one-device steps take the batch as one microbatch a data shard,
which is the same objective.

Bars: losses within 1e-5 a step; every step's gradient on the mesh,
leaf for leaf, within 1e-5 of the port's one-device gradient at the
same params (the mesh's own before that step, so AdamW's drift between
the two trajectories does not enter) and within 1e-4 of it in norm
relative to the leaf's norm, so a missing or doubled reduction shows on
any leaf however small its gradient; params within 1e-5 after five
steps, except entries that AdamW's near-eps rule excuses (ROADMAP C: a
reference gradient under 1e-6, or the reference's and the port's
one-device gradients more than 1% apart, at some step; for RWKV-6, whose
ln_x magnifies rounding, the mesh's and the one-device's gradients on
their own trajectories more than 1% apart instead of the latter), which
are held to five steps of lr -- their share bounded as in the
one-device tests.  The (2, 2) launch also holds the full path's
legacy checkpoint: a mesh state's npz equals the one-device save of the
same values key for key and bitwise, and restores into a one-device
state and back into a mesh state bitwise."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

from repro.configs import smoke_config as jax_smoke
from repro.core import init_train_state as jax_init_state
from repro.models import init_model as jax_init
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_train_step
from repro_torch.bridge import named_to_numpy, params_from_jax
from repro_torch.configs import smoke_config
from repro_torch.data import make_batch
from repro_torch.train import TrainConfig, make_train_step, start_state
from repro_torch.train import trainable

torch.set_num_threads(2)

TOL = 1e-5
GRAD_REL = 1e-4      # a leaf's gradient: norm of the gap over its norm
# RWKV-6's ln_x magnifies the two libraries' rounding (ROADMAP C), and
# the port's one-device RWKV-6 drifts from the reference's past TOL over
# these steps: against the reference, the mesh is held to that drift +
# TOL (loss for loss, entry for entry); against the port's own step, TOL
DRIFTS = {"rwkv6-1.6b"}
# DeepSeek-V3 in four one-row microbatches: the port's and the
# reference's one-device steps agree within 4e-6 on every gradient for
# four steps, then a top-k routing near-tie falls the other way and the
# fifth loss parts by 9.1e-4 (one-device against one-device, no mesh in
# it); the mesh is held to the port's one-device step at TOL, and to the
# reference by that drift + TOL, as for DRIFTS
DRIFT_CASES = {"dsv3_seq"}
ILL, NOISY = 1e-6, 1e-2
# the share of entries the near-eps rule may excuse (as in
# tests/test_torch_arch_train.py; RWKV-6's ln_x magnifies rounding; the
# clip scales every gradient down, putting more of them under ILL)
SHARE = {"rwkv6": 0.15, "qwen3_mb2_clip": 0.06}
DEFAULT_SHARE = 0.03
B, S, STEPS, LR = 4, 32, 5, 3e-4
# case: (arch, config overrides, microbatches, grad clip)
CASES = {
    "qwen3": ("qwen3-1.7b", {}, 1, 0.0),
    "dsv3": ("deepseek-v3-671b", {"mtp_depth": 1}, 1, 0.0),
    "jamba": ("jamba-v0.1-52b", {}, 1, 0.0),
    "rwkv6": ("rwkv6-1.6b", {}, 1, 0.0),
    "seamless": ("seamless-m4t-large-v2", {}, 1, 0.0),
    "llava": ("llava-next-mistral-7b", {}, 1, 0.0),
    "qwen3_mb2_clip": ("qwen3-1.7b", {}, 2, 0.5),
    "qwen3_h6": ("qwen3-1.7b", {"num_heads": 6}, 1, 0.0),
    "qwen3_seq": ("qwen3-1.7b", {}, 4, 0.0),
    "dsv3_seq": ("deepseek-v3-671b", {"mtp_depth": 1}, 4, 0.0),
    "jamba_seq": ("jamba-v0.1-52b", {}, 4, 0.0),
}
LAUNCHES = {"2x2": ((2, 2), ("data", "model"),
                    ["qwen3", "dsv3", "jamba", "rwkv6", "seamless", "llava",
                     "qwen3_mb2_clip", "qwen3_seq", "dsv3_seq",
                     "jamba_seq"]),
            "1x4": ((1, 4), ("data", "model"), ["qwen3", "qwen3_h6"]),
            "2x2x2": ((2, 2, 2), ("pod", "data", "model"), ["qwen3"])}


def _drifts(case):
    return CASES[case][0] in DRIFTS or case in DRIFT_CASES


def _cfgs(case):
    arch, over, _, _ = CASES[case]
    return (jax_smoke(arch).with_overrides(dtype="float32", **over),
            smoke_config(arch).with_overrides(dtype="float32", **over))


def _batch(cfg, i):
    return make_batch(cfg, np.random.default_rng([7, i]), B, S)


def _one_mb(case, shape):
    """One microbatch a data shard for an MoE config (module docstring)."""
    cfg = _cfgs(case)[1]
    n_dp = int(np.prod(shape[:-1]))
    return max(CASES[case][2], n_dp if cfg.moe is not None else 1)


def _tree(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _one_device_grads_at(case, shape, mesh):
    """The port's one-device gradient of each step at the mesh's params
    before that step (``q{i}/...`` of the mesh's dump)."""
    _, cfg = _cfgs(case)
    step, opt = make_train_step(cfg, TrainConfig(
        optimizer="adamw", lr=LR, microbatches=_one_mb(case, shape),
        grad_clip=CASES[case][3]))
    out = []
    for i in range(STEPS):
        pre = f"q{i}/"
        model = params_from_jax(_tree({k[len(pre):]: v for k, v in
                                       mesh.items() if k.startswith(pre)}),
                                cfg, device="cpu", train=True)
        step(start_state(model, opt), _batch(cfg, i))
        out.append(named_to_numpy(model, {k: p.grad for k, p in
                                          trainable(model).items()}))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


RANK_CODE = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import bridge
from repro_torch.checkpoint import (restore_train_state, save_checkpoint,
                                    state_tree)
from repro_torch.configs import smoke_config
from repro_torch.data import make_batch
from repro_torch.train import (TrainConfig, init_train_state,
                               make_train_step, start_state, trainable)
TMP, SHAPE, NAMES = {tmp!r}, {shape}, {names}
CASES, RUN = {cases}, {run}
mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=NAMES)

def tree_of(f):
    out = {{}}
    for key in f.files:
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {{}})
        node[last] = f[key]
    return out

def masters_np(model, named):
    return bridge.named_to_numpy(model, bridge.gather_named(named))

res = {{}}
for case in RUN:
    arch, over, mb, clip = CASES[case]
    cfg = smoke_config(arch).with_overrides(dtype="float32", **over)
    with np.load(f"{{TMP}}/{{case}}_weights.npz") as f:
        model = bridge.params_from_jax(tree_of(f), cfg, device="cpu",
                                       train=True)
    bridge.place_on_mesh(model, mesh)
    tc = TrainConfig(optimizer="adamw", lr={lr}, microbatches=mb,
                     grad_clip=clip)
    step, opt = make_train_step(cfg, tc, mesh=mesh)
    state = start_state(model, opt)
    losses, dump = [], {{}}
    for i in range({steps}):
        batch = make_batch(cfg, np.random.default_rng([7, i]), {B}, {S})
        dump.update({{f"q{{i}}/{{k}}": v for k, v in
                     masters_np(model, trainable(model)).items()}})
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        g = masters_np(model, {{k: p.grad for k, p in
                               trainable(model).items()}})
        dump.update({{f"g{{i}}/{{k}}": v for k, v in g.items()}})
    dump.update({{f"p/{{k}}": v for k, v in
                 masters_np(model, trainable(model)).items()}})
    if RANK == 0:
        np.savez(f"{{TMP}}/{{case}}_{{'x'.join(map(str, SHAPE))}}.npz", **dump)
    res[case] = losses
    if case == "qwen3" and SHAPE == (2, 2):
        # the full path's legacy npz: gathered, written by rank 0
        d_mesh, d_one = f"{{TMP}}/ck_mesh", f"{{TMP}}/ck_one"
        tree = state_tree(state)
        if RANK == 0:
            save_checkpoint(d_mesh, state.step, (tree["params"],
                                                 tree["opt_state"]))
            one = init_train_state(cfg, tc, seed=5, device="cpu")
            one, at = restore_train_state(d_mesh, one)
            t1 = state_tree(one)
            save_checkpoint(d_one, at, (t1["params"], t1["opt_state"]))
            a, b = (np.load(f"{{d}}/step_{{at:010d}}.npz")
                    for d in (d_mesh, d_one))
            res["ckpt_same_keys"] = sorted(a.files) == sorted(b.files)
            res["ckpt_bitwise"] = all(
                a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
                for k in a.files)
            res["ckpt_keys"] = len(a.files)
        dist.barrier()
        back = init_train_state(cfg, tc, mesh=mesh, seed=6, device="cpu")
        back, at = restore_train_state(d_one, back)
        want = state_tree(state)
        got = state_tree(back)
        res["ckpt_back_step"] = [at, back.step, back.opt_state["step"]]
        res["ckpt_back_bitwise"] = all(
            np.array_equal(got[top][k], want[top][k])
            for top in ("params",) for k in want[top]) and all(
            np.array_equal(got["opt_state"][m][k], want["opt_state"][m][k])
            for m in ("m", "v") for k in want["opt_state"][m])
print(json.dumps(res))
"""


def _reference(case, shape):
    """(losses, per-step gradients, final params) of the reference's and
    the port's one-device steps, on the case's weights and batches."""
    jcfg, cfg = _cfgs(case)
    _, _, _, clip = CASES[case]
    mb = _one_mb(case, shape)
    params = jax_init(jcfg, jax.random.PRNGKey(11))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    jtc = JaxTrainConfig(optimizer="adamw", lr=LR, microbatches=mb,
                         grad_clip=clip)
    jstep, jopt = jax_train_step(jcfg, None, jtc)
    jstep = jax.jit(jstep)
    jgrad = jax.jit(jax.grad(lambda p, b: jax_loss_fn(jcfg, jtc)(p, b)[0]))
    jstate = jax_init_state(jopt, params)
    step, opt = make_train_step(cfg, TrainConfig(
        optimizer="adamw", lr=LR, microbatches=mb, grad_clip=clip))
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    state = start_state(model, opt)
    out = {"ref_losses": [], "one_losses": [], "ref_g": [], "one_g": []}
    for i in range(STEPS):
        batch = _batch(cfg, i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        n = B // mb
        g = [_flat(jgrad(jstate.params, {k: v[j * n:(j + 1) * n]
                                         for k, v in jb.items()}))
             for j in range(mb)]
        g = {k: np.mean([x[k] for x in g], axis=0) for k in g[0]}
        if clip:
            norm = np.sqrt(sum(float(np.square(v.astype(np.float64)).sum())
                               for v in g.values()))
            g = {k: v * min(1.0, clip / norm) for k, v in g.items()}
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, batch)
        out["ref_losses"].append(float(jm["loss"]))
        out["one_losses"].append(float(m["loss"]))
        out["ref_g"].append(g)
        out["one_g"].append(named_to_numpy(model, {
            k: p.grad for k, p in trainable(model).items()}))
    out["ref_p"] = _flat(jstate.params)
    out["one_p"] = named_to_numpy(model, trainable(model))
    return np_params, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    refs = {}
    for case in CASES:
        jcfg, _ = _cfgs(case)
        np.savez(tmp / f"{case}_weights.npz", **_flat(jax.tree_util.tree_map(
            np.asarray, jax_init(jcfg, jax.random.PRNGKey(11)))))
    ranks = {}

    def launch():
        for name, (shape, names, run) in LAUNCHES.items():
            code = RANK_CODE.format(tmp=str(tmp), shape=shape, names=names,
                                    cases=CASES, run=run, lr=LR, steps=STEPS,
                                    B=B, S=S)
            try:
                ranks[name] = run_ranks(code, int(np.prod(shape)), tmp,
                                        timeout=240)[0]
            except AssertionError as e:
                ranks[name] = e

    t = threading.Thread(target=launch)
    t.start()
    try:
        for name, (shape, _, run) in LAUNCHES.items():
            for case in run:
                key = (case, _one_mb(case, shape))
                if key not in refs:
                    refs[key] = _reference(case, shape)[1]
    finally:
        t.join()
    return tmp, ranks, refs


@pytest.mark.parametrize("launch,case", [
    (name, case) for name, (_, _, run) in LAUNCHES.items() for case in run])
def test_mesh_step_matches_one_device_and_reference(runs, launch, case):
    tmp, ranks, refs = runs
    if isinstance(ranks[launch], Exception):
        raise ranks[launch]
    shape = LAUNCHES[launch][0]
    ref = refs[(case, _one_mb(case, shape))]
    losses = ranks[launch][case]
    for i in range(STEPS):
        assert abs(losses[i] - ref["one_losses"][i]) <= TOL, (i, losses)
        drift = (abs(ref["one_losses"][i] - ref["ref_losses"][i])
                 if _drifts(case) else 0.0)
        assert abs(losses[i] - ref["ref_losses"][i]) <= drift + TOL, (
            i, losses)
    with np.load(tmp / f"{case}_{'x'.join(map(str, shape))}.npz") as f:
        mesh = {k: f[k] for k in f.files}
    for i, want in enumerate(_one_device_grads_at(case, shape, mesh)):
        for k, w in want.items():
            gap = np.abs(mesh[f"g{i}/{k}"] - w)
            assert gap.max(initial=0) <= TOL, (i, k, gap.max())
            assert np.linalg.norm(gap) <= GRAD_REL * np.linalg.norm(w), (
                i, k, np.linalg.norm(gap), np.linalg.norm(w))
    ill = None
    for i in range(STEPS):
        g_ref, g_one = ref["ref_g"][i], ref["one_g"][i]
        # the one-device step's own distance to the reference is the
        # drift bar's for a config in DRIFTS, not an excuse
        # RWKV-6's ln_x also magnifies the rounding in which the mesh's
        # trajectory and the one-device one part (through AdamW's
        # near-eps entries): there, an entry whose gradients on the two
        # trajectories part by more than 1% is excused as well -- the
        # mesh's gradient at the one-device's params is held to TOL
        # above, so no fault of the mesh hides in it
        now = {k: ((np.abs(x) < ILL) & (x != 0))
               | ((np.abs(g_one[k] - x) > NOISY * np.abs(x))
                  & (not _drifts(case)))
               | ((np.abs(mesh[f"g{i}/{k}"] - g_one[k])
                   > NOISY * np.abs(g_one[k]))
                  & (_drifts(case)))
               for k, x in g_ref.items()}
        ill = now if ill is None else {k: ill[k] | now[k] for k in now}
    n_ill = n = 0
    for k, want in ref["ref_p"].items():
        got = mesh[f"p/{k}"]
        n_ill += int(ill[k].sum())
        n += want.size
        drift = (np.abs(ref["one_p"][k] - want)
                 if _drifts(case) else 0.0)
        for other, tol in ((ref["one_p"][k], TOL), (want, drift + TOL)):
            gap = np.abs(got - other)
            assert (gap - tol)[~ill[k]].max(initial=0) <= 0, (k, gap.max())
            assert gap.max() <= STEPS * LR, (k, gap.max())
    assert n_ill < SHARE.get(case, DEFAULT_SHARE) * n


def test_mesh_state_legacy_checkpoint(runs):
    _, ranks, _ = runs
    r = ranks["2x2"]
    if isinstance(r, Exception):
        raise r
    assert r["ckpt_same_keys"] and r["ckpt_bitwise"] and r["ckpt_keys"] > 10
    assert r["ckpt_back_step"] == [STEPS, STEPS, STEPS]
    assert r["ckpt_back_bitwise"]
