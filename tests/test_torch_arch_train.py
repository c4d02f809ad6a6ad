"""Training RWKV-6, Jamba (Mamba, attention, MoE) and DeepSeek-V3 (MLA,
sigmoid-router MoE; ``mtp_depth=0``) against the reference, at each
smoke config in fp32 on the same bridged weights -- and DeepSeek-V3 and
qwen3 with an MTP head (``mtp_depth=1``): the train-mode
forward; five AdamW steps of losses and params against the reference's
``make_train_step`` (DeepSeek-V3's router balance bias decaying with no
gradient); ``update_router_bias``; ``Trainer(model_cfg=...)``; and the
bridge of each tree, leaf for leaf."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.core import init_train_state as jax_init_state
from repro.models import apply_model as jax_apply
from repro.models import init_model as jax_init
from repro.models import moe as jax_moe
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_train_step
from repro_torch.api import Trainer
from repro_torch.bridge import named_to_numpy, params_from_jax, params_to_numpy
from repro_torch.configs import smoke_config
from repro_torch.models import apply_model, init_model
from repro_torch.models import moe as moe_lib
from repro_torch.train import (TrainConfig, lm_loss, make_train_step,
                               start_state, trainable)

torch.set_num_threads(2)

ARCHS = ["rwkv6-1.6b", "jamba-v0.1-52b", "deepseek-v3-671b"]
# ROADMAP A.1's gate: fp32 losses and params within 1e-5 of the reference
TOL = 1e-5
# the train-mode logits: the same gate, but for RWKV-6, held (as in
# tests/test_torch_arch_slab.py) to the port's RWKV logit bar, its
# cross-library logit gap reaching 2.3e-5 at some lengths
LOGIT_TOL = {"rwkv6-1.6b": 1e-4, "jamba-v0.1-52b": TOL,
             "deepseek-v3-671b": TOL}
# AdamW's near-eps rule (tests/test_torch_train.py): params whose
# reference gradient fell below ILL at some step are held to what five
# steps of at most lr can move them.  Adam's update g / (|g| + eps) is
# sign-like, so the same holds where the gradient is within the two
# libraries' rounding of zero: an entry whose two gradients differ by
# more than NOISY of the reference's at some step is held to 5 lr too.
# With the near-eps entries they are 1.25% of Jamba's and 1.27% of
# DeepSeek-V3's params (the noisy ones alone 0.16% and 0.11%); RWKV-6's
# ln_x normalises heads whose WKV output has an rms down to 6.6e-3
# (median 11), which magnifies the rounding of those heads some
# thousandfold, and 9.7% of its entries are such
ILL = 1e-6
NOISY = 1e-2
NOISY_SHARE = {"rwkv6-1.6b": 0.15, "jamba-v0.1-52b": 0.02,
               "deepseek-v3-671b": 0.02}
# with an MTP head: its gradient is scaled by mtp_weight (0.1), so ten
# times more of its entries fall under ILL -- 2.35% of DeepSeek-V3's and
# 2.40% of qwen3's entries at the smoke configs, the noisy ones 0.23%
# and 0.10% -- and the share is held to this
MTP_SHARE = 0.03
B, S, STEPS, LR = 4, 32, 5, 3e-4
_REFS = {}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


@pytest.fixture(params=ARCHS)
def ref(request):
    """(jcfg, params, numpy params, cfg): a nonzero router balance bias,
    so that its weight decay shows."""
    return _ref(request.param, mtp_depth=0)


def _ref(arch, mtp_depth):
    key = (arch, mtp_depth)
    if key not in _REFS:
        jcfg = jax_smoke(arch).with_overrides(dtype="float32",
                                              mtp_depth=mtp_depth)
        params = jax_init(jcfg, jax.random.PRNGKey(11))
        rng = np.random.default_rng(2)
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(rng.uniform(-0.5, 0.5, a.shape),
                                     a.dtype)
            if "router_bias" in jax.tree_util.keystr(p) else a, params)
        cfg = smoke_config(arch).with_overrides(dtype="float32",
                                                mtp_depth=mtp_depth)
        _REFS[key] = (jcfg, params,
                      jax.tree_util.tree_map(np.asarray, params), cfg)
    return _REFS[key]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_forward_matches_reference(ref, remat):
    jcfg, params, np_params, cfg = ref
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax_apply(jcfg, params, {"tokens": jnp.asarray(tokens)},
                     mode="train")
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    got = apply_model(cfg, model, torch.from_numpy(tokens), mode="train",
                      remat=remat)
    np.testing.assert_allclose(got["logits"].detach().numpy(),
                               np.asarray(want["logits"]), rtol=0,
                               atol=LOGIT_TOL[cfg.name])
    np.testing.assert_allclose(float(got["aux"].detach()) if isinstance(
        got["aux"], torch.Tensor) else got["aux"], float(want["aux"]),
                               rtol=TOL, atol=1e-9)


def test_five_adamw_steps_match_reference(ref):
    _five_adamw_steps(*ref)


@pytest.fixture(params=["qwen3-1.7b", "deepseek-v3-671b"])
def mtp_ref(request):
    """(jcfg, params, numpy params, cfg) of a smoke config with its MTP
    head (``mtp_depth=1``: DeepSeek-V3's own, an override for qwen3)."""
    return _ref(request.param, mtp_depth=1)


def test_five_adamw_steps_with_mtp_match_reference(mtp_ref):
    """Training with the MTP head: the train-mode ``mtp_logits`` and five
    AdamW steps of losses, ``mtp_ce`` and params (the head's included)
    against the reference, as above."""
    jcfg, params, np_params, cfg = mtp_ref
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax_apply(jcfg, params, {"tokens": jnp.asarray(tokens)},
                     mode="train")
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    got = apply_model(cfg, model, torch.from_numpy(tokens), mode="train")
    np.testing.assert_allclose(got["mtp_logits"].detach().numpy(),
                               np.asarray(want["mtp_logits"]), rtol=0,
                               atol=TOL)
    _five_adamw_steps(*mtp_ref, share=MTP_SHARE)


def _five_adamw_steps(jcfg, params, np_params, cfg, share=None):
    jtc = JaxTrainConfig(optimizer="adamw", lr=LR)
    jstep, jopt = jax_train_step(jcfg, None, jtc)
    jstep = jax.jit(jstep)
    jgrad = jax.jit(jax.grad(lambda p, b: jax_loss_fn(jcfg, jtc)(p, b)[0]))
    jstate = jax_init_state(jopt, params)
    step, opt = make_train_step(cfg, TrainConfig(optimizer="adamw", lr=LR))
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    state = start_state(model, opt)
    masters = trainable(model)
    rng = np.random.default_rng(3)
    ill = None
    for i in range(STEPS):
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        g = _paths(jgrad(jstate.params, {"tokens": jnp.asarray(tokens)}))
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": tokens})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL, i
        assert ("mtp_ce" in m) == (cfg.mtp_depth > 0) == ("mtp_ce" in jm)
        if cfg.mtp_depth:
            assert abs(float(m["mtp_ce"]) - float(jm["mtp_ce"])) <= TOL, i
        # the step leaves this step's gradients in the masters' .grad
        pg = named_to_numpy(model, {k: p.grad for k, p in masters.items()})
        now = {k: ((np.abs(x) < ILL) & (x != 0))
               | (np.abs(pg[k] - x) > NOISY * np.abs(x)) for k, x in g.items()}
        ill = now if ill is None else {k: ill[k] | now[k] for k in g}
    got = _paths(params_to_numpy(model, cfg))
    want = _paths(jstate.params)
    assert set(got) == set(want)
    n_ill = 0
    for k, w in want.items():
        gap = np.abs(got[k] - w)
        n_ill += int(ill[k].sum())
        assert gap[~ill[k]].max(initial=0) <= TOL, (k, gap[~ill[k]].max())
        assert gap.max() <= STEPS * LR, (k, gap.max())
    share = NOISY_SHARE[cfg.name] if share is None else share
    assert n_ill < share * sum(w.size for w in want.values())
    # the balance bias has no gradient on either side: AdamW's decay alone
    # moves it, by (1 - lr wd) a step
    for k, w in want.items():
        if k.endswith("router_bias"):
            assert not ill[k].any() and not np.abs(pg[k]).any()
            b0 = _paths(np_params)[k]
            np.testing.assert_allclose(got[k], b0 * (1 - LR * 0.01) ** STEPS,
                                       rtol=1e-6)
            np.testing.assert_allclose(got[k], w, rtol=1e-6)
            assert np.abs(got[k] - b0).max() > 0


@pytest.mark.parametrize("ref", ["jamba-v0.1-52b", "deepseek-v3-671b"],
                         indirect=True)
def test_router_bias_gets_no_gradient(ref):
    """The selection carries no gradient and the balance bias none at all
    (the reference's stop_gradient); the router, the experts and the aux
    loss do carry one, and the step reads the bias's missing gradient as
    zeros."""
    jcfg, params, np_params, cfg = ref
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)))
    out = apply_model(cfg, model, tokens, mode="train")
    loss, _ = lm_loss(cfg, out, {"tokens": tokens})
    loss.backward()
    named = trainable(model)
    biases = [n for n in named if n.endswith("router_bias")]
    assert (len(biases) > 0) == (cfg.moe.router_type == "sigmoid")
    assert all(named[n].grad is None for n in biases)
    for part in ("router", "experts.w_up", "experts.w_down"):
        grads = [p.grad for n, p in named.items() if n.endswith(part)]
        assert grads and all(g is not None and g.abs().max() > 0
                             for g in grads), part
    step, opt = make_train_step(cfg, TrainConfig())
    state = start_state(model, opt)
    step(state, {"tokens": tokens.numpy()})
    assert all(named[n].grad is not None and not named[n].grad.any()
               for n in biases)


# --------------------------------------------------------------------------
# update_router_bias (twins of the reference's tests/test_moe.py:117, :135
# and tests/test_features.py:136)
# --------------------------------------------------------------------------

def _bias_params(cfg, value=0.0):
    return {"router_bias": torch.full((cfg.moe.num_experts,), value)}


def test_update_router_bias_exact_gamma_opposite_directions():
    cfg = smoke_config("deepseek-v3-671b")
    p = _bias_params(cfg)
    E, gamma = cfg.moe.num_experts, 1e-3
    counts = np.full((E,), 8)
    counts[0], counts[1] = 20, 0
    jp = {"router_bias": jnp.zeros((E,), jnp.float32)}
    for dt in (torch.int32, torch.float32, torch.bfloat16):
        new = moe_lib.update_router_bias(cfg, p, torch.tensor(counts).to(dt),
                                         gamma=gamma)
        d = new.double().numpy() - p["router_bias"].double().numpy()
        assert d[0] == -np.float32(gamma), (dt, d[0])
        assert d[1] == +np.float32(gamma), (dt, d[1])
        want = jax_moe.update_router_bias(cfg, jp, jnp.asarray(counts),
                                          gamma=gamma)
        np.testing.assert_array_equal(new.numpy(), np.asarray(want))


def test_update_router_bias_no_bf16_freeze():
    cfg = smoke_config("deepseek-v3-671b")
    p = _bias_params(cfg, 8.0)
    counts = torch.tensor(np.r_[20, np.full((cfg.moe.num_experts - 1,), 8)],
                          dtype=torch.bfloat16)
    new = moe_lib.update_router_bias(cfg, p, counts, gamma=1e-3)
    assert float(new[0]) < 8.0


def test_update_router_bias_direction():
    cfg = smoke_config("deepseek-v3-671b").with_overrides(
        moe=smoke_config("deepseek-v3-671b").moe)
    p = _bias_params(cfg)
    counts = torch.tensor([10.0, 0.0, 5.0, 5.0])
    new = moe_lib.update_router_bias(cfg, p, counts, gamma=0.1)
    assert float(new[0]) < 0 < float(new[1])
    assert float(new[2]) == float(new[3]) == 0.0


# --------------------------------------------------------------------------
# the Trainer and the bridge
# --------------------------------------------------------------------------

def test_trainer_model_cfg_trains(ref):
    """``Trainer(model_cfg=...)`` takes every ported architecture: its
    sequential steps give the one-device train step's losses."""
    _, _, _, cfg = ref
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    trainer = Trainer.create(cfg, optimizer="adamw", lr=LR, seed=3,
                             device="cpu")
    got = [float(trainer.step({"tokens": tokens})["loss"]) for _ in range(2)]
    step, opt = make_train_step(cfg, TrainConfig(optimizer="adamw", lr=LR,
                                                 remat=False))
    state = start_state(init_model(cfg, seed=3, device="cpu", train=True),
                        opt)
    want = []
    for _ in range(2):
        state, m = step(state, {"tokens": tokens})
        want.append(float(m["loss"]))
    assert got == want and np.isfinite(got).all()


def test_bridge_round_trips_every_leaf(ref):
    """``params_from_jax(train=True)`` holds one master per reference
    leaf; ``params_to_numpy`` and ``named_to_numpy`` give every leaf back
    bitwise, at its reference path (stacked super-blocks on n_rep, the
    router balance bias included)."""
    _, _, np_params, cfg = ref
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    want = _paths(np_params)
    got = _paths(params_to_numpy(model, cfg))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    named = named_to_numpy(model, trainable(model))
    assert set(named) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(named[k], w, err_msg=k)
    assert sum(p.numel() for p in trainable(model).values()) == sum(
        w.size for w in want.values())
