"""The port's training slice against the reference on the CPU: the loss,
the train-mode forward, the plain backward of the flash-attention
kernel, and ``make_train_step`` over five AdamW steps on bridged weights
(ROADMAP A.1's gate), with microbatches, clipping and the cosine
schedule; remat, the tied master, the refusals and the launcher.
Inputs are drawn with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_kernels import FLASH_CASES

from repro.configs import smoke_config as jax_smoke
from repro.core import init_train_state as jax_init_state
from repro.models import apply_model as jax_apply
from repro.models import init_model as jax_init
from repro.train import loss as jax_loss
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_train_step
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import make_batch
from repro_torch.kernels import flash_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import apply_model, check_train_ported
from repro_torch.models import init_model
from repro_torch.train import (IGNORE, TrainConfig, cross_entropy, lm_loss,
                               make_labels, make_train_step, start_state,
                               trainable)

torch.set_num_threads(2)

# ROADMAP A.1's gate: fp32 losses and params within 1e-5 of the reference
TOL = 1e-5
# AdamW's update g / (|g| + eps) turns the ~1e-8 fp32 noise between two
# gradients into a step of up to lr where |g| falls near eps = 1e-8; the
# params whose reference gradient fell below ILL = 100 eps at some step
# are held to what five such steps can move them instead
ILL = 1e-6
# the plain backward against autograd of the plain forward (fp32)
GRAD_TOL = 2e-5
B, S, STEPS = 4, 32, 5


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_smoke("qwen3-1.7b").with_overrides(dtype="float32")
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    return jcfg, params, jax.tree_util.tree_map(np.asarray, params), cfg


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def test_labels_ce_and_lm_loss_match_reference(ref):
    jcfg, _, _, cfg = ref
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 50, (3, 9)).astype(np.int32)
    logits = rng.standard_normal((3, 9, 50)).astype(np.float32) * 3
    labels = make_labels(cfg, {"tokens": torch.from_numpy(tokens)})
    want = jax_loss.make_labels(jcfg, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want))
    assert (labels[:, -1] == IGNORE).all()
    # masked positions (padding) anywhere, and a row fully masked
    lab = labels.numpy().copy()
    lab[0, 2:5] = IGNORE
    lab[2, :] = IGNORE
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
    want = jax_loss.cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    out = {"logits": torch.from_numpy(logits), "aux": torch.tensor(0.25)}
    total, metrics = lm_loss(cfg, out, {"tokens": torch.from_numpy(tokens)})
    jt, jm = jax_loss.lm_loss(jcfg, {"logits": jnp.asarray(logits),
                                     "aux": jnp.float32(0.25)},
                              {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(float(total), float(jt), rtol=TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]),
                               rtol=TOL)
    # nothing masked: CE is the mean over every position
    lab = np.zeros((1, 1), np.int64)
    np.testing.assert_allclose(
        float(cross_entropy(torch.zeros(1, 1, 4), torch.from_numpy(lab))),
        np.log(4), rtol=1e-6)


def test_lm_loss_refuses_the_mtp_term(ref):
    cfg = ref[3]
    out = {"logits": torch.zeros(1, 4, 8), "aux": 0.0,
           "mtp_logits": torch.zeros(1, 3, 8)}
    with pytest.raises(ValueError, match="multi-token-prediction"):
        lm_loss(cfg, out, {"tokens": torch.zeros(1, 4, dtype=torch.long)})


# --------------------------------------------------------------------------
# the train-mode forward and the plain attention backward
# --------------------------------------------------------------------------

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
    assert got["logits"].dtype == torch.float32
    np.testing.assert_allclose(got["logits"].detach().numpy(),
                               np.asarray(want["logits"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(got["hidden"].detach().numpy(),
                               np.asarray(want["hidden"]), rtol=0, atol=TOL)


@pytest.mark.parametrize("chunk", [1024, 16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_ref_matches_autograd_of_plain(case, chunk):
    """The kernel's backward (recompute a q-chunk at a time) against
    autograd of ``flash_attention_ref`` over the reference's FLASH_CASES,
    causal, windowed and bidirectional; chunk 16 cuts every case into
    several chunks."""
    B_, S_, T, h, hk, hd, causal, window = case
    rng = np.random.default_rng(sum(case) + chunk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B_, S_, h, hd), (B_, T, hk, hd), (B_, T, hk, hd)))
    dout = torch.from_numpy(
        rng.standard_normal((B_, S_, h, hd)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, dout)
    got = flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                  window=window, chunk=chunk)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_train_attention_gradient_matches_reference_loop():
    """The CPU train branch (the port's ``chunked_attention`` loop) has
    the gradient of the reference's checkpointed loop."""
    from repro.models.attention import chunked_attention as jax_chunked
    from repro_torch.models.attention import chunked_attention
    rng = np.random.default_rng(5)
    Bq, Sq, h, hk, hd = 2, 40, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Bq, Sq, h, hd), (Bq, Sq, hk, hd), (Bq, Sq, hk, hd)))
    w = rng.standard_normal((Bq, Sq, h, hd)).astype(np.float32)

    def jloss(q, k, v):
        pos = jnp.arange(Sq)
        out = jax_chunked(q, k, v, q_positions=pos, kv_positions=pos,
                          chunk=16)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = chunked_attention(*leaves, q_positions=range(Sq),
                            kv_positions=range(Sq), chunk=16)
    (out * torch.from_numpy(w)).sum().backward()
    for t, wnt in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt), rtol=0,
                                   atol=GRAD_TOL)


# --------------------------------------------------------------------------
# the train step: five AdamW steps against the reference
# --------------------------------------------------------------------------

CASES = {
    "adamw": {},
    "microbatches": {"microbatches": 2},
    "grad_clip": {"grad_clip": 0.5},
    "cosine": {"schedule": "cosine", "warmup_steps": 2, "total_steps": 10},
}


@pytest.mark.parametrize("case", list(CASES))
def test_five_adamw_steps_match_reference(ref, case):
    jcfg, params, np_params, cfg = ref
    kw = dict(optimizer="adamw", lr=3e-4, **CASES[case])
    jstep, jopt = jax_train_step(jcfg, None, JaxTrainConfig(**kw))
    jstep = jax.jit(jstep)
    jgrad = jax.jit(jax.grad(
        lambda p, b: jax_loss_fn(jcfg, JaxTrainConfig())(p, b)[0]))
    jstate = jax_init_state(jopt, params)
    step, opt = make_train_step(cfg, TrainConfig(**kw))
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    state = start_state(model, opt)
    rng = np.random.default_rng(3)
    min_grad = None
    for i in range(STEPS):
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        g = _leaves(jgrad(jstate.params, {"tokens": jnp.asarray(tokens)}))
        min_grad = ({k: np.abs(x) for k, x in g.items()} if min_grad is None
                    else {k: np.minimum(min_grad[k], np.abs(x))
                          for k, x in g.items()})
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": tokens})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL, i
        if "grad_norm" in jm:
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=TOL)
    assert state.step == STEPS and state.opt_state["step"] == STEPS
    got = _leaves(params_to_numpy(model, cfg))
    want = _leaves(jstate.params)
    assert set(got) == set(want)
    n_ill = 0
    for k, w in want.items():
        gap = np.abs(got[k] - w)
        well = min_grad[k] >= ILL
        n_ill += int((~well).sum())
        assert gap[well].max(initial=0) <= TOL, (k, gap[well].max())
        assert gap.max() <= STEPS * kw["lr"], (k, gap.max())
    # the exception covers a sliver of the params, not the check
    assert n_ill < 1e-2 * sum(w.size for w in want.values())


def test_remat_on_and_off_train_alike(ref):
    _, _, np_params, cfg = ref
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S))
    out = {}
    for remat in (False, True):
        step, opt = make_train_step(cfg, TrainConfig(remat=remat))
        model = params_from_jax(np_params, cfg, device="cpu", train=True)
        state = start_state(model, opt)
        losses = []
        for _ in range(2):
            state, m = step(state, {"tokens": tokens})
            losses.append(float(m["loss"]))
        out[remat] = (losses, _leaves(params_to_numpy(model, cfg)))
    assert out[False][0] == out[True][0]
    for k, w in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][k], w, err_msg=k)


def test_tied_table_is_one_master(ref):
    jcfg, params, np_params, cfg = ref
    assert cfg.tie_embeddings
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    names = list(trainable(model))
    assert model.unembed_f32 is model.embed
    assert "embed" in names and not any("unembed" in n for n in names)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in trainable(model).values())
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(np_params))
    assert sum(p.numel() for p in trainable(model).values()) == n_ref
    # its gradient sums the embedding's and the unembedding's uses, as the
    # reference's gradient of the one table does
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16))
    out = apply_model(cfg, model, torch.from_numpy(tokens), mode="train")
    loss, _ = lm_loss(cfg, out, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    want = jax.grad(lambda p: jax_loss_fn(jcfg, JaxTrainConfig())(
        p, {"tokens": jnp.asarray(tokens)})[0])(params)["embed"]["table"]
    np.testing.assert_allclose(model.embed.grad.numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_serving_model_stays_frozen_and_cast(ref):
    _, _, np_params, cfg = ref
    model = params_from_jax(np_params, cfg.with_overrides(dtype="bfloat16"),
                            device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    assert model.layers[0].mixer["wq"].dtype == torch.bfloat16
    assert not trainable(model)
    step, opt = make_train_step(cfg, TrainConfig())
    with pytest.raises(ValueError, match="train=True"):
        step(start_state(model, opt), {"tokens": np.zeros((2, 8), np.int32)})


def test_bridge_round_trips_the_masters(ref):
    _, _, np_params, cfg = ref
    model = params_from_jax(np_params, cfg.with_overrides(dtype="bfloat16"),
                            device="cpu", train=True)
    got = _leaves(params_to_numpy(model, cfg))
    for k, w in _leaves(np_params).items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


# --------------------------------------------------------------------------
# refusals, batches and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,part", [
    ("rwkv6-1.6b", "RWKV-6 layers"),
    ("jamba-v0.1-52b", "Mamba layers"),
    ("jamba-v0.1-52b", "MoE ffn"),
    ("deepseek-v3-671b", "MLA attention"),
    ("deepseek-v3-671b", "the MTP head"),
])
def test_check_train_ported_refuses_by_name(arch, part):
    cfg = smoke_config(arch)
    with pytest.raises(ValueError, match=part):
        check_train_ported(cfg)
    with pytest.raises(ValueError, match=part):
        init_model(cfg, device="cpu", train=True)
    with pytest.raises(SystemExit, match=part):
        launch_train.main(["--arch", arch, "--reduced", "--device", "cpu"])
    check_train_ported(smoke_config("qwen3-1.7b"))


def test_train_mode_takes_no_cache(ref):
    cfg = ref[3]
    model = init_model(cfg, device="cpu", train=True)
    with pytest.raises(ValueError, match="no cache"):
        apply_model(cfg, model, torch.zeros(1, 4, dtype=torch.long),
                    mode="train", cache=[], cache_pos=0)
    with pytest.raises(ValueError, match="serving cache"):
        apply_model(cfg, model, torch.zeros(1, 4, dtype=torch.long),
                    mode="prefill")


def test_make_batch_is_a_function_of_the_seed():
    cfg = smoke_config("qwen3-1.7b")
    a = make_batch(cfg, np.random.default_rng(7), 3, 20)
    b = make_batch(cfg, np.random.default_rng(7), 3, 20)
    assert set(a) == {"tokens"} and a["tokens"].dtype == np.int32
    assert a["tokens"].shape == (3, 20)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert 0 <= a["tokens"].min() and a["tokens"].max() < cfg.vocab_size


def test_init_model_train_masters_are_the_serving_weights():
    """The training masters drawn from a seed, cast to bf16, are the
    serving model's weights from the same seed."""
    cfg = smoke_config("qwen3-1.7b")
    serve = init_model(cfg, seed=5, device="cpu")
    masters = init_model(cfg, seed=5, device="cpu", train=True)
    weights = dict(serve.named_parameters())
    for name, b in trainable(masters).items():
        a = weights[name]
        assert torch.equal(a, b.detach().to(a.dtype)), name
    assert torch.equal(serve.unembed_f32, masters.embed.detach())


def test_launcher_trains_on_the_cpu(capsys):
    launch_train.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "4", "--seq", "32",
                       "--microbatches", "2", "--grad-clip", "1.0"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "tokens/s" in out and "peak device memory: not measured" in out


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps",
                           "1"])


def test_full_config_is_trainable_by_name():
    """The full qwen3-1.7b passes the refusal (the card trains it,
    ``chip_smoke.py`` phase 13); its masters are counted, not drawn."""
    cfg = get_config("qwen3-1.7b")
    check_train_ported(cfg)
    assert 1.7e9 < cfg.param_count() < 1.8e9
