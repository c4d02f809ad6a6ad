"""The port's lockstep slab engine against the reference: greedy tokens
and the dispatch / host-sync counters of ``ServeEngine`` bitwise-equal
to the reference's, and equal to the port's own continuous scheduler;
EOS pinning of retired slots; slab logits; the constructor's and the
launcher's refusals; configs whose slab path is not ported."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import apply_model as jax_apply
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init
from repro.serve import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import apply_model, init_cache, init_model
from repro_torch.serve import ContinuousScheduler, ServeEngine, make_engine

torch.set_num_threads(2)

B, S0, NEW, MAX_LEN = 3, 20, 10, 64


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_smoke("qwen3-1.7b").with_overrides(dtype="float32")
    params = jax_init(jcfg, jax.random.PRNGKey(3))
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)
    return jcfg, params, cfg, model, prompts


def _both(ref, **kw):
    jcfg, params, cfg, model, prompts = ref
    je = JaxEngine(jcfg, params, batch_size=B, max_len=MAX_LEN,
                   dtype=jnp.float32, **kw)
    te = ServeEngine(cfg, model, batch_size=B, max_len=MAX_LEN, **kw)
    return (np.asarray(je.generate(jnp.asarray(prompts), NEW)), je,
            te.generate(prompts, NEW).numpy(), te)


def _free(ref):
    _, _, cfg, model, prompts = ref
    return ServeEngine(cfg, model, batch_size=B,
                       max_len=MAX_LEN).generate(prompts, NEW).numpy()


def _eos(free):
    """(index, token): a token whose FIRST occurrence in row 0 is at
    an index >= 2 and that no other row ever emits -- so row 0 retires
    exactly there and the other rows run free."""
    for idx in range(2, NEW - 1):
        t = int(free[0, idx])
        if t not in free[0, :idx] and t not in free[1:]:
            return idx, t
    raise AssertionError(f"no usable EOS in {free}")


@pytest.mark.parametrize("with_eos", [False, True], ids=["free", "eos"])
def test_greedy_tokens_and_counters_bitwise_equal_reference(ref, with_eos):
    kw = {"eos_id": _eos(_free(ref))[1]} if with_eos else {}
    jo, je, to, te = _both(ref, **kw)
    assert to.dtype == np.int32 and to.shape == jo.shape == (B, NEW)
    np.testing.assert_array_equal(to, jo)
    assert (te.dispatches, te.host_syncs) == (je.dispatches, je.host_syncs)
    assert te.dispatches == 2 * NEW
    assert te.host_syncs == (NEW - 1 if with_eos else 0)


def test_matches_the_continuous_scheduler(ref):
    """The lockstep slab and the paged continuous engine give the same
    greedy tokens for the same prompts (the reference's
    ``test_scheduler_lockstep_bitwise_matches_legacy``)."""
    _, _, cfg, model, prompts = ref
    sched = ContinuousScheduler(cfg, model, slots=B, max_len=MAX_LEN,
                                page_size=8, prefill_chunk=8, decode_chunk=4)
    outs = sched.generate(list(prompts), NEW)
    np.testing.assert_array_equal(np.stack(outs), _free(ref))


def test_eos_pins_retired_slots(ref):
    _, _, cfg, model, prompts = ref
    free = _free(ref)
    idx, eos = _eos(free)
    eng = ServeEngine(cfg, model, batch_size=B, max_len=MAX_LEN, eos_id=eos)
    out = eng.generate(prompts, NEW).numpy()
    np.testing.assert_array_equal(out[0, :idx + 1], free[0, :idx + 1])
    assert (out[0, idx + 1:] == eos).all(), "post-EOS slot leaked tokens"
    np.testing.assert_array_equal(out[1:], free[1:])
    assert eng.host_syncs == NEW - 1         # the per-token round-trip


def test_eos_on_every_row_ends_the_batch(ref):
    """When every slot has emitted EOS the loop stops early, as the
    reference's does: a first token that is already EOS still takes one
    decode step (pinned to EOS), then the batch ends."""
    jcfg, params, cfg, model, prompts = ref
    eos = int(_free(ref)[1, 0])
    je = JaxEngine(jcfg, params, batch_size=1, max_len=MAX_LEN,
                   dtype=jnp.float32, eos_id=eos)
    jo = np.asarray(je.generate(jnp.asarray(prompts[1:2]), NEW))
    eng = ServeEngine(cfg, model, batch_size=1, max_len=MAX_LEN, eos_id=eos)
    out = eng.generate(prompts[1:2], NEW).numpy()
    np.testing.assert_array_equal(out, jo)
    assert out.shape == (1, 2) and (out == eos).all()
    assert (eng.dispatches, eng.host_syncs) == (je.dispatches,
                                                je.host_syncs) == (4, 1)


def test_slab_logits_match_reference(ref):
    """A slab prefill and two decode steps: the logits against the
    reference's apply_model at the attention bar."""
    jcfg, params, cfg, model, prompts = ref
    jcache = jax_init_cache(jcfg, B, 32, jnp.float32)
    tcache = init_cache(cfg, torch.float32, batch=B, max_len=32,
                        device="cpu")
    toks = prompts[:, :12]
    steps = [("prefill", 0, toks), ("decode", 12, prompts[:, 12:13]),
             ("decode", 13, prompts[:, 13:16])]
    for mode, pos, t in steps:
        jout = jax_apply(jcfg, params, {"tokens": jnp.asarray(t)}, mode=mode,
                         cache=jcache, cache_pos=pos)
        jcache = jout["cache"]
        tout = apply_model(cfg, model, torch.from_numpy(t), cache=tcache,
                           cache_pos=pos, mode=mode)
        np.testing.assert_allclose(tout["logits"].numpy(),
                                   np.asarray(jout["logits"]), atol=1e-4,
                                   rtol=1e-4)
    # the reference stacks its layers' caches: (layers, B, max_len, hk, hd)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            torch.stack([c[name] for c in tcache]).numpy(),
            np.asarray(jcache["blocks"]["layer0"][name]), atol=1e-5)


def test_make_engine_legacy_and_its_refusals(ref):
    jcfg, params, cfg, model, prompts = ref
    tree = jax.tree_util.tree_map(np.asarray, params)
    eng = make_engine(cfg, tree, engine="legacy", batch_size=B,
                      max_len=MAX_LEN, device="cpu")
    assert isinstance(eng, ServeEngine)
    np.testing.assert_array_equal(eng.generate(prompts, NEW).numpy(),
                                  _free(ref))
    with pytest.raises(TypeError, match="page_size"):
        make_engine(cfg, model, engine="legacy", device="cpu", page_size=8)
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine(cfg, model, engine="slab", device="cpu")
    with pytest.raises(ValueError, match="overrun"):
        eng.generate(prompts, MAX_LEN)


def test_launcher_runs_legacy_and_refuses_more_requests_than_slots(capsys):
    outs = launch_serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                              "cpu", "--engine", "legacy", "--batch", "2",
                              "--prompt-len", "40", "--new-tokens", "12",
                              "--report"])
    assert [len(o) for o in outs] == [12, 12]
    assert "report: legacy 24 dispatches / 0 host syncs" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                           "cpu", "--engine", "legacy", "--requests", "3",
                           "--batch", "2"])


@pytest.mark.parametrize("arch,part", [
    ("deepseek-v3-671b", "MLA attention"),
    ("jamba-v0.1-52b", "Mamba layers"),
    ("rwkv6-1.6b", "RWKV-6 layers"),
])
def test_slab_path_refuses_unported_kinds(arch, part):
    """Once refused, now ported: the slab path accepts and runs every
    architecture -- ``make_engine(engine="legacy")`` generates, the slab
    cache holds each layer kind's own entry, and a MoE stack's slab
    prefill runs (``part`` names what the slab path gained)."""
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    model = init_model(cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6))
    eng = make_engine(cfg, model, engine="legacy", batch_size=2, max_len=16,
                      device="cpu")
    out = eng.generate(prompts, 4).numpy()
    assert out.shape == (2, 4) and out.min() >= 0 \
        and out.max() < cfg.vocab_size, part
    cache = init_cache(cfg, torch.float32, batch=1, max_len=16, device="cpu")
    keys = {"attn": {"ckv", "krope"} if cfg.attention == "mla"
            else {"k", "v"}, "mamba": {"ssm", "conv"},
            "rwkv6": {"state", "shift_tm", "shift_cm"}}
    assert [set(c) for c in cache] == [keys[kind]
                                       for kind, _ in cfg.layer_pattern()]
    if cfg.moe is not None:
        got = apply_model(cfg, model, torch.zeros((1, 4), dtype=torch.int32),
                          cache=cache, cache_pos=0, mode="prefill")
        assert got["logits"].shape == (1, 4, cfg.vocab_size)
        assert torch.isfinite(got["logits"]).all()


def test_legacy_entry_points_default_to_the_card(ref):
    """Without ``--device cpu`` / ``device="cpu"`` the legacy engine asks
    for the card and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, _, cfg, model, _ = ref
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--reduced", "--engine",
                           "legacy", "--batch", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine(cfg, model, engine="legacy", max_len=MAX_LEN)
