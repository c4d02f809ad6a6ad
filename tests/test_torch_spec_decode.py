"""The port's speculative decoding with the MTP head against the
reference's (twins of ``tests/test_spec_decode.py`` without the mesh and
perf-model cases): ``accept_speculative``'s five cases; spec k in {2, 4}
bitwise-equal to k = 0 for qwen3 with an MTP head and for DeepSeek-V3,
whose tokens and acceptance counts equal the reference's on the same
bridged weights; spec with the prefix cache; the refusals and the page
slack; and a trained head (EOS mid-chunk, a checkpoint served with spec,
the dispatch drop), its tokens and acceptance equal to the reference
scheduler's on the port's trained weights.  Then ``params["mtp"]``
across the bridge, the flat (ZeRO) order and checkpoints, both ways."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

from repro.configs import smoke_config as jax_smoke
from repro.models import init_model as jax_init
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve.sampling import accept_speculative as jax_accept
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import smoke_config
from repro_torch.models import init_model
from repro_torch.serve import (ContinuousScheduler, SamplingConfig,
                               accept_speculative)

torch.set_num_threads(2)

# the reference fixture's widths (tests/test_spec_decode.py:30); on the
# CPU the plain attention takes any width
TINY = dict(mtp_depth=1, d_model=64, d_ff=128, num_heads=2,
            num_kv_heads=1, head_dim=32)
_MODELS = {}


def _cfg(arch="qwen3-1.7b", **over):
    return smoke_config(arch).with_overrides(dtype="float32", **over)


def _jcfg(arch="qwen3-1.7b", **over):
    return jax_smoke(arch).with_overrides(dtype="float32", **over)


def _models(arch, **over):
    """(reference params, port model) on the same weights."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        params = jax_init(_jcfg(arch, **over), jax.random.PRNGKey(3))
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                _cfg(arch, **over), device="cpu")
        _MODELS[key] = (params, model)
    return _MODELS[key]


def _prompts(cfg, lens=(7, 12, 5, 9)):
    return [np.asarray(jax.random.randint(jax.random.PRNGKey(10 + i), (n,),
                                          0, cfg.vocab_size))
            for i, n in enumerate(lens)]


# --------------------------------------------------------------------------
# accept_speculative
# --------------------------------------------------------------------------

@pytest.mark.parametrize("targets,chunk,done,eos,want", [
    # all drafts match / draft1 wrong / draft0 wrong
    ([[10, 11, 12, 13]] * 3, [[9, 10, 11, 12], [9, 10, 99, 12],
                              [9, 99, 11, 12]], None, None,
     ([[10, 11, 12, 13], [10, 11, 0, 0], [10, 0, 0, 0]], [4, 2, 1],
      [3, 1, 0], [False] * 3)),
    # a done lane emits nothing and stays done
    ([[10, 11]], [[9, 10]], [True], None, ([[7, 7]], [0], [1], [True])),
    # EOS mid-window: the EOS emits, nothing after it
    ([[10, 5, 12, 13]], [[9, 10, 5, 12]], None, 5,
     ([[10, 5, 0, 0]], [2], [3], [True])),
    # EOS at the carried token's target
    ([[5, 11, 12]], [[9, 5, 11]], None, 5, ([[5, 0, 0]], [1], [2], [True])),
    # an EOS in the rejected region does not retire the lane
    ([[10, 11, 5]], [[9, 10, 99]], None, 5,
     ([[10, 11, 0]], [2], [1], [False])),
], ids=["full_partial_none", "done_lane_pinned", "eos_mid_window",
        "eos_at_carried_target", "eos_beyond_accepted_prefix"])
def test_accept_speculative_matches_reference(targets, chunk, done, eos,
                                              want):
    pad = 7 if done else 0
    t = np.asarray(targets, np.int32)
    c = np.asarray(chunk, np.int32)
    d = np.zeros(len(t), bool) if done is None else np.asarray(done)
    got = accept_speculative(torch.from_numpy(t), torch.from_numpy(c),
                             torch.from_numpy(d), pad, eos)
    ref = jax_accept(jnp.asarray(t), jnp.asarray(c), jnp.asarray(d), pad,
                     eos)
    for g, r, w in zip(got, ref, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int32
    if done is None and eos is None:
        assert (got[1] == got[2] + 1).all()     # the carried target emits


# --------------------------------------------------------------------------
# lossless greedy, port == reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch,over,lens,new", [
    ("qwen3-1.7b", dict(mtp_depth=1), (7, 12, 5, 9), 8),
    ("deepseek-v3-671b", {}, (6, 9, 5), 6),
], ids=["qwen3_mtp", "deepseek_v3"])
def test_spec_bitwise_vs_plain_and_reference(arch, over, lens, new, k):
    cfg = _cfg(arch, **over)
    assert cfg.mtp_depth > 0
    params, model = _models(arch, **over)
    prompts = _prompts(cfg, lens)
    kw = dict(slots=2, max_len=96, page_size=16, prefill_chunk=8,
              decode_chunk=4)
    plain = ContinuousScheduler(cfg, model, **kw).generate(prompts, new)
    sch = ContinuousScheduler(cfg, model, spec_decode=k, **kw)
    got = sch.generate(prompts, new)
    js = JaxScheduler(_jcfg(arch, **over), params, spec_decode=k, **kw)
    want = js.generate(prompts, new)
    for i, (p, g, w) in enumerate(zip(plain, got, want)):
        np.testing.assert_array_equal(g, p, err_msg=f"request {i}: spec")
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}: ref")
    sd, jsd = sch.stats()["spec_decode"], js.stats()["spec_decode"]
    assert sd["k"] == k and sd["verify_steps"] > 0
    for key in ("verify_steps", "draft_tokens", "accepted_tokens",
                "slot_verify_steps", "slot_accepted_tokens"):
        assert sd[key] == jsd[key], key
    assert sum(sd["slot_verify_steps"]) == sd["verify_steps"]
    st = sch.stats()
    assert st["decode_host_syncs"] == st["decode_dispatches"]


def test_spec_composes_with_prefix_cache():
    """Rejected-draft writes land at positions >= S in the slot's private
    slack pages, never in aliased prefix pages."""
    cfg = _cfg(mtp_depth=1)
    params, model = _models("qwen3-1.7b", mtp_depth=1)
    shared = np.asarray(jax.random.randint(jax.random.PRNGKey(9), (16,), 0,
                                           cfg.vocab_size))
    rng = np.random.default_rng(3)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, 3 + i).astype(np.int32)]) for i in range(3)]
    kw = dict(slots=2, max_len=96, page_size=8, prefill_chunk=8,
              decode_chunk=4, num_pages=64)
    plain = ContinuousScheduler(cfg, model, **kw).generate(prompts, 6)
    sch = ContinuousScheduler(cfg, model, spec_decode=3, prefix_cache=True,
                              **kw)
    got = sch.generate(prompts, 6)
    js = JaxScheduler(_jcfg(mtp_depth=1), params, spec_decode=3,
                      prefix_cache=True, **kw)
    want = js.generate(prompts, 6)
    for p, g, w in zip(plain, got, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)
    assert sch.stats()["prefix_hit_rate"] > 0
    assert sch.stats()["prefix_hit_tokens"] == js.stats()["prefix_hit_tokens"]


@pytest.mark.parametrize("arch,over", [
    ("qwen3-1.7b", dict(mtp_depth=1)),
    ("qwen3-1.7b", dict(mtp_depth=1, pad_heads_to=8)),
    ("deepseek-v3-671b", {}),
], ids=["qwen3_mtp", "qwen3_mtp_padded_heads", "deepseek_v3"])
def test_mtp_draft_matches_reference(arch, over):
    """The draft head (window-1 attention: the value path only, the GQA
    padded heads masked; MLA through w_dkv, kv_norm, w_uv and wo) gives
    the reference's drafts and last hidden on the same weights."""
    from repro.models import mtp_draft as jax_draft
    from repro_torch.models import mtp_draft
    params, model = _models(arch, **over)
    cfg = _cfg(arch, **over)
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    drafts, h = mtp_draft(cfg, model, torch.from_numpy(hidden),
                          torch.from_numpy(tokens), 3)
    jd, jh = jax_draft(_jcfg(arch, **over), params, jnp.asarray(hidden),
                       jnp.asarray(tokens), 3)
    np.testing.assert_array_equal(drafts.numpy(), np.asarray(jd))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    assert drafts.dtype == torch.int32


# --------------------------------------------------------------------------
# refusals, the page slack and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("over,kw,match", [
    ({}, dict(spec_decode=2), "mtp_depth"),
    (dict(mtp_depth=1), dict(spec_decode=2, sampling=SamplingConfig(
        temperature=0.7)), "greedy"),
    (dict(mtp_depth=1), dict(spec_decode=1), "spec_decode"),
], ids=["needs_mtp_heads", "greedy_only", "k1_rejected"])
def test_spec_refusals(over, kw, match):
    cfg = _cfg(**over)
    model = init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        ContinuousScheduler(cfg, model, slots=2, max_len=64, **kw)


def test_spec_refuses_recurrent_stacks():
    cfg = _cfg("jamba-v0.1-52b", mtp_depth=1)
    model = init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="recurrent"):
        ContinuousScheduler(cfg, model, slots=1, max_len=64, spec_decode=2)


def test_submit_guard_accounts_spec_slack():
    """Slack = decode_chunk * k + k under spec decode: every step may
    write a k-chunk, and a rejected draft k - 1 positions past the
    budget."""
    cfg = _cfg(mtp_depth=1)
    _, model = _models("qwen3-1.7b", mtp_depth=1)
    kw = dict(slots=1, max_len=64, page_size=16, decode_chunk=4)
    plain = ContinuousScheduler(cfg, model, **kw)
    spec = ContinuousScheduler(cfg, model, spec_decode=4, **kw)
    assert plain._chunk_slack == 4
    assert spec._chunk_slack == 4 * 4 + 4
    prompt = np.arange(1, 9, dtype=np.int32)        # S = 8
    plain.submit(prompt, 64 - 8 - 4)                # fits exactly
    with pytest.raises(ValueError, match="spec_decode"):
        spec.submit(prompt, 64 - 8 - 4)
    spec.submit(prompt, 64 - 8 - 20)                # spec-adjusted: fits


def test_launcher_serves_with_prefix_cache_stream_and_spec(capsys):
    """``launch/serve.py`` on the CPU: --prefix-cache, --stream (through
    the front door) and --spec-decode together give the tokens of a
    plain run; the lockstep engine refuses all three."""
    from repro_torch.launch import serve
    base = ["--arch", "deepseek-v3-671b", "--reduced", "--device", "cpu",
            "--batch", "2", "--requests", "3", "--prompt-len", "20",
            "--new-tokens", "6"]
    plain = serve.main(base)
    got = serve.main(base + ["--prefix-cache", "--stream", "--spec-decode",
                             "3", "--report"])
    assert got == plain
    out = capsys.readouterr().out
    assert "spec k=3" in out and "prefix hit rate" in out
    assert "req 2 (ttft" in out
    for flag in (["--prefix-cache"], ["--stream"], ["--spec-decode", "2"]):
        with pytest.raises(SystemExit, match="continuous-engine"):
            serve.main(base[:-4] + ["--engine", "legacy", "--requests", "2",
                                    "--new-tokens", "4"] + flag)


# --------------------------------------------------------------------------
# a trained head: EOS mid-chunk, checkpoint serve, dispatch drop
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_mtp():
    """The reference fixture's tiny model with an MTP head, trained by
    the port's Trainer on the alternating [3, 5] stream until its drafts
    are near perfect (acceptance ~ 1; EOS = 5 lands mid-chunk)."""
    from repro_torch.api import Trainer
    cfg = _cfg(**TINY)
    tok = np.tile(np.asarray([3, 5], np.int32), (8, 16))
    tr = Trainer.create(cfg, optimizer="adam", lr=3e-3, device="cpu")
    for _ in range(60):
        tr.step({"tokens": tok})
    return cfg, tr


def test_eos_mid_chunk_and_no_post_eos_tokens(trained_mtp):
    cfg, tr = trained_mtp
    model = tr.serve().model
    prompt = np.tile(np.asarray([3, 5], np.int32), 6)   # ends in 5
    kw = dict(slots=2, max_len=96, page_size=16, prefill_chunk=8,
              decode_chunk=4, eos_id=5)
    ref = ContinuousScheduler(cfg, model, **kw).generate([prompt], 12)
    sch = ContinuousScheduler(cfg, model, spec_decode=4, **kw)
    got = sch.generate([prompt], 12)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].tolist() == [3, 5]         # retire at the EOS, no more
    assert sch.stats()["spec_decode"]["verify_steps"] >= 1


def test_trained_mtp_checkpoint_serves_with_spec(trained_mtp, tmp_path):
    """A checkpoint trained with the head restores into serving with
    ``params["mtp"]`` intact; spec decode drafts from it and gives the
    tokens of the non-spec restore."""
    from repro_torch.serve import make_engine_from_checkpoint
    cfg, tr = trained_mtp
    tr.save(tmp_path)
    kw = dict(batch_size=2, max_len=96, page_size=16, device="cpu")
    plain = make_engine_from_checkpoint(tmp_path, cfg, **kw)
    assert plain.model.mtp is not None          # the head survived
    eng = make_engine_from_checkpoint(tmp_path, cfg, spec_decode=2, **kw)
    assert eng.restored_step == plain.restored_step == 60
    prompts = [np.tile(np.asarray([3, 5], np.int32), 4),
               np.tile(np.asarray([5, 3], np.int32), 3)]
    for r, g in zip(plain.generate(prompts, 6), eng.generate(prompts, 6)):
        np.testing.assert_array_equal(g, r)
    assert eng.stats()["spec_decode"]["accepted_tokens"] > 0


def test_dispatch_discipline_speedup_and_reference(trained_mtp):
    """At acceptance >= 0.6, decode dispatches and host syncs per token
    drop >= 1.8x against k = 0 (the reference's bars); the reference's
    scheduler on the port's trained weights gives the same tokens and
    acceptance."""
    cfg, tr = trained_mtp
    model = tr.serve().model
    prompts = [np.tile(np.asarray([3, 5], np.int32), 4) for _ in range(4)]
    kw = dict(slots=4, max_len=128, page_size=16, prefill_chunk=8,
              decode_chunk=8)
    new = 32
    base = ContinuousScheduler(cfg, model, **kw)
    ref = base.generate(prompts, new)
    spec = ContinuousScheduler(cfg, model, spec_decode=4, **kw)
    got = spec.generate(prompts, new)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    sd = spec.stats()["spec_decode"]
    assert sd["acceptance"] >= 0.6, sd
    for counter in ("decode_dispatches", "decode_host_syncs"):
        drop = (base.stats()[counter] / base.tokens_out) / (
            spec.stats()[counter] / spec.tokens_out)
        assert drop >= 1.8, (counter, drop, sd)
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  params_to_numpy(tr.state.params, cfg))
    js = JaxScheduler(_jcfg(**TINY), tree, spec_decode=4, **kw)
    for w, g in zip(js.generate(prompts, new), got):
        np.testing.assert_array_equal(g, w)
    jsd = js.stats()["spec_decode"]
    assert (jsd["verify_steps"], jsd["accepted_tokens"]) == (
        sd["verify_steps"], sd["accepted_tokens"])


# --------------------------------------------------------------------------
# params["mtp"] across the bridge, the flat order and checkpoints
# --------------------------------------------------------------------------

def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch,over", [("deepseek-v3-671b", {}),
                                       ("qwen3-1.7b", dict(mtp_depth=1))],
                         ids=["deepseek_v3", "qwen3_mtp"])
def test_mtp_bridge_round_trip_and_flat_order(arch, over):
    """The head crosses the bridge both ways bitwise, serving and
    training models alike, and ``flat_spec`` (the ZeRO vector) puts its
    leaves where the reference's ``tree_leaves`` does: between
    final_norm and unembed."""
    from repro_torch.core.flat import flat_spec
    from repro_torch.train import trainable
    params, model = _models(arch, **over)
    cfg = _cfg(arch, **over)
    want = _leaves(jax.tree_util.tree_map(np.asarray, params))
    assert any("'mtp'" in k for k in want)
    for m in (model, params_from_jax(jax.tree_util.tree_map(
            np.asarray, params), cfg, device="cpu", train=True)):
        got = _leaves(params_to_numpy(m, cfg))
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    ms = trainable(m)
    spec = flat_spec(m, ms)
    flat = torch.cat([ms[n].detach().reshape(-1) for n in spec.names])
    np.testing.assert_array_equal(flat.numpy(), np.concatenate(
        [np.asarray(a).ravel() for a in jax.tree_util.tree_leaves(params)]))


ZERO_WRITE = """
from repro_torch.api import Trainer
from repro_torch.bridge import named_to_numpy
from repro_torch.configs import smoke_config
from repro_torch.core import DPConfig
from repro_torch.launch.mesh import make_dp_mesh
cfg = smoke_config("deepseek-v3-671b").with_overrides(dtype="float32")
t = Trainer.create(cfg, optimizer="adamw", lr=1e-3, seed=3, device="cpu",
                   dp=DPConfig(strategy="zero3"), mesh=make_dp_mesh(1))
tok = np.random.default_rng(RANK).integers(0, cfg.vocab_size, (2, 16))
for _ in range(2):
    t.step({"tokens": tok.astype(np.int32)})
t.save(os.environ["OUT"] + "/z3")
full = {n: torch.from_numpy(a) for n, a in t.params.items()}
if RANK == 0:
    np.savez(os.environ["OUT"] + "/z3.npz",
             **named_to_numpy(t.state.params, full))
print(json.dumps({}))
"""


def test_mtp_checkpoints_cross_both_ways_zero_included(tmp_path):
    """A port zero3 checkpoint of DeepSeek-V3 (2 gloo ranks) restores in
    the reference's ``restore_serve_params`` with the head, bitwise; a
    reference checkpoint of the same config restores in the port's, and
    both serve with spec decode."""
    import os
    from repro.api import Trainer as JaxTrainer
    from repro.checkpoint import restore_serve_params as jax_restore
    from repro_torch.checkpoint import restore_serve_params
    from repro_torch.serve import make_engine_from_checkpoint
    run_ranks(ZERO_WRITE, 2, tmp_path, env={"OUT": str(tmp_path)},
              timeout=300)
    jcfg, cfg = _jcfg("deepseek-v3-671b"), _cfg("deepseek-v3-671b")
    template = jax.eval_shape(lambda: jax_init(jcfg, jax.random.PRNGKey(0)))
    tree, at = jax_restore(tmp_path / "z3", template)
    assert at == 2 and "mtp" in tree
    with np.load(tmp_path / "z3.npz") as npz:
        want = {k: npz[k] for k in npz.files}
    got = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(a)
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    # the reference's checkpoint of the same config, read by the port
    jt = JaxTrainer.create(model_cfg=jcfg, optimizer="adamw", lr=1e-3)
    jt.step({"tokens": jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)), jnp.int32)})
    jt.save(os.fspath(tmp_path / "ref"))
    ptree, at = restore_serve_params(tmp_path / "ref", cfg)
    assert at == 1
    want = _leaves(jax.tree_util.tree_map(np.asarray, jt.params))
    got = _leaves(ptree)
    assert set(got) == set(want) and any("'mtp'" in k for k in got)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    prompts = _prompts(cfg, (6, 9))
    kw = dict(batch_size=2, max_len=96, page_size=16, device="cpu")
    for d in ("z3", "ref"):
        plain = make_engine_from_checkpoint(tmp_path / d, cfg, **kw)
        spec = make_engine_from_checkpoint(tmp_path / d, cfg, spec_decode=2,
                                           **kw)
        for a, b in zip(plain.generate(prompts, 5),
                        spec.generate(prompts, 5)):
            np.testing.assert_array_equal(a, b)
