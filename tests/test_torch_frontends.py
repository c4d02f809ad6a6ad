"""The encoder-decoder (seamless-m4t-large-v2: bidirectional encoder,
cross-attention and its cache, the audio frontend stub) and the VLM
(llava-next-mistral-7b: the vision frontend stub's projector, image
rows prepended) against the reference, at each smoke config in fp32 on
the same bridged weights: train-mode logits; a slab prefill of seq - 1
targets (against a seq-frame source, or after the image rows) and one
decode step, the reference's own case; 8 greedy decode steps; the cross
cache longer than its source; five AdamW steps of losses and params;
``make_labels``' two branches; ``make_batch``; the bridge; the
refusals of the paged pool, the continuous scheduler, the lockstep
engine and the serve launcher; ``_flash_slab``'s forms; and a zero1
checkpoint of the encoder-decoder written by either package and read by
the other, bitwise."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from torch_ranks import run_ranks

from repro.configs import smoke_config as jax_smoke
from repro.core import init_train_state as jax_init_state
from repro.models import apply_model as jax_apply
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init
from repro.train.loss import make_labels as jax_make_labels
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_train_step
from repro_torch.bridge import named_to_numpy, params_from_jax, params_to_numpy
from repro_torch.configs import smoke_config
from repro_torch.data import make_batch
from repro_torch.models import apply_model, batch_inputs, init_cache
from repro_torch.models.attention import _flash_slab
from repro_torch.serve import ContinuousScheduler, ServeEngine
from repro_torch.train import (TrainConfig, make_labels, make_train_step,
                               start_state, trainable)

torch.set_num_threads(2)

ENCDEC, VLM = "seamless-m4t-large-v2", "llava-next-mistral-7b"
ARCHS = [ENCDEC, VLM]
# the reference's bar for slab prefill and decode against its train-mode
# logits (tests/test_arch_smoke.py), and for the port's fp32 logits
TOL = 2e-5
# five AdamW steps: ROADMAP A.1's bar, with the near-eps and
# gradient-noise rule of tests/test_torch_arch_train.py
STEP_TOL, ILL, NOISY, SHARE = 1e-5, 1e-6, 1e-2, 0.02
B, S, STEPS, LR, GREEDY = 2, 16, 5, 3e-4, 8
_REFS = {}


@pytest.fixture(params=ARCHS)
def ref(request):
    arch = request.param
    if arch not in _REFS:
        jcfg = jax_smoke(arch).with_overrides(dtype="float32")
        params = jax_init(jcfg, jax.random.PRNGKey(7))
        # nonzero projector biases, so that they show
        if "vision_proj" in params:
            rng = np.random.default_rng(1)
            for k in ("b1", "b2"):
                params["vision_proj"][k] = jnp.asarray(rng.uniform(
                    -0.1, 0.1, params["vision_proj"][k].shape), jnp.float32)
        cfg = smoke_config(arch).with_overrides(dtype="float32")
        _REFS[arch] = (jcfg, params,
                       jax.tree_util.tree_map(np.asarray, params), cfg)
    return _REFS[arch]


def _batch(cfg, seed, seq=S, n_img=None):
    """numpy batch of the reference's forms: an encoder-decoder's
    ``seq``-frame source and ``seq`` targets; a VLM's ``n_img`` image
    rows (the config's 16 by default) and ``seq`` tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    if cfg.is_encoder_decoder:
        return {"src_embeds": rng.standard_normal(
            (B, seq, cfg.d_model)).astype(np.float32), "tgt_tokens": toks}
    n = cfg.num_frontend_tokens if n_img is None else n_img
    return {"tokens": toks, "vision_embeds": rng.standard_normal(
        (B, n, 1024)).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(cfg, model, batch, **kw):
    tokens, fronts = batch_inputs({k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    return apply_model(cfg, model, tokens, **fronts, **kw)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_logits_match_reference(ref, remat):
    jcfg, params, np_params, cfg = ref
    batch = _batch(cfg, 2)
    want = np.asarray(jax_apply(jcfg, params, _jax(batch),
                                mode="train")["logits"])
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    got = _port(cfg, model, batch, mode="train", remat=remat)["logits"]
    n_img = 0 if cfg.is_encoder_decoder else cfg.num_frontend_tokens
    assert got.shape == (B, n_img + S, cfg.vocab_size) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL)


def _prefill_case(cfg, batch):
    """The reference's decode test (tests/test_arch_smoke.py): the batch
    with its last target token cut, the length that prefill fills, and
    the cross length."""
    key = "tgt_tokens" if cfg.is_encoder_decoder else "tokens"
    pre = dict(batch, **{key: batch[key][:, :-1]})
    n_img = 0 if cfg.is_encoder_decoder else batch["vision_embeds"].shape[1]
    cross = batch["src_embeds"].shape[1] if cfg.is_encoder_decoder else 0
    return pre, n_img + pre[key].shape[1], batch[key][:, -1:], cross


def test_prefill_and_decode_match_reference(ref):
    """seq - 1 targets against a seq-frame source (or after the image
    rows), then the last target as one decode step: each call's logits
    against the reference's, and the decode step's against the full
    train-mode forward's last position."""
    jcfg, params, np_params, cfg = ref
    batch = _batch(cfg, 3)
    pre, pre_len, last, cross = _prefill_case(cfg, batch)
    full = np.asarray(jax_apply(jcfg, params, _jax(batch),
                                mode="train")["logits"])
    jcache = jax_init_cache(jcfg, B, pre_len + 4, jnp.float32,
                            cross_len=cross)
    jp = jax_apply(jcfg, params, _jax(pre), mode="prefill", cache=jcache,
                   cache_pos=0)
    jd = jax_apply(jcfg, params, {"tokens": jnp.asarray(last)},
                   mode="decode", cache=jp["cache"], cache_pos=pre_len)
    model = params_from_jax(np_params, cfg, device="cpu")
    cache = init_cache(cfg, torch.float32, batch=B, max_len=pre_len + 4,
                       cross_len=cross, device="cpu")
    tp = _port(cfg, model, pre, mode="prefill", cache=cache, cache_pos=0)
    td = apply_model(cfg, model, torch.from_numpy(last), mode="decode",
                     cache=cache, cache_pos=pre_len)
    np.testing.assert_allclose(tp["logits"].numpy(),
                               np.asarray(jp["logits"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(td["logits"].numpy(),
                               np.asarray(jd["logits"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(td["logits"].numpy()[:, 0], full[:, -1],
                               rtol=0, atol=TOL)
    if cfg.is_encoder_decoder:
        # the cross cache holds the encoder's K/V of every layer
        for i, c in enumerate(cache):
            rep = jax.tree_util.tree_map(lambda a: np.asarray(a)[i],
                                         jd["cache"]["blocks"]["layer0"])
            for name in ("k", "v"):
                np.testing.assert_allclose(c["cross"][name].numpy(),
                                           rep["cross"][name], rtol=0,
                                           atol=TOL)


def _greedy(step_fn, first, n):
    toks, logits = [], first
    for i in range(n):
        t = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
        toks.append(t)
        if i + 1 < n:
            logits = step_fn(t, i)
    return np.concatenate(toks, axis=1)


def test_greedy_decode_equals_reference(ref):
    """Slab prefill, then 8 greedy decode steps through ``apply_model``
    (the reference's only serving path for these families): the tokens
    equal."""
    _greedy_both(*ref, cross_extra=0)


def test_cross_cache_longer_than_source():
    """A cross cache 5 rows longer than the source: both packages attend
    to its zero rows, and the greedy tokens still equal."""
    ref = _REFS.get(ENCDEC)
    if ref is None:
        jcfg = jax_smoke(ENCDEC).with_overrides(dtype="float32")
        params = jax_init(jcfg, jax.random.PRNGKey(7))
        ref = (jcfg, params, jax.tree_util.tree_map(np.asarray, params),
               smoke_config(ENCDEC).with_overrides(dtype="float32"))
    _greedy_both(*ref, cross_extra=5)


def _greedy_both(jcfg, params, np_params, cfg, *, cross_extra):
    batch = _batch(cfg, 4)
    pre, pre_len, _, cross = _prefill_case(cfg, batch)
    cross += cross_extra
    L = pre_len + GREEDY + 1
    jc = [jax_init_cache(jcfg, B, L, jnp.float32, cross_len=cross)]
    jp = jax_apply(jcfg, params, _jax(pre), mode="prefill", cache=jc[0],
                   cache_pos=0)
    jc[0] = jp["cache"]

    def jstep(t, i):
        out = jax_apply(jcfg, params, {"tokens": jnp.asarray(t)},
                        mode="decode", cache=jc[0], cache_pos=pre_len + i)
        jc[0] = out["cache"]
        return out["logits"]

    model = params_from_jax(np_params, cfg, device="cpu")
    cache = init_cache(cfg, torch.float32, batch=B, max_len=L,
                       cross_len=cross, device="cpu")
    tp = _port(cfg, model, pre, mode="prefill", cache=cache, cache_pos=0)

    def tstep(t, i):
        return apply_model(cfg, model, torch.from_numpy(t), mode="decode",
                           cache=cache, cache_pos=pre_len + i)["logits"]

    want = _greedy(jstep, jp["logits"], GREEDY)
    got = _greedy(tstep, tp["logits"], GREEDY)
    np.testing.assert_array_equal(got, want)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def test_five_adamw_steps_match_reference(ref):
    """Losses within 1e-5 a step and params within 1e-5 after five AdamW
    steps, entries whose gradient came near Adam's eps or within the
    libraries' rounding of zero held to what five steps of lr move."""
    jcfg, params, np_params, cfg = ref
    jtc = JaxTrainConfig(optimizer="adamw", lr=LR)
    jstep, jopt = jax_train_step(jcfg, None, jtc)
    jstep = jax.jit(jstep)
    jgrad = jax.jit(jax.grad(lambda p, b: jax_loss_fn(jcfg, jtc)(p, b)[0]))
    jstate = jax_init_state(jopt, params)
    step, opt = make_train_step(cfg, TrainConfig(optimizer="adamw", lr=LR))
    model = params_from_jax(np_params, cfg, device="cpu", train=True)
    state = start_state(model, opt)
    masters = trainable(model)
    ill = None
    for i in range(STEPS):
        batch = _batch(cfg, 10 + i)
        g = _paths(jgrad(jstate.params, _jax(batch)))
        jstate, jm = jstep(jstate, _jax(batch))
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= STEP_TOL, i
        pg = named_to_numpy(model, {k: p.grad for k, p in masters.items()})
        assert set(pg) == set(g)
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
        assert gap[~ill[k]].max(initial=0) <= STEP_TOL, (k, gap.max())
        assert gap.max() <= STEPS * LR, (k, gap.max())
    assert n_ill < SHARE * sum(w.size for w in want.values())


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-1.7b"])
def test_make_labels_match_reference(arch):
    """The vision branch puts IGNORE in front of the text's labels for
    every image row; the encoder-decoder's labels are its targets'."""
    cfg = smoke_config(arch)
    jcfg = jax_smoke(arch)
    batch = (_batch(cfg, 5) if arch in ARCHS else
             {"tokens": np.arange(2 * S, dtype=np.int32).reshape(B, S)})
    got = make_labels(cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = np.asarray(jax_make_labels(jcfg, _jax(batch)))
    np.testing.assert_array_equal(got.numpy(), want)
    if arch == VLM:
        assert (want[:, :cfg.num_frontend_tokens] == -1).all()


@pytest.mark.parametrize("seq", [8, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_follows_reference_rules(arch, seq):
    """launch/train.py's make_batch: an encoder-decoder's seq frames and
    seq targets; a VLM's min(num_frontend_tokens, seq // 2) image rows
    and the rest tokens."""
    cfg = smoke_config(arch)
    b = make_batch(cfg, np.random.default_rng(0), 3, seq)
    if cfg.is_encoder_decoder:
        assert b["src_embeds"].shape == (3, seq, cfg.d_model)
        assert b["tgt_tokens"].shape == (3, seq)
    else:
        nv = min(cfg.num_frontend_tokens, seq // 2)
        assert b["vision_embeds"].shape == (3, nv, 1024)
        assert b["tokens"].shape == (3, seq - nv)
    assert all(np.isfinite(v).all() for v in b.values())


def test_bridge_round_trip_is_bitwise(ref):
    jcfg, params, np_params, cfg = ref
    for train in (False, True):
        model = params_from_jax(np_params, cfg, device="cpu", train=train)
        got = _paths(params_to_numpy(model, cfg))
        want = _paths(np_params)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_paged_paths_refuse(ref):
    """As in the reference: the paged cache has no cross form, and the
    continuous scheduler, the lockstep engine (token prompts only) and
    the serve launcher drive decoder-only text architectures."""
    from repro_torch.launch import serve as serve_launcher
    _, _, np_params, cfg = ref
    model = params_from_jax(np_params, cfg, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        init_cache(cfg, torch.float32, pool=(8, 8), slots=2, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ContinuousScheduler(cfg, model, slots=2, max_len=64)
    with pytest.raises(ValueError, match="token prompts"):
        ServeEngine(cfg, model, batch_size=2, max_len=64)
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_launcher.main(["--arch", cfg.name, "--reduced", "--device",
                             "cpu"])
    if cfg.is_encoder_decoder:
        from repro_torch.models import transformer as tfm
        with pytest.raises(ValueError, match="cross-attention"):
            tfm.init_layer_cache(cfg, "attn", torch.float32, pool=(8, 8),
                                 cross=True, device="cpu")
        with pytest.raises(ValueError, match="src_embeds"):
            apply_model(cfg, model, torch.zeros((1, 4), dtype=torch.long),
                        mode="train")


def test_flash_slab_forms():
    """On CPU tensors (the wrapper's plain version): the non-causal form
    takes any query positions over the valid keys; a causal call outside
    the slab form still raises."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 3, 4, 64), (2, 8, 2, 64), (2, 8, 2, 64)))
    from repro_torch.kernels.flash_attention import flash_attention_ref
    got = _flash_slab(q, k, v, q_positions=torch.tensor([5, 9, 11]),
                      kv_positions=range(8), causal=False, window=0,
                      kv_valid_len=6)
    want = flash_attention_ref(q, k[:, :6], v[:, :6], causal=False)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for kw in (dict(q_positions=range(0, 3)),            # not right-aligned
               dict(q_positions=torch.arange(5, 8)),     # not a range
               dict(q_positions=range(5, 8), causal=False, window=4)):
        args = dict(kv_positions=range(8), causal=True, window=0,
                    kv_valid_len=None)
        args.update(kw)
        with pytest.raises(ValueError, match="slab form"):
            _flash_slab(q, k, v, **args)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_reduced(arch, capsys):
    from repro_torch.launch.train import main
    losses = main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--steps", "3", "--batch", "2", "--seq", "32"])
    # random tokens: near ln(vocab) = 6.24
    assert len(losses) == 3 and all(abs(l - 6.24) < 0.5 for l in losses)
    assert "tokens/s" in capsys.readouterr().out


# --------------------------------------------------------------------------
# zero1 checkpoints of the encoder-decoder across the two packages
# --------------------------------------------------------------------------

BATCHES = """
cfg = smoke_config("seamless-m4t-large-v2").with_overrides(dtype="float32")
def batch(i):
    r = np.random.default_rng([6, i])
    return {"src_embeds": r.standard_normal((4, 12, cfg.d_model)).astype(
                np.float32),
            "tgt_tokens": r.integers(0, cfg.vocab_size, (4, 10)).astype(
                np.int32)}
"""

REF_WRITE = """
import os
import jax, jax.numpy as jnp, numpy as np
from repro.api import Trainer
from repro.compat import auto_axis_types, make_mesh
from repro.configs import smoke_config
from repro.core import DPConfig
from repro.core.train_state import assemble_full_flat
""" + BATCHES + """
out = os.environ["OUT"]
mesh = make_mesh((2,), ("data",), axis_types=auto_axis_types(1))
t = Trainer.create(cfg, optimizer="adamw", lr=1e-3,
                   dp=DPConfig(strategy="zero1"), mesh=mesh)
for i in range(2):
    t.step({k: jnp.asarray(v) for k, v in batch(i).items()})
t.save(out + "/ref_z1")
lay = t.state.layout
def flat(leaf):
    shards = np.split(np.asarray(leaf), lay.num_shards)
    return assemble_full_flat(shards, lay)[:lay.total]
np.savez(out + "/ref_z1.npz",
         params=np.concatenate([np.asarray(l).ravel() for l in
                                jax.tree_util.tree_leaves(t.state.params)]),
         m=flat(t.state.opt_state["m"]["flat"]),
         v=flat(t.state.opt_state["v"]["flat"]))
from repro.checkpoint import restore_sharded_checkpoint
t2 = Trainer.create(cfg, optimizer="adamw", lr=1e-3,
                    dp=DPConfig(strategy="zero1"), mesh=mesh)
st, at = restore_sharded_checkpoint(out + "/port_z1", t2.state)
lay = st.layout
assert at == 2 and lay.kind == "zero1" and lay.num_shards == 2
np.savez(out + "/port_z1.ref.npz",
         params=np.concatenate([np.asarray(l).ravel() for l in
                                jax.tree_util.tree_leaves(st.params)]),
         m=flat(st.opt_state["m"]["flat"]), v=flat(st.opt_state["v"]["flat"]))
print("OK")
"""

PORT_WRITE = """
from repro_torch import optim
from repro_torch.api import Trainer
from repro_torch.configs import smoke_config
from repro_torch.core import DPConfig
from repro_torch.core.train_state import assemble_full_flat, gather_shards
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.train import TrainConfig
""" + BATCHES + """
out = os.environ["OUT"]
mesh = make_dp_mesh(1)
t = Trainer.create(cfg, optimizer=optim.adamw(1e-3),
                   dp=DPConfig(strategy="zero1"), mesh=mesh, device="cpu",
                   train_cfg=TrainConfig(remat=False), seed=0)
for i in range(2):
    t.step(batch(i))
t.save(out + "/port_z1")
st = t.state
lay = st.layout
m, v = (assemble_full_flat(gather_shards(st.opt_state[k]["flat"], mesh,
                                         lay.axes), lay)[:lay.total]
        for k in ("m", "v"))
if RANK == 0:
    from repro_torch.core.flat import flat_spec
    from repro_torch.train import trainable
    spec = flat_spec(st.params, trainable(st.params))
    prm = t.params
    np.savez(out + "/port_z1.npz",
             params=np.concatenate([prm[n].ravel() for n in spec.names]),
             m=m, v=v)
print(json.dumps({}))
"""


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def encdec_ckpts(tmp_path_factory):
    """The port's zero1 checkpoint (2 gloo ranks), then the reference's
    zero1 run on 2 emulated devices, which also reads the port's."""
    import os
    d = tmp_path_factory.mktemp("encdec_zero1")
    run_ranks(PORT_WRITE, 2, d, env={"OUT": str(d)}, timeout=300)
    os.environ["OUT"] = str(d)
    try:
        run_with_devices(REF_WRITE, 2)
    finally:
        del os.environ["OUT"]
    return d


def test_port_zero1_checkpoint_reads_in_reference(encdec_ckpts):
    got = _load(encdec_ckpts / "port_z1.ref.npz")
    want = _load(encdec_ckpts / "port_z1.npz")
    meta = json.loads((encdec_ckpts / "port_z1" / "step_0000000002.shards"
                       / "meta.json").read_text())
    assert meta["layout"]["num_shards"] == 2
    for k in ("params", "m", "v"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reference_zero1_checkpoint_reads_in_port(encdec_ckpts):
    from repro_torch import optim
    from repro_torch.api import Trainer
    from repro_torch.core.flat import flat_spec
    cfg = smoke_config(ENCDEC).with_overrides(dtype="float32")
    t = Trainer.create(cfg, optimizer=optim.adamw(1e-3), device="cpu",
                       train_cfg=TrainConfig(remat=False), seed=3)
    assert t.restore(encdec_ckpts / "ref_z1") == 2
    st = t.state
    spec = flat_spec(st.params, trainable(st.params))
    p = t.params
    got = {"params": np.concatenate([p[n].ravel() for n in spec.names])}
    for k in ("m", "v"):
        got[k] = np.concatenate([st.opt_state[k][n].numpy().ravel()
                                 for n in spec.names])
    want = _load(encdec_ckpts / "ref_z1.npz")
    for k in ("params", "m", "v"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
