"""The lockstep slab path of RWKV-6, Jamba (Mamba, attention, MoE) and
DeepSeek-V3 (MLA, sigmoid-router MoE) against the reference, at each
smoke config in fp32 on the same bridged weights: slab prefill and
decode logits (and the recurrent caches) within the reference's own
arch bar; ``ServeEngine`` greedy tokens and counters bitwise the
reference's first batch, and equal to the port's continuous engine; a
second ``generate()`` equal to a fresh engine's."""
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
from repro_torch.models import apply_model, init_cache
from repro_torch.serve import ContinuousScheduler, ServeEngine, make_engine

torch.set_num_threads(2)

ARCHS = ["rwkv6-1.6b", "jamba-v0.1-52b", "deepseek-v3-671b"]
B, S0, NEW, MAX_LEN = 3, 20, 10, 64
# the reference's own bar for a slab prefill and decode against its
# train-mode logits (tests/test_arch_smoke.py).  RWKV-6 is held to the
# port's RWKV logit bar instead (tests/test_torch_rwkv.py): across the
# two libraries its logits differ by up to 2.3e-5 at position 0, a gap
# the reference's own matmuls move with the sequence's length (8.4e-6
# at 20 tokens), where Jamba's and DeepSeek-V3's stay below 2.3e-6
TOL = {"rwkv6-1.6b": 1e-4, "jamba-v0.1-52b": 2e-5, "deepseek-v3-671b": 2e-5}
_REFS = {}


@pytest.fixture(params=ARCHS)
def ref(request):
    arch = request.param
    if arch not in _REFS:
        jcfg = jax_smoke(arch).with_overrides(dtype="float32")
        params = jax_init(jcfg, jax.random.PRNGKey(7))
        cfg = smoke_config(arch).with_overrides(dtype="float32")
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                cfg, device="cpu")
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S0)).astype(np.int32)
        _REFS[arch] = (jcfg, params, cfg, model, prompts)
    return _REFS[arch]


def _port(ref):
    _, _, cfg, model, prompts = ref
    return ServeEngine(cfg, model, batch_size=B, max_len=MAX_LEN).generate(
        prompts, NEW).numpy()


def test_slab_logits_match_reference(ref):
    """A slab prefill, a one-token decode step and a three-token decode
    call (the recurrent layers' chunked scan, MLA's per-query causal
    mask): the logits against the reference's apply_model, then each
    recurrent layer's carried state, relative to its largest entry."""
    jcfg, params, cfg, model, prompts = ref
    tol = TOL[cfg.name]
    jcache = jax_init_cache(jcfg, B, 32, jnp.float32)
    tcache = init_cache(cfg, torch.float32, batch=B, max_len=32,
                        device="cpu")
    steps = [("prefill", 0, prompts[:, :12]),
             ("decode", 12, prompts[:, 12:13]),
             ("decode", 13, prompts[:, 13:16])]
    for mode, pos, t in steps:
        jout = jax_apply(jcfg, params, {"tokens": jnp.asarray(t)}, mode=mode,
                         cache=jcache, cache_pos=pos)
        jcache = jout["cache"]
        tout = apply_model(cfg, model, torch.from_numpy(t), cache=tcache,
                           cache_pos=pos, mode=mode)
        np.testing.assert_allclose(tout["logits"].numpy(),
                                   np.asarray(jout["logits"]), atol=tol,
                                   rtol=tol, err_msg=mode)
    prefix, pattern, n_rep = cfg.block_structure()
    for i, (kind, _) in enumerate(cfg.layer_pattern()):
        if kind == "attn":
            continue
        if i < len(prefix):
            want = jcache["prefix"][f"layer{i}"]
        else:
            rep, j = divmod(i - len(prefix), len(pattern))
            want = jax.tree_util.tree_map(lambda a: a[rep],
                                          jcache["blocks"][f"layer{j}"])
        # the states grow to |x| ~ 10 over 16 tokens: the bar scales
        for name, t in tcache[i].items():
            w = np.asarray(want[name])
            gap = np.abs(t.numpy() - w).max()
            assert gap <= tol * max(1.0, np.abs(w).max()), (i, name, gap)


def test_greedy_tokens_and_counters_bitwise_equal_reference(ref):
    """The first batch of the reference's engine (whose cache is fresh)."""
    jcfg, params, cfg, model, prompts = ref
    je = JaxEngine(jcfg, params, batch_size=B, max_len=MAX_LEN,
                   dtype=jnp.float32)
    jo = np.asarray(je.generate(jnp.asarray(prompts), NEW))
    te = ServeEngine(cfg, model, batch_size=B, max_len=MAX_LEN)
    to = te.generate(prompts, NEW).numpy()
    assert to.dtype == np.int32 and to.shape == jo.shape == (B, NEW)
    np.testing.assert_array_equal(to, jo)
    assert (te.dispatches, te.host_syncs) == (je.dispatches, je.host_syncs)


def test_matches_the_continuous_scheduler(ref):
    """The lockstep slab (whole-prompt scans and attention) and the paged
    continuous engine (8-token prefill chunks, one-step decode) give the
    same greedy tokens."""
    _, _, cfg, model, prompts = ref
    sched = ContinuousScheduler(cfg, model, slots=B, max_len=MAX_LEN,
                                page_size=8, prefill_chunk=8, decode_chunk=4)
    outs = sched.generate(list(prompts), NEW)
    np.testing.assert_array_equal(np.stack(outs), _port(ref))


def test_second_generate_equals_a_fresh_engine(ref):
    """Every batch starts from a zero recurrent state: a second batch on
    the same engine (the first left its state in the cache) gives what a
    fresh engine gives, as does the first batch run again."""
    _, _, cfg, model, prompts = ref
    eng = make_engine(cfg, model, engine="legacy", batch_size=B,
                      max_len=MAX_LEN, device="cpu")
    first = eng.generate(prompts, NEW).numpy()
    other = prompts[::-1, 3:].copy()
    second = eng.generate(other, NEW).numpy()
    fresh = ServeEngine(cfg, model, batch_size=B,
                        max_len=MAX_LEN).generate(other, NEW).numpy()
    np.testing.assert_array_equal(second, fresh)
    np.testing.assert_array_equal(eng.generate(prompts, NEW).numpy(), first)
    np.testing.assert_array_equal(first, _port(ref))


@pytest.mark.parametrize("mode", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_one_token_prefill_and_train_take_the_scan(arch, mode, monkeypatch):
    """As in the reference, only a one-token ``"decode"`` call takes the
    recurrent one-step update; a one-token slab prefill or train call
    runs the whole-segment scan (the kernel on the card), and gives the
    reference's logits."""
    from repro_torch.models import ssm
    jcfg = jax_smoke(arch).with_overrides(dtype="float32")
    params = jax_init(jcfg, jax.random.PRNGKey(7))
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu", train=mode == "train")
    scans = []
    for name in ("wkv6", "mamba_scan"):
        monkeypatch.setattr(ssm, name, lambda *a, _f=getattr(ssm, name),
                            **k: scans.append(1) or _f(*a, **k))

    def no_step(*a, **k):
        raise AssertionError("the one-step update ran")

    monkeypatch.setattr(ssm, "wkv6_step", no_step)
    monkeypatch.setattr(ssm, "mamba_step", no_step)
    tok = np.array([[5], [9]], np.int32)
    kw = dict(mode=mode)
    jkw = dict(mode=mode)
    if mode == "prefill":
        kw.update(cache=init_cache(cfg, torch.float32, batch=2, max_len=4,
                                   device="cpu"), cache_pos=0)
        jkw.update(cache=jax_init_cache(jcfg, 2, 4, jnp.float32), cache_pos=0)
    got = apply_model(cfg, model, torch.from_numpy(tok), **kw)["logits"]
    want = jax_apply(jcfg, params, {"tokens": jnp.asarray(tok)}, **jkw)
    kinds = [m for m, _ in cfg.layer_pattern()]
    assert len(scans) == sum(k in ("rwkv6", "mamba") for k in kinds)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want["logits"]), atol=TOL[arch],
                               rtol=TOL[arch])
