"""The port's Jamba layers and model against the reference on
``smoke_config("jamba-v0.1-52b")`` in fp32 -- a Mamba + MLP layer, then
attention + MoE: ``apply_mamba`` with and without a carried cache at
S = 1, 7 and 32, the decode-mode model over a paged pool and per-slot
Mamba state, the configs and their parameter counts, the bitwise weight
bridge, what a bf16 model keeps in fp32, and ``init_model`` holding one
layer's fp32 masters at a time."""
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get
from repro.configs import smoke_config as jax_smoke
from repro.models import apply_model as jax_apply
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init
from repro.models import ssm as jax_ssm
from repro.models.attention import PagedView as JaxView
from repro_torch.bridge import layer_trees, params_from_jax, params_to_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import apply_model, init_cache, init_model, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import PagedView
from repro_torch.serve import PagedKVCache

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
# fp32 matmuls over d = 256 and dI = 512 and the scan's sums over d_state,
# taken in another order by the two libraries; outputs are O(1)
ATOL = 1e-4
# logits: the same, through two layers and the unembedding
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_smoke(ARCH).with_overrides(dtype="float32")
    params = jax_init(jcfg, jax.random.PRNGKey(7))
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = smoke_config(ARCH).with_overrides(dtype="float32")
    return jcfg, params, tree, cfg, params_from_jax(tree, cfg, device="cpu")


def _rand_cache(cfg, B, seed):
    rng = np.random.default_rng(seed)
    dI, dS = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    return {"ssm": rng.standard_normal((B, dI, dS)).astype(np.float32),
            "conv": rng.standard_normal(
                (B, cfg.mamba.d_conv - 1, dI)).astype(np.float32)}


@pytest.mark.parametrize("S", [1, 7, 32])
@pytest.mark.parametrize("carried", [False, True], ids=["no_cache", "cache"])
def test_apply_mamba_matches_reference(ref, S, carried):
    jcfg, _, tree, cfg, model = ref
    assert cfg.layer_pattern()[0] == ("mamba", "mlp")
    jp = jax.tree_util.tree_map(jnp.asarray,
                                layer_trees(cfg, tree["decoder"])[0]["mixer"])
    tp = model.layers[0].mixer
    B = 2
    x = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    c = _rand_cache(cfg, B, S + 1) if carried else None
    jc = jax.tree_util.tree_map(jnp.asarray, c) if carried else None
    tc = {k: torch.from_numpy(v.copy()) for k, v in c.items()} \
        if carried else None
    jout, jnew = jax_ssm.apply_mamba(jcfg, jp, jnp.asarray(x), mode="decode",
                                     cache=jc)
    tout = ssm.apply_mamba(cfg, tp, torch.from_numpy(x), cache=tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    if carried:                       # the in-place cache equals the new one
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jnew[k]),
                                       atol=ATOL, rtol=0)


def test_decode_mode_model_matches_reference(ref):
    """A 12-token prefill chunk into two slots carrying different states,
    then a decode step: logits and the MoE aux loss agree, and so do
    the Mamba states and the attention pool."""
    jcfg, params, tree, cfg, model = ref
    ps, n_pages, B = 8, 10, 2
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    rng = np.random.default_rng(0)
    chunk = rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    start = np.array([0, 9], np.int32)

    jcache = jax_init_cache(jcfg, B, 32, jnp.float32, pool=(n_pages, ps))
    tcache = init_cache(cfg, torch.float32, pool=(n_pages, ps), slots=B,
                        device="cpu")
    jview = JaxView(jnp.asarray(table), ps)
    tview = PagedView(torch.from_numpy(table), ps)
    for toks, pos in ((chunk, start), (step, start + 12)):
        jout = jax_apply(jcfg, params, {"tokens": jnp.asarray(toks)},
                         mode="decode", cache=jcache,
                         cache_pos=jnp.asarray(pos), paged=jview)
        jcache = jout["cache"]
        tout = apply_model(cfg, model, torch.from_numpy(toks), cache=tcache,
                           cache_pos=torch.from_numpy(pos), paged=tview)
        np.testing.assert_allclose(tout["logits"].numpy(),
                                   np.asarray(jout["logits"]),
                                   atol=LOGIT_ATOL, rtol=0)
        assert (tout["logits"].argmax(-1).numpy()
                == np.asarray(jout["logits"]).argmax(-1)).all()
        np.testing.assert_allclose(float(tout["aux"]), float(jout["aux"]),
                                   rtol=1e-5)
    mamba = jcache["blocks"]["layer0"]
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tcache[0][k].numpy(),
                                   np.asarray(mamba[k][0]), atol=ATOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(
            tcache[1][k].numpy(),
            np.asarray(jcache["blocks"]["layer1"][k][0]).reshape(
                tcache[1][k].shape), atol=ATOL, rtol=0)


def test_slot_cache_rows_are_updated_in_place(ref):
    """A B=1 call on ``slot_cache(1)`` writes slot 1's Mamba rows and no
    other, equals the same call on a stand-alone B=1 state, and admit's
    reset zeros the rows."""
    _, _, _, cfg, model = ref
    kv = PagedKVCache(cfg, slots=3, max_len=32, page_size=8, device="cpu")
    kv.alloc(1, 5)
    g = torch.Generator().manual_seed(1)
    for layer, per_slot in zip(kv.cache, kv._per_slot):
        if per_slot:
            for t in layer.values():
                t.normal_(generator=g)
    before = {k: t.clone() for k, t in kv.cache[0].items()}
    alone = {k: t[1:2].clone() for k, t in kv.cache[0].items()}
    toks = torch.randint(0, cfg.vocab_size, (1, 5),
                         generator=torch.Generator().manual_seed(2))
    pos = torch.zeros(1, dtype=torch.int32)
    view = kv.view([1])
    a = apply_model(cfg, model, toks, cache=kv.slot_cache(1), cache_pos=pos,
                    paged=view)
    b = apply_model(cfg, model, toks, cache=[alone, kv.cache[1]],
                    cache_pos=pos, paged=view)
    assert torch.equal(a["logits"], b["logits"])
    for k, t in kv.cache[0].items():
        old = before[k]
        assert torch.equal(t[0], old[0]) and torch.equal(t[2], old[2])
        assert torch.equal(t[1:2], alone[k])
        assert not torch.equal(t[1], old[1])
    kv.reset_slot_state(1)
    assert all((t[1] == 0).all() for t in kv.cache[0].values())
    dI, dS = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    assert kv.state_bytes() == 3 * (dI * dS * 4
                                    + (cfg.mamba.d_conv - 1) * dI * 4)
    assert kv.pool_bytes() == 2 * kv.num_pages * 8 * cfg.num_kv_heads \
        * cfg.head_dim * 4


@pytest.mark.parametrize("which", ["full", "smoke", "super-block"])
def test_configs_and_param_count_equal_reference(which):
    tcfg, jcfg = {"full": (get_config(ARCH), jax_get(ARCH)),
                  "smoke": (smoke_config(ARCH), jax_smoke(ARCH)),
                  "super-block": (get_config(ARCH).with_overrides(
                      num_layers=8), jax_get(ARCH).with_overrides(
                      num_layers=8))}[which]
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "attention", "ssm_kind",
              "attn_layer_period", "attn_layer_offset", "tie_embeddings",
              "norm_eps", "dtype"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.mamba.__dict__ == jcfg.mamba.__dict__
    assert tcfg.moe.__dict__ == jcfg.moe.__dict__
    assert tcfg.layer_pattern() == jcfg.layer_pattern()
    assert tcfg.block_structure() == jcfg.block_structure()
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.ffn_params("moe") == jcfg.ffn_params("moe")
    if which == "super-block":       # one of each layer kind, 13.29 B
        assert set(tcfg.layer_pattern()) == {
            ("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp")}
        assert tcfg.param_count() == 13_294_993_408


def test_bridge_round_trip_is_bitwise(ref):
    _, _, tree, cfg, model = ref
    back = params_to_numpy(model, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_bf16_model_keeps_fp32_where_the_reference_reads_fp32():
    cfg = smoke_config(ARCH)
    m = init_model(cfg, seed=3, device="cpu")
    mixer, ffn = m.layers[0].mixer, m.layers[1].ffn
    assert mixer["A_log"].dtype == torch.float32
    assert mixer["D"].dtype == torch.float32
    assert mixer["in_x"].dtype == torch.bfloat16
    assert mixer["dt_bias"].dtype == torch.bfloat16
    assert ffn["router"].dtype == torch.float32
    assert ffn["experts"]["w_down"].dtype == torch.bfloat16
    assert m.layers[0].ffn["w_up"].dtype == torch.bfloat16
    cache = init_cache(cfg, torch.bfloat16, pool=(3, 8), slots=2,
                       device="cpu")
    assert cache[0]["ssm"].dtype == torch.float32
    assert cache[0]["conv"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="slots"):
        init_cache(cfg, torch.bfloat16, pool=(3, 8), device="cpu")


def test_init_model_holds_one_layers_fp32_masters_at_a_time(monkeypatch):
    """Every weight a bf16 model casts is drawn in fp32 and must be
    freed before the next layer is drawn: at each draw, no cast master
    of an earlier layer is alive, so the peak is the cast model plus one
    layer's masters (at full width: one 11.3 GB MoE layer, not 53 GB)."""
    cfg = smoke_config(ARCH).with_overrides(num_layers=8)
    drawn, alive_at_draw = [], []
    real = tfm.init_layer

    def spy(*a, **kw):
        alive_at_draw.append(sum(r() is not None for r in drawn))
        tree = real(*a, **kw)
        stack = [tree]
        while stack:
            node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append(v)
                elif k not in ssm.FP32_WEIGHTS + ("router", "scale"):
                    drawn.append(weakref.ref(v))
        return tree

    monkeypatch.setattr(tfm, "init_layer", spy)
    m = init_model(cfg, seed=0, device="cpu")
    assert len(alive_at_draw) == cfg.num_layers == len(m.layers)
    assert alive_at_draw == [0] * cfg.num_layers
    assert all(r() is None for r in drawn)
    assert m.layers[1].ffn["experts"]["w_up"].dtype == torch.bfloat16


CAST_ARCHS = ["qwen3-1.7b", "rwkv6-1.6b", ARCH, "deepseek-v3-671b"]


@pytest.mark.parametrize("arch", CAST_ARCHS)
def test_init_model_casts_each_weight_as_it_is_drawn(monkeypatch, arch):
    """Every weight is drawn in fp32 and cast at once: when any weight is
    drawn, the fp32 draws still alive are only weights the bf16 model
    keeps in fp32 (the unembedding, the router, RWKV's u and w_base), so
    the peak is the cast model plus the one fp32 tensor being drawn (at
    DeepSeek-V3's 4-layer cut, one 15 GB expert tensor, not a 45 GB MoE
    layer and a 3.7 GB fp32 embedding)."""
    cfg = smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    real = torch.nn.init.trunc_normal_
    draws, live_at_draw = [], []

    def spy(t, *a, **kw):
        live_at_draw.append(sum(n for r, n in draws if r() is not None))
        draws.append((weakref.ref(t), t.numel() * t.element_size()))
        return real(t, *a, **kw)

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", spy)
    m = init_model(cfg, seed=0, device="cpu")
    kept_fp32 = sum(p.numel() * 4 for p in m.parameters()
                    if p.dtype == torch.float32)
    assert len(draws) > 3 * cfg.num_layers
    assert max(live_at_draw) <= kept_fp32
    assert m.embed.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", CAST_ARCHS)
def test_seeded_weights_are_the_fp32_masters_cast(arch):
    """Casting as drawn changes no weight: the bf16 model from a seed is
    the fp32 model from the same seed, cast (the draws keep their
    order), so seeded weights and greedy tokens stay as they were."""
    cfg = smoke_config(arch)
    m16 = init_model(cfg, seed=0, device="cpu")
    m32 = init_model(cfg.with_overrides(dtype="float32"), seed=0,
                     device="cpu")
    p16, p32 = dict(m16.named_parameters()), dict(m32.named_parameters())
    assert p16.keys() == p32.keys()
    for name, p in p16.items():
        assert torch.equal(p, p32[name].to(p.dtype)), name
