"""The port's RWKV-6 layers and model against the reference on
``smoke_config("rwkv6-1.6b")`` in fp32: time mix and channel mix with
and without a carried cache at S = 1 and S = 32, the decode-mode model
over per-slot recurrent state, the config and its parameter count, and
the weight bridge round trip."""
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
from repro_torch.models import apply_model, init_cache, init_model
from repro_torch.models import ssm
from repro_torch.models.attention import PagedView
from repro_torch.serve import PagedKVCache

torch.set_num_threads(2)

ARCH = "rwkv6-1.6b"
# The matmuls over d = 256 (and the wkv sums) are taken in another order
# by the two libraries; outputs are O(1).
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
    H, K, d = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim, cfg.d_model
    return {"state": rng.standard_normal((B, H, K, K)).astype(np.float32),
            "shift_tm": rng.standard_normal((B, d)).astype(np.float32),
            "shift_cm": rng.standard_normal((B, d)).astype(np.float32)}


@pytest.mark.parametrize("S", [1, 32])
@pytest.mark.parametrize("carried", [False, True], ids=["no_cache", "cache"])
def test_time_and_channel_mix_match_reference(ref, S, carried):
    jcfg, _, tree, cfg, model = ref
    jp = jax.tree_util.tree_map(jnp.asarray,
                                layer_trees(cfg, tree["decoder"])[1]["mixer"])
    tp = model.layers[1].mixer
    B = 2
    x = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    c = _rand_cache(cfg, B, S + 1) if carried else None
    jc = jax.tree_util.tree_map(jnp.asarray, c) if carried else None
    tc = {k: torch.from_numpy(v.copy()) for k, v in c.items()} \
        if carried else None

    jout, jnew = jax_ssm.apply_rwkv6_time_mix(jcfg, jp, jnp.asarray(x),
                                              mode="decode", cache=jc)
    tout = ssm.apply_rwkv6_time_mix(cfg, tp, torch.from_numpy(x), cache=tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    jout2, jnew2 = jax_ssm.apply_rwkv6_channel_mix(jcfg, jp, jnp.asarray(x),
                                                   cache=jnew)
    tout2 = ssm.apply_rwkv6_channel_mix(cfg, tp, torch.from_numpy(x),
                                        cache=tc)
    np.testing.assert_allclose(tout2.numpy(), np.asarray(jout2), atol=ATOL,
                               rtol=0)
    if carried:                       # the in-place cache equals the new one
        for k in ("state", "shift_tm", "shift_cm"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jnew2[k]),
                                       atol=ATOL, rtol=0)


def test_decode_mode_model_matches_reference(ref):
    """A 12-token prefill chunk into two slots carrying different states,
    then a decode step: logits within LOGIT_ATOL, states agreeing."""
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
    for i in range(cfg.num_layers):
        for k in ("state", "shift_tm", "shift_cm"):
            want = np.asarray(jcache["blocks"]["layer0"][k][i])
            np.testing.assert_allclose(tcache[i][k].numpy(), want, atol=ATOL,
                                       rtol=0)


def test_slot_cache_rows_are_updated_in_place(ref):
    """A B=1 call on ``slot_cache(1)`` writes slot 1's rows and no other,
    and equals the same call on a stand-alone B=1 cache."""
    _, _, _, cfg, model = ref
    kv = PagedKVCache(cfg, slots=3, max_len=32, page_size=8, device="cpu")
    for layer in kv.cache:
        for t in layer.values():
            t.normal_(generator=torch.Generator().manual_seed(1))
    before = [{k: t.clone() for k, t in layer.items()} for layer in kv.cache]
    alone = [{k: t[1:2].clone() for k, t in layer.items()}
             for layer in kv.cache]
    toks = torch.randint(0, cfg.vocab_size, (1, 5),
                         generator=torch.Generator().manual_seed(2))
    pos = torch.zeros(1, dtype=torch.int32)
    view = kv.view([1])
    a = apply_model(cfg, model, toks, cache=kv.slot_cache(1), cache_pos=pos,
                    paged=view)
    b = apply_model(cfg, model, toks, cache=alone, cache_pos=pos, paged=view)
    assert torch.equal(a["logits"], b["logits"])
    for layer, old, solo in zip(kv.cache, before, alone):
        for k, t in layer.items():
            assert torch.equal(t[0], old[k][0]) and torch.equal(t[2], old[k][2])
            assert torch.equal(t[1:2], solo[k])
            assert not torch.equal(t[1], old[k][1])
    kv.reset_slot_state(1)
    assert all((layer[k][1] == 0).all() for layer in kv.cache for k in layer)
    H, K = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    assert kv.pool_bytes() == 0
    assert kv.state_bytes() == cfg.num_layers * 3 * (
        H * K * K * 4 + 2 * cfg.d_model * 4)


def test_configs_and_param_count_equal_reference():
    for tcfg, jcfg in ((get_config(ARCH), jax_get(ARCH)),
                       (smoke_config(ARCH), jax_smoke(ARCH))):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "attention", "ssm_kind",
                  "attn_layer_period", "tie_embeddings", "norm_eps", "dtype"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
        assert tcfg.rwkv.__dict__ == jcfg.rwkv.__dict__
        assert tcfg.layer_pattern() == jcfg.layer_pattern()
        assert tcfg.block_structure() == jcfg.block_structure()
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.rwkv_params() == jcfg.rwkv_params()
        assert tcfg.mamba_params() == jcfg.mamba_params()


def test_param_count_formula_vs_allocated_tensors():
    """The reference's formula leaves out cm_wr (d^2 a layer), counts the
    decay LoRA twice and skips the vectors (norms, mixes, w_base, u,
    ln_x); the allocated tensors are what they are."""
    cfg = smoke_config(ARCH)
    model = init_model(cfg, seed=0, device="cpu")
    numel = (model.embed.numel() + model.unembed_f32.numel()
             + model.final_norm.numel()
             + sum(p.numel() for p in model.layers.parameters()))
    d, K, r = cfg.d_model, cfg.rwkv.head_dim, cfg.rwkv.decay_lora
    vectors = 2 * d + d + 5 * d + d + d + K + 2 * d   # norms, mu*, w_base,
    per_layer = d * d - 2 * d * r + vectors          # u, ln_x, cm_mu_*
    assert numel == cfg.param_count() + cfg.num_layers * per_layer + d


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
    mixer = m.layers[0].mixer
    assert mixer["u"].dtype == torch.float32
    assert mixer["w_base"].dtype == torch.float32
    assert mixer["ln_x"].dtype == torch.float32
    assert mixer["wr"].dtype == torch.bfloat16
    assert m.layers[0].ffn is None and m.rope_freqs is None
    cache = init_cache(cfg, torch.bfloat16, pool=(3, 8), slots=2,
                       device="cpu")
    assert cache[0]["state"].dtype == torch.float32
    assert cache[0]["shift_tm"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="slots"):
        init_cache(cfg, torch.bfloat16, pool=(3, 8), device="cpu")


@pytest.mark.parametrize("overrides,part", [
    (dict(is_encoder_decoder=True, encoder_layers=2), "encoder-decoder"),
    (dict(frontend="audio"), "audio frontend"),
    (dict(frontend="vision", num_frontend_tokens=16), "vision frontend"),
])
def test_unported_stacks_are_refused_by_name(overrides, part):
    """The encoder-decoder and the vision frontend run on the slab and
    train paths but not on the paged pool, whose refusal names the part;
    an audio frontend without an encoder is refused everywhere."""
    from repro_torch.models.model import check_paged_ported, check_ported
    cfg = get_config("qwen3-1.7b").with_overrides(**overrides)
    with pytest.raises(ValueError, match=part):
        check_paged_ported(cfg)
    if "audio" in part:
        with pytest.raises(ValueError, match=part):
            check_ported(cfg)
    else:
        check_ported(cfg)
    check_ported(get_config(ARCH))
    check_ported(get_config("deepseek-v3-671b"))       # MLA is ported
