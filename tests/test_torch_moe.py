"""The port's MoE against the reference on the smoke configs of jamba
(softmax router), deepseek-moe-16b (shared experts, a dense first
layer) and deepseek-v3-671b (sigmoid router with a balance bias), in
fp32: routing, ``apply_moe_dense``'s (y, aux) at the configs' generous
capacity and at a tight one (0.25) whose drops must match, and the
decode-mode model of deepseek-moe-16b through the weight bridge.  Inputs
are drawn with numpy from a seed; expert weights come from the
reference's ``init_moe``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import apply_model as jax_apply
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init
from repro.models import moe as jax_moe
from repro.models.attention import PagedView as JaxView
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import base as tbase
from repro_torch.models import apply_model, init_cache, init_model, moe
from repro_torch.models.attention import PagedView

torch.set_num_threads(2)

ARCHS = ["jamba-v0.1-52b", "deepseek-moe-16b", "deepseek-v3-671b"]
# fp32 matmuls of depth <= 256 (router, experts) taken in another order
# by the two libraries; outputs are O(1)
ATOL = 2e-5
# logits through two layers and the unembedding
LOGIT_ATOL = 1e-4


def port_cfg(jcfg):
    """The port's config for a reference config, field for field (the
    port registers only the archs it serves; these tests need more);
    ``decode_kernel`` keeps the port's default, its values being the
    port's own."""
    kw = {}
    for f in dataclasses.fields(tbase.ModelConfig):
        if f.name == "decode_kernel":
            continue
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tbase, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tbase.ModelConfig(**kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


@pytest.fixture(scope="module", params=ARCHS)
def moe_case(request):
    jcfg = jax_smoke(request.param).with_overrides(dtype="float32")
    p = _np_tree(jax_moe.init_moe(jcfg, jax.random.PRNGKey(5)))
    if "router_bias" in p:        # a nonzero balance bias moves selection
        p["router_bias"] = np.random.default_rng(1).uniform(
            -0.05, 0.05, p["router_bias"].shape).astype(np.float32)
    x = np.random.default_rng(2).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    return jcfg, port_cfg(jcfg), p, x


def test_routing_matches_reference(moe_case):
    jcfg, cfg, p, x = moe_case
    xf = x.reshape(-1, cfg.d_model)
    jw, jidx, jaux = jax_moe._routing(jcfg, jax.tree_util.tree_map(
        jnp.asarray, p), jnp.asarray(xf))
    w, idx, aux = moe._routing(cfg, _torch_tree(p), torch.from_numpy(xf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("capacity_factor", [None, 0.25],
                         ids=["config", "tight"])
def test_moe_dense_matches_reference(moe_case, capacity_factor):
    """(y, aux) equal the reference's.  At capacity 0.25 the buffers
    overflow: the same (token, slot) pairs are dropped on both sides
    (a drop lands on its expert's row 0 as a zero update, which must
    not overwrite the token that holds that row)."""
    jcfg, cfg, p, x = moe_case
    cf = cfg.moe.capacity_factor if capacity_factor is None \
        else capacity_factor
    jy, jaux = jax_moe.apply_moe_dense(
        jcfg, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        capacity_factor=cf)
    y, aux = moe.apply_moe_dense(cfg, _torch_tree(p), torch.from_numpy(x),
                                 capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    if capacity_factor is not None:
        loose, _ = moe.apply_moe_dense(cfg, _torch_tree(p),
                                       torch.from_numpy(x),
                                       capacity_factor=64.0)
        assert (y - loose).abs().max() > 1e-3      # drops did happen


def test_capacity_matches_reference_formula():
    cfg = port_cfg(jax_smoke("jamba-v0.1-52b"))
    full = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=16, top_k=2))
    # the full config's prefill chunk (32 tokens) and decode tick (8)
    assert moe.capacity(full, 32, 1.25) == 8
    assert moe.capacity(full, 8, 1.25) == 8
    assert moe.capacity(full, 1, 1.25) == 1
    assert moe.capacity(cfg, 64, 8.0) == 64


def test_drops_follow_token_major_order():
    """Every pair routed to one expert, capacity 8 of 16 tokens x 2
    slots: the first 8 (token-major) pairs are kept, the rest get
    weight 0 -- checked through the output against a brute-force sum."""
    jcfg = jax_smoke("jamba-v0.1-52b").with_overrides(dtype="float32")
    cfg = port_cfg(jcfg)
    p = _torch_tree(_np_tree(jax_moe.init_moe(jcfg, jax.random.PRNGKey(0))))
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 0] = 0.02          # expert 0 first, expert 1 second
    p["router"][:, 1] = 0.01
    x = torch.from_numpy(np.abs(np.random.default_rng(3).standard_normal(
        (1, 16, cfg.d_model))).astype(np.float32))
    y, _ = moe.apply_moe_dense(cfg, p, x, capacity_factor=1.0)
    C = moe.capacity(cfg, 16, 1.0)
    assert C == 8
    w, idx, _ = moe._routing(cfg, p, x[0])
    assert (idx[:, 0] == 0).all() and (idx[:, 1] == 1).all()
    one = lambda e, t: moe._expert_ffn(
        {k: v[e:e + 1] for k, v in p["experts"].items()}, t[None])[0]
    want = torch.zeros_like(x[0])
    want[:C] = w[:C, :1] * one(0, x[0, :C]) + w[:C, 1:] * one(1, x[0, :C])
    torch.testing.assert_close(y[0], want, atol=ATOL, rtol=0)


def test_deepseek_moe_decode_mode_model_matches_reference():
    """deepseek-moe-16b's smoke stack (a dense first layer of
    dense_d_ff, then attention + MoE with a shared expert) through the
    bridge: a 12-token prefill chunk into two slots, then a decode
    step; logits within LOGIT_ATOL, the bridge round trip bitwise."""
    jcfg = jax_smoke("deepseek-moe-16b").with_overrides(dtype="float32")
    cfg = port_cfg(jcfg)
    params = jax_init(jcfg, jax.random.PRNGKey(11))
    tree = _np_tree(params)
    model = params_from_jax(tree, cfg, device="cpu")
    assert model.layers[0].ffn["w_up"].shape[1] == cfg.moe.dense_d_ff
    assert "shared" in model.layers[1].ffn
    back = params_to_numpy(model, cfg)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    ps, n_pages, B = 8, 10, 2
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    rng = np.random.default_rng(0)
    chunk = rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    start = np.array([0, 9], np.int32)
    jcache = jax_init_cache(jcfg, B, 32, jnp.float32, pool=(n_pages, ps))
    tcache = init_cache(cfg, torch.float32, pool=(n_pages, ps), device="cpu")
    for toks, pos in ((chunk, start), (step, start + 12)):
        jout = jax_apply(jcfg, params, {"tokens": jnp.asarray(toks)},
                         mode="decode", cache=jcache,
                         cache_pos=jnp.asarray(pos),
                         paged=JaxView(jnp.asarray(table), ps))
        jcache = jout["cache"]
        tout = apply_model(cfg, model, torch.from_numpy(toks), cache=tcache,
                           cache_pos=torch.from_numpy(pos),
                           paged=PagedView(torch.from_numpy(table), ps))
        np.testing.assert_allclose(tout["logits"].numpy(),
                                   np.asarray(jout["logits"]),
                                   atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(float(tout["aux"]), float(jout["aux"]),
                                   rtol=1e-5)


def test_init_model_draws_the_dense_prefix_at_dense_d_ff():
    cfg = port_cfg(jax_smoke("deepseek-moe-16b"))
    m = init_model(cfg, seed=0, device="cpu")
    assert m.layers[0].ffn_kind == "mlp" and m.layers[1].ffn_kind == "moe"
    assert m.layers[0].ffn["w_gate"].shape == (cfg.d_model,
                                               cfg.moe.dense_d_ff)
    assert m.layers[1].ffn["experts"]["w_up"].shape == (
        cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert)
    assert m.layers[1].ffn["router"].dtype == torch.float32
    assert m.layers[1].ffn["experts"]["w_up"].dtype == torch.bfloat16
