"""The port's MLA (DeepSeek-V3 multi-head latent attention) against the
reference: the plain ``paged_flash_decode_mla`` (what the CPU runs, and
what the CUDA kernel is held to on the card) against the reference's
Pallas kernel (interpret mode) and its XLA formula; the paged absorbed
branch of ``apply_mla`` and the decode-mode model on
``smoke_config("deepseek-v3-671b")`` in fp32; the latent pools, the
RoPE width, the configs and parameter counts, and the weight bridge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_paged_cases import MLA_CASES, POISON, mla_case

from repro.configs import get_config as jax_get
from repro.configs import smoke_config as jax_smoke
from repro.kernels.paged_decode import paged_flash_decode_mla as jax_kernel
from repro.models import apply_model as jax_apply
from repro.models import attention as ja
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init
from repro.models.layers import rope_freqs as jax_rope_freqs
from repro.serve.kvcache import PagedKVCache as JaxKVCache
from repro_torch.bridge import layer_trees, params_from_jax, params_to_numpy
from repro_torch.configs import (get_config, one_card_config, smoke_config)
from repro_torch.kernels import (launch_counts, paged_flash_decode_mla,
                                 paged_flash_decode_mla_ref,
                                 reset_launch_counts)
from repro_torch.models import apply_model, init_cache, init_model
from repro_torch.models import attention as ta
from repro_torch.models.layers import rope_angles, rope_freqs
from repro_torch.serve import PagedKVCache

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
TOL = 2e-5      # the reference's own kernel-vs-oracle bar
# an MLA layer's output and the logits: fp32 matmuls over d = 256 and the
# latent, summed in another order by the two libraries; values are O(1)
ATOL = 1e-4


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _xla_formula(q_lat, q_rope, ckv, krope, table, pos, ps, scale, window):
    """The reference's XLA oracle (``apply_mla``'s paged branch)."""
    view = ja.PagedView(table, ps)
    ckv_c, kv_pos = ja.paged_read(ckv, view)
    krp_c, _ = ja.paged_read(krope, view)
    scores = (jnp.einsum("bshr,btr->bhst", q_lat, ckv_c,
                         preferred_element_type=jnp.float32)
              + jnp.einsum("bshk,btk->bhst", q_rope, krp_c,
                           preferred_element_type=jnp.float32)) * scale
    mask = kv_pos[None, None, :] <= pos[:, :, None]
    if window:
        mask &= kv_pos[None, None, :] > pos[:, :, None] - window
    scores = jnp.where(mask[:, None], scores, ja.NEG_INF)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhst,btr->bshr", probs, ckv_c)


@pytest.mark.parametrize("case", MLA_CASES)
def test_plain_mla_decode_matches_reference(case):
    B, S, h, r, rope, ps, W, window = case
    host = mla_case(sum(case), B, S, h, r, rope, ps, W)
    scale = 0.125
    got = paged_flash_decode_mla(*_t(*host), page_size=ps, scale=scale,
                                 window=window).numpy()
    jin = _j(*host)
    kernel = jax_kernel(*jin, page_size=ps, scale=scale, window=window)
    oracle = _xla_formula(*jin, ps, scale, window)
    assert got.shape == (B, S, h, r)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL, rtol=TOL)


def test_mla_trash_poison_never_leaks():
    """Trash page, unreferenced pages and unwritten page tails flooded
    with 1e8 give the bitwise same output as zero-filled storage."""
    q_lat, q_rope, ckv, krope, table, pos = mla_case(
        11, 2, 3, 4, 32, 16, 8, 4, lengths=[13, 27])
    outs = []
    for fill in (0.0, 1e8):
        c, k = (np.where(x == POISON, fill, x).astype(np.float32)
                for x in (ckv, krope))
        outs.append(paged_flash_decode_mla(*_t(q_lat, q_rope, c, k, table,
                                               pos), page_size=8, scale=0.2))
    assert torch.equal(outs[0], outs[1])
    want = jax_kernel(*_j(q_lat, q_rope, ckv, krope, table, pos),
                      page_size=8, scale=0.2)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_mla_cpu_wrapper_takes_plain_path_and_checks_shapes():
    args = _t(*mla_case(3, 2, 1, 4, 32, 16, 16, 4))
    reset_launch_counts()
    a = paged_flash_decode_mla(*args, page_size=16, scale=0.1)
    b = paged_flash_decode_mla_ref(*args, page_size=16, scale=0.1)
    assert torch.equal(a, b)
    assert launch_counts().get("paged_flash_decode_mla", 0) == 0
    q_lat, q_rope, ckv, krope, table, pos = args
    with pytest.raises(ValueError, match="latent"):
        paged_flash_decode_mla(q_lat, q_rope, ckv[:, :16], krope, table, pos,
                               page_size=16, scale=0.1)
    with pytest.raises(ValueError, match="krope_pool"):
        paged_flash_decode_mla(q_lat, q_rope, ckv, krope[:, :8], table, pos,
                               page_size=16, scale=0.1)
    with pytest.raises(ValueError, match="q_positions"):
        paged_flash_decode_mla(q_lat, q_rope, ckv, krope, table, pos[:, :0],
                               page_size=16, scale=0.1)


# --------------------------------------------------------------------------
# the MLA layer and the model on the smoke config
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    jcfg = jax_smoke(ARCH).with_overrides(dtype="float32")
    params = jax_init(jcfg, jax.random.PRNGKey(11))
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = smoke_config(ARCH).with_overrides(dtype="float32")
    return jcfg, params, tree, cfg, params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_apply_mla_paged_branch_matches_reference(ref, kernel):
    """A 7-token prefill chunk into two slots at different depths, then a
    decode step: the layer output and both latent pools agree with the
    reference under either of its decode kernels."""
    jcfg, _, tree, cfg, model = ref
    jcfg = jcfg.with_overrides(decode_kernel=kernel)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                layer_trees(cfg, tree["decoder"])[0]["mixer"])
    tp = model.layers[0].mixer
    ps, B = 8, 2
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    jcache = {k: jnp.asarray(v) for k, v in
              jax_init_cache(jcfg, B, 32, jnp.float32,
                             pool=(10, ps))["prefix"]["layer0"].items()}
    tcache = init_cache(cfg, torch.float32, pool=(10, ps), device="cpu")[0]
    jview = ja.PagedView(jnp.asarray(table), ps)
    tview = ta.PagedView(torch.from_numpy(table), ps)
    freqs = torch.from_numpy(rope_freqs(cfg.mla.qk_rope_head_dim,
                                        cfg.rope_theta))
    rng = np.random.default_rng(4)
    start = np.array([0, 9], np.int32)
    for S, pos0 in ((7, start), (1, start + 7)):
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        pos = (pos0[:, None] + np.arange(S)[None]).astype(np.int32)
        jout, jcache = ja.apply_mla(jcfg, jp, jnp.asarray(x),
                                    positions=jnp.asarray(pos), mode="decode",
                                    cache=jcache, paged=jview)
        tpos = torch.from_numpy(pos)
        tout = ta.apply_mla(cfg, tp, torch.from_numpy(x), positions=tpos,
                            cache=tcache, paged=tview,
                            write_idx=ta.paged_write_indices(tview, tpos),
                            rope=rope_angles(tpos, freqs))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                                   rtol=0)
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), atol=ATOL,
                                       rtol=0)


def test_decode_mode_model_matches_reference(ref):
    """The decode-mode model (MLA + dense MLP, then MLA + sigmoid MoE)
    over the paged latent pools: logits and the MoE aux loss agree."""
    jcfg, params, _, cfg, model = ref
    ps, n_pages, B = 8, 10, 2
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    rng = np.random.default_rng(0)
    chunk = rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    start = np.array([0, 9], np.int32)
    jcache = jax_init_cache(jcfg, B, 32, jnp.float32, pool=(n_pages, ps))
    tcache = init_cache(cfg, torch.float32, pool=(n_pages, ps), device="cpu")
    jview = ja.PagedView(jnp.asarray(table), ps)
    tview = ta.PagedView(torch.from_numpy(table), ps)
    for toks, pos in ((chunk, start), (step, start + 12)):
        jout = jax_apply(jcfg, params, {"tokens": jnp.asarray(toks)},
                         mode="decode", cache=jcache,
                         cache_pos=jnp.asarray(pos), paged=jview)
        jcache = jout["cache"]
        tout = apply_model(cfg, model, torch.from_numpy(toks), cache=tcache,
                           cache_pos=torch.from_numpy(pos), paged=tview)
        np.testing.assert_allclose(tout["logits"].numpy(),
                                   np.asarray(jout["logits"]), atol=ATOL,
                                   rtol=0)
        assert (tout["logits"].argmax(-1).numpy()
                == np.asarray(jout["logits"]).argmax(-1)).all()
        np.testing.assert_allclose(float(tout["aux"]), float(jout["aux"]),
                                   rtol=1e-5)


def test_rope_rotates_the_rope_width_not_head_dim(ref):
    """The RoPE trap: MLA rotates q's rope part and krope with
    ``rope_freqs(qk_rope_head_dim)``; the GQA frequencies of head_dim
    are not a prefix of them, so reusing them would rotate wrongly."""
    jcfg, _, _, cfg, model = ref
    m = cfg.mla
    assert model.rope_freqs.shape == (m.qk_rope_head_dim // 2,)
    np.testing.assert_array_equal(
        model.rope_freqs.numpy(),
        np.asarray(jax_rope_freqs(m.qk_rope_head_dim, jcfg.rope_theta)))
    wide = rope_freqs(cfg.head_dim, cfg.rope_theta)
    assert not np.array_equal(wide[:m.qk_rope_head_dim // 2],
                              model.rope_freqs.numpy())
    full = get_config(ARCH)
    assert not np.array_equal(rope_freqs(128, full.rope_theta)[:32],
                              rope_freqs(64, full.rope_theta))


def test_mla_pools_and_pool_bytes_equal_reference(ref):
    jcfg, _, _, cfg, _ = ref
    kv = PagedKVCache(cfg, slots=3, max_len=32, page_size=8, device="cpu")
    jkv = JaxKVCache(jcfg, slots=3, max_len=32, page_size=8)
    n = kv.num_pages * 8
    for layer in kv.cache:
        assert {k: tuple(t.shape) for k, t in layer.items()} == {
            "ckv": (n, cfg.mla.kv_lora_rank),
            "krope": (n, cfg.mla.qk_rope_head_dim)}
    assert kv.pool_bytes() == jkv.pool_bytes() == cfg.num_layers * n * (
        cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 4
    assert kv.state_bytes() == 0


# --------------------------------------------------------------------------
# configs, parameter counts, bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_configs_equal_reference_field_by_field(which):
    tcfg, jcfg = {"full": (get_config(ARCH), jax_get(ARCH)),
                  "smoke": (smoke_config(ARCH), jax_smoke(ARCH))}[which]
    for f in dataclasses.fields(tcfg):
        a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert tcfg.layer_pattern() == jcfg.layer_pattern()
    assert tcfg.block_structure() == jcfg.block_structure()
    assert tcfg.param_count() == jcfg.param_count()


def _allocated(cfg) -> int:
    """Elements ``init_model`` allocates for an MLA + MoE stack, from the
    shapes: the reference's formula plus what it leaves out (the dense
    prefix's MLPs at dense_d_ff, not d_ff; the norm scales; the router
    bias)."""
    d, m, e = cfg.d_model, cfg.mla, cfg.moe
    total = cfg.vocab_size * d * 2 + d                    # untied + final norm
    for i, (_, ffn) in enumerate(cfg.layer_pattern()):
        total += cfg.attn_params() + m.q_lora_rank + m.kv_lora_rank + 2 * d
        if ffn == "moe":
            total += cfg.ffn_params("moe") + e.num_experts
        else:
            total += 3 * d * (e.dense_d_ff if i < e.first_dense_layers
                              else cfg.d_ff)
    return total


def test_one_card_cut_and_its_param_counts():
    """Four layers: the 3 dense layers and the first MoE layer, every
    width kept.  The reference's formula counts the dense prefix's MLPs
    at d_ff (2048), not dense_d_ff (18432): 14.05 B where the tensors
    hold 15.11 B.  The shape count is checked against the tensors on
    the smoke config."""
    cfg = one_card_config(ARCH)
    assert cfg.layer_pattern() == (("attn", "mlp"),) * 3 + (("attn", "moe"),)
    assert cfg == get_config(ARCH).with_overrides(num_layers=4)
    assert cfg.param_count() == jax_get(ARCH).with_overrides(
        num_layers=4).param_count() == 14_054_064_128
    assert _allocated(cfg) == 15_111_101_696
    d = cfg.d_model
    assert _allocated(cfg) - cfg.param_count() == (
        3 * 3 * d * (cfg.moe.dense_d_ff - cfg.d_ff)
        + 4 * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank + 2 * d) + d
        + cfg.moe.num_experts)
    small = smoke_config(ARCH)
    m = init_model(small, seed=0, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == _allocated(small)


def test_bridge_round_trip_drops_mtp_by_name_and_refuses_unknown(ref):
    _, _, tree, cfg, model = ref
    assert "mtp" in tree                         # the reference draws it
    back = params_to_numpy(model, cfg)
    assert "mtp" not in back
    kept = {k: v for k, v in tree.items() if k != "mtp"}
    flat_a = jax.tree_util.tree_leaves_with_path(kept)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    kv_norm = back["decoder"]["prefix"]["layer0"]["mixer"]["kv_norm"]
    assert set(kv_norm) == {"scale"}
    assert kv_norm["scale"].shape == (cfg.mla.kv_lora_rank,)
    with pytest.raises(ValueError, match="vision_proj"):
        params_from_jax(dict(tree, vision_proj={}), cfg, device="cpu")


def test_bf16_mla_model_keeps_norms_fp32():
    cfg = smoke_config(ARCH)
    m = init_model(cfg, seed=0, device="cpu")
    mixer = m.layers[0].mixer
    assert mixer["q_norm"].dtype == mixer["kv_norm"].dtype == torch.float32
    assert mixer["w_uk"].dtype == torch.bfloat16
    assert m.layers[1].ffn["router"].dtype == torch.float32
    assert m.layers[1].ffn["router_bias"].dtype == torch.float32
    cache = init_cache(cfg, torch.bfloat16, pool=(3, 8), device="cpu")
    assert cache[0]["ckv"].dtype == torch.bfloat16
