"""The port's model against the reference: the weight bridge and the
decode-mode paged forward of ``smoke_config("qwen3-1.7b")`` in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import apply_model as jax_apply
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init
from repro.models.attention import PagedView as JaxView
from repro_torch.bridge import layer_trees, params_from_jax, params_to_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import apply_model, init_cache, init_model
from repro_torch.models.attention import PagedView

torch.set_num_threads(2)

# Logit bar: the matmul sums over d=256 are taken in another order by
# the two libraries.
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    cfg = jax_smoke("qwen3-1.7b").with_overrides(dtype="float32")
    params = jax_init(cfg, jax.random.PRNGKey(5))
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _tcfg():
    return smoke_config("qwen3-1.7b").with_overrides(dtype="float32")


def test_port_configs_equal_reference_fields():
    from repro.configs import get_config as jax_get
    for tcfg, jcfg in ((get_config("qwen3-1.7b"), jax_get("qwen3-1.7b")),
                       (_tcfg(), jax_smoke("qwen3-1.7b")
                        .with_overrides(dtype="float32"))):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "qk_norm", "rope_theta",
                  "tie_embeddings", "norm_eps", "dtype", "mlp_gated"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
        assert tcfg.block_structure() == jcfg.block_structure()
        assert tcfg.param_count() == jcfg.param_count()


def test_bridge_round_trip_is_bitwise(ref):
    _, _, tree = ref
    model = params_from_jax(tree, _tcfg(), device="cpu")
    back = params_to_numpy(model, _tcfg())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_bridge_unstacks_layers_and_casts_once(ref):
    _, _, tree = ref
    cfg = _tcfg()
    layers = layer_trees(cfg, tree["decoder"])
    assert len(layers) == cfg.num_layers
    np.testing.assert_array_equal(
        layers[1]["mixer"]["wq"], tree["decoder"]["blocks"]["layer0"]
        ["mixer"]["wq"][1])
    bf = params_from_jax(tree, cfg.with_overrides(dtype="bfloat16"),
                         device="cpu")
    assert bf.layers[0].mixer["wq"].dtype == torch.bfloat16
    assert bf.layers[0].mixer["q_norm"].dtype == torch.float32
    assert bf.embed.dtype == torch.bfloat16
    assert bf.unembed_f32.dtype == torch.float32


def test_decode_mode_paged_logits_match_reference(ref):
    """A 12-token prefill chunk into two slots at different depths, then
    a decode step: logits within LOGIT_ATOL, pools agreeing."""
    jcfg, params, tree = ref
    cfg = _tcfg()
    model = params_from_jax(tree, cfg, device="cpu")
    ps, n_pages = 8, 10
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    rng = np.random.default_rng(0)
    chunk = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    step = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    start = np.array([0, 9], np.int32)

    jcache = jax_init_cache(jcfg, 2, 32, jnp.float32, pool=(n_pages, ps))
    tcache = init_cache(cfg, torch.float32, pool=(n_pages, ps), device="cpu")
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
        jk = np.asarray(jcache["blocks"]["layer0"]["k"][i])
        np.testing.assert_allclose(tcache[i]["k"].numpy(), jk, atol=1e-5)


def test_last_only_and_logit_free_calls(ref):
    _, _, tree = ref
    cfg = _tcfg()
    model = params_from_jax(tree, cfg, device="cpu")
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (1, 6))
    pos0 = torch.zeros(1, dtype=torch.int32)

    def run(**kw):
        cache = init_cache(cfg, torch.float32, pool=(3, 8), device="cpu")
        return apply_model(cfg, model, toks, cache=cache, cache_pos=pos0,
                           paged=PagedView(table, 8), **kw)
    full, last = run(), run(last_only=True)
    assert last["logits"].shape == (1, 1, cfg.vocab_size)
    torch.testing.assert_close(last["logits"][:, 0], full["logits"][:, -1])
    assert "logits" not in run(logits=False)


def test_init_model_seeded_and_cast():
    cfg = smoke_config("qwen3-1.7b")                  # bf16 compute
    a = init_model(cfg, seed=1, device="cpu")
    b = init_model(cfg, seed=1, device="cpu")
    assert torch.equal(a.layers[1].ffn["w_up"], b.layers[1].ffn["w_up"])
    assert a.layers[0].mixer["wq"].shape == (cfg.d_model, cfg.num_heads,
                                             cfg.head_dim)
    assert a.layers[0].mixer["wq"].dtype == torch.bfloat16
    assert a.unembed_f32.dtype == torch.float32
    assert len(a.layers) == cfg.num_layers
