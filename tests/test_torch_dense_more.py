"""The four decoder-only newcomers against the reference, at each smoke
config in fp32 on the same bridged weights: granite-20b (MQA, the plain
gelu MLP), qwen2.5-32b (GQA g = 5 at full width, with its qkv bias --
drawn nonzero here, so that it shows), deepseek-coder-33b (GQA) and
deepseek-moe-16b (MHA; a dense first layer, then MoE with a shared
expert): the continuous scheduler's and the lockstep ``ServeEngine``'s
greedy tokens and counters bitwise the reference's, and five AdamW steps
of losses and params."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_arch_train import _five_adamw_steps

from repro.configs import smoke_config as jax_smoke
from repro.models import init_model as jax_init
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, smoke_config
from repro_torch.serve import ContinuousScheduler, ServeEngine

torch.set_num_threads(2)

ARCHS = ["granite-20b", "qwen2.5-32b", "deepseek-coder-33b",
         "deepseek-moe-16b"]
COUNTERS = ("prefill_dispatches", "prefill_host_syncs", "decode_dispatches",
            "decode_host_syncs", "tokens_out")
LENGTHS, NEW = [5, 40, 19, 70], 10
SCHED = dict(slots=2, max_len=128, page_size=8, prefill_chunk=32,
             decode_chunk=4)
B, S0, MAX_LEN = 3, 20, 64
# the near-eps share of five AdamW steps (tests/test_torch_arch_train.py)
SHARE = 0.02
_REFS = {}


@pytest.fixture(params=ARCHS)
def ref(request):
    """(jcfg, params, numpy params, cfg) with the qkv biases drawn
    nonzero."""
    arch = request.param
    if arch not in _REFS:
        jcfg = jax_smoke(arch).with_overrides(dtype="float32")
        params = jax_init(jcfg, jax.random.PRNGKey(9))
        rng = np.random.default_rng(4)
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(rng.uniform(-0.2, 0.2, a.shape),
                                     a.dtype)
            if jax.tree_util.keystr(p).endswith(("['bq']", "['bk']",
                                                 "['bv']")) else a, params)
        cfg = smoke_config(arch).with_overrides(dtype="float32")
        _REFS[arch] = (jcfg, params,
                       jax.tree_util.tree_map(np.asarray, params), cfg)
    return _REFS[arch]


def test_structure_of_each_newcomer(ref):
    """What sets each apart, in the bridged model: granite's single kv
    head and two-matrix MLP; qwen2.5's nonzero qkv bias; deepseek-moe's
    dense first layer (``dense_d_ff`` wide) and MoE layers with a shared
    expert; the full configs' group sizes 48, 5, 7 and 1."""
    _, _, np_params, cfg = ref
    model = params_from_jax(np_params, cfg, device="cpu")
    full = get_config(cfg.name)
    g = full.num_heads // full.num_kv_heads
    assert g == {"granite-20b": 48, "qwen2.5-32b": 5,
                 "deepseek-coder-33b": 7, "deepseek-moe-16b": 1}[cfg.name]
    layer0 = model.layers[0]
    if cfg.name == "granite-20b":
        assert cfg.num_kv_heads == 1 and "w_gate" not in layer0.ffn
    if cfg.name == "qwen2.5-32b":
        assert all(float(l.mixer["bk"].abs().max()) > 0 for l in model.layers)
    if cfg.name == "deepseek-moe-16b":
        assert layer0.ffn_kind == "mlp"
        assert layer0.ffn["w_up"].shape[1] == cfg.moe.dense_d_ff
        assert model.layers[1].ffn_kind == "moe"
        assert "shared" in model.layers[1].ffn


def test_continuous_scheduler_equals_reference(ref):
    jcfg, params, np_params, cfg = ref
    model = params_from_jax(np_params, cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    js = JaxScheduler(jcfg.with_overrides(decode_kernel="xla"), params,
                      **SCHED)
    ts = ContinuousScheduler(cfg, model, **SCHED)
    jo, to = js.generate(prompts, NEW), ts.generate(prompts, NEW)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a), b)
    jst, tst = js.stats(), ts.stats()
    for c in COUNTERS:
        assert jst[c] == tst[c], c


def test_serve_engine_equals_reference(ref):
    jcfg, params, np_params, cfg = ref
    model = params_from_jax(np_params, cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)
    je = JaxEngine(jcfg, params, batch_size=B, max_len=MAX_LEN,
                   dtype=jnp.float32)
    jo = np.asarray(je.generate(jnp.asarray(prompts), NEW))
    te = ServeEngine(cfg, model, batch_size=B, max_len=MAX_LEN)
    np.testing.assert_array_equal(te.generate(prompts, NEW).numpy(), jo)
    assert (te.dispatches, te.host_syncs) == (je.dispatches, je.host_syncs)


def test_five_adamw_steps_match_reference(ref):
    _five_adamw_steps(*ref, share=SHARE)
