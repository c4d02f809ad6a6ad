"""The port's serving path against the reference: greedy tokens and
dispatch/sync counters of ``ContinuousScheduler`` bitwise-equal to the
reference's under both of its decode kernels, EOS retirement, sampling
filters, and the page bookkeeping."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import init_model as jax_init
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import sampling as jax_sampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import smoke_config
from repro_torch.serve import (ContinuousScheduler, PagedKVCache,
                               SamplingConfig, filter_logits, make_engine,
                               masked_sample)

torch.set_num_threads(2)

COUNTERS = ("prefill_dispatches", "prefill_host_syncs", "decode_dispatches",
            "decode_host_syncs", "tokens_out")
# staggered: more requests than slots, prompts longer than prefill_chunk
# (two and three chunks, ragged tails) and shorter than one page
LENGTHS = [5, 40, 19, 70]
SCHED = dict(slots=2, max_len=128, page_size=8, prefill_chunk=32,
             decode_chunk=4)
NEW = 10


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_smoke("qwen3-1.7b").with_overrides(dtype="float32")
    params = jax_init(jcfg, jax.random.PRNGKey(3))
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    return jcfg, params, cfg, model, prompts


def _both(ref, kernel, **kw):
    jcfg, params, cfg, model, prompts = ref
    js = JaxScheduler(jcfg.with_overrides(decode_kernel=kernel), params,
                      **SCHED, **kw)
    ts = ContinuousScheduler(cfg, model, **SCHED, **kw)
    return (js.generate(prompts, NEW), js.stats(),
            ts.generate(prompts, NEW), ts.stats())


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_greedy_tokens_and_counters_bitwise_equal_reference(ref, kernel):
    jo, jst, to, tst = _both(ref, kernel)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)
    for c in COUNTERS:
        assert jst[c] == tst[c], c
    assert tst["decode_host_syncs"] == tst["decode_dispatches"]
    assert tst["prefill_host_syncs"] == len(LENGTHS)


def test_eos_retires_mid_stream_like_reference(ref):
    """EOS picked as a token whose FIRST occurrence in request 0's free
    run is at index 3, so request 0 retires there and its slot admits
    the next request."""
    jcfg, params, cfg, model, prompts = ref
    free = ContinuousScheduler(cfg, model, **SCHED).generate(prompts, NEW)[0]
    idx = next(i for i in range(3, NEW) if free[i] not in free[:i])
    eos = int(free[idx])
    jo, jst, to, tst = _both(ref, "xla", eos_id=eos)
    assert list(to[0]) == list(free[:idx + 1])
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)
    for c in COUNTERS:
        assert jst[c] == tst[c], c


@pytest.mark.parametrize("sc", [
    SamplingConfig(temperature=0.7, top_k=5),
    SamplingConfig(temperature=1.0, top_p=0.8),
    SamplingConfig(temperature=1.3, top_k=20, top_p=0.5),
    SamplingConfig(temperature=1.0, top_k=3, top_p=0.999999),
])
def test_filter_logits_keeps_the_reference_set(sc):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 64)).astype(np.float32)
    logits[1, :10] = 2.5                            # ties at the cutoff
    got = torch.isfinite(filter_logits(torch.from_numpy(logits), sc))
    want = jnp.isfinite(jax_sampling.filter_logits(
        jnp.asarray(logits), jax_sampling.SamplingConfig(
            sc.temperature, sc.top_k, sc.top_p)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_sample_pins_done_lanes_and_samples_kept_set():
    logits = torch.zeros(3, 16)
    logits[:, 5] = 9.0
    done = torch.tensor([False, True, False])
    g = torch.Generator().manual_seed(0)
    got = masked_sample(logits, g, done, 7, SamplingConfig())
    assert got.tolist() == [5, 7, 5] and got.dtype == torch.int32
    sc = SamplingConfig(temperature=1.0, top_k=2)
    logits = torch.randn(3, 16, generator=g).repeat(50, 1)
    draws = masked_sample(logits, g, torch.zeros(150, dtype=torch.bool), 0,
                          sc)
    kept = torch.isfinite(filter_logits(logits, sc))
    assert kept[torch.arange(150), draws.long()].all()
    assert len(set(draws.tolist())) > 3        # not collapsed to argmax


def test_kvcache_alloc_free_reuse():
    cfg = smoke_config("qwen3-1.7b")
    kv = PagedKVCache(cfg, slots=2, max_len=64, page_size=16, num_pages=5,
                      device="cpu")
    assert kv.free_pages == 4                  # page 0 is the trash page
    kv.alloc(0, 33)
    assert kv.pages_in_use == 3 and kv.free_pages == 1
    assert 0 not in kv.table()[0, :3].tolist()
    assert kv.pages_needed(17) > kv.free_pages
    with pytest.raises(MemoryError):
        kv.alloc(1, 32)
    kv.free(0)
    assert kv.free_pages == 4 and (kv.table()[0] == 0).all()
    kv.alloc(1, 64)
    assert kv.free_pages == 0
    kv.free(1)
    kv.alloc(0, 10)
    kv.alloc(0, 20)                            # tops up by one page
    assert kv.pages_in_use == 2
    assert kv.pool_bytes() == 2 * 2 * 5 * 16 * cfg.num_kv_heads \
        * cfg.head_dim * 4                     # 2 layers, k+v, fp32
    with pytest.raises(ValueError):
        PagedKVCache(cfg, slots=1, max_len=60, page_size=16, device="cpu")


def test_priority_admission_and_submit_guards(ref):
    _, _, cfg, model, prompts = ref
    sch = ContinuousScheduler(cfg, model, slots=1, max_len=64, page_size=8,
                              decode_chunk=4)
    with pytest.raises(ValueError):
        sch.submit([], 4)
    with pytest.raises(ValueError):
        sch.submit(np.zeros(60, np.int32), 4)
    low = sch.submit(prompts[0], 3)
    high = sch.submit(prompts[2], 3, priority=5)
    sch.tick()                                 # admits and finishes `high`
    assert list(sch.take_results()) == [high]
    assert list(sch.run()) == [low]
    st = sch.stats()
    assert st["tokens_out"] == 6 and st["pool_pages_in_use"] == 0
    assert st["ttft_count_cum"] == 2


def test_make_engine_loads_reference_tree_and_rejects_legacy(ref):
    jcfg, params, cfg, _, prompts = ref
    tree = jax.tree_util.tree_map(np.asarray, params)
    eng = make_engine(cfg, tree, batch_size=2, max_len=64, device="cpu",
                      page_size=8)
    assert isinstance(eng, ContinuousScheduler)
    assert len(eng.generate(prompts[:1], 3)[0]) == 3
    # the lockstep slab engine is ported now: it refuses the continuous
    # engine's keywords, and unknown engine names raise
    with pytest.raises(TypeError):
        make_engine(cfg, tree, engine="legacy", device="cpu", page_size=8)
    with pytest.raises(ValueError):
        make_engine(cfg, tree, engine="paged", device="cpu")
