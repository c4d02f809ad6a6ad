"""The port's prefix (radix) cache against the reference's: page
refcounts, double free, page 0, the copy-on-write byte copy and
full-page matching from the root (twins of ``tests/test_prefix.py``),
then serving: greedy tokens with the cache on bitwise-equal to the cache
off, and the port's tokens, ``prefix_hit_tokens`` and tree stats equal
to the reference's on the same bridged weights -- partial matches, the
fully matched repeat (the copy-on-write path) and eviction under pool
pressure.  ``deepseek-v3-671b`` stands in for MLA (the reference's
``deepseek-moe-16b`` is not in the port)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import init_model as jax_init
from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.bridge import params_from_jax
from repro_torch.configs import smoke_config
from repro_torch.serve import ContinuousScheduler, PagedKVCache, PrefixCache

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(7)
_MODELS = {}


def _cfg(arch="qwen3-1.7b"):
    return smoke_config(arch).with_overrides(dtype="float32")


def _models(arch="qwen3-1.7b"):
    """(reference cfg, reference params, port model) on the same
    weights."""
    if arch not in _MODELS:
        jcfg = jax_smoke(arch).with_overrides(dtype="float32")
        params = jax_init(jcfg, KEY)
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                _cfg(arch), device="cpu")
        _MODELS[arch] = (jcfg, params, model)
    return _MODELS[arch]


def _rand_prompt(seed, n, vocab):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                                         vocab))


def _pool(slots=2, page_size=4, num_pages=12, max_len=32, arch="qwen3-1.7b"):
    return PagedKVCache(_cfg(arch), slots=slots, max_len=max_len,
                        page_size=page_size, num_pages=num_pages,
                        device="cpu")


# --------------------------------------------------------------------------
# refcount bookkeeping (host-side, no model passes)
# --------------------------------------------------------------------------

def test_refcounts_alias_and_tree_survival():
    kv = _pool()
    px = PrefixCache(kv)
    prompt = np.arange(8, dtype=np.int32)        # 2 full pages of 4
    kv.alloc(0, 8)
    owned = list(kv._owned[0])
    px.insert(prompt, owned)                     # the tree takes +1 each
    assert all(kv.refcount(p) == 2 for p in owned)
    kv.free(0)                                   # the slot drops its refs
    assert all(kv.refcount(p) == 1 for p in owned)   # the pages survive
    assert sorted(px.pages()) == sorted(owned)
    n_tok, pages = px.match(prompt)
    assert (n_tok, pages) == (8, owned)
    kv.alias(1, pages)                           # admission: +1 a page
    assert all(kv.refcount(p) == 2 for p in owned)
    assert kv._owned[1] == owned
    assert kv.table()[1, :2].tolist() == owned
    kv.free(1)                                   # decrements, no release
    assert all(kv.refcount(p) == 1 for p in owned)
    assert sorted(px.pages()) == sorted(owned)


def test_release_to_zero_returns_page_and_double_free_raises():
    kv = _pool()
    kv.alloc(0, 4)
    page = kv._owned[0][0]
    free0 = kv.free_pages
    kv.free(0)
    assert kv.free_pages == free0 + 1            # back on the free list
    with pytest.raises(ValueError, match="double free"):
        kv.release(page)
    with pytest.raises(ValueError, match="dead page"):
        kv.retain(page)


def test_page0_never_enters_tree_or_refcounts():
    kv = _pool()
    px = PrefixCache(kv)
    with pytest.raises(ValueError, match="page 0"):
        kv.retain(0)
    with pytest.raises(ValueError, match="page 0"):
        kv.release(0)
    with pytest.raises(ValueError, match="page 0"):
        px.insert(np.arange(4, dtype=np.int32), [0])
    assert px.nodes == 0 and px.pages() == []


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v3-671b"])
def test_cow_fork_copies_bytes_and_leaves_shared_page_untouched(arch):
    """Every pooled leaf (GQA k / v, MLA ckv / krope) gets the shared
    page's rows copied along its token axis; the shared rows and every
    other row keep their bytes."""
    kv = _pool(arch=arch)
    ps = kv.page_size
    kv.alloc(0, 8)
    shared = kv._owned[0][1]
    g = torch.Generator().manual_seed(0)
    for layer in kv.cache:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=g))
    before = [{k: t.clone() for k, t in layer.items()} for layer in kv.cache]
    kv.retain(shared)                            # a second holder
    new = kv.cow_fork(0, 1)
    assert new != shared
    assert kv._owned[0][1] == new and kv.table()[0, 1] == new
    assert kv.refcount(shared) == 1              # the slot's ref moved off
    assert kv.refcount(new) == 1
    rows = lambda p: slice(p * ps, (p + 1) * ps)                # noqa: E731
    for layer, old in zip(kv.cache, before):
        for k, t in layer.items():
            torch.testing.assert_close(t[rows(new)], old[k][rows(shared)],
                                       rtol=0, atol=0)
            keep = torch.ones(t.shape[0], dtype=torch.bool)
            keep[rows(new)] = False
            torch.testing.assert_close(t[keep], old[k][keep], rtol=0, atol=0)


def test_cow_fork_skips_per_slot_recurrent_leaves():
    cfg = _cfg("jamba-v0.1-52b")
    kv = PagedKVCache(cfg, slots=2, max_len=32, page_size=4, num_pages=12,
                      device="cpu")
    kv.alloc(0, 8)
    kv.retain(kv._owned[0][1])
    states = [(kind, {k: t.clone() for k, t in layer.items()})
              for (kind, _), layer in zip(cfg.layer_pattern(), kv.cache)]
    kv.cow_fork(0, 1)
    for (kind, old), layer in zip(states, kv.cache):
        if kind != "attn":
            for k, t in layer.items():
                assert torch.equal(t, old[k])


def test_match_requires_full_pages_from_root():
    kv = _pool()
    px = PrefixCache(kv)
    prompt = np.arange(8, dtype=np.int32)
    kv.alloc(0, 8)
    px.insert(prompt, kv._owned[0])
    assert px.match(prompt[:3])[0] == 0          # no full page: no match
    assert px.match(prompt + 1)[0] == 0          # never shared mid-prompt
    assert px.match(np.concatenate([prompt, prompt]))[0] == 8


def test_eviction_lru_leaf_only_and_alias_protection():
    kv = _pool(num_pages=12)
    px = PrefixCache(kv)
    a = np.arange(8, dtype=np.int32)
    b = np.arange(100, 108, dtype=np.int32)
    for p in (a, b):
        kv.alloc(0, 8)
        px.insert(p, kv._owned[0])
        kv.free(0)
    px.match(a)                                  # touch a: b is now LRU
    free0 = kv.free_pages
    assert px.evict_one()
    assert kv.free_pages == free0 + 1
    assert px.match(b)[0] == 4                   # only b's LEAF went
    n, pages = px.match(a)
    kv.alias(1, pages)
    while px.evict_one():
        pass
    assert px.nodes == 0 and px.stats()["evictions"] == 4
    assert all(kv.refcount(p) == 1 for p in pages)   # slot 1 holds them
    kv.free(1)
    assert kv.free_pages == kv.num_pages - 1


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-1.6b"])
def test_prefix_cache_refuses_recurrent_stacks(arch):
    from repro_torch.models import init_model
    cfg = _cfg(arch)
    model = init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="attention/MLA-only"):
        ContinuousScheduler(cfg, model, slots=1, max_len=32, page_size=8,
                            prefix_cache=True)


# --------------------------------------------------------------------------
# serving: cache on == cache off, port == reference
# --------------------------------------------------------------------------

def _both(arch, prompts, new, **kw):
    """The reference's cached run, the port's cached run and the port's
    uncached run on the same weights: (outputs, stats) each."""
    jcfg, params, model = _models(arch)
    js = JaxScheduler(jcfg, params, prefix_cache=True, **kw)
    on = ContinuousScheduler(_cfg(arch), model, prefix_cache=True, **kw)
    off = ContinuousScheduler(_cfg(arch), model, **kw)
    return ((js.generate(prompts, new), js.stats()),
            (on.generate(prompts, new), on.stats()),
            (off.generate(prompts, new), off.stats()), on)


def _check(ref, on, off):
    (jo, jst), (to, tst), (uo, _) = ref, on, off
    for i, (j, t, u) in enumerate(zip(jo, to, uo)):
        np.testing.assert_array_equal(t, u, err_msg=f"request {i}: on/off")
        np.testing.assert_array_equal(t, j, err_msg=f"request {i}: port/ref")
    for key in ("prefix_hit_tokens", "prompt_tokens", "prefill_dispatches",
                "decode_dispatches", "tokens_out", "pool_pages_in_use"):
        assert tst[key] == jst[key], key
    assert tst["prefix_cache"] == jst["prefix_cache"]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v3-671b"])
def test_scheduler_prefix_bitwise_vs_uncached_and_reference(arch):
    """Staggered shared-prefix traffic: a 2-page template with distinct
    suffixes (partial matches), plus an exact repeat (a full match: the
    copy-on-write path)."""
    cfg = _cfg(arch)
    shared = _rand_prompt(9, 16, cfg.vocab_size)
    rng = np.random.default_rng(3)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, 3 + i).astype(np.int32)]) for i in range(3)]
    prompts.append(prompts[0].copy())
    ref, on, off, sch = _both(arch, prompts, 6, slots=2, max_len=64,
                              page_size=8, prefill_chunk=8, decode_chunk=4,
                              num_pages=40)
    _check(ref, on, off)
    st = on[1]
    assert st["prefix_hit_rate"] > 0 and st["prefix_cache"]["nodes"] > 0
    # after the drain only the tree holds references
    assert sorted(sch.kv._refs) == sorted(sch.prefix.pages())
    assert all(r == 1 for r in sch.kv._refs.values())


def test_full_match_cow_repeat_is_bitwise_stable():
    """An identical page-aligned prompt served twice by one cached
    scheduler: the second pass aliases both prompt pages, forks the last
    one and prefills only the final token into the copy."""
    jcfg, params, model = _models()
    cfg = _cfg()
    pa = _rand_prompt(5, 16, cfg.vocab_size)     # 2 full pages of 8
    kw = dict(slots=1, max_len=64, page_size=8, prefill_chunk=8,
              decode_chunk=4, prefix_cache=True, num_pages=32)
    s = ContinuousScheduler(cfg, model, **kw)
    o1 = s.generate([pa], 5)
    o2 = s.generate([pa], 5)
    np.testing.assert_array_equal(o1[0], o2[0])
    assert s.stats()["prefix_hit_tokens"] == 15
    assert all(r == 1 for r in s.kv._refs.values())
    js = JaxScheduler(jcfg, params, **kw)
    j1, j2 = js.generate([pa], 5), js.generate([pa], 5)
    np.testing.assert_array_equal(o1[0], j1[0])
    np.testing.assert_array_equal(o2[0], j2[0])
    assert js.stats()["prefix_hit_tokens"] == 15


def test_prefix_eviction_under_pool_pressure_stays_correct():
    """A pool too small to cache every distinct prompt: admission evicts
    LRU chains, and the tokens still equal the uncached scheduler's and
    the reference's."""
    cfg = _cfg()
    prompts = [_rand_prompt(20 + i, 16, cfg.vocab_size) for i in range(5)]
    ref, on, off, sch = _both("qwen3-1.7b", prompts, 4, slots=1, max_len=32,
                              page_size=8, prefill_chunk=8, decode_chunk=4,
                              num_pages=11)
    _check(ref, on, off)
    assert sch.prefix.evictions > 0
