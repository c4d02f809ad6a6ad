"""The port's front door against the reference's: non-blocking submit,
streaming handles, priority ordering and per-tenant quotas, and the
scheduler regressions they pin (mid-pass slot reuse, the TTFT window)
-- twins of ``tests/test_frontdoor.py`` on the reference's weights
bridged into the port; streamed tokens equal the reference's batch
outputs."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import init_model as jax_init
from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.bridge import params_from_jax
from repro_torch.configs import smoke_config
from repro_torch.serve import ContinuousScheduler, FrontDoor

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(7)
SCHED = dict(slots=2, max_len=64, page_size=8, prefill_chunk=8,
             decode_chunk=4, num_pages=32)


def _cfg():
    return smoke_config("qwen3-1.7b").with_overrides(dtype="float32")


def _prompt(seed, n, vocab):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                                         vocab))


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_smoke("qwen3-1.7b").with_overrides(dtype="float32")
    params = jax_init(jcfg, KEY)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            _cfg(), device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module")
def model(ref):
    return ref[2]


def _sched(model, **kw):
    return ContinuousScheduler(_cfg(), model, **dict(SCHED, **kw))


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------

def test_submit_is_nonblocking_and_stream_matches_batch(ref, model):
    cfg = _cfg()
    prompts = [_prompt(i, 10 + i, cfg.vocab_size) for i in range(3)]
    want = _sched(model).generate(prompts, 8)
    jcfg, params, _ = ref
    jwant = JaxScheduler(jcfg, params, **SCHED).generate(prompts, 8)
    fd = FrontDoor(_sched(model))
    handles = [fd.submit(p, 8) for p in prompts]
    assert fd.sched.dispatches == 0            # no device work yet
    assert all(h.available() == [] for h in handles)
    streamed = [[t for t in h] for h in handles]
    for got, w, j in zip(streamed, want, jwant):
        np.testing.assert_array_equal(np.asarray(got, np.int32), w)
        np.testing.assert_array_equal(np.asarray(got, np.int32), j)
    assert all(h.done for h in handles)
    assert fd.in_flight == 0                   # results harvested
    assert fd.sched._byuid == {}               # and the uid index dropped


def test_tokens_arrive_in_decode_chunk_bursts(model):
    cfg = _cfg()
    fd = FrontDoor(_sched(model, slots=1))
    h = fd.submit(_prompt(0, 12, cfg.vocab_size), 8)
    sizes = []
    while not h.done:
        fd.pump()
        got = h.available()
        if got:
            sizes.append(len(got))
    # one tick = admission (prefill gives 1 token) + one decode chunk
    assert len(sizes) >= 2
    assert sum(sizes) == 8
    assert all(s <= 5 for s in sizes)
    assert h.ttft is not None and h.ttft >= 0


def test_interleaved_consumers_see_shared_progress(model):
    cfg = _cfg()
    fd = FrontDoor(_sched(model))
    h1 = fd.submit(_prompt(1, 9, cfg.vocab_size), 8)
    h2 = fd.submit(_prompt(2, 11, cfg.vocab_size), 8)
    next(h1)                                   # pumping h1 advances h2 too
    while not h1.done:
        fd.pump()
    assert len(h2.available()) > 0
    assert len(h2.result()) == 8


# --------------------------------------------------------------------------
# priority + tenant quotas
# --------------------------------------------------------------------------

def test_priority_order_admits_high_first(model):
    cfg = _cfg()
    fd = FrontDoor(_sched(model, slots=1))
    lo = fd.submit(_prompt(0, 10, cfg.vocab_size), 4, priority=0)
    hi = fd.submit(_prompt(1, 10, cfg.vocab_size), 4, priority=5)
    hi2 = fd.submit(_prompt(2, 10, cfg.vocab_size), 4, priority=5)
    fd.drain()
    # high priority first; equal priorities keep submit order
    assert hi._req.t_first < hi2._req.t_first < lo._req.t_first


def test_tenant_quota_skips_not_blocks(model):
    cfg = _cfg()
    fd = FrontDoor(_sched(model), quotas={"a": 1})
    a1 = fd.submit(_prompt(0, 10, cfg.vocab_size), 8, tenant="a")
    a2 = fd.submit(_prompt(1, 10, cfg.vocab_size), 8, tenant="a")
    b1 = fd.submit(_prompt(2, 10, cfg.vocab_size), 8, tenant="b")
    fd.pump()
    # a2 is quota-blocked but does not head-of-line block b1
    active = {r.uid for r in fd.sched._active.values()}
    assert a1.uid in active and b1.uid in active
    assert a2.uid not in active
    fd.drain()
    assert all(h.done for h in (a1, a2, b1))
    assert len(a2.result()) == 8
    assert a2._req.t_first > a1._req.t_done


def test_quota_validation(model):
    with pytest.raises(ValueError, match=">= 1"):
        _sched(model, tenant_quota=0)
    with pytest.raises(ValueError, match=">= 1"):
        FrontDoor(_sched(model), quotas={"a": 0})
    with pytest.raises(ValueError, match=">= 1"):
        FrontDoor(_sched(model), quotas=0)


# --------------------------------------------------------------------------
# serving-path regressions
# --------------------------------------------------------------------------

def test_slot_freed_mid_pass_admits_same_tick(model):
    """A request that retires AT PREFILL (EOS as its first token) frees
    its slot mid-admission-pass; the queued request behind it admits in
    the same tick."""
    cfg = _cfg()
    probe = _prompt(3, 10, cfg.vocab_size)
    first = int(_sched(model, slots=1).generate([probe], 1)[0][0])
    sch = _sched(model, slots=1, eos_id=first)
    u_eos = sch.submit(probe, 8)
    u_next = sch.submit(_prompt(4, 10, cfg.vocab_size), 4)
    sch.tick()
    done = sch.take_results()
    assert u_eos in done
    assert list(done[u_eos].out) == [first]
    assert u_next in {r.uid for r in sch._active.values()} \
        or not sch._pending
    sch.run()


def test_budget_one_requests_drain_in_single_tick(model):
    cfg = _cfg()
    sch = _sched(model, slots=1)
    uids = [sch.submit(_prompt(10 + i, 8, cfg.vocab_size), 1)
            for i in range(3)]
    assert sch.tick() is False                 # nothing left after one tick
    assert sorted(sch.take_results()) == sorted(uids)


def test_ttft_stats_window_resets_per_run(model):
    cfg = _cfg()
    sch = _sched(model)
    sch.generate([_prompt(0, 8, cfg.vocab_size)] * 3, 4)
    st1 = sch.stats()
    assert len(st1["ttft_s"]) == 3 and st1["ttft_count_cum"] == 3
    sch.generate([_prompt(1, 8, cfg.vocab_size)] * 2, 4)
    st2 = sch.stats()
    assert len(st2["ttft_s"]) == 2             # this run only
    assert st2["ttft_count_cum"] == 5          # the lifetime keeps counting
    assert st2["ttft_sum_cum_s"] >= st1["ttft_sum_cum_s"]
