"""The port's Jamba serving path against the reference: greedy tokens
and dispatch/sync counters of ``ContinuousScheduler`` on
``smoke_config("jamba-v0.1-52b")`` in fp32 (a Mamba + MLP layer, then
attention + MoE) bitwise-equal to the reference's, whose selective scan
runs as the chunked XLA form and as the interpret-mode Pallas kernel;
staggered requests reuse slots, so each admit must reset the slot's
Mamba rows."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.kernels import ops as jax_ops
from repro.models import init_model as jax_init
from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.bridge import params_from_jax
from repro_torch.configs import smoke_config
from repro_torch.serve import ContinuousScheduler

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
COUNTERS = ("prefill_dispatches", "prefill_host_syncs", "decode_dispatches",
            "decode_host_syncs", "tokens_out", "prompt_tokens",
            "pool_pages_in_use", "pool_bytes")
# staggered: more requests than slots; one chunk, two and three chunks
# with ragged tails, and a prompt that ends in a one-token chunk (33)
LENGTHS = [5, 40, 33, 70, 19]
SCHED = dict(slots=2, max_len=128, page_size=8, prefill_chunk=32,
             decode_chunk=4)
NEW = 10


@pytest.fixture
def scan_impl():
    """Sets the reference's global scan implementation for one test and
    restores it afterwards."""
    before = jax_ops.get_default_impl()
    yield jax_ops.set_default_impl
    jax_ops.set_default_impl(before)


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_smoke(ARCH).with_overrides(dtype="float32")
    params = jax_init(jcfg, jax.random.PRNGKey(3))
    cfg = smoke_config(ARCH).with_overrides(dtype="float32")
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    return jcfg, params, cfg, model, prompts


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_greedy_tokens_and_counters_bitwise_equal_reference(ref, scan_impl,
                                                            impl):
    jcfg, params, cfg, model, prompts = ref
    scan_impl(impl)
    js = JaxScheduler(jcfg, params, **SCHED)
    jo, jst = js.generate(prompts, NEW), js.stats()
    ts = ContinuousScheduler(cfg, model, **SCHED)
    to, tst = ts.generate(prompts, NEW), ts.stats()
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)
    for c in COUNTERS:
        assert jst[c] == tst[c], c
    assert tst["prefill_dispatches"] == sum(-(-n // 32) for n in LENGTHS)
    assert tst["pool_bytes"] > 0 and tst["state_bytes"] > 0


def test_readmitted_slot_matches_request_served_alone(ref):
    """One slot serves three requests in turn; each gets exactly the
    tokens it gets in a fresh scheduler -- the previous occupant's Mamba
    state and conv tail (and the pad steps the slot ran while idle) do
    not leak."""
    _, _, cfg, model, prompts = ref
    one = dict(SCHED, slots=1)
    together = ContinuousScheduler(cfg, model, **one).generate(prompts[:3],
                                                                NEW)
    for p, got in zip(prompts[:3], together):
        alone = ContinuousScheduler(cfg, model, **one).generate([p], NEW)[0]
        np.testing.assert_array_equal(got, alone)


def test_launcher_serves_jamba_on_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--requests", "3", "--prompt-len",
                       "40", "--new-tokens", "5", "--report"])
    assert [len(o) for o in outs] == [5, 5, 5]
    out = capsys.readouterr().out
    assert "recurrent state bytes" in out and "report:" in out
