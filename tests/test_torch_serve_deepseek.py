"""The port's DeepSeek-V3 serving path against the reference: greedy
tokens and dispatch/sync counters of ``ContinuousScheduler`` on
``smoke_config("deepseek-v3-671b")`` in fp32 (MLA + dense MLP, then
MLA + the sigmoid-router MoE with a shared expert) bitwise-equal to the
reference's, whose absorbed MLA decode runs as the XLA formula and as
the interpret-mode Pallas kernel.  Staggered requests reuse slots and
pages; one prompt ends in a one-token chunk."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import init_model as jax_init
from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.bridge import params_from_jax
from repro_torch.configs import smoke_config
from repro_torch.serve import ContinuousScheduler

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
COUNTERS = ("prefill_dispatches", "prefill_host_syncs", "decode_dispatches",
            "decode_host_syncs", "tokens_out", "prompt_tokens",
            "pool_pages_in_use", "pool_bytes")
# staggered: more requests than slots; one chunk, two and three chunks
# with ragged tails, and a prompt that ends in a one-token chunk (33)
LENGTHS = [5, 40, 33, 70, 19]
SCHED = dict(slots=2, max_len=128, page_size=8, prefill_chunk=32,
             decode_chunk=4)
NEW = 10


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


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_greedy_tokens_and_counters_bitwise_equal_reference(ref, kernel):
    jcfg, params, cfg, model, prompts = ref
    js = JaxScheduler(jcfg.with_overrides(decode_kernel=kernel), params,
                      **SCHED)
    jo, jst = js.generate(prompts, NEW), js.stats()
    ts = ContinuousScheduler(cfg, model, **SCHED)
    to, tst = ts.generate(prompts, NEW), ts.stats()
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)
    for c in COUNTERS:
        assert jst[c] == tst[c], c
    assert tst["prefill_dispatches"] == sum(-(-n // 32) for n in LENGTHS)
    assert tst["pool_bytes"] > 0 and tst["state_bytes"] == 0


def test_readmitted_slot_matches_request_served_alone(ref):
    """One slot serves three requests in turn; each gets exactly the
    tokens it gets in a fresh scheduler: the previous occupant's latent
    rows, left in the pages it freed, stay masked."""
    _, _, cfg, model, prompts = ref
    one = dict(SCHED, slots=1)
    together = ContinuousScheduler(cfg, model, **one).generate(prompts[:3],
                                                                NEW)
    for p, got in zip(prompts[:3], together):
        alone = ContinuousScheduler(cfg, model, **one).generate([p], NEW)[0]
        np.testing.assert_array_equal(got, alone)


def test_launcher_serves_deepseek_on_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--requests", "3", "--prompt-len",
                       "40", "--new-tokens", "5", "--report"])
    assert [len(o) for o in outs] == [5, 5, 5]
    out = capsys.readouterr().out
    assert "pool bytes" in out and "report: decode_kernel=plain" in out
