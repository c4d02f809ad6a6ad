"""The port's ``decode_kernel`` switch against the reference's: greedy
tokens and counters of ``ContinuousScheduler`` at ``decode_kernel``
"plain" and "auto" on the CPU bitwise-equal to the reference's at
"xla", for GQA (qwen3-1.7b) and MLA (deepseek-v3-671b) smoke configs in
fp32; which paged attention each value runs ("plain" never calls the
kernel's wrapper, "cuda" refuses a CPU pool, no value gives way to
another); and ``launch.serve --decode-kernel``, whose report names the
attention that ran."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import init_model as jax_init
from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.bridge import params_from_jax
from repro_torch.configs import smoke_config
from repro_torch.models import attention
from repro_torch.serve import ContinuousScheduler

torch.set_num_threads(2)

COUNTERS = ("prefill_dispatches", "prefill_host_syncs", "decode_dispatches",
            "decode_host_syncs", "tokens_out")
# staggered: more requests than slots, chunked prompts with ragged tails
LENGTHS = [5, 40, 19, 33]
SCHED = dict(slots=2, max_len=128, page_size=8, prefill_chunk=32,
             decode_chunk=4)
NEW = 8
ARCHS = {"gqa": "qwen3-1.7b", "mla": "deepseek-v3-671b"}
# the wrappers each decode_kernel reaches on a CPU pool, by attention
KERNELS = {"gqa": ("paged_flash_decode", "paged_flash_decode_ref"),
           "mla": ("paged_flash_decode_mla", "paged_flash_decode_mla_ref")}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def ref(request):
    arch = ARCHS[request.param]
    jcfg = jax_smoke(arch).with_overrides(dtype="float32",
                                          decode_kernel="xla")
    params = jax_init(jcfg, jax.random.PRNGKey(4))
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    js = JaxScheduler(jcfg, params, **SCHED)
    jo = js.generate(prompts, NEW)
    return request.param, cfg, model, prompts, jo, js.stats()


def _spy(monkeypatch, kind):
    """Count the calls of each paged wrapper ``attention`` reaches."""
    calls = dict.fromkeys(KERNELS[kind], 0)
    for name in calls:
        def spy(*a, _f=getattr(attention, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(attention, name, spy)
    return calls


@pytest.mark.parametrize("kernel", ["plain", "auto"])
def test_greedy_tokens_bitwise_equal_reference_xla(ref, kernel, monkeypatch):
    kind, cfg, model, prompts, jo, jst = ref
    calls = _spy(monkeypatch, kind)
    ts = ContinuousScheduler(cfg.with_overrides(decode_kernel=kernel),
                             model, **SCHED)
    to, tst = ts.generate(prompts, NEW), ts.stats()
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)
    for c in COUNTERS:
        assert jst[c] == tst[c], c
    # both run the plain version on a CPU pool, once a layer a model
    # call, and never enter the kernel's wrapper
    wrapper, plain = KERNELS[kind]
    layers = sum(m == "attn" for m, _ in cfg.layer_pattern())
    model_calls = (tst["prefill_dispatches"]
                   + SCHED["decode_chunk"] * tst["decode_dispatches"])
    assert calls == {wrapper: 0, plain: layers * model_calls}


def test_cuda_refuses_a_cpu_pool(ref):
    _, cfg, model, prompts, _, _ = ref
    ts = ContinuousScheduler(cfg.with_overrides(decode_kernel="cuda"), model,
                             **SCHED)
    with pytest.raises(ValueError, match="needs a CUDA pool"):
        ts.generate(prompts[:1], 2)


def test_decode_kernel_for_follows_the_device_only_under_auto():
    cfg = smoke_config("qwen3-1.7b")
    assert cfg.decode_kernel == "auto"
    pick = attention.decode_kernel_for
    assert pick(cfg, "cpu") == "plain"
    assert pick(cfg, "cuda") == "cuda"
    assert pick(cfg, torch.device("meta")) == "cuda"
    plain = cfg.with_overrides(decode_kernel="plain")
    assert pick(plain, "cpu") == pick(plain, "cuda") == "plain"
    cuda = cfg.with_overrides(decode_kernel="cuda")
    assert pick(cuda, "cuda") == "cuda"
    with pytest.raises(ValueError, match="needs a CUDA pool"):
        pick(cuda, "cpu")


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_launcher_reports_the_decode_kernel(arch, capsys):
    from repro_torch.launch import serve
    base = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--requests", "3", "--prompt-len", "20", "--new-tokens", "4",
            "--report"]
    outs = {}
    for kernel in ("plain", "auto"):
        outs[kernel] = serve.main(base + ["--decode-kernel", kernel])
        assert "report: decode_kernel=plain" in capsys.readouterr().out
    assert outs["plain"] == outs["auto"]
    with pytest.raises(SystemExit, match="needs a CUDA pool"):
        serve.main(base + ["--decode-kernel", "cuda"])
    with pytest.raises(SystemExit):
        serve.main(base + ["--decode-kernel", "pallas"])


def test_launcher_dtype_and_layers_cut_the_config(capsys):
    """--dtype and --layers (phase 31's full-width fp32 run at a cut
    depth): the smoke config at one layer in bf16 serves, a depth past
    the stack's is refused."""
    from repro_torch.launch import serve
    base = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--requests", "2", "--prompt-len", "12",
            "--new-tokens", "3"]
    outs = serve.main(base + ["--layers", "1", "--dtype", "bfloat16"])
    assert [len(o) for o in outs] == [3, 3]
    with pytest.raises(SystemExit, match="has 2 layers"):
        serve.main(base + ["--layers", "3"])
    with pytest.raises(SystemExit, match="has 2 layers"):
        serve.main(base + ["--layers", "0"])
