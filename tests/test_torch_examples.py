"""The port's three example entry points (``launch/quickstart.py``,
``launch/serve_batched.py``, ``launch/long_context_decode.py``, ports of
``examples/``) run on the CPU through ``main(argv)``: the quickstart's
losses are finite and falling and it generates; serve_batched's
requests equal their solo generation (its own check) and its lockstep
run serves; long_context_decode prefills chunk by chunk through the
scan (one call a recurrent layer a chunk) and prints the reference
example's state / cache bytes and its deepseek-coder-33b contrast line,
computed by the reference example's own code on the same arguments."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get
from repro.configs import smoke_config as jax_smoke
from repro.core import perf_model as jax_perf
from repro.models import init_cache as jax_init_cache
from repro_torch.configs import smoke_config
from repro_torch.launch import long_context_decode, quickstart, serve_batched
from repro_torch.models import ssm

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2"])
def test_quickstart_trains_and_generates(arch, capsys):
    out = quickstart.main(["--device", "cpu", "--arch", arch, "--steps",
                           "4"])
    losses = out["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    text = capsys.readouterr().out
    assert "trainer: strategy=flat world=1" in text
    if arch == "seamless-m4t-large-v2":        # no token-serving forward
        assert out["generated"] is None
    else:
        cfg = smoke_config(arch)
        gen = out["generated"]
        assert gen.shape == (2, 8)
        assert gen.min() >= 0 and gen.max() < cfg.vocab_size
        assert "generated token ids:" in text


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "jamba-v0.1-52b"])
def test_serve_batched_equals_solo_generation(arch, capsys):
    outs = serve_batched.main(["--device", "cpu", "--arch", arch,
                               "--requests", "4", "--new-tokens", "6"])
    assert [len(o) for o in outs] == [6] * 4
    text = capsys.readouterr().out
    assert "equal its solo generation (4 requests)" in text
    assert "static-slab equivalent" in text
    rows = serve_batched.main(["--device", "cpu", "--arch", arch,
                               "--legacy", "--new-tokens", "6"])
    assert [len(r) for r in rows] == [6, 6]


def _reference_bytes(arch, context, new_tokens):
    """The reference example's printed byte counts, from its own code
    (``examples/long_context_decode.py``'s ``state_bytes`` of the
    reference's ``init_cache``, and its contrast line's
    ``perf_model`` counts), without running its model."""
    spec = importlib.util.spec_from_file_location(
        "reference_long_context_decode",
        ROOT / "examples" / "long_context_decode.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = jax_smoke(arch).with_overrides(dtype="float32")
    state = example.state_bytes(jax_init_cache(cfg, 1, context + new_tokens,
                                               jnp.float32))
    tok_bytes = jax_perf.kv_bytes_per_token(jax_get("deepseek-coder-33b"))
    slab = context * tok_bytes
    paged = jax_perf.paged_pool_bytes(
        [context * (i + 1) // 8 for i in range(8)], 16, tok_bytes)
    return state, (f"{slab / 1e6:.1f} MB/sequence slab", f"{8 * slab / 1e6:.1f}"
                   f" MB slab -> {paged / 1e6:.1f} MB paged pool")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_long_context_decode_matches_reference_bytes(arch, capsys,
                                                     monkeypatch):
    args = ["--arch", arch, "--context", "96", "--chunk", "32",
            "--new-tokens", "3"]
    scans = []
    for name in ("wkv6", "mamba_scan"):
        monkeypatch.setattr(ssm, name, lambda *a, _f=getattr(ssm, name),
                            **k: scans.append(a[0].shape[1]) or _f(*a, **k))
    got = long_context_decode.main(args + ["--device", "cpu"])
    text = capsys.readouterr().out
    state, contrast = _reference_bytes(arch, 96, 3)
    assert got["state_bytes"] == state
    assert f"recurrent-state+cache bytes: {state / 1e6:.1f} MB" in text
    assert all(part in text for part in contrast)
    cfg = smoke_config(arch)
    recurrent = sum(m != "attn" for m, _ in cfg.layer_pattern())
    assert scans == [32] * (3 * recurrent)        # 3 chunks, then steps
    assert len(got["generated"]) == 3
