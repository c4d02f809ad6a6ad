"""The dry run (``repro_torch.launch.dryrun``), its input specs
(``repro_torch.data.specs``), its cost counts (``repro_torch.roofline.
cost``) and the roofline (``repro_torch.roofline.analysis``) against
the reference's ``repro.launch.dryrun``, ``repro.data.specs`` and
``repro.roofline``.

In this process:
  * twins of ``tests/test_roofline.py``: the cost counter is exact on a
    loop of 10 products, a nested 3 x 5 and through autograd (21), and
    ``model_flops`` of train is 3x prefill's per token;
  * ``model_flops`` and ``input_specs`` equal the reference's on all 39
    pairs (the cache leaves mapped by the reference's tree paths);
  * ``roofline_terms``, ``analyse_pair``, ``suggestion`` and
    ``render_markdown`` equal the reference's on synthetic records, with
    and without an overlap report, under an ``HW`` of the reference's
    v5e fields;
  * each kernel's meta formula equals ``FlopCounterMode``'s count (and
    the counter's dot bytes) of its plain version on CPU tensors, and
    the counter's FLOPs equal ``FlopCounterMode``'s on a train step;
  * ``flops_global`` of every smoke config at a small train, prefill and
    decode shape equals the reference's StableHLO walk of the same step
    (lowered from its public pieces, one device), exactly, plus these
    named terms, each computed here from the port's own calls:
      - ``flash_bwd_value_product``: the plain flash backward recomputes
        the forward's probabilities-times-values product (2 B h S T hdv a
        call), which the reference's checkpointed q-chunk drops as dead;
      - ``mamba_bwd_readouts``: the plain Mamba backward reads the state
        out three more times than the reference's differentiated scan
        (3 x 2 Bb T dI dS a call, T padded to its chunks);
      - ``prefix_remat``: the port rematerialises every layer, the
        reference only its scanned block layers, not an unrolled dense
        prefix (DeepSeek's): the port's recompute of those layers;
      - ``wkv_einsum_path``: the reference's three-operand einsums of
        the WKV chunk contract through an outer product of r and k (2 B
        H K C^2 a chunk) and of u and k (2 B C H K a chunk), which
        torch's path folds into elementwise products (RWKV-6 prefill);
    RWKV-6's train step, whose backward einsums take other paths in the
    two libraries, is held within 1 %.

In one subprocess on PyTorch's fake process group (worlds 2, 4, 256):
the collective counter on a 5-trip loop of a tuple all-to-all, an
all-gather and an all-reduce (the reference's numbers); qwen3's rank-0
FLOPs on a (2, 2) mesh x 4 == its one-device FLOPs within 1 %; the
sequence split's mutation check (the split put back to replication: a
rank's FLOPs rise by at least the data factor); full qwen3-1.7b's
``argument_size_in_bytes`` on the 256-rank mesh == its masters' and
AdamW moments' blocks (``tests/test_torch_sharding.py``'s count) plus
the global batch every rank is passed and the model's RoPE
frequencies; and the CLI on ``qwen3-1.7b|decode_32k --mesh single``
writes one ``ok`` record with the record's keys, whose one-device
counts ``launch.recost`` recounts the same."""
import functools
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import LONG_500K_SKIPS
from repro.configs import config_for_shape as jax_config_for_shape
from repro.configs import smoke_config as jax_smoke
from repro.configs.base import InputShape as JaxShape
from repro.core.train_state import TrainState as JaxTrainState
from repro.data.specs import batch_struct as jax_batch_struct
from repro.data.specs import input_specs as jax_input_specs
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro import optim as jax_optim
from repro.roofline import analysis as jax_analysis
from repro.roofline.hlocost import stablehlo_cost
from repro.serve.engine import make_decode_step as jax_decode_step
from repro.serve.engine import make_prefill_step as jax_prefill_step
from repro.sharding.rules import _path_str
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_train_step
from repro.train.step import replicated_layout
from repro_torch.configs import (ARCHITECTURES, INPUT_SHAPES, InputShape,
                                 config_for_shape, smoke_config)
from repro_torch.data.specs import input_specs
from repro_torch.launch import dryrun
from repro_torch.models.model import layer_path
from repro_torch.roofline import analysis
from repro_torch.roofline.cost import count, step_cost
from repro_torch.train import TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FA, WKV, MAMBA = (importlib.import_module(f"repro_torch.kernels.{m}")
                  for m in ("flash_attention", "wkv6", "mamba_scan"))
PAIRS = [(a, s) for a in sorted(ARCHITECTURES) for s in INPUT_SHAPES
         if not (s == "long_500k" and a in LONG_500K_SKIPS)]
SMALL = {"train": InputShape("train_s", 64, 8, "train"),
         "prefill": InputShape("prefill_s", 64, 4, "prefill"),
         "decode": InputShape("decode_s", 64, 4, "decode")}
MICRO = 2


# --------------------------------------------------------------------------
# twins of tests/test_roofline.py
# --------------------------------------------------------------------------

def test_counter_exact_on_loop():
    def f(x, w):
        return [x @ w for _ in range(10)]
    c = step_cost(f, torch.zeros(64, 128), torch.zeros(128, 32))
    assert c["flops"] == 10 * 2 * 64 * 32 * 128
    assert c["unresolved_loops"] == 0


def test_counter_exact_on_nested_loop():
    def g(x, w):
        for _ in range(3):
            for _ in range(5):
                x = x @ w
        return x
    c = step_cost(g, torch.zeros(64, 128), torch.zeros(128, 128))
    assert c["flops"] == 15 * 2 * 64 * 128 * 128


def test_counter_exact_through_grad():
    def h(w, x):
        c = x
        for _ in range(7):
            c = torch.tanh(c @ w)
        c.sum().backward()
    w = torch.zeros(128, 128, requires_grad=True)
    x = torch.zeros(64, 128, requires_grad=True)
    c = step_cost(h, w, x)
    # forward 7 products; backward 2 a step (dx and dw)
    assert c["flops"] == 21 * 2 * 64 * 128 * 128


def test_model_flops_consistency():
    t = analysis.model_flops("qwen3-1.7b", "train_4k")
    p = analysis.model_flops("qwen3-1.7b", "prefill_32k")
    assert abs(t / (256 * 4096) / (p / (32 * 32768)) - 3.0) < 1e-6


# --------------------------------------------------------------------------
# the reference's numbers on all 39 pairs
# --------------------------------------------------------------------------

def test_model_flops_match_reference_on_every_pair():
    assert len(PAIRS) == 39
    for arch, shape in PAIRS:
        assert analysis.model_flops(arch, shape) == \
            jax_analysis.model_flops(arch, shape), (arch, shape)


_DTYPES = {torch.int32: "int32", torch.bfloat16: "bfloat16",
           torch.float32: "float32"}


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_input_specs_match_reference(arch):
    """Keys, shapes and dtypes of every input the pair's step takes;
    each port cache leaf (layer i, name) is the reference's leaf at
    ``layer_path`` (a scanned block's leaf stacks its repetitions)."""
    for name in INPUT_SHAPES:
        if name == "long_500k" and arch in LONG_500K_SKIPS:
            continue
        cfg = config_for_shape(arch, name)
        jcfg = jax_config_for_shape(arch, name)
        got = input_specs(cfg, INPUT_SHAPES[name])
        want = jax_input_specs(jcfg, JAX_SHAPES[name])
        assert sorted(got) == sorted(want), (name, sorted(got))
        for key, w in want.items():
            if key == "cache":
                continue
            assert tuple(got[key].shape) == tuple(w.shape), (name, key)
            assert _DTYPES[got[key].dtype] == str(w.dtype), (name, key)
            assert got[key].device.type == "meta"
        if "cache" not in want:
            continue
        ref = {_path_str(p): leaf for p, leaf in
               jax.tree_util.tree_leaves_with_path(want["cache"])}
        covered = {}
        for i, layer in enumerate(got["cache"]):
            base = layer_path("decoder", cfg, i).split("/", 1)[1]
            flat = ({f"{k}/{n}": t for k, sub in layer.items()
                     for n, t in sub.items()} if "cross" in layer
                    else layer)
            for leaf_name, t in flat.items():
                path = f"{base}/{leaf_name}"
                w = ref[path]
                stacked = path.startswith("blocks/")
                assert tuple(w.shape[1:] if stacked else w.shape) == \
                    tuple(t.shape), (name, path)
                assert _DTYPES[t.dtype] == str(w.dtype), (name, path)
                covered[path] = covered.get(path, 0) + 1
        for path, w in ref.items():
            n = w.shape[0] if path.startswith("blocks/") else 1
            assert covered.get(path) == n, (name, path, covered.get(path))


# --------------------------------------------------------------------------
# the roofline on synthetic records
# --------------------------------------------------------------------------

def _records():
    base = {"ok": True, "flops": 3.2e13, "bytes_accessed": 1.1e12,
            "flops_global": 7.3e18, "dot_bytes_global": 2.9e14,
            "collective_bytes": {"all-gather": 4.0e10,
                                 "all-reduce": 2.5e9}}
    small = {"ok": True, "flops": 4.0e12, "bytes_accessed": 9.0e12,
             "collective_bytes": {"all-to-all": 1.0e8}}
    ovl = dict(base, async_overlap={"report_bytes": 4.25e10,
                                    "overlappable_bytes": 3.0e10})
    comm_bound = dict(small, collective_bytes={"all-gather": 9.0e13})
    return [("qwen3-1.7b", "train_4k", base), ("rwkv6-1.6b", "decode_32k",
            small), ("deepseek-v3-671b", "train_4k", ovl),
            ("granite-20b", "prefill_32k", comm_bound),
            ("jamba-v0.1-52b", "long_500k", dict(base, flops_global=1.0e9))]


def test_roofline_matches_reference_under_v5e_fields():
    v5e = jax_analysis.V5E
    hw = analysis.HW(peak_flops=v5e.peak_flops, hbm_bw=v5e.hbm_bw,
                     ici_bw=v5e.ici_bw, chips=v5e.chips)
    rows, jrows = [], []
    for arch, shape, rec in _records():
        assert analysis.roofline_terms(rec, hw) == \
            jax_analysis.roofline_terms(rec, v5e)
        row = analysis.analyse_pair(arch, shape, rec, hw)
        jrow = jax_analysis.analyse_pair(arch, shape, rec, v5e)
        assert row == jrow
        assert analysis.suggestion(row) == jax_analysis.suggestion(jrow)
        rows.append(row)
        jrows.append(jrow)
    assert analysis.render_markdown(rows) == \
        jax_analysis.render_markdown(jrows)
    assert {r["dominant"] for r in rows} == {"compute", "memory",
                                             "collective"}


def test_h100_fields():
    hw = analysis.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989e12, 3.35e12, 450e9)
    assert hw.hbm_bytes == 85017493504      # what the card reports


def test_fits_holds_a_peak_to_the_cards_bytes():
    """A peak between the card's 85017493504 B and 80 GiB (85899345920 B)
    does not fit; the card's own bytes do."""
    hw = analysis.H100_SXM
    between = (hw.hbm_bytes + 80 * 2 ** 30) // 2
    assert hw.hbm_bytes < between < 80 * 2 ** 30
    assert analysis.fits(hw.hbm_bytes)
    assert not analysis.fits(between) and not analysis.fits(80 * 2 ** 30)


# --------------------------------------------------------------------------
# the kernels' meta formulas
# --------------------------------------------------------------------------

def _both(fn, *args):
    """(FLOPs, dot bytes) of ``fn(*args)``: FlopCounterMode's FLOPs, the
    counter's bytes, and the counter's FLOPs held to FlopCounterMode's."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    c = count(fn, *args, track_memory=False)[1]
    assert c["flops"] == fc.get_total_flops()
    return fc.get_total_flops(), c["dot_bytes"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_meta_formulas_count_the_plain_versions(dtype):
    g = torch.Generator().manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g)        # noqa: E731
    for B, S, T, h, hk, hd, hdv in ((1, 5, 9, 4, 2, 16, 8),
                                    (2, 7, 7, 2, 2, 8, 8)):
        q, k, v = (rand(*s).to(dtype) for s in
                   ((B, S, h, hd), (B, T, hk, hd), (B, T, hk, hdv)))
        assert _both(FA.flash_attention_ref, q, k, v) == FA.meta_cost(
            B, S, T, h, hd, hdv, v.element_size())
    for B, T, H, K in ((1, 5, 2, 16), (2, 40, 3, 32), (2, 33, 2, 16)):
        r = rand(B, T, H, K).to(dtype)
        assert _both(WKV.wkv6_chunked, r, r, r, -rand(B, T, H, K).abs(),
                     rand(H, K), rand(B, H, K, K)) == WKV.meta_cost(B, T, H, K)
    for Bb, T, dI, dS in ((1, 5, 8, 4), (2, 40, 16, 8)):
        x = rand(Bb, T, dI).to(dtype)
        assert _both(MAMBA.mamba_ref, x, x.abs(), -rand(dI, dS).abs(),
                     rand(Bb, T, dS).to(dtype), rand(Bb, T, dS).to(dtype),
                     rand(dI), torch.zeros(Bb, dI, dS)) == MAMBA.meta_cost(
                         Bb, T, dI, dS)


def test_counter_flops_are_flop_counter_modes_on_a_train_step():
    """The counter applies FlopCounterMode's formulas in its own
    dispatch: on a whole train step (CPU tensors, the plain versions)
    the two counts are equal."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data import make_batch
    from repro_torch.train import init_train_state, make_train_step
    cfg = smoke_config("deepseek-v3-671b").with_overrides(dtype="float32")
    tc = TrainConfig(optimizer="adamw", microbatches=2)
    step, _ = make_train_step(cfg, tc)
    batch = make_batch(cfg, np.random.default_rng(0), 4, 32)
    with FlopCounterMode(display=False) as fc:
        step(init_train_state(cfg, tc, device="cpu"), batch)
    got = count(step, init_train_state(cfg, tc, device="cpu"), batch)[1]
    assert got["flops"] == fc.get_total_flops() > 0


def test_meta_launch_charges_the_formula_and_saves_the_card_inputs():
    q = torch.empty(1, 64, 4, 64, device="meta", requires_grad=True)
    k = torch.empty(1, 64, 2, 64, device="meta", requires_grad=True)

    def f(q, k):
        out = FA.flash_attention(q, k, k)
        out.sum().backward()
        return out
    out, c = count(f, q, k)
    fwd = FA.meta_cost(1, 64, 64, 4, 64, 64, 4)[0]
    # forward by formula; the plain backward recomputes both products
    # and runs four more
    assert c["flops"] == 4 * fwd
    assert out.shape == (1, 64, 4, 64) and out.device.type == "meta"


# --------------------------------------------------------------------------
# flops_global against the reference's walker
# --------------------------------------------------------------------------

def _reference_flops(arch, shape):
    cfg = jax_smoke(arch)
    jshape = JaxShape(shape.name, shape.seq_len, shape.global_batch,
                      shape.mode)
    sd = jax.ShapeDtypeStruct
    pshape = jax.eval_shape(functools.partial(jax_init_model, cfg),
                            jax.random.PRNGKey(0))
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        tc = JaxTrainConfig(optimizer="adamw", microbatches=MICRO)
        params = jax.tree_util.tree_map(lambda l: sd(l.shape, jnp.float32),
                                        pshape)
        opt = jax_optim.get_optimizer(tc.optimizer, tc.lr)
        state = JaxTrainState(params, jax.eval_shape(opt.init, params),
                              sd((), jnp.int32), replicated_layout(params))
        step, _ = jax_train_step(cfg, None, tc)
        low = jax.jit(step).lower(state, jax_batch_struct(cfg, jshape))
    else:
        params = jax.tree_util.tree_map(lambda l: sd(l.shape, jnp.bfloat16),
                                        pshape)
        cache = jax.eval_shape(lambda: jax_init_cache(
            cfg, B, S, jnp.bfloat16, cross_len=S))
        if shape.mode == "prefill":
            low = jax.jit(jax_prefill_step(cfg)).lower(
                params, jax_batch_struct(cfg, jshape), cache)
        else:
            low = jax.jit(jax_decode_step(cfg)).lower(
                params, sd((B, 1), jnp.int32), cache, sd((), jnp.int32))
    c = stablehlo_cost(low.as_text())
    assert c["unresolved_loops"] == 0
    return c["flops"]


def _port_flops(cfg, shape, monkeypatch):
    """(the port's one-device FLOPs of the pair's step, its named terms:
    module docstring)."""
    terms = dict.fromkeys(("flash_bwd_value_product", "mamba_bwd_readouts",
                           "prefix_remat", "wkv_einsum_path"), 0)
    fa_bwd, m_bwd, wkv_cost = (FA.flash_attention_bwd_ref,
                               MAMBA.mamba_chunked_bwd, WKV.meta_cost)

    def flash_bwd(q, k, v, dout, **kw):
        B, S, h, _ = q.shape
        terms["flash_bwd_value_product"] += \
            2 * B * h * S * k.shape[1] * v.shape[3]
        return fa_bwd(q, k, v, dout, **kw)

    def mamba_bwd(x, dt, A, B, C, D, state, dy, dstate, **kw):
        Bb, T, dI = x.shape
        c = min(MAMBA.CHUNK, T)
        terms["mamba_bwd_readouts"] += \
            3 * 2 * Bb * (-(-T // c) * c) * dI * A.shape[1]
        return m_bwd(x, dt, A, B, C, D, state, dy, dstate, **kw)

    def wkv_meta(B, T, H, K, chunk=WKV.CHUNK):
        C = min(chunk, T)
        terms["wkv_einsum_path"] += -(-T // C) * (
            2 * B * H * K * C * C + 2 * B * C * H * K)
        return wkv_cost(B, T, H, K, chunk=chunk)

    monkeypatch.setattr(FA, "flash_attention_bwd_ref", flash_bwd)
    monkeypatch.setattr(MAMBA, "mamba_chunked_bwd", mamba_bwd)
    monkeypatch.setattr(WKV, "meta_cost", wkv_meta)
    tc = TrainConfig(optimizer="adamw", microbatches=MICRO)
    fn, args = dryrun.build_step(cfg, tc, shape)
    flops = count(fn, *args, track_memory=False)[1]["flops"]
    if shape.mode == "train" and cfg.block_structure()[0]:
        # the same step with the prefix layers not rematerialised
        tfm = importlib.import_module("repro_torch.models.transformer")
        fn, args = dryrun.build_step(cfg, tc, shape)
        prefix = list(args[0].params.layers[:len(cfg.block_structure()[0])])
        remat = tfm.checkpoint
        monkeypatch.setattr(tfm, "checkpoint", lambda f, x, **kw: (
            f(x) if any(f.args[1] is p for p in prefix) else
            remat(f, x, **kw)))
        saved = dict(terms)
        plain = count(fn, *args, track_memory=False)[1]["flops"]
        terms = dict(saved, prefix_remat=flops - plain)
        monkeypatch.setattr(tfm, "checkpoint", remat)
    return flops, terms


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_flops_global_matches_reference_walker(arch, monkeypatch):
    cfg = smoke_config(arch)
    for mode, shape in SMALL.items():
        with monkeypatch.context() as mp:
            got, terms = _port_flops(cfg, shape, mp)
        want = _reference_flops(arch, shape)
        if arch == "rwkv6-1.6b" and mode == "train":
            assert abs(got / want - 1) <= 0.01, (mode, got, want)
            continue
        wkv = terms.pop("wkv_einsum_path")     # the reference's extra
        assert got == want + sum(terms.values()) - wkv, (mode, got, want,
                                                         terms, wkv)
        if mode == "train":
            assert terms["flash_bwd_value_product"] > 0


# --------------------------------------------------------------------------
# on the fake process group: one subprocess
# --------------------------------------------------------------------------

FAKE = r"""
import json, sys, math
import torch, torch.distributed as dist
from repro_torch.configs import InputShape, get_config, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.roofline.cost import collective_bytes, count
from repro_torch.train import TrainConfig, trainable
from repro_torch.train import step as step_mod
OUT = sys.argv[1]
res = {}

# the collective counter: a 5-trip loop
dryrun.fake_world(2)
def loop():
    for _ in range(5):
        outs = [torch.empty(4) for _ in range(2)]
        dist.all_to_all(outs, [torch.ones(4), torch.ones(4)])
        big = torch.empty(2, 8, 16, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(big, torch.ones(1, 8, 16,
                                                    dtype=torch.bfloat16))
        dist.all_reduce(torch.ones(8))
res["collectives"] = collective_bytes(loop)

# qwen3 on a (2, 2) mesh: rank 0's FLOPs x 4 against one device; and the
# sequence split put back to replication
dryrun.fake_world(4)
mesh = make_serve_mesh(2, 2, device_type="cpu")
cfg = smoke_config("qwen3-1.7b")
tc = TrainConfig(optimizer="adamw", microbatches=2)
shape = InputShape("train_s", 64, 8, "train")
rec = dryrun.analyse(cfg, tc, shape, mesh)
res["mesh"] = [rec["flops"], rec["flops_global"]]
one_row = TrainConfig(optimizer="adamw", microbatches=8)
def rank_flops():
    fn, args = dryrun.build_step(cfg, one_row, shape, mesh)
    return count(fn, *args, track_memory=False)[1]["flops"]
split = rank_flops()
step_mod._splits = lambda *a: None
res["mutation"] = [split, rank_flops()]

# full qwen3-1.7b's arguments on the 256-rank mesh
mesh = dryrun.make_mesh("single")
cfg, tc = dryrun.pair_config("qwen3-1.7b", "train_4k")
fn, args = dryrun.build_step(cfg, tc, dryrun.INPUT_SHAPES["train_4k"], mesh)
state, batch = args
blocks = 0
for name, p in trainable(state.params).items():
    for t in (p, state.opt_state["m"][name], state.opt_state["v"][name]):
        blocks += t.to_local().numel() * 4
from repro_torch.roofline import cost
held = {}
for t in cost._tensors(list(args)):
    for st in cost._storages(t):
        held[id(st)] = st.nbytes()
res["arguments"] = [sum(held.values()), blocks,
                    sum(v.numel() * v.element_size() for v in batch.values()),
                    sum(b.numel() * b.element_size()
                        for b in state.params.buffers())]
del fn, args, state

# the CLI
dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--mesh",
             "single", "--out", OUT])
# and recost's recount of its one-device FLOPs, into a copy
from repro_torch.launch.recost import recost
rec = json.load(open(OUT))["qwen3-1.7b|decode_32k"]
with open(OUT + ".recost", "w") as f:
    json.dump({"qwen3-1.7b|decode_32k": dict(rec, flops_global=0.0)}, f)
again = recost(OUT + ".recost", force=True)["qwen3-1.7b|decode_32k"]
res["recost"] = [again["flops_global"], rec["flops_global"],
                 again["dot_bytes_global"], rec["dot_bytes_global"]]
print(json.dumps(res))
"""

RECORD_KEYS = {"ok", "params", "params_active", "run_config", "flops",
               "bytes_accessed", "flops_global", "dot_bytes_global",
               "unresolved_loops", "collective_bytes",
               "argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "peak_bytes", "fits", "count_s"}


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "dryrun_single.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", FAKE, str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return (json.loads(proc.stdout.strip().splitlines()[-1]),
            json.loads(out.read_text()))


def test_collective_counter_on_fake_group(fake):
    got = fake[0]["collectives"]
    assert got["all-to-all"] == 5 * (4 + 4) * 4
    assert got["all-reduce"] == 5 * 8 * 4
    assert got["all-gather"] == 5 * 2 * 8 * 16 * 2


def test_mesh_flops_are_partitioned(fake):
    rank0, whole = fake[0]["mesh"]
    assert abs(4 * rank0 / whole - 1) <= 0.01, (rank0, whole)


def test_sequence_split_cuts_a_rank_flops(fake):
    """One-row microbatches on (2, 2): each rank takes half of every
    row's sequence; replicated, it would take all of it -- at least the
    data factor (2) more (its queries see twice the keys)."""
    split, replicated = fake[0]["mutation"]
    assert replicated >= 2 * split, (split, replicated)


def test_argument_size_is_the_placed_blocks(fake):
    args, blocks, batch, buffers = fake[0]["arguments"]
    assert args == blocks + batch + buffers, (args, blocks, batch, buffers)
    assert buffers < 1024          # the RoPE frequencies


def test_cli_writes_the_record(fake):
    records = fake[1]
    assert list(records) == ["qwen3-1.7b|decode_32k"]
    rec = records["qwen3-1.7b|decode_32k"]
    assert rec["ok"] and RECORD_KEYS <= set(rec), sorted(rec)
    assert rec["fits"] and rec["unresolved_loops"] == 0
    assert 0 < rec["flops"] < rec["flops_global"]
    assert rec["temp_size_in_bytes"] >= 0
    assert rec["argument_size_in_bytes"] > 0


def test_recost_recounts_the_one_device_flops(fake):
    flops, want, dot, want_dot = fake[0]["recost"]
    assert flops == want > 0 and dot == want_dot > 0
