"""Serving on a (data, model) mesh: twins of ``tests/test_serve_mesh.py``.

The reference runs its mesh engines in subprocesses with 8 emulated
host devices, as its own tests run them, on params drawn there from its
tests' keys and handed to the port as numpy arrays.  The port runs
the same engines over 8 gloo ranks on a (data 2, model 4) mesh (each
rank a fresh process from ``tests/torch_ranks.py``): its greedy tokens
must equal its one-device engine's bit for bit and the reference's;
every sample's logits lie within 1e-5 of the one-device engine's (the
row-parallel sums over "model" re-associate fp32 sums); and the pool is
distributed as ``rules.pool_spec`` places it -- qwen3's 2 kv heads do
not divide model 4, so its pool is cut on head_dim (the fallback the
reference's test picks on purpose), deepseek-moe-16b's 4 kv heads are
cut one a rank.  Every decoder-only architecture also serves on a
(2, 2) mesh of 4 ranks with the one-device engine's tokens.

The reference's two processes draw the params and prompts of their
cases and publish them; the port's rank launches start then and run
while the reference's engines do (one module fixture).
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import pytest

from repro.configs import smoke_config as jax_smoke
from repro.serve import PagedKVCache as JaxPagedKVCache
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import PagedKVCache
from torch_ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-1.7b", "deepseek-moe-16b")
LENS, NEW = (7, 12, 5, 9), 8
PREFIX_KW = dict(engine="continuous", batch_size=2, max_len=64, page_size=8,
                 prefill_chunk=8, decode_chunk=4, num_pages=40)
LAUNCH = ["--arch", "deepseek-moe-16b", "--reduced", "--batch", "2",
          "--prompt-len", "8", "--new-tokens", "6", "--engine", "continuous"]
LOGIT_TOL = 1e-5
DECODER_ONLY = ("qwen3-1.7b", "rwkv6-1.6b", "jamba-v0.1-52b",
                "deepseek-v3-671b", "granite-20b", "qwen2.5-32b",
                "deepseek-coder-33b", "deepseek-moe-16b")


REFERENCE = """
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import smoke_config
from repro.launch.mesh import make_serve_mesh
from repro.models import init_model
from repro.serve import make_engine

tmp, cases = sys.argv[1], sys.argv[2].split(",")


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def publish(case, params, prompts):
    # the port's ranks start once every case's inputs are on disk
    np.savez(f"{tmp}/{case}.npz", **flat(params))
    with open(f"{tmp}/{case}.prompts.json", "w") as f:
        json.dump(prompts, f)
    open(f"{tmp}/{case}.ready", "w").close()


cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
inputs = {}
for case in cases:
    if case == "legacy":
        params = init_model(cfg, jax.random.PRNGKey(0))
        prompts = np.tile(np.arange(4, 12, dtype=np.int32), (2, 1)).tolist()
    else:
        c = smoke_config(case).with_overrides(dtype="float32")
        params = init_model(c, jax.random.PRNGKey(3))
        shared = np.asarray(jax.random.randint(
            jax.random.PRNGKey(9), (16,), 0, c.vocab_size))
        rng = np.random.default_rng(3)
        pre = [np.concatenate([shared, rng.integers(0, c.vocab_size, 3 + i)
                               .astype(np.int32)]) for i in range(3)]
        pre.append(pre[0].copy())          # exact repeat: the COW fork
        prompts = {"plain": [np.asarray(jax.random.randint(
            jax.random.PRNGKey(10 + i), (L,), 0, c.vocab_size)).tolist()
            for i, L in enumerate(LENS)],
            "prefix": [p.tolist() for p in pre]}
    publish(case, params, prompts)
    inputs[case] = params, prompts

mesh = make_serve_mesh(2, 4)
for case, (params, prompts) in inputs.items():
    if case == "legacy":
        eng = make_engine(cfg, params, engine="legacy", batch_size=2,
                          max_len=64, dtype=jnp.float32, mesh=mesh)
        res = np.asarray(eng.generate(jnp.asarray(prompts, jnp.int32),
                                      8)).tolist()
    else:
        c = smoke_config(case).with_overrides(dtype="float32")
        eng = make_engine(c, params, engine="continuous", batch_size=2,
                          max_len=64, mesh=mesh)
        got = eng.generate([np.asarray(p, np.int32)
                            for p in prompts["plain"]], NEW)
        per = eng.kv.pool_bytes_by_device()
        eng2 = make_engine(c, params, prefix_cache=True, mesh=mesh,
                           **PREFIX_KW)
        got2 = eng2.generate([np.asarray(p, np.int32)
                              for p in prompts["prefix"]], 6)
        res = {"plain": [g.tolist() for g in got],
               "pool_bytes": eng.kv.pool_bytes(),
               "per_max": max(per.values()), "per_sum": sum(per.values()),
               "prefix": [g.tolist() for g in got2],
               "prefix_hit_rate": eng2.stats()["prefix_hit_rate"]}
    with open(f"{tmp}/{case}.ref.json", "w") as f:
        json.dump(res, f)
"""
# the reference's processes: each draws its cases' params and prompts,
# publishes them, then runs its mesh engines
REF_SPLIT = (("qwen3-1.7b", "legacy"), ("deepseek-moe-16b",))


# the port's ranks: the mesh engine on every case; rank 0 also runs the
# one-device engine and compares the logits
PORT = """
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.launch.serve import main
from repro_torch.serve import SamplingConfig, make_engine
from repro_torch.serve import scheduler as sched_lib
from repro_torch.sharding.comm import MeshComm
from repro_torch.sharding.ctx import gather_placed
from repro_torch.sharding.rules import pool_spec

tmp = {tmp!r}
prompts = {{case: json.load(open(f"{{tmp}}/{{case}}.prompts.json"))
           for case in {archs!r} + ("legacy",)}}
PREFIX_KW = {prefix_kw!r}
plain_fns = sched_lib.sample, sched_lib.masked_sample


def tree(name):
    out = {{}}
    for key, a in np.load(f"{{tmp}}/{{name}}.npz").items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {{}})
        node[leaf] = a
    return out


def serve(cfg, params, prompts, new, mesh=None, **kw):
    logits = []

    def keep(fn):
        def rec(lg, *a, **k):
            logits.append(lg.clone())
            return fn(lg, *a, **k)
        return rec
    sched_lib.sample, sched_lib.masked_sample = map(keep, plain_fns)
    try:
        eng = make_engine(cfg, params, device="cpu", mesh=mesh, **kw)
        outs = eng.generate([np.asarray(p, np.int32) for p in prompts], new)
    finally:
        sched_lib.sample, sched_lib.masked_sample = plain_fns
    return eng, [o.tolist() for o in outs], logits


def gap(a, b):
    if len(a) != len(b):
        return float("inf")
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def solo(cfg, params, prompts, new, **kw):
    # the one-device engine, its tokens and logits: rank 0 only
    if RANK:
        return None, None, []
    return serve(cfg, params, prompts, new, **kw)


def pool_gaps(eng, one):
    # each layer's pool gathered whole over "model" against the
    # one-device engine's (a collective; rank 0 compares): layer 0's
    # gap, which exact block writes make 0, and the largest
    whole = [gather_placed(layer, comm) for layer in eng.kv.cache]
    if RANK:
        return None, None
    gaps = [max(float((w[n] - layer[n]).abs().max()) for n in layer)
            for w, layer in zip(whole, one.kv.cache)]
    return gaps[0], max(gaps)


mesh = make_serve_mesh(2, 4)
comm = MeshComm(mesh)
res = {{}}
for arch in {archs!r}:
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    params = tree(arch)
    kw = dict(engine="continuous", batch_size=2, max_len=64)
    one_eng, one, one_lg = solo(cfg, params, prompts[arch]["plain"], {new},
                                **kw)
    eng, got, lg = serve(cfg, params, prompts[arch]["plain"], {new}, mesh,
                         **kw)
    gap0, gap_all = pool_gaps(eng, one_eng)
    _, psolo, psolo_lg = solo(cfg, params, prompts[arch]["prefix"], 6,
                              **PREFIX_KW)
    peng, pgot, plg = serve(cfg, params, prompts[arch]["prefix"], 6, mesh,
                            prefix_cache=True, **PREFIX_KW)
    res[arch] = {{
        "solo": one, "mesh": got, "gap": 0.0 if RANK else gap(lg, one_lg),
        "pool_gap0": gap0, "pool_gap": gap_all,
        "pool_bytes": eng.kv.pool_bytes(),
        "per": list(eng.kv.pool_bytes_by_device().values()),
        "per_device": eng.kv.pool_bytes_per_device(),
        "split": [layer.split for layer in eng.kv.cache
                  if hasattr(layer, "split")],
        "prefix_solo": psolo, "prefix_mesh": pgot,
        "prefix_gap": 0.0 if RANK else gap(plg, psolo_lg),
        "prefix_hit_rate": peng.stats()["prefix_hit_rate"],
        "prefix_per": list(peng.kv.pool_bytes_by_device().values()),
        "prefix_pool_bytes": peng.kv.pool_bytes()}}
cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
legacy = tree("legacy")
res["legacy_solo"] = None if RANK else make_engine(
    cfg, legacy, engine="legacy", batch_size=2, max_len=64,
    device="cpu").generate(prompts["legacy"], 8).tolist()
res["legacy_mesh"] = make_engine(
    cfg, legacy, engine="legacy", batch_size=2, max_len=64, device="cpu",
    mesh=mesh).generate(prompts["legacy"], 8).tolist()
# sampled at temperature 1: each data replica computes its row, and every
# row is drawn as on one device
hot = dict(engine="legacy", batch_size=2, max_len=64, device="cpu",
           sampling=SamplingConfig(temperature=1.0), seed=5)
res["legacy_hot_solo"] = None if RANK else make_engine(
    cfg, legacy, **hot).generate(prompts["legacy"], 8).tolist()
res["legacy_hot_mesh"] = make_engine(cfg, legacy, mesh=mesh, **hot).generate(
    prompts["legacy"], 8).tolist()
# pool_spec on the real mesh: heads, head_dim, the MLA latent, per-slot
res["specs"] = [
    pool_spec(smoke_config("deepseek-moe-16b"), mesh, "/blocks/k",
              (256, 4, 64), -1),
    pool_spec(smoke_config("qwen3-1.7b"), mesh, "/layers/0/k", (256, 2, 64),
              -1),
    pool_spec(smoke_config("deepseek-v3-671b"), mesh, "/layers/0/ckv",
              (256, 32), -1),
    pool_spec(smoke_config("qwen3-1.7b"), mesh, "/layers/1/ssm", (4, 8, 16),
              0)]
launch = {launch!r} + ["--device", "cpu"]
res["launcher_host"] = None if RANK else main(launch)
res["launcher_mesh"] = main(launch + ["--mesh-shape", "2x4", "--backend",
                                      "gloo"])
print(json.dumps(res))
"""


# every decoder-only architecture on (2, 2), its own weights from a seed
EIGHT = """
from repro_torch.configs import smoke_config
from repro_torch.bridge import mesh_placer
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import init_model
from repro_torch.serve import make_engine

mesh = make_serve_mesh(2, 2)
rng = np.random.default_rng(0)
res = {{}}


def placed(cfg):
    # the one-device draw from seed 3, each leaf cut to this rank's
    # block as it is drawn
    return init_model(cfg, seed=3, device="cpu",
                      place=mesh_placer(cfg, mesh, mode="serve"))


for arch in {archs!r}:
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 12, 5, 9)]
    kw = dict(batch_size=2, max_len=64, device="cpu")
    solo = [] if RANK else make_engine(
        cfg, init_model(cfg, seed=3, device="cpu"), **kw).generate(prompts, 8)
    eng = make_engine(cfg, placed(cfg), mesh=mesh, **kw)
    got = eng.generate(prompts, 8)
    res[arch] = {{"solo": [o.tolist() for o in solo],
                 "mesh": [o.tolist() for o in got],
                 "per": list(eng.kv.pool_bytes_by_device().values()),
                 "pool_bytes": eng.kv.pool_bytes()}}
# spec decode with DeepSeek-V3's MTP head (gathered at use on the mesh)
cfg = smoke_config("deepseek-v3-671b").with_overrides(dtype="float32")
kw = dict(batch_size=2, max_len=96, device="cpu", spec_decode=3)
spec = [] if RANK else make_engine(
    cfg, init_model(cfg, seed=3, device="cpu"), **kw).generate(prompts, 8)
eng = make_engine(cfg, placed(cfg), mesh=mesh, **kw)
res["spec"] = {{"solo": [o.tolist() for o in spec],
               "mesh": [o.tolist() for o in eng.generate(prompts, 8)],
               "verify_steps": eng.stats()["spec_decode"]["verify_steps"]}}
# a whole model is refused on a mesh, by both engines, and left whole
whole = init_model(cfg, seed=3, device="cpu")
res["refused"] = []
for engine in ("continuous", "legacy"):
    try:
        make_engine(cfg, whole, engine=engine, batch_size=2, max_len=96,
                    device="cpu", mesh=mesh)
    except ValueError as e:
        res["refused"].append("serve-mode rules" in str(e))
res["whole_kept"] = not any(hasattr(p, "device_mesh")
                            for p in whole.parameters())
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's results by case, "port": 8 ranks' results
    on (2, 4), "eight": 4 ranks' on (2, 2)}; the reference's processes
    run while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(REFERENCE).replace("LENS", repr(LENS)).replace(
        "NEW", str(NEW)).replace("PREFIX_KW", repr(PREFIX_KW))
    refs = [subprocess.Popen([sys.executable, "-c", code, str(tmp),
                              ",".join(cases)], env=env, cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for cases in REF_SPLIT]
    try:
        deadline = time.monotonic() + 300
        while not all((tmp / f"{c}.ready").exists()
                      for cases in REF_SPLIT for c in cases):
            bad = [p for p in refs if p.poll() not in (None, 0)]
            assert not bad and time.monotonic() < deadline, \
                bad[0].communicate()[1][-3000:] if bad else "timeout"
            time.sleep(0.2)
        eight = run_ranks(EIGHT.format(archs=DECODER_ONLY), 4, tmp,
                          timeout=300)
        port = run_ranks(PORT.format(
            tmp=str(tmp), prefix_kw=PREFIX_KW, archs=ARCHS, new=NEW,
            launch=LAUNCH), 8, tmp, timeout=300)
        for p in refs:
            _, err = p.communicate(timeout=400)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in refs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ref = {}
    for cases in REF_SPLIT:
        for c in cases:
            with open(tmp / f"{c}.ref.json") as f:
                ref[c] = json.load(f)
    return {"ref": ref, "port": port, "eight": eight}


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_continuous_bitwise_and_pool_distributed(runs, arch):
    ref = runs["ref"][arch]
    assert runs["port"][0][arch]["solo"] == ref["plain"]
    for r in runs["port"]:
        got = r[arch]
        assert got["mesh"] == ref["plain"], (got, ref)
        assert got["gap"] <= LOGIT_TOL, got["gap"]
        tot = got["pool_bytes"]
        assert tot == ref["pool_bytes"]
        per = got["per"]
        assert len(per) == 8 and all(b < tot for b in per), per
        # feature axes cut 4 ways over "model": a rank's share is pool/4
        assert max(per) == tot // 4 == ref["per_max"], (per, tot)
        assert sum(per) == 2 * tot == ref["per_sum"]     # 2 data replicas
        assert got["per_device"] == tot // 4
        # qwen3: 2 kv heads on model 4 -> head_dim; deepseek: kv heads
        want = {"k": 2, "v": 2} if arch == "qwen3-1.7b" else {"k": 1, "v": 1}
        assert all(s == want for s in got["split"]), got["split"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_pool_writes_are_each_ranks_block(runs, arch):
    """Each rank writes exactly its block of every new k / v (the
    reference pins the update replicated because its partitioner scaled
    the written K): the pool gathered over "model" equals the one-device
    engine's, bitwise in layer 0 (its inputs are the exact embedding)
    and within the logit bar after (the row-parallel sums)."""
    got = runs["port"][0][arch]
    assert got["pool_gap0"] == 0.0, got["pool_gap0"]
    assert got["pool_gap"] <= LOGIT_TOL, got["pool_gap"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefix_cache_bitwise(runs, arch):
    """The radix prefix cache on (2, 4): aliasing edits only the host
    page table, the pool stays cut; cached on the mesh == uncached on
    one device == the reference's cached mesh run."""
    ref = runs["ref"][arch]
    assert runs["port"][0][arch]["prefix_solo"] == ref["prefix"]
    for r in runs["port"]:
        got = r[arch]
        assert got["prefix_mesh"] == ref["prefix"]
        assert got["prefix_gap"] <= LOGIT_TOL, got["prefix_gap"]
        assert got["prefix_hit_rate"] > 0
        assert got["prefix_hit_rate"] == ref["prefix_hit_rate"]
        per = got["prefix_per"]
        assert len(per) == 8 and max(per) == got["prefix_pool_bytes"] // 4


def test_mesh_legacy_engine_matches_solo(runs):
    """The lockstep slab engine on (2, 4): each data replica its row,
    the slab's sequence cut over "model"; greedy tokens == one device ==
    the reference's mesh run.  Sampled at temperature 1 from one seed,
    the mesh draws every row as the one-device engine does: the two
    rows share a prompt, and their tokens differ on one device and on
    the mesh alike."""
    assert runs["port"][0]["legacy_solo"] == runs["ref"]["legacy"]
    hot = runs["port"][0]["legacy_hot_solo"]
    assert hot[0] != hot[1]
    for r in runs["port"]:
        assert r["legacy_mesh"] == runs["ref"]["legacy"]
        assert r["legacy_hot_mesh"] == hot


def test_pool_specs_follow_divisibility(runs):
    """pool_spec on a real (2, 4) gloo mesh: kv heads over "model" when
    they divide, else head_dim; the MLA latent on its width; per-slot
    leaves replicated (the port's pool leaves carry no stacked lead)."""
    want = [[None, "model", None], [None, None, "model"], [None, "model"],
            [None, None, None]]
    for r in runs["port"]:
        assert r["specs"] == want


def test_kvcache_accounting_host_path():
    """One device: the per-device sweep is the whole pool, the
    reference's size."""
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    kv = PagedKVCache(cfg, slots=2, max_len=64, page_size=16, device="cpu")
    assert kv.mesh is None
    assert kv.pool_bytes_per_device() == kv.pool_bytes()
    ref = JaxPagedKVCache(jax_smoke("qwen3-1.7b").with_overrides(
        dtype="float32"), slots=2, max_len=64, page_size=16,
        dtype=jnp.float32)
    assert kv.pool_bytes() == ref.pool_bytes()


def test_launcher_mesh_end_to_end_no_systemexit(runs):
    """``launch.serve --mesh-shape 2x4`` under 8 gloo ranks (the
    reference's test's arguments): the continuous engine on the mesh,
    every rank's outputs equal to the one-process run's.  The launchers
    draw their weights from --seed, each package with its own
    generator, so the two packages' outputs are not compared."""
    host = runs["port"][0]["launcher_host"]
    assert len(host) == 2 and all(len(o) == 6 for o in host)
    for r in runs["port"]:
        assert r["launcher_mesh"] == host


def test_launcher_requests_normalisation_and_legacy_refusal():
    """--requests 0 and omitted both resolve to --batch; the legacy
    refusal reports the resolved values; 0 does not trip it."""
    base = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "6", "--new-tokens", "4"]
    outs_default = launch_serve.main(base)
    assert len(outs_default) == 2
    assert launch_serve.main(base + ["--requests", "0"]) == outs_default
    with pytest.raises(SystemExit) as ei:
        launch_serve.main(base + ["--engine", "legacy", "--requests", "5"])
    msg = str(ei.value)
    assert "--requests 5" in msg and "--batch 2" in msg
    outs = launch_serve.main(base + ["--engine", "legacy", "--requests", "0"])
    assert len(outs) == 2


def test_every_decoder_only_arch_serves_on_a_2x2_mesh(runs):
    """All eight decoder-only architectures on (data 2, model 2): greedy
    tokens equal to the one-device engine's at fp32, the pool cut in
    two where it has one (RWKV-6 has none)."""
    solo = runs["eight"][0]
    for r in runs["eight"]:
        assert sorted(r) == sorted(DECODER_ONLY + ("spec", "refused",
                                                   "whole_kept"))
        for arch in DECODER_ONLY:
            got = r[arch]
            assert got["mesh"] == solo[arch]["solo"], arch
            assert got["per"] == [got["pool_bytes"] // 2] * 4, arch


def test_launcher_mesh_refusals(monkeypatch):
    """A malformed --mesh-shape exits with its message; the full config
    under torchrun without --mesh-shape serves on the production mesh
    and exits unless the world fills it; a mesh shape the world does not
    fill exits with the mesh's message."""
    base = ["--arch", "qwen3-1.7b", "--device", "cpu", "--backend", "gloo"]
    with pytest.raises(SystemExit, match="expected DxM"):
        launch_serve.main(base + ["--reduced", "--mesh-shape", "2by4"])
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(SystemExit, match="needs 256 ranks, have 8"):
        launch_serve.main(base)
    for key in ("RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match="RANK is not set"):
        launch_serve.main(base + ["--reduced", "--mesh-shape", "2x4"])


def test_spec_decode_on_a_mesh_keeps_its_tokens(runs):
    """Speculative decode (k = 3, DeepSeek-V3's MTP head gathered at use
    and run replicated) on (2, 2): the one-device engine's tokens."""
    solo = runs["eight"][0]["spec"]["solo"]
    assert len(solo) == 4
    for r in runs["eight"]:
        assert r["spec"]["mesh"] == solo
        assert r["spec"]["verify_steps"] > 0


def test_mesh_engines_refuse_a_whole_model(runs):
    """Serving weights are drawn or loaded to their blocks, never drawn
    whole and cut: both engines refuse a one-device ``Model`` on a mesh
    and leave it as it was."""
    for r in runs["eight"]:
        assert r["refused"] == [True, True]
        assert r["whole_kept"]
