"""The sharding rules (``repro_torch.sharding.rules``) against the
reference's ``repro.sharding.rules``, and the production mesh.

Rules parity: for all ten architectures, full and smoke config, train
and serve mode, on the (16, 16) and (2, 16, 16) production meshes (an
object with the reference's ``axis_names`` and ``shape``, as
``tests/test_substrate.py`` builds it), the port's spec of every
parameter -- matched by its bridge path -- is the reference's
``param_spec`` without the stacked ``n_rep`` lead; likewise
``batch_spec``, ``cache_spec`` on the reference's ``init_cache`` shapes
and ``pool_spec`` on its paged ones.  The twins of
``tests/test_substrate.py``'s ``test_param_specs_rank_match`` and
``test_cache_specs_rank_match``.

The production mesh: in a subprocess on PyTorch's fake process group at
world 256 and 512, ``init_train_state(mesh=make_production_mesh(...))``
of every full config with AdamW on the meta device places every master
and both moments with the local shape the reference's spec implies; any
other world raises.  The launcher's full path keeps the reference's
refusals.

Placed as drawn: on 4 gloo ranks of a (2, 2) mesh, every architecture's
``init_train_state(mesh=)`` holds, bitwise, the blocks of the
one-device model drawn from the same seed; and a rank's resident memory
while it draws a mesh state (8 layers of 16 MiB MLP leaves) rises no
higher than its blocks plus what drawing one whole leaf takes, far
under the whole model.  Large allocations are mapped and unmapped one
by one (``MALLOC_MMAP_THRESHOLD_``), so the resident set follows the
live tensors; the high mark read is the rank's own (``VmHWM``), since
``ru_maxrss`` starts at the resident set of the process that spawned
the rank."""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import (ARCHITECTURES as JAX_ARCHS, INPUT_SHAPES,
                           LONG_500K_SKIPS)
from repro.configs import config_for_shape as jax_config_for_shape
from repro.configs import smoke_config as jax_smoke
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.sharding import rules as jax_rules
from repro_torch.bridge import reference_key
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.models import init_model
from repro_torch.sharding import rules
from torch_ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)


class _Mesh:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"16x16": _Mesh({"data": 16, "model": 16}),
          "2x16x16": _Mesh({"pod": 2, "data": 16, "model": 16})}


def _path_str(path):
    return jax_rules._path_str(path)


def _stacked(path):
    return "/blocks/" in path or path.startswith("blocks/")


def _body(path, shape):
    return tuple(shape[1:]) if _stacked(path) else tuple(shape)


def _unlead(path, spec, ndim):
    """The reference's spec as the port's tuple: one entry a dim, the
    stacked lead dropped."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    entries = tuple(tuple(e) if isinstance(e, list) else e for e in entries)
    return entries[1:] if _stacked(path) else entries


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch, smoke):
    cfg = jax_smoke(arch) if smoke else JAX_ARCHS[arch]
    tree = jax.eval_shape(functools.partial(jax_init_model, cfg), KEY)
    return cfg, {_path_str(p): tuple(l.shape)
                 for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _port_shapes(arch, smoke):
    cfg = smoke_config(arch) if smoke else get_config(arch)
    model = init_model(cfg, device="meta", train=True)
    out = {}
    for name, p in model.named_parameters():
        path, _ = reference_key(model, name)
        out.setdefault(path, tuple(p.shape))
    return cfg, out


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_specs_match_reference(arch):
    for smoke in (False, True):
        jcfg, ref = _ref_shapes(arch, smoke)
        cfg, port = _port_shapes(arch, smoke)
        assert set(port) == set(ref), sorted(set(port) ^ set(ref))
        for mode in ("train", "serve"):
            for mesh_name, mesh in MESHES.items():
                jsh = jax_rules.ShardingConfig.for_mode(mode)
                sh = rules.ShardingConfig.for_mode(mode)
                got = rules.param_specs(cfg, mesh, port, sh)
                for path, shape in ref.items():
                    want = _unlead(path, jax_rules.param_spec(
                        jcfg, mesh, path, jax.ShapeDtypeStruct(
                            shape, jnp.float32), jsh), len(shape))
                    assert port[path] == _body(path, shape), path
                    assert got[path] == want, (arch, smoke, mode, mesh_name,
                                               path, got[path], want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_spec_matches_reference(mesh_name):
    mesh = MESHES[mesh_name]
    for b in (1, 3, 16, 32, 256, 512, 1024):
        want = tuple(tuple(e) if isinstance(e, list) else e
                     for e in jax_rules.batch_spec(mesh, b))
        assert rules.batch_spec(mesh, b) == want, (mesh_name, b)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_cache_and_pool_specs_match_reference(arch):
    n_cache = n_pool = 0
    for name, shp in INPUT_SHAPES.items():
        if shp.mode != "decode":
            continue
        if name == "long_500k" and arch in LONG_500K_SKIPS:
            continue
        jcfg = jax_config_for_shape(arch, name)
        cfg = get_config(arch)
        if name == "long_500k" and jcfg.swa_window:
            cfg = cfg.with_overrides(swa_window=jcfg.swa_window)
        max_len = min(shp.seq_len, 4096)
        cache = jax.eval_shape(lambda: jax_init_cache(
            jcfg, shp.global_batch, max_len, jnp.bfloat16, cross_len=max_len))
        for mesh in MESHES.values():
            for mode in ("serve", "train"):
                jsh = jax_rules.ShardingConfig.for_mode(mode)
                sh = rules.ShardingConfig.for_mode(mode)
                for p, leaf in jax.tree_util.tree_leaves_with_path(cache):
                    path = _path_str(p)
                    want = _unlead(path, jax_rules.cache_spec(
                        jcfg, mesh, path, leaf, shp.global_batch, jsh),
                        len(leaf.shape))
                    got = rules.cache_spec(cfg, mesh, path,
                                           _body(path, leaf.shape),
                                           shp.global_batch, sh)
                    assert got == want, (arch, name, path, got, want)
                    n_cache += 1
    if jcfg.is_encoder_decoder:
        assert n_cache
        return
    # the paged pool: per-slot leaves found as the reference's kvcache
    # finds them, by the shape that changes with the slot count
    slots, max_len, pool = 8, 256, (33, 64)
    a, b = (jax.eval_shape(lambda s=s: jax_init_cache(
        JAX_ARCHS[arch], s, max_len, jnp.bfloat16, pool=pool))
        for s in (slots, slots + 1))
    for (p, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                         jax.tree_util.tree_leaves(b)):
        path = _path_str(p)
        ax = next((i for i, (m, n) in enumerate(zip(x.shape, y.shape))
                   if m != n), -1)
        for mesh in MESHES.values():
            want = _unlead(path, jax_rules.pool_spec(
                JAX_ARCHS[arch], mesh, path, x, ax), len(x.shape))
            got = rules.pool_spec(get_config(arch), mesh, path,
                                  _body(path, x.shape),
                                  ax - _stacked(path) if ax >= 0 else ax)
            assert got == want, (arch, path, got, want)
            n_pool += 1
    assert n_cache and n_pool


def test_placements_are_data_major():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert rules.placements((("data", "model"), None), names) == [
        Replicate(), Shard(0), Shard(0)]
    assert rules.placements(("data", "model", None), names) == [
        Replicate(), Shard(0), Shard(1)]
    with pytest.raises(ValueError, match="order"):
        rules.placements((("model", "data"),), names)
    sizes = {"pod": 2, "data": 2, "model": 2}
    spec = (("data", "model"), None)
    # rank (d, m) holds block d * |model| + m of the split dim
    for d in range(2):
        for m in range(2):
            sl = rules.local_slices((8, 3), spec, sizes,
                                    {"pod": 1, "data": d, "model": m})
            assert sl == (slice(2 * (2 * d + m), 2 * (2 * d + m) + 2),
                          slice(0, 3))


PRODUCTION = """
import json, sys
import jax, jax.numpy as jnp
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro.configs import ARCHITECTURES as JAX_ARCHS
from repro.models import init_model as jax_init_model
from repro.sharding import rules as jax_rules
from repro_torch.bridge import reference_key
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import TrainConfig, init_train_state, trainable
sh = jax_rules.ShardingConfig.for_mode("train")
refs = {arch: jax.eval_shape(lambda: jax_init_model(
            JAX_ARCHS[arch], jax.random.PRNGKey(0)))
        for arch in sorted(JAX_ARCHS)}
out = {}
for world in (256, 512, 8):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    if world == 8:
        try:
            make_production_mesh(multi_pod=False)
            out["8"] = {"raised": None}
        except RuntimeError as e:
            out["8"] = {"raised": str(e)}
        dist.destroy_process_group()
        continue
    mesh = make_production_mesh(multi_pod=world == 512)
    fake = type("M", (), {"axis_names": mesh.mesh_dim_names,
                          "shape": dict(zip(mesh.mesh_dim_names,
                                            mesh.mesh.shape))})()
    res = {}
    for arch, ref in refs.items():
        want = {}
        for p, leaf in jax.tree_util.tree_leaves_with_path(ref):
            path = jax_rules._path_str(p)
            spec = tuple(jax_rules.param_spec(JAX_ARCHS[arch], fake, path,
                                              leaf, sh))
            stacked = "/blocks/" in path or path.startswith("blocks/")
            shape, spec = ((leaf.shape[1:], spec[1:]) if stacked
                           else (leaf.shape, spec))
            local = []
            for dim, ax in zip(shape, spec + (None,) * len(shape)):
                n = 1
                for a in (() if ax is None else ax if isinstance(ax, tuple)
                          else (ax,)):
                    n *= fake.shape[a]
                local.append(dim // n)
            want[path] = tuple(local)
        state = init_train_state(get_config(arch),
                                 TrainConfig(optimizer="adamw"), mesh=mesh,
                                 device="meta")
        masters = trainable(state.params)
        bad, n_bytes = [], 0
        for name, p in masters.items():
            path, _ = reference_key(state.params, name)
            for what, t in (("master", p), ("m", state.opt_state["m"][name]),
                            ("v", state.opt_state["v"][name])):
                loc = tuple(t.to_local().shape)
                n_bytes += t.to_local().numel() * 4
                if loc != want[path] or tuple(t.placements) != tuple(
                        p.placements):
                    bad.append([what, path, loc, want[path]])
        res[arch] = {"bad": bad[:5], "bytes_per_rank": n_bytes,
                     "paths": len(set(reference_key(state.params, n)[0]
                                      for n in masters)),
                     "want_paths": len(want)}
    out[str(world)] = res
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def production():
    """Every full config on the fake 256- and 512-rank production meshes
    (and a world of 8), laid out in one subprocess: the reference's
    shapes are drawn once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", PRODUCTION],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("world", [256, 512])
def test_production_mesh_places_every_master_and_moment(production, world):
    out = production[str(world)]
    assert sorted(out) == sorted(JAX_ARCHS)
    for arch, r in out.items():
        assert not r["bad"], (arch, r["bad"])
        assert r["paths"] == r["want_paths"], arch
        assert r["bytes_per_rank"] > 0


def test_production_mesh_refuses_other_worlds(production):
    assert "needs 256 ranks, have 8" in production["8"]["raised"]


def test_launcher_full_path_refusals(capsys):
    with pytest.raises(SystemExit, match="needs 512 ranks, have 1"):
        launch_train.main(["--arch", "qwen3-1.7b", "--multi-pod",
                           "--device", "cpu", "--steps", "1"])
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen3-1.7b", "--dp-strategy", "flat",
                           "--device", "cpu"])
    assert "--dp-strategy requires --reduced" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced",
                           "--multi-pod", "--device", "cpu"])


DRAWN = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.models.layers import truncated_normal
from repro_torch.train import TrainConfig, init_train_state, trainable
ARCHS = {archs}
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
tc = TrainConfig(optimizer="sgd", lr=0.1)
gen = torch.Generator().manual_seed(0)

def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

def high():
    # this image's own high mark: ru_maxrss carries the spawning
    # process's resident set across fork and exec, VmHWM starts anew
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024

# the peak while a mesh state is drawn, first: the resident set's high
# mark cannot be reset, so nothing larger may be drawn before; a small
# mesh state first loads what a first draw and placement load
res = {{"same": {{}}}}
init_train_state(smoke_config("qwen3-1.7b"), tc, mesh=mesh, device="cpu")
cfg = smoke_config("qwen3-1.7b").with_overrides(
    dtype="float32", num_layers=8, d_model=512, d_ff=8192)
base = rss()
leaf = truncated_normal((512, 8192), 0.1, generator=gen)
res["leaf_bytes"] = leaf.nbytes
del leaf
res["draw_peak"] = high() - base
base = rss()
state = init_train_state(cfg, tc, mesh=mesh, seed=3, device="cpu")
res["init_peak"] = high() - base
masters = trainable(state.params)
res["block_bytes"] = sum(p.to_local().nbytes for p in masters.values())
res["whole_bytes"] = sum(p.numel() * p.element_size()
                         for p in masters.values())
del state, masters
for arch in ARCHS:
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    placed = trainable(init_train_state(cfg, tc, mesh=mesh, seed=3,
                                        device="cpu").params)
    whole = trainable(init_train_state(cfg, tc, seed=3,
                                       device="cpu").params)
    got = bridge.gather_named(placed)
    res["same"][arch] = sorted(got) == sorted(whole) and all(
        got[k].dtype == whole[k].dtype and torch.equal(got[k], whole[k])
        for k in whole)
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    return run_ranks(DRAWN.format(archs=sorted(JAX_ARCHS)), 4,
                     tmp_path_factory.mktemp("drawn"), timeout=240,
                     env={"MALLOC_MMAP_THRESHOLD_": str(2 ** 20)})


def test_mesh_init_holds_the_one_device_draws(drawn):
    for r in drawn:
        assert sorted(r["same"]) == sorted(JAX_ARCHS)
        assert all(r["same"].values()), r["same"]


def test_mesh_init_peak_is_blocks_plus_one_leaf(drawn):
    for r in drawn:
        bound = r["block_bytes"] + r["draw_peak"] + 16 * 2 ** 20
        assert r["draw_peak"] >= r["leaf_bytes"], r
        assert r["init_peak"] <= bound, r
        # drawing the whole model first could not have stayed under it
        assert r["whole_bytes"] > bound, r
