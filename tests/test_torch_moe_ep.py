"""Expert parallelism (``repro_torch.models.moe.apply_moe_ep``) on gloo
ranks: the twins of ``tests/test_moe.py``'s four EP tests -- the
all-to-all branch, expert-FSDP (6 experts), an unsharded batch and
multi-pod -- each held to the port's dense dispatch at the reference's
5e-5, with the aux loss the mean over the batch axes of each shard's
own; at a capacity that drops tokens (0.5) the port's EP is held to the
reference's ``apply_moe_ep`` on 4 forced host devices on the same numpy
inputs; and a dim split over ("data", "model") lands on the rank the
reference's ``NamedSharding`` puts it on."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_ranks import ROOT, run_ranks

from repro_torch.configs import smoke_config
from repro_torch.models import moe as moe_lib

EP_TOL = 5e-5          # the reference's EP-vs-dense bar (tests/test_moe.py)
TIGHT_CF = 0.5         # drops tokens on the local routing
CASES = {"a2a": ((4, 8), None), "fsdp": ((4, 8), (6, 2, 128)),
         "unsharded": ((1, 8), None), "tight": ((4, 8), None)}


def _cfg(case):
    import dataclasses
    cfg = smoke_config("deepseek-moe-16b").with_overrides(dtype="float32")
    if CASES[case][1]:
        E, k, f = CASES[case][1]
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, num_experts=E, top_k=k, d_expert=f))
    return cfg


def _inputs(case, seed=0):
    """(params as numpy, x) of a case, drawn from a torch generator."""
    gen = torch.Generator().manual_seed(seed)
    cfg = _cfg(case)
    p = moe_lib.init_moe(cfg, generator=gen, dtype=torch.float32)
    x = torch.randn(CASES[case][0] + (cfg.d_model,), generator=gen)
    tree = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy()) for k, v in p.items()}
    return tree, x.numpy()


def _save(tmp_path):
    for case in CASES:
        tree, x = _inputs(case)
        flat = {"x": x}
        for k, v in tree.items():
            if isinstance(v, dict):
                flat.update({f"{k}/{kk}": vv for kk, vv in v.items()})
            else:
                flat[k] = v
        np.savez(tmp_path / f"{case}.npz", **flat)


RANK_CODE = """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.bridge import _block
from repro_torch.configs import smoke_config
from repro_torch.models import moe as moe_lib
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.comm import MeshComm
from repro_torch.sharding.rules import (local_slices, param_spec,
                                        placements)
from torch.distributed.tensor import DTensor
SHAPE, NAMES = {shape}, {names}
mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=NAMES)
comm = MeshComm(mesh)
CASES = {cases}

def cfg_of(case):
    cfg = smoke_config("deepseek-moe-16b").with_overrides(dtype="float32")
    if CASES[case][1]:
        E, k, f = CASES[case][1]
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, num_experts=E, top_k=k, d_expert=f))
    return cfg

def place(cfg, path, a):
    t = torch.from_numpy(a)
    spec = param_spec(cfg, mesh, path, tuple(t.shape))
    blk = t[local_slices(tuple(t.shape), spec, dict(comm.sizes),
                         comm.coord)].clone()
    return torch.nn.Parameter(DTensor.from_local(
        blk, mesh, placements(spec, comm.names), run_check=False))

out = {{"coord": [comm.index(a) for a in NAMES]}}
for case in {run}:
    cfg = cfg_of(case)
    cf = {tight} if case == "tight" else 8.0
    f = np.load("{tmp}/" + case + ".npz")
    x = torch.from_numpy(f["x"])
    p = {{"router": torch.from_numpy(f["router"]),
          "experts": {{k: torch.from_numpy(f["experts/" + k])
                      for k in ("w_up", "w_gate", "w_down")}},
          "shared": {{k: torch.from_numpy(f["shared/" + k])
                     for k in ("w_up", "w_gate", "w_down")}}}}
    y0, a0 = moe_lib.apply_moe_dense(cfg, p, x, capacity_factor=cf)
    pre = "decoder/blocks/layer0/ffn/"
    dp = {{"router": place(cfg, pre + "router", f["router"]),
           "experts": {{k: place(cfg, pre + "experts/" + k, v.numpy())
                       for k, v in p["experts"].items()}},
           "shared": {{k: place(cfg, pre + "shared/" + k, v.numpy())
                      for k, v in p["shared"].items()}}}}
    B = x.shape[0]
    split = B % comm.dp_size() == 0
    n = B // comm.dp_size() if split else B
    lo = comm.dp_index() * n if split else 0
    with shctx.activation_mesh(mesh), shctx.batch_split(split):
        y1, a1 = moe_lib.apply_moe(cfg, dp, x[lo:lo + n], capacity_factor=cf)
    rows = [torch.empty_like(y1) for _ in range(WORLD)]
    dist.all_gather(rows, y1.contiguous())
    M = comm.size("model")
    y1 = torch.cat(rows[::M]) if split else y1
    # the aux the reference's EP takes: each batch shard's own routing
    shard_aux = [float(moe_lib._routing(cfg, p, x[i * n:(i + 1) * n].reshape(
        -1, cfg.d_model))[2]) for i in range(B // n)]
    out[case] = {{"err": float((y1 - y0).abs().max()), "aux": float(a1),
                 "shard_aux_mean": float(np.mean(shard_aux)),
                 "y": y1.numpy().tolist() if case == "tight" else None}}
# a ("data", "model") split: this rank's block of an (8, 3) array
if "data" in NAMES and "model" in NAMES:
    t = torch.arange(24.).reshape(8, 3)
    spec = (("data", "model"), None)
    dt = DTensor.from_local(t[local_slices((8, 3), spec, dict(comm.sizes),
                                           comm.coord)].clone(), mesh,
                            placements(spec, comm.names), run_check=False)
    out["block"] = [[s.start, s.stop] for s in _block(dt)]
    out["rows"] = dt.to_local()[:, 0].tolist()
print(json.dumps(out))
"""

JAX_CODE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh, auto_axis_types, set_mesh
from repro.configs import smoke_config
from repro.models import moe as moe_lib
from repro.sharding.ctx import set_activation_mesh
mesh = make_mesh((2, 2), ("data", "model"), axis_types=auto_axis_types(2))
cfg = smoke_config("deepseek-moe-16b").with_overrides(dtype="float32")
f = np.load(sys.argv[1])
x = jnp.asarray(f["x"])
p = {"router": jnp.asarray(f["router"]),
     "experts": {k: jnp.asarray(f["experts/" + k])
                 for k in ("w_up", "w_gate", "w_down")},
     "shared": {k: jnp.asarray(f["shared/" + k])
                for k in ("w_up", "w_gate", "w_down")}}
set_activation_mesh(mesh)
with set_mesh(mesh):
    y, aux = jax.jit(lambda p, x: moe_lib.apply_moe(
        cfg, p, x, capacity_factor=float(sys.argv[2])))(p, x)
set_activation_mesh(None)
idx = NamedSharding(mesh, P(("data", "model"), None)).devices_indices_map(
    (8, 3))
pos = {d.id: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
       for d in mesh.devices.flat}
print(json.dumps({"y": np.asarray(y).tolist(), "aux": float(aux),
                  "blocks": {json.dumps(pos[d.id]): [s.start or 0, s.stop or 8]
                             for d, (s, _) in idx.items()}}))
"""


def _ranks(tmp_path, shape, names, run):
    code = RANK_CODE.format(shape=shape, names=names, cases=CASES, run=run,
                            tight=TIGHT_CF, tmp=tmp_path)
    world = int(np.prod(shape))
    return run_ranks(code, world, tmp_path, timeout=180)


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    _save(tmp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", JAX_CODE,
                            str(tmp / "tight.npz"), str(TIGHT_CF)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=ROOT)
    ranks = _ranks(tmp, (2, 2), ("data", "model"), list(CASES))
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    return ranks, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["a2a", "fsdp", "unsharded"])
def test_ep_matches_dense(ep, case):
    r = ep[0][0][case]
    assert r["err"] <= EP_TOL, r
    # the aux: the mean over the batch shards of each one's own
    assert abs(r["aux"] - r["shard_aux_mean"]) <= 1e-7, r


def test_ep_branches_are_the_references():
    fake = type("C", (), {"size": lambda self, a: {"data": 2,
                                                   "model": 2}[a]})()
    assert moe_lib._ep_factors(_cfg("a2a"), fake) == (2, 2)
    assert moe_lib._ep_factors(_cfg("fsdp"), fake) == (1, 2)


def test_ep_tight_capacity_matches_reference_ep(ep):
    ranks, ref = ep
    r = ranks[0]["tight"]
    y, want = np.asarray(r["y"]), np.asarray(ref["y"])
    assert np.abs(y - want).max() <= EP_TOL
    # and the capacity dropped tokens: the dense dispatch disagrees
    assert r["err"] > 1e-3
    assert abs(r["aux"] - ref["aux"]) <= 1e-6


def test_data_model_split_is_data_major(ep):
    ranks, ref = ep
    for r in ranks:
        want = ref["blocks"][json.dumps(r["coord"])]
        assert r["block"][0] == want
        assert r["rows"] == [3.0 * i for i in range(*want)]


def test_ep_multipod_matches_dense(tmp_path):
    _save(tmp_path)
    ranks = _ranks(tmp_path, (2, 2, 2), ("pod", "data", "model"), ["a2a"])
    r = ranks[0]["a2a"]
    assert r["err"] <= EP_TOL, r
    assert abs(r["aux"] - r["shard_aux_mean"]) <= 1e-7, r
