"""The port's collectives on gloo ranks on the CPU: ``flat``,
``bucketed`` (with a bucket size that forces several buckets and
padding) and ``hierarchical``, on the reference's single- and
multi-pod meshes (8,) and (2, 4), against the numpy mean; the replicas
left bitwise equal; ``compress="bf16"``; the ``zero1`` reduce-scatter /
all-gather round trip; ``rank0_scatter``'s rows and its refusal of an
uneven batch; and the strategy registry, which holds the reference's
eight strategies.
Each mesh shape runs once, in a module-scoped fixture whose ranks run
every case and return JSON."""
import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

from repro_torch.core import available_strategies, get_strategy
from repro_torch.core.collectives import allreduce_mean, wire_bytes
from repro_torch.core.strategy import (ReplicatedStrategy,
                                       register_strategy)

MESHES = {"single_pod": (8,), "multi_pod": (2, 4)}
STRATEGIES = ["flat", "bucketed", "hierarchical"]
SHAPES = [(3, 5), (7,), (11, 2), (64, 33), (1,)]
# 600 B buckets of fp32: several buckets, the last padded
BUCKET_BYTES = 600
# fp32 sums of 8 values in another order than numpy's
TOL = 1e-6
# bf16 on the wire: 8-bit mantissa
BF16_TOL = 5e-2

CODE = """
import hashlib
from repro_torch.core import DPConfig, allreduce_mean
from repro_torch.data import rank0_scatter
from repro_torch.launch.mesh import make_dp_mesh

pods = {pods}
mesh = make_dp_mesh(pods)
shapes = {shapes}

def inputs(r):
    rng = np.random.default_rng(100 + r)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]

all_in = [inputs(r) for r in range(WORLD)]
want = [np.mean([a[i] for a in all_in], axis=0, dtype=np.float64)
        for i in range(len(shapes))]
out = {{"err": {{}}, "sha": {{}}}}
for name, kw in [("flat", {{}}), ("bucketed", {{"bucket_bytes": {bucket}}}),
                 ("hierarchical", {{}}), ("zero1", {{}}),
                 ("bf16", {{"compress": "bf16"}})]:
    strategy = "flat" if name == "bf16" else name
    ts = [torch.from_numpy(a.copy()) for a in all_in[RANK]]
    ret = allreduce_mean(ts, mesh, strategy=strategy, **kw)
    assert ret is ts and all(t.dtype == torch.float32 for t in ts)
    out["err"][name] = max(float(np.abs(t.numpy() - w).max())
                           for t, w in zip(ts, want))
    out["sha"][name] = hashlib.sha256(
        b"".join(t.numpy().tobytes() for t in ts)).hexdigest()

B = 2 * WORLD
g = {{"x": np.arange(B * 3, dtype=np.float32).reshape(B, 3),
      "y": np.arange(B, dtype=np.int32)}}
mine = {{k: v if RANK == 0 else np.zeros_like(v) for k, v in g.items()}}
got = rank0_scatter(mesh, mine, device="cpu")
lo, hi = RANK * B // WORLD, (RANK + 1) * B // WORLD
out["scatter_rows"] = all(np.array_equal(got[k].numpy(), g[k][lo:hi])
                          for k in g)
out["scatter_dtypes"] = [str(got[k].dtype) for k in sorted(got)]
try:
    rank0_scatter(mesh, {{"x": np.zeros((B + 1, 2), np.float32)}},
                  device="cpu")
except ValueError as e:
    out["uneven"] = str(e)
out["coordinate"] = mesh.get_coordinate()
print(json.dumps(out))
"""


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    shape = MESHES[request.param]
    pods = shape[0] if len(shape) == 2 else 1
    code = CODE.format(pods=pods, shapes=SHAPES, bucket=BUCKET_BYTES)
    return shape, run_ranks(code, int(np.prod(shape)),
                            tmp_path_factory.mktemp("collectives"))


@pytest.mark.parametrize("strategy", STRATEGIES + ["zero1"])
def test_allreduce_equals_numpy_mean(ranks, strategy):
    _, results = ranks
    assert max(r["err"][strategy] for r in results) <= TOL


@pytest.mark.parametrize("strategy", STRATEGIES + ["zero1", "bf16"])
def test_replicas_end_bitwise_equal(ranks, strategy):
    _, results = ranks
    assert len({r["sha"][strategy] for r in results}) == 1


def test_bf16_compression_stays_close(ranks):
    _, results = ranks
    errs = [r["err"]["bf16"] for r in results]
    assert 0 < max(errs) <= BF16_TOL


def test_hierarchical_degenerates_to_flat_on_one_pod(ranks):
    """One pod: the same all-reduce as flat, bit for bit.  A pod x data
    mesh stages its sums (reduce-scatter, all-reduce, all-gather), whose
    mean the first test holds."""
    shape, results = ranks
    if len(shape) == 1:
        assert all(r["sha"]["hierarchical"] == r["sha"]["flat"]
                   for r in results)
    else:
        assert max(r["err"]["hierarchical"] for r in results) <= TOL


def test_rank0_scatter_gives_contiguous_rows(ranks):
    shape, results = ranks
    assert all(r["scatter_rows"] for r in results)
    assert all(r["scatter_dtypes"] == ["torch.float32", "torch.int32"]
               for r in results)
    # rank order of the mesh's data axes: row-major over (pod, data)
    coords = [tuple(r["coordinate"]) for r in results]
    assert coords == sorted(coords) and len(set(coords)) == len(coords)


def test_rank0_scatter_refuses_an_uneven_batch(ranks):
    shape, results = ranks
    p = int(np.prod(shape))
    assert all(f"over {p} data-parallel ranks" in r["uneven"]
               for r in results)


def test_bucket_size_forces_several_padded_buckets():
    ts = [torch.zeros(s) for s in SHAPES]
    n = sum(t.numel() for t in ts)
    per = BUCKET_BYTES // 4
    assert n > 2 * per and n % per
    assert wire_bytes(ts, strategy="bucketed", bucket_bytes=BUCKET_BYTES) \
        == -(-n // per) * per * 4
    # a bucket larger than the whole is the whole, unpadded
    assert wire_bytes(ts, strategy="bucketed") == 4 * n


def test_wire_bytes_counts_dtype_and_padding():
    ts = [torch.zeros(s) for s in SHAPES]
    n = sum(t.numel() for t in ts)
    assert wire_bytes(ts) == 4 * n
    assert wire_bytes(ts, compress="bf16") == 2 * n
    padded = sum(t.numel() + (-t.numel()) % 4 for t in ts)
    assert wire_bytes(ts, strategy="hierarchical", n_intra=4) == 4 * padded
    assert wire_bytes([]) == 0


@pytest.mark.parametrize("name", ["zero1", "zero2", "zero3", "zero1_hier",
                                  "zero3_hier"])
def test_zero_strategies_registered(name):
    s = get_strategy(name)
    assert name in available_strategies()
    assert (s.name, s.kind, s.sharded) == (name, name, True)
    assert s.params_sharded == name.startswith("zero3")


def test_allreduce_zero1_round_trip_guards():
    """The zero1 branch runs (``ranks`` holds it to the numpy mean); an
    empty list passes through, an unknown wire dtype raises."""
    assert allreduce_mean([], None, strategy="zero1") == []
    with pytest.raises(ValueError, match="compress"):
        allreduce_mean([torch.zeros(2)], None, compress="fp8")
    with pytest.raises(ValueError, match="unknown allreduce strategy"):
        allreduce_mean([torch.zeros(2)], None, strategy="zero2")


def test_registry_lists_and_guards():
    assert available_strategies()[:3] == tuple(STRATEGIES)
    with pytest.raises(ValueError, match="registered strategies"):
        get_strategy("nope")
    with pytest.raises(ValueError, match="already registered"):
        register_strategy(get_strategy("flat"))
    with pytest.raises(TypeError):
        register_strategy("flat")

    class Mine(ReplicatedStrategy):
        name = "test_mine"
        collective = "bucketed"

    mine = register_strategy(Mine())
    try:
        assert get_strategy("test_mine") is mine
        assert get_strategy(mine) is mine
    finally:
        from repro_torch.core import strategy
        del strategy._REGISTRY["test_mine"]


def test_replicated_memory_entry():
    entry = get_strategy("flat").memory_entry(1000, 2, 8)
    assert entry == {"params": 4000, "grads": 4000, "opt_state": 8000.0}
