"""The port's Table-1 networks and their data against the reference on
the CPU: logits and CE-loss gradients of every net on bridged weights
(the CNNs' NHWC flatten order included), the bridge's round trip,
``init_paper_net``'s leaves and draws, ``make_dataset``'s geometry and
``ShardedLoader``'s batches.  Inputs are drawn with numpy from a seed
and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_nets import PAPER_NETS as JAX_NETS
from repro.data import ShardedLoader as JaxLoader
from repro.data import make_dataset as jax_dataset
from repro.models import apply_paper_net as jax_apply
from repro.models import init_paper_net as jax_init
from repro_torch.bridge import paper_net_from_jax, paper_net_to_numpy
from repro_torch.configs import PAPER_NETS
from repro_torch.data import PAPER_DATASET_SHAPES, ShardedLoader, make_dataset
from repro_torch.models import apply_paper_net, init_paper_net
from repro_torch.train import cross_entropy

torch.set_num_threads(2)

# fp32, the reference's own bar for the paper nets
TOL = 1e-5
NETS = sorted(PAPER_NETS)
# the std of a normal truncated at +-3 sigma, over sigma
TRUNC_STD = 0.98658


def _inputs(net, B=4, seed=0):
    rng = np.random.default_rng(seed)
    if net.kind == "dnn":
        x = rng.standard_normal((B, net.layer_sizes[0]), dtype=np.float32)
        classes = net.layer_sizes[-1]
    else:
        x = rng.standard_normal((B, *net.image_hw, net.image_channels),
                                dtype=np.float32)
        classes = net.num_classes
    return x, rng.integers(0, classes, B).astype(np.int32)


def _ref(name, seed=0):
    params = jax_init(JAX_NETS[name], jax.random.PRNGKey(seed))
    return params, jax.tree_util.tree_map(np.asarray, params)


def _named(tree):
    """The reference's leaves under the port's parameter names."""
    return {f"{g}.{i}.{k}": np.asarray(v) for g, layers in tree.items()
            for i, layer in enumerate(layers) for k, v in layer.items()}


def test_configs_are_the_references():
    assert PAPER_NETS.keys() == JAX_NETS.keys()
    for name, net in PAPER_NETS.items():
        ref = JAX_NETS[name]
        assert {f: getattr(net, f) for f in net.__dataclass_fields__} == \
            {f: getattr(ref, f) for f in ref.__dataclass_fields__}


@pytest.mark.parametrize("name", NETS)
def test_logits_match_reference(name):
    net = PAPER_NETS[name]
    params, np_params = _ref(name)
    x, _ = _inputs(net)
    model = paper_net_from_jax(np_params, net, device="cpu")
    got = apply_paper_net(net, model, torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jax_apply(JAX_NETS[name], params, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", NETS)
def test_ce_gradients_match_reference(name):
    net = PAPER_NETS[name]
    params, np_params = _ref(name)
    x, y = _inputs(net, seed=1)

    def jloss(p):
        lg = jax_apply(JAX_NETS[name], p, jnp.asarray(x))
        return jnp.mean(-jax.nn.log_softmax(lg)[jnp.arange(len(y)), y])

    jl, jg = jax.value_and_grad(jloss)(params)
    model = paper_net_from_jax(np_params, net, device="cpu")
    loss = cross_entropy(apply_paper_net(net, model, torch.from_numpy(x)),
                         torch.from_numpy(y))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= TOL
    want = _named(jg)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", NETS)
def test_bridge_round_trips(name):
    net = PAPER_NETS[name]
    _, np_params = _ref(name)
    back = paper_net_to_numpy(paper_net_from_jax(np_params, net,
                                                 device="cpu"), net)
    assert _named(back).keys() == _named(np_params).keys()
    for k, w in _named(np_params).items():
        np.testing.assert_array_equal(_named(back)[k], w, err_msg=k)


def test_bridge_refuses_another_nets_tree():
    _, np_params = _ref("mnist-dnn")
    with pytest.raises(ValueError, match="mnist-cnn"):
        paper_net_from_jax(np_params, PAPER_NETS["mnist-cnn"], device="cpu")


@pytest.mark.parametrize("name", NETS)
def test_init_has_reference_leaves_and_truncated_normal(name):
    net = PAPER_NETS[name]
    _, np_params = _ref(name)
    model = init_paper_net(net, seed=0, device="cpu")
    got = dict(model.named_parameters())
    want = _named(np_params)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(p.dtype == torch.float32 for p in got.values())
    for k, w in got.items():
        w = w.detach().numpy()
        if k.endswith(".b"):
            assert not w.any(), k
            continue
        d_in = np.prod(w.shape[:-1])
        sigma = ((2.0 / d_in) if k.startswith("conv") else 1.0 / d_in) ** 0.5
        assert np.abs(w).max() <= 3 * sigma * (1 + 1e-6), k
        if w.size >= 2000:          # enough draws for a 5% check
            assert abs(w.std() / (TRUNC_STD * sigma) - 1) < 0.05, k
    again = init_paper_net(net, seed=0, device="cpu")
    other = init_paper_net(net, seed=1, device="cpu")
    for k, p in again.named_parameters():
        assert torch.equal(p, got[k])
    assert any(not torch.equal(p, got[k]) for k, p in
               other.named_parameters() if k.endswith(".w"))


@pytest.mark.parametrize("name", sorted(PAPER_DATASET_SHAPES))
def test_dataset_geometry_matches_reference(name):
    n = 512
    want = jax_dataset(name, n=n, as_images=True)
    got = make_dataset(name, n=n, as_images=True)
    assert (got.name, got.num_classes) == (want.name, want.num_classes)
    assert got.x.shape == want.x.shape and got.x.dtype == want.x.dtype
    assert got.y.shape == want.y.shape and got.y.dtype == want.y.dtype
    assert got.y.min() >= 0 and got.y.max() < got.num_classes
    assert len(np.unique(got.y)) > 1          # learnable: not one class
    flat = make_dataset(name, n=n)
    assert flat.x.shape == (n, PAPER_DATASET_SHAPES[name]["features"])
    np.testing.assert_array_equal(flat.x.reshape(got.x.shape), got.x)
    again = make_dataset(name, n=n)
    np.testing.assert_array_equal(again.x, flat.x)
    np.testing.assert_array_equal(again.y, flat.y)
    assert not np.array_equal(make_dataset(name, n=n, seed=1).x, flat.x)


def test_dataset_default_sizes_match_reference():
    for name, spec in PAPER_DATASET_SHAPES.items():
        assert spec == jax_dataset.__globals__["PAPER_DATASET_SHAPES"][name]
    assert make_dataset("higgs").x.shape == (200_000, 28)


@pytest.mark.parametrize("batch,drop_last", [(32, True), (48, False)])
def test_sharded_loader_yields_reference_batches(batch, drop_last):
    ds = make_dataset("adult", n=200)
    data = {"x": ds.x, "y": ds.y}
    ref = JaxLoader(data, batch, seed=3, drop_last=drop_last)
    got = ShardedLoader(data, batch, seed=3, drop_last=drop_last)
    assert got.steps_per_epoch() == ref.steps_per_epoch()
    for epoch in (0, 1):
        a, b = list(got.epoch(epoch)), list(ref.epoch(epoch))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            for k in data:
                np.testing.assert_array_equal(x[k], np.asarray(y[k]))
