"""The port's optimizers against the reference's ``repro.optim``: the same
random tree and gradients (numpy, from a seed) through both, three
updates, params and every state leaf within 1e-6; the cosine schedule
step by step; the step at which each optimizer reads its rate."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro_torch import optim

TOL = 1e-6
SHAPES = {"a": (4, 7), "b": (13,), "c": (3, 2, 5)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _schedule(pkg, kind, lr):
    # warmup 2 of 6 steps: three updates see warmup, the peak and the decay
    return pkg.cosine_schedule(lr, 2, 6) if kind == "cosine" else lr


def _state_leaves(state):
    for name, v in state.items():
        if isinstance(v, dict):
            for k, t in v.items():
                yield f"{name}.{k}", t
        else:
            yield name, v


@pytest.mark.parametrize("kind", ["constant", "cosine"])
@pytest.mark.parametrize("name", sorted(optim.OPTIMIZERS))
def test_updates_match_reference(name, kind):
    rng = np.random.default_rng(sorted(optim.OPTIMIZERS).index(name))
    params = _tree(rng)
    lr = 0.05
    ref = jax_optim.get_optimizer(name, _schedule(jax_optim, kind, lr))
    port = optim.get_optimizer(name, _schedule(optim, kind, lr))
    assert (port.name, port.state_factor) == (ref.name, ref.state_factor)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = ref.init(jp), port.init(tp)
    for _ in range(3):
        grads = _tree(rng, 0.3)
        jp, js = ref.update({k: jnp.asarray(v) for k, v in grads.items()},
                            js, jp)
        out, ts = port.update({k: torch.from_numpy(v) for k, v in
                               grads.items()}, ts, tp)
        assert out is tp                       # updated in place
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    want = dict(_state_leaves(js))
    got = dict(_state_leaves(ts))
    assert set(got) == set(want)
    for k, t in got.items():
        if k == "step":
            assert t == int(want[k]) == 3
        else:
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(want[k]),
                                       rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("floor", [0.1, 0.0])
def test_cosine_schedule_matches_reference(floor):
    ref = jax_optim.cosine_schedule(3e-4, 10, 50, floor)
    port = optim.cosine_schedule(3e-4, 10, 50, floor)
    for step in range(0, 60, 3):
        got = port(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref(jnp.int32(step))),
                                   rtol=TOL, atol=0)


def test_rate_is_read_before_the_increment_except_adam():
    """Under the cosine schedule SGD's first update has rate 0 (it reads
    step 0), Adam's does not (it reads step 1)."""
    sched = optim.cosine_schedule(1.0, 4, 10)
    p = {"w": torch.ones(3)}
    g = {"w": torch.ones(3)}
    sgd = optim.sgd(sched)
    sgd.update(g, sgd.init(p), p)
    assert torch.equal(p["w"], torch.ones(3))
    adam = optim.adam(sched)
    adam.update(g, adam.init(p), p)
    assert (p["w"] < 1).all()


def test_get_optimizer_names():
    assert set(optim.OPTIMIZERS) == set(jax_optim.OPTIMIZERS)
    assert optim.get_optimizer("adamw", 1e-3).name == "adamw"
    assert optim.adam(1e-3, weight_decay=0.1).name == "adamw"
    with pytest.raises(KeyError):
        optim.get_optimizer("lamb", 1e-3)
