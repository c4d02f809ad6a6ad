"""The port's asynchronous parameter server (``repro_torch.core.
make_ps_trainer``), the paper's rejected alternative, against the
reference's ``repro.core.param_server`` on the CPU: a twin of
``tests/test_data_parallel.py``'s async-vs-sync test, tick-by-tick
parity on the same numpy data, and a check that the workers' snapshots
are copies of the server's tensors and never views (a view would make
every gradient fresh: synchronous SGD)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.core.param_server import make_ps_trainer as ref_ps
from repro_torch import optim
from repro_torch.core import make_ps_trainer

TICKS, WORKERS, LR = 64, 8, 0.05


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(16).astype(np.float32)
    X = rng.standard_normal((256, 16)).astype(np.float32)
    y = (X @ w_true).astype(np.float32)
    return X, y


def _loss(p, b):
    xb, yb = b
    return torch.mean((xb @ p["w"] - yb) ** 2)


def _ref_loss(p, b):
    xb, yb = b
    return jnp.mean((xb @ p["w"] - yb) ** 2)


def _port_run(X, y, workers=WORKERS):
    params = {"w": torch.zeros(16)}
    opt = optim.sgd(LR)
    batches = (X.reshape(TICKS, 4, 16), y.reshape(TICKS, 4))
    run = make_ps_trainer(_loss, opt, num_workers=workers)
    return run(params, opt.init(params), batches)


def test_ps_baseline_converges_slower_or_equal():
    """Twin of the reference's test: async PS learns, and sync SGD over
    the same stream is at least as good."""
    X, y = _problem()
    p_ps, _, losses = _port_run(X, y)
    assert losses.shape == (TICKS,)
    p_sq = {"w": torch.zeros(16)}
    opt = optim.sgd(LR)
    s_sq = opt.init(p_sq)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    for i in range(TICKS):
        p = {"w": p_sq["w"].clone().requires_grad_(True)}
        (g,) = torch.autograd.grad(_loss(p, (Xt[4 * i:4 * i + 4],
                                             yt[4 * i:4 * i + 4])), [p["w"]])
        opt.update({"w": g}, s_sq, p_sq)
    l_ps = float(_loss(p_ps, (Xt, yt)))
    l_sq = float(_loss(p_sq, (Xt, yt)))
    assert l_ps < float(losses[0])
    assert l_sq <= l_ps * 1.5 + 1e-3
    # staleness changes the trajectory: a view-aliased snapshot would
    # have made the two runs equal
    assert not torch.allclose(p_ps["w"], p_sq["w"])


@pytest.mark.parametrize("workers", [1, 3, WORKERS])
def test_ps_matches_reference_tick_by_tick(workers):
    X, y = _problem(1)
    p_ps, _, losses = _port_run(X, y, workers)
    params = {"w": jnp.zeros((16,), jnp.float32)}
    opt = ref_optim.sgd(LR)
    batches = (jnp.asarray(X.reshape(TICKS, 4, 16)),
               jnp.asarray(y.reshape(TICKS, 4)))
    p_ref, st_ref, l_ref = ref_ps(_ref_loss, opt, workers)(
        params, opt.init(params), batches)
    np.testing.assert_allclose(losses.numpy(), np.asarray(l_ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(p_ps["w"].numpy(), np.asarray(p_ref["w"]),
                               rtol=1e-6, atol=1e-6)


def test_ps_snapshots_are_copies_not_views():
    X, y = _problem(2)
    server = {"w": torch.zeros(16)}
    seen = []

    def spy(p, b):
        seen.append(p["w"])
        return _loss(p, b)

    opt = optim.sgd(LR)
    run = make_ps_trainer(spy, opt, num_workers=4)
    run(server, opt.init(server), (X.reshape(TICKS, 4, 16)[:8],
                                   y.reshape(TICKS, 4)[:8]))
    base = server["w"].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() != base for t in seen)
    # the four first ticks read the initial params, although the server
    # moved after the first of them
    for t in seen[1:4]:
        assert torch.equal(t.detach(), seen[0].detach())
    assert not torch.equal(seen[4].detach(), seen[0].detach())
