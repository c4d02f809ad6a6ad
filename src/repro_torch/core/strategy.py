"""Data-parallel strategies: protocol + registry (port of
``repro.core.strategy`` for the replicated strategies).

A gradient-sync strategy is one pluggable object.  Each
:class:`Strategy` owns its step dataflow -- ``grad_sync`` (how the
gradients are averaged) and ``weight_sync`` (how the weights are, in
the §3.3.2 local-SGD mode) -- its ``validate`` check of a ``DPConfig``
and mesh, and its perf-model ``memory_entry``.  ``make_dp_train_step``
and the ``Trainer`` facade ask the registered strategy; to add one,
subclass and :func:`register_strategy` it.

Registered built-ins, all with params and optimizer state replicated
per rank (the paper's per-rank model copies): ``flat``, ``bucketed``,
``hierarchical``.  The ZeRO ladder (``zero1``, ``zero2``, ``zero3``,
``zero1_hier``, ``zero3_hier``) waits for ROADMAP A.4: asking for it
raises by name.  The modeled wire time (``comm_time``) waits for the
perf model (ROADMAP A.10).
"""
from __future__ import annotations

from repro_torch.core.collectives import allreduce_mean

# the reference's sharded strategies, not ported yet
ZERO_STRATEGIES = ("zero1", "zero2", "zero3", "zero1_hier", "zero3_hier")


class Strategy:
    """One pluggable data-parallel strategy (see module docstring).
    Subclass :class:`ReplicatedStrategy` (override ``grad_sync``), set
    ``name`` and :func:`register_strategy` an instance."""
    name: str = ""

    def validate(self, dp, mesh):
        """Reject DPConfig / mesh combinations this strategy cannot run."""

    def memory_entry(self, n_params, state_factor, n_workers, *,
                     param_bytes=4, grad_bytes=4) -> dict:
        """Per-device persistent bytes: params / grads / opt_state (a
        replicated strategy holds all of each on every rank, whatever
        ``n_workers``)."""
        return {"params": param_bytes * n_params,
                "grads": grad_bytes * n_params,
                "opt_state": 4.0 * state_factor * n_params}


class ReplicatedStrategy(Strategy):
    """Params + optimizer state replicated per rank; subclasses choose
    the collective of ``repro_torch.core.collectives`` by name."""
    collective = "flat"

    def grad_sync(self, grads, mesh, dp):
        """Average the list ``grads`` over the DP axes, in place."""
        return allreduce_mean(grads, mesh, strategy=self.collective,
                              compress=dp.compress,
                              bucket_bytes=dp.bucket_bytes)

    def weight_sync(self, params, mesh, dp):
        """Average the list ``params`` (sync="weights"), in place."""
        return allreduce_mean(params, mesh, strategy=self.collective,
                              compress=dp.compress,
                              bucket_bytes=dp.bucket_bytes)


class FlatStrategy(ReplicatedStrategy):
    """One all-reduce per tensor -- the paper's MPI_Allreduce per
    gradient."""
    name = "flat"
    collective = "flat"


class BucketedStrategy(ReplicatedStrategy):
    """Tensors fused into ~bucket_bytes 1-D buckets (tensor fusion)."""
    name = "bucketed"
    collective = "bucketed"


class HierarchicalStrategy(ReplicatedStrategy):
    """Two-stage pod-aware allreduce: reduce-scatter inside a pod,
    all-reduce the 1/n shard across pods, all-gather inside the pod."""
    name = "hierarchical"
    collective = "hierarchical"


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

_REGISTRY: "dict[str, Strategy]" = {}


def register_strategy(strategy: Strategy, *, overwrite: bool = False):
    """Register a Strategy instance under ``strategy.name``.  Duplicate
    names raise unless ``overwrite=True``.  Returns the strategy."""
    if not isinstance(strategy, Strategy):
        raise TypeError(f"register_strategy takes a Strategy instance, "
                        f"got {type(strategy).__name__}")
    name = strategy.name
    if not name or not isinstance(name, str):
        raise ValueError(f"strategy name must be a non-empty str, "
                         f"got {name!r}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"strategy {name!r} is already registered "
            f"({type(_REGISTRY[name]).__name__}); pass overwrite=True to "
            "replace it")
    _REGISTRY[name] = strategy
    return strategy


def available_strategies() -> tuple:
    """Registered strategy names, registration order."""
    return tuple(_REGISTRY)


def get_strategy(name) -> Strategy:
    """Resolve a strategy by registry name (or pass an instance
    through).  The ZeRO strategies raise naming ROADMAP A.4; unknown
    names raise, listing every registered name."""
    if isinstance(name, Strategy):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in ZERO_STRATEGIES:
        raise ValueError(
            f"strategy {name!r} (sharded optimizer state, gradients or "
            "params) is not ported yet: it waits for ROADMAP A.4; the port "
            f"runs {list(available_strategies())}")
    raise ValueError(
        f"unknown strategy {name!r}; registered strategies: "
        f"{list(available_strategies())}.  Register custom strategies via "
        "repro_torch.core.strategy.register_strategy(...)")


register_strategy(FlatStrategy())
register_strategy(BucketedStrategy())
register_strategy(HierarchicalStrategy())
