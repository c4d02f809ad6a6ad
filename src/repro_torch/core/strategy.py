"""Data-parallel strategies: protocol + registry (port of
``repro.core.strategy``).

A gradient-sync strategy is one pluggable object.  Each
:class:`Strategy` owns

  * its **layout** (``layout(mesh, dp, model)`` -> ``Layout``) and
    **state construction** (``init(optimizer, model, mesh, dp)`` ->
    ``TrainState``);
  * its **step dataflow** -- for a replicated strategy ``grad_sync``
    (how the gradients are averaged) and ``weight_sync`` (the §3.3.2
    local-SGD mode); for a sharded one ``grad_sync`` (the loss and this
    worker's shard of the averaged gradient) and ``step_transform``
    (the optimizer update on the shard, and the params' resync);
  * its **perf-model entries** -- ``comm_time`` (the modeled wire time
    of a step), ``bucket_comm_time`` (of one overlap bucket) and
    ``memory_entry`` (per-rank persistent bytes; the rows
    ``perf_model.dp_memory_report`` assembles by ``memory_key``);
  * its **checkpoint identity** (``checkpoint_layout``, the meta.json
    record a restore resolves back through the registry).

``make_dp_train_step``, ``init_train_state`` and the ``Trainer`` facade
ask the registered strategy; to add one, subclass and
:func:`register_strategy` it.  Registered built-ins:

  flat / bucketed / hierarchical -- params and optimizer state
                                    replicated, gradients all-reduced;
  zero1 / zero2 / zero3          -- the ZeRO ladder: optimizer state,
                                    then gradients, then params sharded
                                    1/p a rank over the flat master
                                    vector (``core.flat``);
  zero1_hier / zero3_hier        -- the same over a (pod, data) mesh with
                                    two-level collectives: the cross-pod
                                    link carries 1/n_intra of the volume.

The step is eager: a sharded strategy runs its microbatches' forward
and backward into a flat gradient buffer (the masters' ``.grad`` are
views of it), reduce-scatters it -- bucket-pipelined through
``core.overlap`` under ``overlap=True`` / ``"serial"`` -- updates the
owned shard, and all-gathers the params back (zero1/zero2) or keeps
only the shard (zero3, which gathers the params per microbatch and
frees them after its backward).  The flat vector, and so each
gradient buffer bound to it, has the masters' dtype (bf16 masters: a
bf16 vector); gradients accumulate across microbatches in fp32, as the
reference's strategies accumulate them whatever ``grad_dtype`` says.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.core import flat as flat_lib
from repro_torch.core.collectives import (allreduce_mean, dp_batch_axes,
                                          dp_world_size, worker_index)
from repro_torch.core.overlap import (all_gather_flat, overlapped_allreduce,
                                      plan_local_shard, reduce_scatter_flat,
                                      whole_plan)
from repro_torch.core.perf_model import (TPU_DCN, TPU_V5E_ICI,
                                         allreduce_comm_time,
                                         hierarchical_comm_time,
                                         zero1_comm_time,
                                         zero1_hier_comm_time,
                                         zero2_comm_time, zero3_comm_time,
                                         zero3_hier_comm_time)
from repro_torch.core.train_state import (Layout, register_layout_kind,
                                          replicated_layout)
from repro_torch.train.step import TrainState, _split_micro, trainable


def _padded_shard(n_params, n_workers):
    if n_workers <= 1:
        return n_params
    return (n_params + (-n_params) % n_workers) // n_workers


class Strategy:
    """One pluggable data-parallel strategy (see module docstring).
    Subclass :class:`ReplicatedStrategy` (override ``grad_sync``) or
    :class:`ShardedStrategy` (override ``grad_sync`` /
    ``step_transform``), set ``name`` / ``kind`` and
    :func:`register_strategy` an instance."""
    name: str = ""
    kind: str = "replicated"        # Layout kind of the persistent state
    sharded: bool = False           # opt state (at least) sharded 1/p?
    params_sharded: bool = False    # params a flat 1/p shard (zero3)?
    memory_key: str = "replicated"  # row key in dp_memory_report

    # ---- layout / state construction ------------------------------------
    def dp_axes(self, mesh) -> tuple:
        """Mesh axes (and the worker numbering's order) the shards span."""
        return dp_batch_axes(mesh)

    def state_kind(self, dp) -> str:
        """Layout kind the train step expects of its input state."""
        return self.kind if (self.sharded and dp.sync == "grads") \
            else "replicated"

    def bucket_layout(self, dp) -> Optional[int]:
        """bucket_bytes of the persistent shards' bucket-major
        permutation, or None when they are contiguous."""
        return None

    def layout(self, mesh, dp, model) -> Layout:
        """The Layout this strategy's state uses on ``mesh``."""
        masters = trainable(model)
        if self.state_kind(dp) == "replicated":
            return replicated_layout(masters, mesh, self.name)
        n = dp_world_size(mesh)
        total = sum(p.numel() for p in masters.values())
        return Layout(self.kind, self.dp_axes(mesh), n, total,
                      total + (-total) % n, self.bucket_layout(dp),
                      strategy=self.name)

    def init(self, optimizer, model, mesh, dp) -> TrainState:
        """The TrainState the step consumes, over ``model``'s masters."""
        layout = self.layout(mesh, dp, model)
        if not layout.sharded:
            return TrainState(model, optimizer.init(trainable(model)), 0,
                              layout)
        return self._init_sharded(optimizer, model, mesh, dp, layout)

    def _init_sharded(self, optimizer, model, mesh, dp, layout):
        raise NotImplementedError(
            f"strategy {self.name!r} declares sharded state but does not "
            "implement _init_sharded")

    # ---- step dataflow ---------------------------------------------------
    def validate(self, dp, mesh):
        """Reject DPConfig / mesh combinations this strategy cannot run."""

    # ---- perf model --------------------------------------------------------
    @staticmethod
    def _ring_fabric(n_pods, fabric, inter):
        """A one-level ring spanning pods is bottlenecked by its slowest
        link: on a multi-pod mesh the whole volume crosses the pod link
        (the pod-aware strategies override ``comm_time``)."""
        return inter if (n_pods or 1) > 1 else fabric

    def comm_time(self, v_bytes, *, p=None, n_intra=None, n_pods=None,
                  microbatches=1, fabric=TPU_V5E_ICI, inter=TPU_DCN):
        """Modeled per-step wire time for ``v_bytes`` of gradients."""
        p = p if p is not None else (n_intra or 1) * (n_pods or 1)
        return allreduce_comm_time(
            v_bytes, p=p, fabric=self._ring_fabric(n_pods, fabric, inter))

    def bucket_comm_time(self, v_bytes, *, p, fabric=TPU_V5E_ICI):
        """Wire time for ONE overlap-scheduler bucket of ``v_bytes``."""
        return allreduce_comm_time(v_bytes, p=p, fabric=fabric)

    def memory_entry(self, n_params, state_factor, n_workers, *,
                     param_bytes=4, grad_bytes=4) -> dict:
        """Per-rank persistent bytes: params / grads / opt_state."""
        shard = _padded_shard(n_params, n_workers)
        p_n, g_n, o_n = self._persistent_elems(n_params, shard)
        return {"params": param_bytes * p_n, "grads": grad_bytes * g_n,
                "opt_state": 4.0 * state_factor * o_n}

    def _persistent_elems(self, n_params, shard):
        """(param, grad, opt) element counts per rank."""
        return n_params, n_params, n_params

    # ---- checkpointing ---------------------------------------------------
    def checkpoint_layout(self, layout: Layout) -> dict:
        """The meta.json record identifying this state."""
        d = layout.to_json()
        d["strategy"] = self.name
        return d


# --------------------------------------------------------------------------
# replicated strategies: flat / bucketed / hierarchical
# --------------------------------------------------------------------------

class ReplicatedStrategy(Strategy):
    """Params + optimizer state replicated per rank (the paper's per-rank
    model copies); subclasses choose the collective of
    ``repro_torch.core.collectives`` by name."""
    collective = "flat"

    def grad_sync(self, grads, mesh, dp):
        """Average the list ``grads`` over the DP axes, in place (bucket
        by bucket through ``core.overlap`` under ``dp.overlap``)."""
        if dp.overlap:
            return overlapped_allreduce(
                grads, mesh, strategy=self.collective,
                bucket_bytes=dp.bucket_bytes, compress=dp.compress,
                serialize=dp.overlap == "serial")
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

    def bucket_comm_time(self, v_bytes, *, p, fabric=TPU_V5E_ICI):
        raise ValueError(
            "hierarchical per-bucket wire time needs the pod split -- "
            "model it with perf_model.hierarchical_comm_time, not the "
            "single-fabric bucket scheduler formula")

    def comm_time(self, v_bytes, *, p=None, n_intra=None, n_pods=None,
                  microbatches=1, fabric=TPU_V5E_ICI, inter=TPU_DCN):
        if n_intra is None:
            return allreduce_comm_time(v_bytes, p=p or 1, fabric=fabric)
        return hierarchical_comm_time(v_bytes, n_intra=n_intra,
                                      n_pods=n_pods or 1, intra=fabric,
                                      inter=inter)


# --------------------------------------------------------------------------
# sharded strategies: the ZeRO ladder (+ the two-level pod x data pair)
# --------------------------------------------------------------------------

def _backward(loss_fn, model, batch):
    loss, _ = loss_fn(model, batch)
    loss.backward()
    return loss.detach()


def _micro(batch, n):
    if n == 1:
        return [batch]
    micro = _split_micro(batch, n)
    return [{k: v[i] for k, v in micro.items()} for i in range(n)]


class ShardedStrategy(Strategy):
    """State sharded 1/p a rank over the flat master vector
    (``core.flat``).  The data-parallel step asks two hooks:

      * ``grad_sync(loss_fn, state, batch, mesh, dp, timed)`` ->
        ``(loss, gshard)`` -- this worker's shard of the averaged
        gradient (contiguous, or bucket-major under the layout's plan);
      * ``step_transform(optimizer, gshard, state, mesh, dp, timed)`` --
        the optimizer update of the owned shard, in place, plus the
        params' resync the layout needs.

    ``timed(label)`` is a context that times one collective.
    """
    sharded = True

    def validate(self, dp, mesh):
        if dp.sync != "grads":
            raise ValueError(f"strategy={self.name!r} requires sync='grads'")

    def bucket_layout(self, dp) -> Optional[int]:
        return dp.bucket_bytes if dp.overlap else None

    def _init_sharded(self, optimizer, model, mesh, dp, layout):
        """The masters become views of a new flat vector in the
        reference's order, of the masters' dtype (the reference's
        ``result_type`` of the leaves: fp32, or bf16 for bf16 masters);
        the optimizer state (fp32) is built over this worker's shard
        only.  zero3 keeps the shard and frees the vector's storage, so
        after ``init`` no tensor of the state is larger than the
        shard."""
        masters = trainable(model)
        if not masters:
            raise ValueError("init_train_state: empty param tree")
        dtype = flat_lib.flat_dtype(masters)
        spec = flat_lib.flat_spec(model, masters)
        if self.params_sharded:
            layout = dataclasses.replace(
                layout, param_spec=spec, param_dtypes=tuple(
                    str(masters[n].dtype).removeprefix("torch.")
                    for n in spec.names))
        dev = next(iter(masters.values())).device
        full = torch.zeros(layout.padded_total, dtype=dtype, device=dev)
        flat_lib.gather_into(spec, masters, full)
        flat_lib.bind_masters(spec, masters, full)
        fm = flat_lib.FlatMasters(spec, full, worker_index(mesh, layout.axes))
        pshard = self.owned_shard(full, fm.worker, layout)
        opt_state = optimizer.init({"flat": pshard})
        if self.params_sharded:
            fm.shard = pshard
            fm.free()
        return TrainState(model, opt_state, 0, layout, fm)

    @staticmethod
    def owned_shard(full, w, layout):
        """A copy of worker ``w``'s shard of the padded vector ``full``
        (``local_shard``, or ``plan_local_shard`` for bucket-major)."""
        n = layout.num_shards
        plan = layout.plan()
        if plan is not None:
            return plan_local_shard(full, w, n, plan)
        per = layout.shard_len
        return full[w * per:(w + 1) * per].clone()

    @staticmethod
    def _plan(layout):
        return layout.plan() or whole_plan(layout.padded_total,
                                           layout.num_shards)

    # ---- step hooks ------------------------------------------------------
    def grad_sync(self, loss_fn, state, batch, mesh, dp, timed):
        raise NotImplementedError

    def step_transform(self, optimizer, gshard, state, mesh, dp, timed):
        """Default (replicated-params layouts): update only the owned
        param shard -- the moments never exist beyond 1/p -- then
        all-gather the updated params into the master vector."""
        layout, fm = state.layout, state.flat
        pshard = self.owned_shard(fm.full, fm.worker, layout)
        optimizer.update({"flat": gshard}, state.opt_state,
                         {"flat": pshard})
        with timed("all_gather"):
            all_gather_flat(pshard, mesh, layout.axes, self._plan(layout),
                            out=fm.full, serialize=dp.overlap == "serial")

    def _accumulate_flat(self, loss_fn, state, batch, n, gbuf):
        """The loss of ``batch`` and its gradient accumulated into
        ``gbuf`` over ``n`` microbatches, then scaled by 1/n (the
        reference's ``_accumulate``).  A ``gbuf`` of the masters' dtype
        takes the backward in place; a wider one (fp32 under bf16
        masters) sums each microbatch's gradient, taken into a buffer of
        the masters' dtype."""
        masters = trainable(state.params)
        direct = gbuf.dtype == state.flat.full.dtype
        mbuf = gbuf if direct else torch.zeros_like(
            gbuf, dtype=state.flat.full.dtype)
        flat_lib.bind_grads(state.flat.spec, masters, mbuf)
        for i, mb in enumerate(_micro(batch, n)):
            if i and not direct:
                mbuf.zero_()
            lm = _backward(loss_fn, state.params, mb)
            loss = lm if i == 0 else loss + lm
            if not direct:
                gbuf.add_(mbuf)
        if n > 1:
            gbuf.mul_(1.0 / n)
            loss = loss * (1.0 / n)
        flat_lib.unbind_grads(masters)
        return loss

    def _accumulate_then_scatter(self, loss_fn, state, batch, mesh, dp,
                                 timed):
        """Classic ZeRO-1 (and the single-microbatch zero2): accumulate
        the full gradient, reduce-scatter it ONCE.  One microbatch's
        gradient keeps the masters' dtype; microbatches sum in fp32 (the
        reference's ``_accumulate``)."""
        layout, full = state.layout, state.flat.full
        g = torch.zeros(layout.padded_total, device=full.device,
                        dtype=full.dtype if dp.microbatches == 1
                        else torch.float32)
        loss = self._accumulate_flat(loss_fn, state, batch,
                                     dp.microbatches, g)
        with timed("reduce_scatter"):
            gshard = reduce_scatter_flat(
                g, mesh, layout.axes, self._plan(layout),
                compress=dp.compress, serialize=dp.overlap == "serial")
        return loss, gshard


class Zero1Strategy(ShardedStrategy):
    """Sharded optimizer state: the allreduce splits into its
    reduce-scatter and all-gather halves, and the optimizer updates only
    the owned 1/p shard between them.  Same wire volume as a ring
    allreduce; optimizer memory drops to 1/p."""
    name = "zero1"
    kind = "zero1"
    memory_key = "zero1"

    def grad_sync(self, loss_fn, state, batch, mesh, dp, timed):
        return self._accumulate_then_scatter(loss_fn, state, batch, mesh,
                                             dp, timed)

    def comm_time(self, v_bytes, *, p=None, n_intra=None, n_pods=None,
                  microbatches=1, fabric=TPU_V5E_ICI, inter=TPU_DCN):
        p = p if p is not None else (n_intra or 1) * (n_pods or 1)
        return zero1_comm_time(
            v_bytes, p=p, fabric=self._ring_fabric(n_pods, fabric, inter))

    def bucket_comm_time(self, v_bytes, *, p, fabric=TPU_V5E_ICI):
        return zero1_comm_time(v_bytes, p=p, fabric=fabric)

    def _persistent_elems(self, n_params, shard):
        return n_params, n_params, shard


class Zero2Strategy(Zero1Strategy):
    """Additionally the gradient SHARD is the only gradient that
    persists: each microbatch's gradient is reduce-scattered as soon as
    its backward ends and only the 1/p shard accumulates.  With
    ``overlap=True`` microbatch k's reduce-scatter is issued async and
    runs while microbatch k+1's backward fills a second buffer."""
    name = "zero2"
    kind = "zero2"
    memory_key = "zero2"

    def bucket_layout(self, dp) -> Optional[int]:
        # the per-microbatch reduce-scatters stay contiguous; only the
        # single-microbatch case shares zero1's bucketed tail
        if dp.microbatches > 1:
            return None
        return super().bucket_layout(dp)

    def grad_sync(self, loss_fn, state, batch, mesh, dp, timed):
        if dp.microbatches == 1:
            return self._accumulate_then_scatter(loss_fn, state, batch,
                                                 mesh, dp, timed)
        layout, fm = state.layout, state.flat
        masters = trainable(state.params)
        plan, dev = self._plan(layout), fm.full.device
        overlap = dp.overlap is True
        bufs = [torch.zeros(layout.padded_total, dtype=fm.full.dtype,
                            device=dev) for _ in range(2 if overlap else 1)]
        acc = torch.zeros(layout.shard_len, dtype=torch.float32, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        pending = None
        for i, mb in enumerate(_micro(batch, dp.microbatches)):
            buf = bufs[i % len(bufs)]
            if i >= len(bufs):
                buf.zero_()
            flat_lib.bind_grads(fm.spec, masters, buf)
            loss = loss + _backward(loss_fn, state.params, mb)
            if overlap:
                # the previous microbatch's reduce-scatter ran behind
                # this backward; wait for it, then issue this one's
                if pending is not None:
                    with timed("reduce_scatter"):
                        acc.add_(pending())
                pending = reduce_scatter_flat(
                    buf, mesh, layout.axes, plan, compress=dp.compress,
                    async_op=True)
            else:
                with timed("reduce_scatter"):
                    acc.add_(reduce_scatter_flat(buf, mesh, layout.axes,
                                                 plan, compress=dp.compress))
        if pending is not None:
            with timed("reduce_scatter"):
                acc.add_(pending())
        flat_lib.unbind_grads(masters)
        inv = 1.0 / dp.microbatches
        return loss * inv, acc.mul_(inv)

    def comm_time(self, v_bytes, *, p=None, n_intra=None, n_pods=None,
                  microbatches=1, fabric=TPU_V5E_ICI, inter=TPU_DCN):
        p = p if p is not None else (n_intra or 1) * (n_pods or 1)
        return zero2_comm_time(
            v_bytes, p=p, microbatches=microbatches,
            fabric=self._ring_fabric(n_pods, fabric, inter))

    def _persistent_elems(self, n_params, shard):
        return n_params, shard, shard


class Zero3Strategy(ShardedStrategy):
    """Params themselves live sharded between steps: each microbatch
    all-gathers the flat vector (bucket-pipelined under the plan) into
    the storage the masters are views of, runs its forward and backward,
    frees that storage, and reduce-scatters its flat gradient straight
    onto the shard -- params, grads and optimizer state are all 1/p a
    rank between steps."""
    name = "zero3"
    kind = "zero3"
    memory_key = "zero3"
    params_sharded = True

    def gather_params(self, state, mesh, dp, timed=None):
        """All-gather the param shards into the master vector (its
        storage re-grown), so the masters hold the full params; undone
        by ``state.flat.free()``."""
        fm, layout = state.flat, state.layout
        fm.regrow()
        with (timed or contextlib.nullcontext)("all_gather"):
            all_gather_flat(fm.shard, mesh, layout.axes, self._plan(layout),
                            out=fm.full, compress=dp.compress,
                            serialize=dp.overlap == "serial")

    def grad_sync(self, loss_fn, state, batch, mesh, dp, timed):
        layout, fm = state.layout, state.flat
        masters = trainable(state.params)
        n_micro = dp.microbatches
        loss = torch.zeros((), dtype=torch.float32, device=fm.shard.device)
        acc = None
        for mb in _micro(batch, n_micro):
            self.gather_params(state, mesh, dp, timed)
            g = torch.zeros(layout.padded_total, dtype=fm.shard.dtype,
                            device=fm.shard.device)
            flat_lib.bind_grads(fm.spec, masters, g)
            lm = _backward(loss_fn, state.params, mb)
            loss = lm if n_micro == 1 else loss + lm
            flat_lib.unbind_grads(masters)
            fm.free()
            with timed("reduce_scatter"):
                sh = reduce_scatter_flat(
                    g, mesh, layout.axes, self._plan(layout), mean=False,
                    compress=dp.compress, serialize=dp.overlap == "serial")
            del g
            # the shard's sum sits in the masters' dtype; it accumulates
            # in fp32, as the reference's cotangent does
            acc = sh.float() if acc is None else acc.add_(sh)
        n = layout.num_shards
        if n_micro == 1:
            return loss, acc.div_(n)
        inv = 1.0 / n_micro
        return loss * inv, acc.mul_(inv).div_(n)

    def step_transform(self, optimizer, gshard, state, mesh, dp, timed):
        optimizer.update({"flat": gshard}, state.opt_state,
                         {"flat": state.flat.shard})

    def comm_time(self, v_bytes, *, p=None, n_intra=None, n_pods=None,
                  microbatches=1, fabric=TPU_V5E_ICI, inter=TPU_DCN):
        p = p if p is not None else (n_intra or 1) * (n_pods or 1)
        return zero3_comm_time(
            v_bytes, p=p, microbatches=microbatches,
            fabric=self._ring_fabric(n_pods, fabric, inter))

    def bucket_comm_time(self, v_bytes, *, p, fabric=TPU_V5E_ICI):
        return zero3_comm_time(v_bytes, p=p, fabric=fabric)

    def _persistent_elems(self, n_params, shard):
        return shard, shard, shard


def _hier_axes(mesh) -> tuple:
    axes = dp_batch_axes(mesh)
    return (axes[1], axes[0]) if len(axes) == 2 else axes


class Zero1HierStrategy(Zero1Strategy):
    """Two-level ZeRO-1 for a (pod, data) mesh: the gradient
    reduce-scatter runs inside the pod first, then on the 1/n_intra
    piece across pods; the updated params come back the inverse way
    (the small cross-pod gather first).  The optimizer state is sharded
    over all pod x data workers, and the cross-pod link never carries
    more than 1/n_intra of the volume.  Workers are numbered
    intra-major (``dp_axes`` is ``("data", "pod")``), which lands each
    worker on its contiguous slice, so states and checkpoints need no
    special casing; on a one-axis mesh it is plain zero1."""
    name = "zero1_hier"
    kind = "zero1_hier"
    memory_key = "zero1_hier"

    def dp_axes(self, mesh) -> tuple:
        return _hier_axes(mesh)

    def bucket_comm_time(self, v_bytes, *, p=None, fabric=TPU_V5E_ICI,
                         n_intra=None, n_pods=None, inter=TPU_DCN):
        if n_intra is None:
            return zero1_comm_time(v_bytes, p=p or 1, fabric=fabric)
        return zero1_hier_comm_time(v_bytes, n_intra=n_intra,
                                    n_pods=n_pods or 1, intra=fabric,
                                    inter=inter)

    def comm_time(self, v_bytes, *, p=None, n_intra=None, n_pods=None,
                  microbatches=1, fabric=TPU_V5E_ICI, inter=TPU_DCN):
        if n_intra is None:
            return zero1_comm_time(v_bytes, p=p or 1, fabric=fabric)
        return zero1_hier_comm_time(v_bytes, n_intra=n_intra,
                                    n_pods=n_pods or 1, intra=fabric,
                                    inter=inter)


class Zero3HierStrategy(Zero3Strategy):
    """Two-level ZeRO-3: params, grads and optimizer state all 1/p, and
    both wires of the per-microbatch param gather staged -- the small
    cross-pod gather first, then the intra-pod one; the gradient
    reduce-scatter inside the pod first.  zero1_hier's worker
    numbering; on a one-axis mesh it is plain zero3."""
    name = "zero3_hier"
    kind = "zero3_hier"
    memory_key = "zero3"                    # zero3's 1/p residency

    def dp_axes(self, mesh) -> tuple:
        return _hier_axes(mesh)

    def comm_time(self, v_bytes, *, p=None, n_intra=None, n_pods=None,
                  microbatches=1, fabric=TPU_V5E_ICI, inter=TPU_DCN):
        if n_intra is None:
            return zero3_comm_time(v_bytes, p=p or 1,
                                   microbatches=microbatches, fabric=fabric)
        return zero3_hier_comm_time(v_bytes, n_intra=n_intra,
                                    n_pods=n_pods or 1,
                                    microbatches=microbatches,
                                    intra=fabric, inter=inter)

    def bucket_comm_time(self, v_bytes, *, p=None, fabric=TPU_V5E_ICI,
                         n_intra=None, n_pods=None, inter=TPU_DCN):
        if n_intra is None:
            return zero3_comm_time(v_bytes, p=p or 1, fabric=fabric)
        return zero3_hier_comm_time(v_bytes, n_intra=n_intra,
                                    n_pods=n_pods or 1, intra=fabric,
                                    inter=inter)


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
    register_layout_kind(strategy.kind, sharded=strategy.sharded)
    _REGISTRY[name] = strategy
    return strategy


def available_strategies() -> tuple:
    """Registered strategy names, registration order."""
    return tuple(_REGISTRY)


def get_strategy(name) -> Strategy:
    """Resolve a strategy by registry name (or pass an instance
    through); unknown names raise, listing every registered name."""
    if isinstance(name, Strategy):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(
        f"unknown strategy {name!r}; registered strategies: "
        f"{list(available_strategies())}.  Register custom strategies via "
        "repro_torch.core.strategy.register_strategy(...)")


def memory_rows(n_params, state_factor, n_workers, *, param_bytes=4,
                grad_bytes=4):
    """(memory_key, entry) rows for ``perf_model.dp_memory_report`` --
    one row per distinct ``memory_key`` across the registry (the
    replicated strategies share one row), registration order."""
    seen = set()
    rows = []
    for strategy in _REGISTRY.values():
        key = strategy.memory_key
        if key in seen:
            continue
        seen.add(key)
        rows.append((key, strategy.memory_entry(
            n_params, state_factor, n_workers, param_bytes=param_bytes,
            grad_bytes=grad_bytes)))
    return rows


register_strategy(FlatStrategy())
register_strategy(BucketedStrategy())
register_strategy(HierarchicalStrategy())
register_strategy(Zero1Strategy())
register_strategy(Zero2Strategy())
register_strategy(Zero3Strategy())
register_strategy(Zero1HierStrategy())
register_strategy(Zero3HierStrategy())
