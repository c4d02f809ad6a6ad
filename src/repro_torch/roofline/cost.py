"""Cost counts of an eager step: FLOPs, dot bytes, collectives, memory.

The port's counterpart of ``repro.roofline.hlocost`` and of the
reference dry run's HLO collective walk.  The port has no HLO: a step
is counted by running it -- on the meta device, where every op computes
shapes and nothing else -- under dispatch modes that see each op:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s formulas
    (its ``flop_registry``: the matmul family -- mm, bmm, addmm, baddbmm,
    convolutions, SDPA -- at 2 FLOPs a multiply-add, as the reference's
    walker counts ``dot_general``s), applied in this module's own
    dispatch mode: ``FlopCounterMode`` itself decomposes every other op
    into primitives first, which on the meta device more than triples
    a step's time;
  * dot bytes: the operand and output bytes of each op of that family,
    the reference's "no-fusion-reuse upper bound" on dot traffic;
  * collectives: the output bytes of each c10d collective (the moved
    volume's proxy the reference takes from the HLO op's output shape),
    under the reference's kind names;
  * memory: the bytes of the live tensor storages, each rounded up to
    the CUDA caching allocator's 512-byte block, and their peak.

An eager loop runs every trip, so there are no loop trip counts to
recover: ``unresolved_loops`` is always 0.  A kernel whose meta form
returns empty outputs (``kernels.flash_attention``, ``kernels.wkv6``,
``kernels.mamba_scan``) adds its FLOPs and bytes by formula through
``add_kernel_cost``; outside a count that is a no-op.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

ALLOC_BLOCK = 512      # the caching allocator's smallest block, bytes

# c10d / functional collective ops -> the reference's kind names
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}

_ACTIVE: list = []     # the counts running, innermost last
_DOT_OPS = frozenset(flop_registry)


def add_kernel_cost(flops: float, dot_bytes: float) -> None:
    """Charge a kernel's FLOPs and dot bytes to every count running (a
    kernel wrapper's meta form, whose outputs are empty)."""
    for c in _ACTIVE:
        c.flops += flops
        c.dot_bytes += dot_bytes


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()


def _storages(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    try:
        return [t.untyped_storage()]
    except (RuntimeError, NotImplementedError):
        return []


def _rounded(n: int) -> int:
    return math.ceil(n / ALLOC_BLOCK) * ALLOC_BLOCK if n else 0


class _Count(TorchDispatchMode):
    """One pass of a step: FLOPs, dot bytes, collective bytes by kind and
    the live storage bytes with their peak."""

    def __init__(self, track_memory=True):
        super().__init__()
        self.flops = 0
        self.dot_bytes = 0.0
        self.collectives: dict = {}
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0
        self._seen = {}            # id(storage) -> (weakref, bytes)

    # ---- memory ----
    def track(self, t) -> int:
        """Count ``t``'s storage as live (once) until it is freed; the
        bytes newly counted."""
        added = 0
        for st in _storages(t):
            key = id(st)
            if key in self._seen and self._seen[key][0]() is st:
                continue
            n = _rounded(st.nbytes())

            def freed(_, key=key, n=n):
                if key in self._seen:
                    del self._seen[key]
                    self.live -= n
            self._seen[key] = (weakref.ref(st, freed), n)
            self.live += n
            added += n
        self.peak = max(self.peak, self.live)
        return added

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pkt = func._overloadpacket
        if pkt in _DOT_OPS:
            self.flops += flop_registry[pkt](*args, **kwargs, out_val=out)
            self.dot_bytes += sum(_nbytes(t) for t in _tensors((args,
                                                                kwargs)))
            self.dot_bytes += sum(_nbytes(t) for t in _tensors(out))
        ns, _, op = func.name().partition("::")
        kind = COLLECTIVE_KINDS.get(op.split(".")[0])
        if ns in ("c10d", "_c10d_functional") and kind:
            self.collectives[kind] = (self.collectives.get(kind, 0)
                                      + self._moved(ns, args, out))
        if self.track_memory:
            for t in _tensors(out):
                self.track(t)
        return out

    @staticmethod
    def _moved(ns, args, out) -> int:
        """The output bytes of a collective: a c10d op writes its first
        argument in place (the output tensors; an all-reduce's inputs),
        a functional one returns its output."""
        return sum(_nbytes(t) for t in _tensors(args[0] if ns == "c10d"
                                                else out))


def count(fn, *args, track_memory=True):
    """Run ``fn(*args)`` once under the counts.  Returns (fn's result,
    {"flops", "dot_bytes", "unresolved_loops", "collective_bytes",
    "argument_bytes", "output_bytes", "peak_bytes",
    "argument_bytes_held"}): the argument bytes are those of the
    distinct storages of the tensors in ``args`` (an ``nn.Module`` by its
    parameters and buffers, DTensors by their local blocks), the output
    bytes those of the tensors in the result that the arguments did not
    hold; the peak is that of the live storages over the run, the
    arguments included, each storage rounded up to ``ALLOC_BLOCK`` as
    the card's allocator rounds it (``argument_bytes_held`` the
    arguments' share, so rounded)."""
    c = _Count(track_memory=track_memory)
    held = {}
    for t in _tensors(list(args)):
        for st in _storages(t):
            held[id(st)] = st.nbytes()
        if track_memory:
            c.track(t)
    arg_bytes = sum(held.values())
    held_rounded = sum(_rounded(n) for n in held.values())
    _ACTIVE.append(c)
    try:
        with c:
            out = fn(*args)
    finally:
        _ACTIVE.remove(c)
    out_bytes = sum(_rounded(st.nbytes()) for t in _tensors(out)
                    for st in _storages(t) if id(st) not in held)
    return out, {"flops": float(c.flops),
                 "dot_bytes": float(c.dot_bytes),
                 "unresolved_loops": 0,
                 "collective_bytes": dict(sorted(c.collectives.items())),
                 "argument_bytes": int(arg_bytes),
                 "argument_bytes_held": int(held_rounded),
                 "output_bytes": int(out_bytes),
                 "peak_bytes": int(c.peak)}


def step_cost(fn, *args) -> dict:
    """{"flops", "dot_bytes", "unresolved_loops": 0} of ``fn(*args)``:
    the twin of ``stablehlo_cost`` of a lowered step."""
    _, c = count(fn, *args, track_memory=False)
    return {k: c[k] for k in ("flops", "dot_bytes", "unresolved_loops")}


def collective_bytes(fn, *args) -> dict:
    """{kind: bytes} of the collectives ``fn(*args)`` runs (the output
    bytes of each, every trip of a loop counted): the twin of
    ``collective_bytes_from_hlo``."""
    _, c = count(fn, *args, track_memory=False)
    return c["collective_bytes"]
