"""Step-addressable checkpointing (port of ``repro.checkpoint.store``).

This is the restart half of the paper's fault-tolerance story (§2.2 /
§3.1): ULFM lets the MPI job survive a rank failure because the model
state is replicated under data parallelism; recovery = reload the last
consistent state and continue.

The on-disk format is the reference's, so a checkpoint either package
writes restores in the other:

* ``save_checkpoint`` / ``restore_checkpoint`` -- the legacy path: a
  loose tree written as one flat ``step_%010d.npz`` keyed by pytree
  path (the full-config launcher writes ``(params, opt_state)``, keys
  ``0/...`` and ``1/...``);
* ``save_sharded_checkpoint`` / ``restore_sharded_checkpoint`` -- the
  ``TrainState`` path: a ``step_%010d.shards`` directory of
  ``meta.json`` (the ``Layout``, each leaf's shape, dtype and
  ``sharded``, and ``extra``), ``replicated.npz`` and, for a ZeRO
  state, one ``worker_%05d.npz`` per worker holding its shard of each
  flat leaf (``opt_state/m/flat``, and ``params`` for zero3) -- written
  as-is, no gather.  A restore into the same layout reads its own
  worker file; into any other (replicated <-> zero1 <-> zero2 <->
  zero3 <-> the hier kinds, contiguous <-> bucket-major, any two world
  sizes) it reshards on the host through the canonical flat vector.

Keys are the reference's pytree paths (``params/decoder/blocks/layer0/
mixer/wq`` stacked on ``n_rep``, ``opt_state/m/...``, ``opt_state/step``
and ``step`` as int32), mapped from the port's parameter names by
``bridge.named_to_numpy``.  Leaves are written in the reference's
flatten order -- dict keys sorted at every level, lists by index --
in ``meta["leaves"]`` and in the npz: the reference reads a checkpoint
of another layout by ORDER (it concatenates the ``params/`` leaves in
manifest order and splits them in its template's), so another order
would restore scrambled weights there without an error.  The port
itself reads every leaf by key.

bf16 masters are written as the fp32 arrays of their values
(``bridge.host_copy``; ``meta.json`` records float32) and restored
into any template by a cast, bitwise, since bf16 -> fp32 -> bf16 is
exact.  The reference writes its bf16 arrays as they are, which numpy
stores as the void dtype ``|V2``; the port reads such members back as
the fp32 values they encode.

All writers are atomic: everything lands under a ``tmp-`` prefix first
and is published with one ``os.replace``, and ``latest_step`` refuses
to match anything but a fully-published name -- a killed worker can
never leave a truncated checkpoint that a restart then picks up.

Under ``torch.distributed`` a replicated state (one built on a mesh,
``layout.axes`` non-empty) is written by rank 0 only.  A sharded state
is written by every rank (its own worker file) into the save's staging
directory, and rank 0 publishes once every worker's file is complete.
A synchronous save ends at a barrier, so every rank returns after the
publish.  Restores read on every rank.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import re
import shutil
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.core.flat import flat_spec
from repro_torch.core.train_state import (Layout, assemble_full_flat,
                                          split_flat_shards)
from repro_torch.train.step import trainable

_STEP_FILE_RE = re.compile(r"step_(\d+)\.npz")
_STEP_DIR_RE = re.compile(r"step_(\d+)\.shards")
_TMP_STEP_RE = re.compile(r"tmp-step_(\d+)")
# how long the publishing rank waits for the other ranks' worker files
PUBLISH_TIMEOUT_S = 600.0


class CorruptCheckpointError(ValueError):
    """A published checkpoint's file content is unreadable (torn write,
    bit rot, truncation).  Carries the offending file's name so the
    operator knows WHICH shard to investigate; the elastic resize
    driver catches this and falls back to the previous published step."""


def _load_npz(path, prefix: str = "") -> dict:
    """Eagerly load every member of an npz (whose key starts with
    ``prefix``) into plain host arrays, converting any read failure (bad
    zip directory, truncated member, zlib error) into a
    :class:`CorruptCheckpointError` that names the bad file -- a torn
    shard must fail the restore loudly, before any tensor is written."""
    path = pathlib.Path(path)
    try:
        with np.load(path) as npz:
            return {k: _from_bf16_bits(npz[k]) for k in npz.files
                    if k.startswith(prefix)}
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CorruptCheckpointError(
            f"checkpoint shard file {path.name!r} in {path.parent} is "
            f"corrupt or truncated ({type(e).__name__}: {e}); the step "
            "was published but its data is unreadable -- restore an "
            "earlier published step") from e


def _from_bf16_bits(a: np.ndarray) -> np.ndarray:
    """A member the reference wrote from a bf16 array: numpy has no
    bf16, so ``np.savez`` stored its 2-byte elements as the void dtype
    ``|V2`` -- read back here as the fp32 values they encode (exactly:
    the bf16 bits are the top half of the fp32 word).  Any other array
    is returned as it is.  The port itself writes bf16 masters as fp32
    (``bridge.host_copy``)."""
    if a.dtype.kind != "V" or a.dtype.itemsize != 2 or a.dtype.names:
        return a
    bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
    return (bits << 16).view(np.float32)


def _write_latest(ckpt_dir: pathlib.Path, step: int):
    """The marker itself must publish atomically too -- a kill between
    open and write would otherwise leave an empty/partial pointer that
    breaks every restart even though the step data is intact."""
    tmp = ckpt_dir / "tmp-latest"
    tmp.write_text(str(step))
    os.replace(tmp, ckpt_dir / "latest")


_order = bridge.reference_order


def _flatten(tree) -> dict:
    """{path: leaf} of a tree of dicts, lists and tuples, in the
    reference's flatten order (``_order``); a dict key may itself be a
    path (``a/b``), as ``state_tree`` returns them."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            out[prefix[:-1]] = node
    walk(tree, "")
    return {k: out[k] for k in sorted(out, key=_order)}


def _treedef(keys) -> str:
    """A record of the tree's structure for ``meta["treedef"]`` and
    ``__treedef__`` (neither package parses it)."""
    return "PyTreeDef(" + ", ".join(keys) + ")"


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf (a tensor, an array or a number)."""
    if isinstance(leaf, torch.Tensor):
        return bridge.host_copy([leaf])
    return np.array(leaf)


def save_checkpoint(ckpt_dir, step: int, state) -> str:
    """state: a loose tree (dicts, lists, tuples) of tensors or arrays.
    Legacy path: leaves are copied to the host in full and written as
    one npz keyed by path."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = {k: _host(v) for k, v in _flatten(state).items()}
    final = ckpt_dir / f"step_{step:010d}.npz"
    # tmp- prefix: neither the glob nor the regex in latest_step can
    # ever pick a half-written file up (and savez keeps the .npz name)
    tmp = str(ckpt_dir / f"tmp-step_{step:010d}.npz")
    try:
        np.savez(tmp, __treedef__=np.frombuffer(
            _treedef(flat).encode(), dtype=np.uint8), **flat)
        os.replace(tmp, final)        # atomic publish
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    _sweep_stale_tmp(ckpt_dir)
    _write_latest(ckpt_dir, step)
    return str(final)


def latest_step(ckpt_dir) -> int | None:
    """Newest fully-published step.  Only exact ``step_N.npz`` files or
    ``step_N.shards`` directories count -- ``tmp-`` leftovers from a
    killed writer are invisible, and a corrupt marker falls through to
    the directory scan instead of killing the restart."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    marker = ckpt_dir / "latest"
    if marker.exists():
        try:
            return int(marker.read_text().strip())
        except ValueError:
            pass                          # torn marker: trust the scan
    steps = published_steps(ckpt_dir)
    return max(steps) if steps else None


def published_steps(ckpt_dir) -> list:
    """Every fully-published step in ``ckpt_dir``, ascending.  Only
    exact ``step_N.npz`` files / ``step_N.shards`` directories count;
    ``tmp-`` staging leftovers are invisible.  The elastic resize
    driver walks this list newest-first when a restore fails."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    steps = set()
    if ckpt_dir.exists():
        for f in ckpt_dir.iterdir():
            m = _STEP_FILE_RE.fullmatch(f.name)
            if m and f.is_file():
                steps.add(int(m.group(1)))
            m = _STEP_DIR_RE.fullmatch(f.name)
            if m and f.is_dir():
                steps.add(int(m.group(1)))
    return sorted(steps)


def checkpoint_meta(ckpt_dir, step: int | None = None) -> dict:
    """The ``meta.json`` of a published sharded step (latest by
    default) -- layout, leaf manifest, and any ``extra`` record the
    writer attached (e.g. the launcher's data cursor)."""
    d, _ = _checkpoint_dir(ckpt_dir, step)
    return json.loads((d / "meta.json").read_text())


def _sweep_stale_tmp(ckpt_dir: pathlib.Path, upto: int | None = None):
    """Remove ``tmp-`` staging leftovers from writers that died between
    writes.  Runs after every successful publish: with one writer,
    anything still under a ``tmp-`` prefix at that point belongs to a
    dead writer (the live writer's staging dir was just renamed away).
    A sharded step has a writer per rank, and the others may already be
    staging later steps, so there (``upto``) only the leftovers of steps
    up to the one just published go.  ``tmp-latest`` is the marker's own
    staging file -- only ever alive inside ``_write_latest``, which runs
    after this sweep."""
    for f in ckpt_dir.iterdir():
        if not f.name.startswith("tmp-") or f.name == "tmp-latest":
            continue
        m = _TMP_STEP_RE.match(f.name)
        if upto is not None and m and int(m.group(1)) > upto:
            continue
        try:
            if f.is_dir():
                shutil.rmtree(f)
            else:
                f.unlink()
        except OSError:
            pass                      # already gone / racing sweep: fine


def _prune_published(ckpt_dir: pathlib.Path, keep_last: int):
    """Retention: drop the oldest published steps beyond the newest
    ``keep_last``, so long runs with frequent checkpoints don't fill
    the disk.  Never touches the newest step."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    for step in published_steps(ckpt_dir)[:-keep_last]:
        for victim in (ckpt_dir / f"step_{step:010d}.npz",
                       ckpt_dir / f"step_{step:010d}.shards"):
            try:
                if victim.is_dir():
                    shutil.rmtree(victim)
                elif victim.exists():
                    victim.unlink()
            except OSError:
                pass


def _step_path(ckpt_dir, step, kind):
    ckpt_dir = pathlib.Path(ckpt_dir)
    at = step if step is not None else latest_step(ckpt_dir)
    if at is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return ckpt_dir / f"step_{at:010d}.{kind}", at


def restore_checkpoint(ckpt_dir, state_like, step: int | None = None):
    """Restore a loose tree saved by ``save_checkpoint`` into the
    structure of ``state_like`` (shapes validated; tensor leaves come
    back as new tensors on the leaf's device and dtype, others as the
    saved arrays).  Returns ``(tree, step)``."""
    path, at = _step_path(ckpt_dir, step, "npz")
    data = _load_npz(path)
    flat_like = _flatten(state_like)
    missing = set(flat_like) - set(data)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}")
    new = {}
    for key, leaf in flat_like.items():
        arr = data[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"{np.shape(leaf)}")
        new[key] = (torch.from_numpy(arr).to(leaf.device, leaf.dtype)
                    if isinstance(leaf, torch.Tensor) else arr)
    return _unflatten_like(state_like, new, ""), at


def _unflatten_like(like, flat, prefix):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return flat[prefix[:-1]]


# --------------------------------------------------------------------------
# TrainState <-> the reference's keys
# --------------------------------------------------------------------------

def _flat_keys(state) -> list:
    """The keys of a sharded state's flat leaves, each of them this
    worker's shard of a ``[padded_total]`` vector: the moments
    ``opt_state/<name>/flat`` and, params-flat (zero3), ``params``."""
    if not state.layout.sharded:
        return []
    keys = [f"opt_state/{k}/flat" for k in state.opt_state if k != "step"]
    return keys + (["params"] if state.layout.params_flat else [])


def state_tree(state, *, replicated: bool = True) -> dict:
    """Host copies of a ``TrainState`` under the reference's names:
    ``{"params": {path: array}, "opt_state": {"step": int32, moment:
    {path: array}, ...}, "step": int32}`` (``bridge.named_to_numpy``:
    masters and moments stacked on ``n_rep``, a tied table once).  A
    sharded state's flat leaves are this worker's shards, as the
    reference's tree over ``{"flat": shard}`` names them: ``opt_state/
    m/flat``, and ``params`` itself for zero3.  ``replicated=False``
    leaves a zero1 / zero2 state's (replicated) params out.  A mesh
    state's DTensor masters and moments are gathered whole first (a
    collective: every rank calls this; the launcher's rank 0 writes).
    The only part of a save that reads the device."""
    model = state.params
    opt = {}
    for k, v in state.opt_state.items():
        opt[k] = (np.asarray(v, np.int32) if k == "step"
                  else {"flat": bridge.host_copy([v["flat"]])}
                  if state.layout.sharded
                  else bridge.named_to_numpy(model, bridge.gather_named(v)))
    tree = {"opt_state": opt, "step": np.asarray(state.step, np.int32)}
    if state.layout.params_flat:
        tree["params"] = bridge.host_copy([state.flat.shard])
    elif replicated:
        tree["params"] = bridge.named_to_numpy(
            model, bridge.gather_named(trainable(model)))
    return tree


def _assign_state(state, get):
    """Write ``get(key)`` for every key of a replicated ``state`` into
    its masters and moments in place (by key, never by order); returns
    the state with the restored step.  Every key and shape is looked up
    and checked before the first copy, so a checkpoint that does not fit
    (a missing moment, another shape) raises and leaves the state as it
    was."""
    model = state.params
    sources = bridge.named_sources(model, trainable(model),
                                   lambda p: get(f"params/{p}"))
    opt_step = None
    for k, v in state.opt_state.items():
        if k == "step":
            opt_step = int(get("opt_state/step"))
        else:
            sources += bridge.named_sources(
                model, v, lambda p, k=k: get(f"opt_state/{k}/{p}"))
    step = int(get("step"))
    bridge.copy_sources(sources)
    if opt_step is not None:
        state.opt_state["step"] = opt_step
    return state._replace(step=step)


def _getter(data, where, rename=lambda k: k):
    def get(key):
        try:
            return data[rename(key)]
        except KeyError:
            raise ValueError(f"checkpoint {where} has no leaf "
                             f"{rename(key)!r}") from None
    return get


def _legacy_key(key):
    """A state key's name in the launcher's legacy ``(params,
    opt_state)`` npz."""
    head, _, rest = key.partition("/")
    return {"params": "0", "opt_state": "1"}[head] + "/" + rest


def restore_train_state(ckpt_dir, state, step: int | None = None):
    """Restore a ``TrainState`` picking the store by what is ON DISK: a
    ``step_N.shards`` directory goes through the sharded store (which
    reshards between any two layouts and world sizes), a legacy
    ``step_N.npz`` of ``(params, opt_state)`` is loaded leaf for leaf
    into a replicated state.  The masters and moments of ``state`` are
    overwritten in place, and only after every member was read and
    every key and shape checked.  The single dispatch point behind
    ``Trainer.restore`` and the launchers.  Returns ``(TrainState,
    step)``."""
    shards, at = _step_path(ckpt_dir, step, "shards")
    if shards.is_dir():
        return restore_sharded_checkpoint(ckpt_dir, state, at)
    if state.layout.sharded:
        raise ValueError(
            f"checkpoint step {at} in {ckpt_dir} is a legacy npz, which "
            f"cannot restore into the sharded {state.layout.kind!r} layout; "
            "restore into a replicated-layout state first and re-save "
            "through save_sharded_checkpoint")
    path = shards.with_suffix(".npz")
    data = _load_npz(path)
    get = _getter(data, path, _legacy_key)
    return _assign_state(state, lambda k: at if k == "step" else get(k)), at


def _check_strategy(meta, where):
    """Resolve the writer's strategy through the registry before
    touching the layout: an unknown name fails with the registered
    names (and registers the hier kinds it may need)."""
    name = meta["layout"].get("strategy")
    if name is None:
        return
    from repro_torch.core.strategy import available_strategies, get_strategy
    try:
        get_strategy(name)
    except ValueError as e:
        raise ValueError(
            f"checkpoint {where} was written by strategy {name!r}, which "
            f"is not registered here; registered strategies: "
            f"{list(available_strategies())}.  Register it "
            "(repro_torch.core.strategy.register_strategy) before "
            "restoring") from e


def _open_step(d):
    """(meta, source Layout, worker_npz(w), replicated_npz()) of a
    published step directory; the npz readers load each file once."""
    meta = json.loads((d / "meta.json").read_text())
    _check_strategy(meta, d)
    src = Layout.from_json(meta["layout"])

    @functools.lru_cache(maxsize=None)
    def worker_npz(w):
        return _load_npz(d / f"worker_{w:05d}.npz")

    @functools.lru_cache(maxsize=None)
    def replicated_npz():
        return _load_npz(d / "replicated.npz")

    return meta, src, worker_npz, replicated_npz


def restore_sharded_checkpoint(ckpt_dir, state, step: int | None = None):
    """Restore ``state`` (a ``TrainState``, e.g. a fresh trainer's) from a
    sharded step.  Replicated into replicated (any world size and
    strategy): by key.  The same sharded layout: each rank reads only
    its own worker file, bitwise.  Any other pair -- replicated, zero1,
    zero2, zero3 and the hier kinds, contiguous or bucket-major, any
    two world sizes -- reshards on the host through the canonical flat
    vector (``_reshard_restore``).  Everything is read and checked
    before the first tensor is written.  Returns ``(TrainState,
    step)``."""
    d, at = _checkpoint_dir(ckpt_dir, step)
    meta, src, worker_npz, replicated_npz = _open_step(d)
    tgt = state.layout
    if src.total != tgt.total:
        raise ValueError(f"checkpoint has {src.total} params, template "
                         f"has {tgt.total}")
    if not src.sharded and not tgt.sharded:
        return _assign_state(state, _getter(replicated_npz(), d)), at
    same = (src.kind == tgt.kind and src.num_shards == tgt.num_shards
            and src.bucket_bytes == tgt.bucket_bytes)
    if same:
        return _same_layout_restore(state, meta, d, worker_npz,
                                    replicated_npz), at
    return _reshard_restore(state, meta, src, worker_npz,
                            replicated_npz), at


@torch.no_grad()
def _same_layout_restore(state, meta, d, worker_npz, replicated_npz):
    """A sharded state from a checkpoint of its own layout: this rank's
    flat leaves from its worker file, the rest from ``replicated.npz``."""
    w, per = state.flat.worker, state.layout.shard_len
    mine = worker_npz(w)
    get = _getter(replicated_npz(), d)
    flat = {}
    for key in _flat_keys(state):
        info = meta["leaves"].get(key)
        if info is None or not info["sharded"]:
            raise ValueError(f"checkpoint {d} has no sharded leaf {key!r}")
        flat[key] = mine[key]
        if flat[key].shape != (per,):
            raise ValueError(f"{key}: worker {w}'s shard has shape "
                             f"{flat[key].shape}, expected ({per},)")
    sources = [] if state.layout.params_flat else bridge.named_sources(
        state.params, trainable(state.params), lambda p: get(f"params/{p}"))
    opt_step = int(get("opt_state/step")) if "step" in state.opt_state \
        else None
    step = int(get("step"))
    bridge.copy_sources(sources)
    _write_flat_leaves(state, flat)
    if opt_step is not None:
        state.opt_state["step"] = opt_step
    return state._replace(step=step)


def _write_flat_leaves(state, flat):
    for key, arr in flat.items():
        dst = (state.flat.shard if key == "params"
               else state.opt_state[key.split("/")[1]]["flat"])
        dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


# ---- cross-layout resharding (host-side; the reference's names) ---------

def _src_flat_leaf(key, meta, src, worker_npz, replicated_npz):
    """Canonical (contiguous, unpadded) flat vector of a source leaf
    that is a flat master vector -- assembling the worker shards and
    undoing the bucket-major permutation where needed."""
    if meta["leaves"][key]["sharded"]:
        shards = [worker_npz(w)[key] for w in range(src.num_shards)]
        full = assemble_full_flat(shards, src)
    else:
        full = replicated_npz()[key]
    return full[:src.total]


def _src_param_order_keys(meta, prefix):
    return [k for k in meta["leaves"] if k.startswith(prefix)]


def _src_canonical_moment(top_key, meta, src, worker_npz, replicated_npz):
    """Canonical flat [total] f32 of one optimizer moment, whatever
    structure the source stored it in (leaves by ORDER, as the
    reference reads them)."""
    flat_key = f"opt_state/{top_key}/flat"
    if flat_key in meta["leaves"]:
        return _src_flat_leaf(flat_key, meta, src, worker_npz,
                              replicated_npz)
    keys = _src_param_order_keys(meta, f"opt_state/{top_key}/")
    if not keys:
        raise ValueError(f"checkpoint has no moment {top_key!r}")
    parts = [np.asarray(replicated_npz()[k], np.float32).ravel()
             for k in keys]
    return np.concatenate(parts)[:src.total]


def _src_params_flat(meta, src) -> bool:
    """Whether the source's params are the flat master vector (zero3):
    exactly one "params" leaf, sharded, of the padded length."""
    info = meta["leaves"].get("params")
    return (info is not None and info.get("sharded")
            and list(info["shape"]) == [src.padded_total])


def _src_canonical_params(meta, src, worker_npz, replicated_npz):
    if _src_params_flat(meta, src):
        return _src_flat_leaf("params", meta, src, worker_npz,
                              replicated_npz)
    keys = _src_param_order_keys(meta, "params/")
    parts = [np.asarray(replicated_npz()[k]).ravel().astype(np.float32)
             for k in keys]
    return np.concatenate(parts)[:src.total]


def _tgt_flat_array(canonical, tgt, worker):
    """This worker's shard of a canonical flat [total] vector under the
    target's (padded, possibly bucket-major) layout."""
    padded = np.zeros(tgt.padded_total, np.float32)
    padded[:tgt.total] = canonical
    return split_flat_shards(padded, tgt)[worker]


def _unflatten_params_like(canonical, spec) -> dict:
    """{port name: array} of a canonical flat vector, by the target's
    ``core.flat.FlatSpec`` (the reference's flatten order)."""
    return {name: canonical[a:b].reshape(shp)
            for name, a, b, shp in spec.slices()}


@torch.no_grad()
def _reshard_restore(state, meta, src, worker_npz, replicated_npz):
    """Any layout into any other through the canonical flat vector: the
    source's params and moments are assembled on the host in the
    reference's flatten order (worker shards un-permuted, or replicated
    leaves concatenated by manifest order) and placed as the target
    holds them -- its masters, its master vector, or this worker's
    shard.  Everything is read before the first write."""
    tgt = state.layout
    model = state.params
    masters = trainable(model)
    spec = state.flat.spec if tgt.sharded else flat_spec(model, masters)
    p_canon = _src_canonical_params(meta, src, worker_npz, replicated_npz)
    moments = {k: _src_canonical_moment(k, meta, src, worker_npz,
                                        replicated_npz)
               for k in state.opt_state if k != "step"}
    for name, canon in [("params", p_canon), *moments.items()]:
        if canon.size != tgt.total:
            raise ValueError(f"checkpoint {name} holds {canon.size} "
                             f"values, the template {tgt.total}")
    opt_step = int(replicated_npz()["opt_state/step"]) \
        if "step" in state.opt_state else None
    step = int(replicated_npz()["step"])
    if tgt.sharded:
        w = state.flat.worker
        flat = {f"opt_state/{k}/flat": _tgt_flat_array(c, tgt, w)
                for k, c in moments.items()}
        if tgt.params_flat:
            flat["params"] = _tgt_flat_array(p_canon, tgt, w)
        else:
            state.flat.full[:tgt.total].copy_(torch.from_numpy(p_canon))
        _write_flat_leaves(state, flat)
    else:
        for name, arr in _unflatten_params_like(p_canon, spec).items():
            masters[name].copy_(torch.from_numpy(arr))
        for k, canon in moments.items():
            for name, arr in _unflatten_params_like(canon, spec).items():
                state.opt_state[k][name].copy_(torch.from_numpy(arr))
    if opt_step is not None:
        state.opt_state["step"] = opt_step
    return state._replace(step=step)


def restore_serve_params(ckpt_dir, cfg, step: int | None = None):
    """Read-only serve restore: ONLY the parameters, as the reference's
    tree of numpy arrays for ``bridge.params_from_jax`` -- no optimizer
    state, no mesh, no template.  Whatever layout training wrote
    (replicated or any ZeRO kind, sharded store or legacy npz), only the
    params are read: the ``params/`` members (or a legacy ``0/...`` /
    ``params/...`` prefix), or a zero3 step's worker files, reassembled
    on the host and split by ``cfg``'s shapes (``bridge.
    reference_shapes``).  The embedding and the stacked depth are
    checked against ``cfg``.  Returns ``(tree, step)``."""
    d, at = _step_path(ckpt_dir, step, "shards")
    if d.is_dir():
        meta, src, worker_npz, replicated_npz = _open_step(d)
        if _src_params_flat(meta, src):
            canon = _src_canonical_params(meta, src, worker_npz,
                                          replicated_npz)
            shapes = bridge.reference_shapes(cfg)
            n = sum(int(np.prod(s)) for s in shapes.values())
            if n != canon.size:
                raise ValueError(
                    f"checkpoint step {at} holds {canon.size} params, "
                    f"{cfg.name} has {n} -- wrong architecture/config for "
                    "this checkpoint?")
            flat, off = {}, 0
            for path, shp in shapes.items():
                sz = int(np.prod(shp))
                flat[path] = canon[off:off + sz].reshape(shp)
                off += sz
            return _serve_tree(flat, cfg, at), at
        path, prefix = d / "replicated.npz", "params/"
    else:
        path = d.with_suffix(".npz")
        with np.load(path) as npz:
            prefix = next((p for p in ("params/", "0/")
                           if any(k.startswith(p) for k in npz.files)), "")
    flat = _load_npz(path, prefix)
    flat.pop("__treedef__", None)
    return _serve_tree({k[len(prefix):]: a for k, a in flat.items()},
                       cfg, at), at


def _serve_tree(flat, cfg, at) -> dict:
    tree = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    _check_serve_tree(tree, cfg, at)
    return tree


def _check_serve_tree(tree, cfg, at):
    table = tree.get("embed", {}).get("table")
    _, _, n_rep = cfg.block_structure()
    reps = {a.shape[0] for a in _flatten(
        tree.get("decoder", {}).get("blocks", {})).values()}
    want = (cfg.vocab_size, cfg.d_model)
    if table is None or table.shape != want or reps - {n_rep}:
        raise ValueError(
            f"checkpoint step {at} holds an embedding of "
            f"{None if table is None else table.shape} and blocks stacked "
            f"{sorted(reps)} deep; {cfg.name} has {want} and {n_rep} -- "
            "wrong architecture/config for this checkpoint?")


# --------------------------------------------------------------------------
# sharded TrainState checkpoints
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StateSnapshot:
    """A TrainState frozen into plain host buffers -- what
    ``save_sharded_checkpoint`` writes, detached from the device.
    Producing one (:func:`snapshot_train_state`) is the ONLY part of a
    save that must block the step path (one device->host copy per
    leaf); :func:`write_state_snapshot` turns it into a published step
    from any thread.  A sharded state's snapshot holds this rank's
    worker shards (``per_worker``) and, on the writing rank only, the
    meta and the replicated leaves; ``token`` names the save, agreed by
    every rank, so that no rank mixes its file into another save's
    staging directory."""
    step: int
    meta: dict | None                # layout + leaf manifest (+ extra)
    replicated: dict                 # key -> np.ndarray, flatten order
    per_worker: dict = dataclasses.field(default_factory=dict)
    n_workers: int = 1
    token: str = ""
    writer: bool = True

    @property
    def nbytes(self) -> int:
        total = sum(a.nbytes for a in self.replicated.values())
        for payload in self.per_worker.values():
            total += sum(a.nbytes for a in payload.values())
        return total


def _agree_token(on_mesh: bool) -> str:
    """A fresh name for one save, the same on every rank (rank 0's)."""
    token = [uuid.uuid4().hex[:12]]
    if on_mesh and dist.get_world_size() > 1:
        dist.broadcast_object_list(token, src=0)
    return token[0]


def _layout_meta(layout) -> dict:
    """The layout record, through the strategy's ``checkpoint_layout``
    hook when the strategy is registered (``to_json`` otherwise)."""
    if layout.strategy is not None:
        from repro_torch.core.strategy import get_strategy
        try:
            return get_strategy(layout.strategy).checkpoint_layout(layout)
        except ValueError:
            pass
    return layout.to_json()


def snapshot_train_state(state, step: int, *, extra: dict | None = None
                         ) -> StateSnapshot:
    """Device->host half of a save: copy every leaf under the
    reference's key (``state_tree``), in its flatten order, plus the
    meta.json record.  The copy is complete when this returns, so the
    next in-place step cannot reach it.  A sharded state is snapshot on
    every rank (each holds its own worker's shards; every rank calls
    this at the same step, since it agrees the save's token), and only
    the writing rank copies the replicated leaves.  ``extra`` is
    recorded verbatim under ``meta["extra"]`` (the launcher stores its
    data cursor there)."""
    layout = state.layout
    writer = is_writer(state)
    flat = _flatten(state_tree(state, replicated=writer))
    sharded = set(_flat_keys(state))
    meta = None
    if writer:
        meta = {"step": int(step), "layout": _layout_meta(layout),
                "treedef": _treedef(flat),
                "leaves": {k: ({"shape": [layout.padded_total],
                                "dtype": str(a.dtype), "sharded": True}
                               if k in sharded else
                               {"shape": list(a.shape), "dtype": str(a.dtype),
                                "sharded": False})
                           for k, a in flat.items()}}
        if extra is not None:
            meta["extra"] = extra
    snap = StateSnapshot(int(step), meta,
                         {k: a for k, a in flat.items() if k not in sharded},
                         writer=writer)
    if layout.sharded:
        snap.per_worker = {state.flat.worker: {k: flat[k] for k in sharded}}
        snap.n_workers = layout.num_shards
        snap.token = _agree_token(bool(layout.axes))
    return snap


def _savez_atomic(final: pathlib.Path, arrays: dict):
    part = final.with_name("tmp-" + final.name)
    np.savez(str(part), **arrays)
    os.replace(part, final)


def write_state_snapshot(ckpt_dir, snap: StateSnapshot, *,
                         keep_last: int | None = None) -> str:
    """File half of a save -- pure host I/O on a :class:`StateSnapshot`,
    safe to run from a background thread.  The whole step is staged
    under a ``tmp-`` directory and published with one atomic
    ``os.replace``; after a successful publish, stale ``tmp-`` leftovers
    from dead writers are swept and (with ``keep_last=``) published
    steps beyond the newest *keep_last* are pruned.

    A sharded snapshot: every rank writes its own ``worker_%05d.npz``
    into the save's staging directory (each file published into it by
    a rename, so it is complete when its name appears); the writing
    rank adds ``meta.json`` and ``replicated.npz`` and publishes only
    once every worker's file is there (waiting up to
    ``PUBLISH_TIMEOUT_S``).  A rank that dies mid-save leaves the step
    unpublished."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step = snap.step
    final = ckpt_dir / f"step_{step:010d}.shards"
    if snap.per_worker:
        tmp = ckpt_dir / f"tmp-step_{step:010d}-{snap.token}.shards"
        tmp.mkdir(exist_ok=True)
        for w, payload in snap.per_worker.items():
            _savez_atomic(tmp / f"worker_{w:05d}.npz", payload)
        if not snap.writer:
            return str(final)
    else:
        tmp = ckpt_dir / f"tmp-step_{step:010d}.shards"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
    (tmp / "meta.json").write_text(json.dumps(snap.meta, indent=1))
    np.savez(str(tmp / "replicated.npz"), **snap.replicated)
    if snap.per_worker:
        _wait_for_workers(tmp, snap.n_workers)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)            # atomic publish
    _sweep_stale_tmp(ckpt_dir, upto=step if snap.per_worker else None)
    if keep_last is not None:
        _prune_published(ckpt_dir, keep_last)
    _write_latest(ckpt_dir, step)
    return str(final)


def _wait_for_workers(tmp: pathlib.Path, n: int):
    deadline = time.monotonic() + PUBLISH_TIMEOUT_S
    while True:
        missing = [w for w in range(n)
                   if not (tmp / f"worker_{w:05d}.npz").exists()]
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"{tmp.name}: worker files {missing} did not appear within "
                f"{PUBLISH_TIMEOUT_S} s; the step stays unpublished")
        time.sleep(0.02)


def is_writer(state) -> bool:
    """Whether this process writes ``state``'s meta and replicated
    leaves (and publishes): always without a mesh, rank 0 only on one.
    In a sharded state every rank also writes its worker file."""
    return not state.layout.axes or dist.get_rank() == 0


def save_sharded_checkpoint(ckpt_dir, step: int, state, *,
                            keep_last: int | None = None,
                            extra: dict | None = None) -> str:
    """Write a TrainState: ``meta.json`` (layout, leaf manifest,
    ``extra``), ``replicated.npz`` and, for a sharded state, one
    ``worker_%05d.npz`` per worker written by the rank that holds it
    (no gather), staged under a ``tmp-`` directory and published with
    one atomic ``os.replace``.  Synchronous composition of
    :func:`snapshot_train_state` + :func:`write_state_snapshot` (the
    async checkpointer, ``repro_torch.elastic``, runs the write on a
    background thread).  On a mesh every rank leaves through a barrier
    after the publish.  Returns the published step's path."""
    final = pathlib.Path(ckpt_dir) / f"step_{int(step):010d}.shards"
    on_mesh = bool(state.layout.axes)
    try:
        if state.layout.sharded or is_writer(state):
            write_state_snapshot(
                ckpt_dir, snapshot_train_state(state, step, extra=extra),
                keep_last=keep_last)
    finally:
        if on_mesh:
            dist.barrier()
    return str(final)


def _checkpoint_dir(ckpt_dir, step):
    d, at = _step_path(ckpt_dir, step, "shards")
    if not d.is_dir():
        raise FileNotFoundError(f"no sharded checkpoint for step {at} "
                                f"in {ckpt_dir}")
    return d, at
