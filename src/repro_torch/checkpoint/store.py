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
  ``sharded``, and ``extra``) and ``replicated.npz``.  The port's
  layouts are all replicated, so there are no ``worker_%05d.npz``
  files; a ZeRO checkpoint of the reference raises, naming ROADMAP A.4.

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

All writers are atomic: everything lands under a ``tmp-`` prefix first
and is published with one ``os.replace``, and ``latest_step`` refuses
to match anything but a fully-published name -- a killed worker can
never leave a truncated checkpoint that a restart then picks up.

Under ``torch.distributed`` a replicated state (one built on a mesh,
``layout.axes`` non-empty) is written by rank 0 only, and a synchronous
save ends at a barrier, so every rank returns after the publish.
Restores read on every rank.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.core.train_state import Layout
from repro_torch.train.step import trainable

_STEP_FILE_RE = re.compile(r"step_(\d+)\.npz")
_STEP_DIR_RE = re.compile(r"step_(\d+)\.shards")


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
            return {k: npz[k] for k in npz.files if k.startswith(prefix)}
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CorruptCheckpointError(
            f"checkpoint shard file {path.name!r} in {path.parent} is "
            f"corrupt or truncated ({type(e).__name__}: {e}); the step "
            "was published but its data is unreadable -- restore an "
            "earlier published step") from e


def _write_latest(ckpt_dir: pathlib.Path, step: int):
    """The marker itself must publish atomically too -- a kill between
    open and write would otherwise leave an empty/partial pointer that
    breaks every restart even though the step data is intact."""
    tmp = ckpt_dir / "tmp-latest"
    tmp.write_text(str(step))
    os.replace(tmp, ckpt_dir / "latest")


def _order(path: str) -> tuple:
    """Sort key of a pytree path in the reference's flatten order: dict
    keys sorted, list (and tuple) indices by number."""
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in path.split("/"))


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


def _sweep_stale_tmp(ckpt_dir: pathlib.Path):
    """Remove ``tmp-`` staging leftovers from writers that died between
    writes.  Runs after every successful publish: anything still under
    a ``tmp-`` prefix at that point belongs to a dead writer (the live
    writer's staging dir was just renamed away).  ``tmp-latest`` is the
    marker's own staging file -- only ever alive inside
    ``_write_latest``, which runs after this sweep."""
    for f in ckpt_dir.iterdir():
        if not f.name.startswith("tmp-") or f.name == "tmp-latest":
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

def state_tree(state) -> dict:
    """Host copies of a ``TrainState`` under the reference's names:
    ``{"params": {path: array}, "opt_state": {"step": int32, moment:
    {path: array}, ...}, "step": int32}`` (``bridge.named_to_numpy``:
    masters and moments stacked on ``n_rep``, a tied table once).  The
    only part of a save that reads the device."""
    model = state.params
    opt = {}
    for k, v in state.opt_state.items():
        opt[k] = (np.asarray(v, np.int32) if k == "step"
                  else bridge.named_to_numpy(model, v))
    return {"params": bridge.named_to_numpy(model, trainable(model)),
            "opt_state": opt, "step": np.asarray(state.step, np.int32)}


def _assign_state(state, get):
    """Write ``get(key)`` for every key of ``state`` into its masters
    and moments in place (by key, never by order); returns the state
    with the restored step.  Every key and shape is looked up and
    checked before the first copy, so a checkpoint that does not fit
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
    also takes a replicated checkpoint of another world size), a legacy
    ``step_N.npz`` of ``(params, opt_state)`` is loaded leaf for leaf.
    The masters and moments of ``state`` are overwritten in place, and
    only after every member was read and every key and shape checked.
    The single dispatch point behind ``Trainer.restore`` and the
    launchers.  Returns ``(TrainState, step)``."""
    shards, at = _step_path(ckpt_dir, step, "shards")
    if shards.is_dir():
        return restore_sharded_checkpoint(ckpt_dir, state, at)
    path = shards.with_suffix(".npz")
    data = _load_npz(path)
    get = _getter(data, path, _legacy_key)
    return _assign_state(state, lambda k: at if k == "step" else get(k)), at


def _check_strategy(meta, where):
    """Resolve the writer's strategy through the registry before
    touching the layout: an unknown name fails with the registered
    names, and a ZeRO name with ROADMAP A.4."""
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
            f"{list(available_strategies())} ({e})") from e


def restore_sharded_checkpoint(ckpt_dir, state, step: int | None = None):
    """Restore ``state`` (a ``TrainState``, e.g. a fresh trainer's) from
    a sharded step, by key.  The source layout is replicated, of any
    world size and strategy (the reference's replicated <-> replicated
    branch); a ZeRO source raises, naming ROADMAP A.4.  Returns
    ``(TrainState, step)``."""
    d, at = _checkpoint_dir(ckpt_dir, step)
    meta = json.loads((d / "meta.json").read_text())
    _check_strategy(meta, d)
    src = Layout.from_json(meta["layout"])
    tgt = state.layout
    if src.total != tgt.total:
        raise ValueError(f"checkpoint has {src.total} params, template "
                         f"has {tgt.total}")
    data = _load_npz(d / "replicated.npz")
    return _assign_state(state, _getter(data, d)), at


def restore_serve_params(ckpt_dir, cfg, step: int | None = None):
    """Read-only serve restore: ONLY the parameters, as the reference's
    tree of numpy arrays for ``bridge.params_from_jax`` -- no optimizer
    state, no mesh, no template.  Whatever layout training wrote
    (sharded store or legacy npz), only the ``params/`` members (or a
    legacy ``0/...`` / ``params/...`` prefix) are read.  The embedding
    and the stacked depth are checked against ``cfg``.  Returns
    ``(tree, step)``."""
    d, at = _step_path(ckpt_dir, step, "shards")
    if d.is_dir():
        meta = json.loads((d / "meta.json").read_text())
        _check_strategy(meta, d)
        Layout.from_json(meta["layout"])
        path, prefix = d / "replicated.npz", "params/"
    else:
        path = d.with_suffix(".npz")
        with np.load(path) as npz:
            prefix = next((p for p in ("params/", "0/")
                           if any(k.startswith(p) for k in npz.files)), "")
    flat = _load_npz(path, prefix)
    flat.pop("__treedef__", None)
    tree = {}
    for key, arr in flat.items():
        *parents, leaf = key[len(prefix):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    _check_serve_tree(tree, cfg, at)
    return tree, at


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
    from any thread."""
    step: int
    meta: dict                       # layout + leaf manifest (+ extra)
    replicated: dict                 # key -> np.ndarray, flatten order

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.replicated.values())


def snapshot_train_state(state, step: int, *, extra: dict | None = None
                         ) -> StateSnapshot:
    """Device->host half of a save: copy every leaf under the
    reference's key (``state_tree``), in its flatten order, plus the
    meta.json record.  The copy is complete when this returns, so the
    next in-place step cannot reach it.  ``extra`` is recorded verbatim
    under ``meta["extra"]`` (the launcher stores its data cursor
    there)."""
    flat = _flatten(state_tree(state))
    meta = {"step": int(step), "layout": state.layout.to_json(),
            "treedef": _treedef(flat),
            "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype),
                           "sharded": False} for k, a in flat.items()}}
    if extra is not None:
        meta["extra"] = extra
    return StateSnapshot(int(step), meta, flat)


def write_state_snapshot(ckpt_dir, snap: StateSnapshot, *,
                         keep_last: int | None = None) -> str:
    """File half of a save -- pure host I/O on a :class:`StateSnapshot`,
    safe to run from a background thread.  The whole step is staged
    under a ``tmp-`` directory and published with one atomic
    ``os.replace``; after a successful publish, stale ``tmp-`` leftovers
    from dead writers are swept and (with ``keep_last=``) published
    steps beyond the newest *keep_last* are pruned."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step = snap.step
    final = ckpt_dir / f"step_{step:010d}.shards"
    tmp = ckpt_dir / f"tmp-step_{step:010d}.shards"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    (tmp / "meta.json").write_text(json.dumps(snap.meta, indent=1))
    np.savez(str(tmp / "replicated.npz"), **snap.replicated)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)            # atomic publish
    _sweep_stale_tmp(ckpt_dir)
    if keep_last is not None:
        _prune_published(ckpt_dir, keep_last)
    _write_latest(ckpt_dir, step)
    return str(final)


def is_writer(state) -> bool:
    """Whether this process writes ``state``'s checkpoints: always for a
    state without a mesh, rank 0 only for one built on a mesh."""
    return not state.layout.axes or dist.get_rank() == 0


def save_sharded_checkpoint(ckpt_dir, step: int, state, *,
                            keep_last: int | None = None,
                            extra: dict | None = None) -> str:
    """Write a TrainState: ``meta.json`` (layout, leaf manifest,
    ``extra``) and ``replicated.npz``, staged under a ``tmp-`` directory
    and published with one atomic ``os.replace``.  Synchronous
    composition of :func:`snapshot_train_state` +
    :func:`write_state_snapshot` (the async checkpointer,
    ``repro_torch.elastic``, runs the write on a background thread).
    On a mesh, rank 0 writes and every rank leaves through a barrier
    after the publish.  Returns the published step's path."""
    final = pathlib.Path(ckpt_dir) / f"step_{int(step):010d}.shards"
    on_mesh = bool(state.layout.axes)
    try:
        if is_writer(state):
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
