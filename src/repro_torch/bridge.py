"""Weights from the reference's parameter tree into the port, and back.

The reference (``repro.models.init_model``) keeps a decoder's layers
stacked: ``params["decoder"]["blocks"]["layer{j}"]`` carries a leading
``n_rep`` axis (one super-block of ``len(pattern)`` layers, repeated),
after an unrolled ``params["decoder"]["prefix"]``.  Layouts are the
same on both sides -- wq (d, h, hd), wk/wv (d, hk, hd), wo (h, hd, d),
MLA's w_dq/w_uq/w_dkv/w_uk/w_uv/wo with nested q_norm and kv_norm,
MLP (d_in, d_out), the nested MoE ffn (router, ``experts`` {w_up,
w_gate (E, d, f), w_down (E, f, d)}, optional router_bias and
``shared`` MLP), the Mamba and RWKV mixers as in ``models.ssm`` (an
RWKV block: norm1, norm2 and a mixer with the nested ``ln_x:
{"scale"}``, no ffn) -- so the bridge only unstacks.  Weights the
reference reads in fp32 (Mamba's A_log and D, the router) stay fp32
in a bf16 model, so they round-trip exactly.

``paper_net_from_jax`` / ``paper_net_to_numpy`` do the same for the
paper's Table-1 networks, whose trees are plain lists of ``{"w", "b"}``.

``named_to_numpy`` / ``named_sources`` + ``copy_sources`` map a dict of
the port's named tensors -- a training model's fp32 masters, or an
optimizer moment keyed alike -- to and from the reference's pytree
paths (the checkpoint store's keys, e.g. ``decoder/blocks/layer0/
mixer/wq`` stacked on ``n_rep``, or ``layers/0/w`` for a Table-1 net).
``serving_model`` casts a training model's masters into a serving
``Model``.

The caller turns the reference's arrays into numpy first; this module
imports neither ``jax`` nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model, PaperNet

# mixer norms the reference nests as {"scale": t}; ``Layer`` flattens them
NESTED_SCALES = ("q_norm", "k_norm", "kv_norm", "ln_x")
# top-level keys of the reference's tree the port serves from
SERVED_KEYS = ("embed", "decoder", "final_norm", "unembed")
# ... and those it leaves out by name: the multi-token-prediction head is
# read only by speculative decoding (``model.py::mtp_draft``), not ported
DROPPED_KEYS = ("mtp",)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":             # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.tensor(a)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_trees(cfg, decoder):
    """Per-layer trees, in depth order, from the reference's stacked
    ``params["decoder"]``."""
    prefix, pattern, n_rep = cfg.block_structure()
    layers = [decoder["prefix"][f"layer{i}"] for i in range(len(prefix))]
    for rep in range(n_rep):
        for j in range(len(pattern)):
            layers.append(_map(lambda a, r=rep: np.asarray(a)[r],
                               decoder["blocks"][f"layer{j}"]))
    return layers


def params_from_jax(tree, cfg, *, device="cuda", train=False) -> Model:
    """The reference's params (a tree of numpy arrays) as the port's
    ``Model`` on ``device``, each weight cast once to ``cfg.dtype``; or,
    with ``train``, a training ``Model`` of trainable fp32 masters, one
    per leaf of the tree.  ``DROPPED_KEYS`` are left out; any other key
    the port does not serve raises rather than being dropped silently."""
    unknown = sorted(set(tree) - set(SERVED_KEYS) - set(DROPPED_KEYS))
    if unknown:
        raise ValueError(f"params_from_jax: the port does not serve the "
                         f"reference's {unknown}")
    dev = resolve_device(device)
    # a generator: Model draws one layer's tensors at a time
    port = {"embed": _map(_tensor, tree["embed"]),
            "layers": (_map(_tensor, t)
                       for t in layer_trees(cfg, tree["decoder"])),
            "final_norm": _map(_tensor, tree["final_norm"])}
    if "unembed" in tree:
        port["unembed"] = _map(_tensor, tree["unembed"])
    return Model(cfg, port, device=dev, train=train)


def _layer_tree(layer, leaf) -> dict:
    """A ``Layer``'s weights in the reference's per-layer layout (mixer
    norms nested as {"scale"}), each through ``leaf``."""
    def ffn_tree(node):
        return {k: leaf(v) if isinstance(v, torch.Tensor) else ffn_tree(v)
                for k, v in node.items()}

    mixer = {k: ({"scale": leaf(v)} if k in NESTED_SCALES else leaf(v))
             for k, v in layer.mixer.items()}
    tree = {"norm1": {"scale": leaf(layer.norm1)}, "mixer": mixer,
            "norm2": {"scale": leaf(layer.norm2)}}
    if layer.ffn is not None:
        tree["ffn"] = ffn_tree(layer.ffn)
    return tree


def params_to_numpy(model: Model, cfg) -> dict:
    """The inverse of ``params_from_jax``: the reference's tree layout
    (layers restacked on ``n_rep``) as numpy arrays of the port's
    weights -- bitwise the input when the compute dtype is fp32 or the
    model holds fp32 masters (``train``)."""
    prefix, pattern, n_rep = cfg.block_structure()
    np_ = lambda t: t.detach().float().cpu().numpy() \
        if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
    trees = [_layer_tree(layer, np_) for layer in model.layers]
    n_pre, P = len(prefix), len(pattern)
    blocks = {}
    for j in range(P):
        reps = [trees[n_pre + rep * P + j] for rep in range(n_rep)]
        blocks[f"layer{j}"] = _stack(reps)
    out = {"embed": {"table": np_(model.unembed_f32) if cfg.tie_embeddings
                     else np_(model.embed)},
           "decoder": {"prefix": {f"layer{i}": trees[i]
                                  for i in range(n_pre)},
                       "blocks": blocks},
           "final_norm": {"scale": np_(model.final_norm)}}
    if not cfg.tie_embeddings:
        out["unembed"] = {"table": np_(model.unembed_f32)}
    return out


def paper_net_from_jax(tree, net, *, device="cuda") -> PaperNet:
    """The reference's Table-1 params (``{"layers": [{"w", "b"}, ...]}``
    or ``{"conv": [...], "fc": [...]}`` of numpy arrays) as the port's
    ``PaperNet`` of fp32 weights on ``device``.  The layouts are the
    same on both sides (dense (d_in, d_out), conv HWIO)."""
    want = {"layers"} if net.kind == "dnn" else {"conv", "fc"}
    if set(tree) != want:
        raise ValueError(f"paper_net_from_jax: {net.name} has "
                         f"{sorted(want)}, got {sorted(tree)}")
    return PaperNet({k: [_map(_tensor, l) for l in tree[k]]
                     for k in sorted(want)}, device=resolve_device(device))


def paper_net_to_numpy(model: PaperNet, net) -> dict:
    """The inverse of ``paper_net_from_jax``: the reference's tree of
    numpy arrays, bitwise the port's weights (copies: a later step does
    not change them)."""
    groups = ("layers",) if net.kind == "dnn" else ("conv", "fc")
    return {g: [{"w": l.w.detach().to("cpu", copy=True).numpy(),
                 "b": l.b.detach().to("cpu", copy=True).numpy()}
                for l in getattr(model, g)] for g in groups}


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


# --------------------------------------------------------------------------
# {port name: tensor} <-> {reference path: array} (checkpoint keys)
# --------------------------------------------------------------------------

_TOP_KEYS = {"embed": "embed/table", "unembed_f32": "unembed/table",
             "final_norm": "final_norm/scale"}


def reference_key(model, name) -> tuple:
    """(reference path, n_rep index or None) of the port's trainable
    parameter ``name`` of ``model``.  A decoder ``Model``: the embedding
    (a tied table is the one master ``embed``), the final norm, and
    ``layers.{i}.*`` -- an unrolled prefix layer, or repetition ``rep``
    of super-block layer ``j``, whose leaf is stacked on ``n_rep``.  Any
    other module (a Table-1 ``PaperNet``: ``layers.0.w`` ->
    ``layers/0/w``): its dotted name with slashes, unstacked."""
    if not isinstance(model, Model):
        return name.replace(".", "/"), None
    if name in _TOP_KEYS:
        return _TOP_KEYS[name], None
    layers, i, *rest = name.split(".")
    if layers != "layers":
        raise ValueError(f"no reference path for the port's {name!r}")
    if rest[0] in ("norm1", "norm2") or (rest[0] == "mixer"
                                         and rest[1] in NESTED_SCALES):
        rest.append("scale")
    prefix, pattern, _ = model.cfg.block_structure()
    i = int(i)
    if i < len(prefix):
        return "/".join(["decoder", "prefix", f"layer{i}", *rest]), None
    rep, j = divmod(i - len(prefix), len(pattern))
    return "/".join(["decoder", "blocks", f"layer{j}", *rest]), rep


def reference_order(path: str) -> tuple:
    """Sort key of a reference path in the reference's flatten order
    (``tree_leaves``): dict keys sorted, list indices by number."""
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in path.split("/"))


def reference_groups(model, names) -> dict:
    """{reference path: (port names, stacked)}: one name for an
    unstacked leaf, the ``n_rep`` names in repetition order for a leaf
    stacked on ``n_rep``."""
    groups = {}
    for name in names:
        path, rep = reference_key(model, name)
        members, _ = groups.setdefault(path, ([], rep is not None))
        members.append((rep or 0, name))
    return {path: ([n for _, n in sorted(members)], stacked)
            for path, (members, stacked) in groups.items()}


def reference_shapes(cfg) -> dict:
    """{reference path: shape} of ``cfg``'s trainable params (a stacked
    leaf with ``n_rep`` in front), in the reference's flatten order --
    what a flat master vector of ``cfg`` unflattens into.  Read from a
    training model of one repetition and an 8-row table, drawn on the
    CPU (a full-width layer is held for the call)."""
    from repro_torch.models.model import init_model
    prefix, pattern, n_rep = cfg.block_structure()
    small = cfg.with_overrides(num_layers=len(prefix) + len(pattern),
                               vocab_size=8)
    model = init_model(small, device="cpu", train=True)
    masters = dict(model.named_parameters())
    shapes = {}
    for path, (names, stacked) in reference_groups(model, masters).items():
        shp = tuple(masters[names[0]].shape)
        if path in ("embed/table", "unembed/table"):
            shp = (cfg.vocab_size,) + shp[1:]
        shapes[path] = ((n_rep,) + shp) if stacked else shp
    return {k: shapes[k] for k in sorted(shapes, key=reference_order)}


def host_copy(ts, stacked=False) -> np.ndarray:
    """A fresh host array of the tensor ``ts[0]`` -- or, ``stacked``, of
    the equal-shaped tensors ``ts`` stacked on a new leading axis --
    copied straight from the device into it; bf16 as fp32.  Always a
    copy, on the CPU too: a master's ``numpy()`` would alias it, and
    the next in-place step would change the copy."""
    dt = torch.float32 if ts[0].dtype == torch.bfloat16 else ts[0].dtype
    host = torch.empty(((len(ts),) if stacked else ())
                       + tuple(ts[0].shape), dtype=dt)
    for dst, t in zip(host if stacked else [host], ts):
        dst.copy_(t.detach())
    return host.numpy()


def named_to_numpy(model, named) -> dict:
    """Host copies (``host_copy``) of ``named`` ({port name: tensor} --
    ``model``'s masters, or an optimizer moment keyed alike) as
    {reference path: numpy array}, stacked on ``n_rep`` where the
    reference stacks."""
    return {path: host_copy([named[n] for n in names], stacked)
            for path, (names, stacked)
            in reference_groups(model, named).items()}


def named_sources(model, named, get) -> list:
    """[(tensors, array)]: ``get(reference path)`` for every group of
    ``named`` (as in ``named_to_numpy``), each checked against its
    tensors' shape (with ``n_rep`` in front where stacked) and given a
    leading axis of one where unstacked.  Writes nothing, so a missing
    key or a wrong shape raises before any tensor changes."""
    out = []
    for path, (names, stacked) in reference_groups(model, named).items():
        ts = [named[n] for n in names]
        want = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
        a = np.asarray(get(path))
        if a.shape != want:
            raise ValueError(f"{path}: checkpoint shape {a.shape} != "
                             f"{want}")
        out.append((ts, a if stacked else a[None]))
    return out


@torch.no_grad()
def copy_sources(sources):
    """Copy each array of ``named_sources`` into its tensors in place,
    unstacking ``n_rep``."""
    for ts, a in sources:
        for t, s in zip(ts, torch.from_numpy(a)):
            t.copy_(s)


def serving_model(model: Model) -> Model:
    """A serving ``Model`` on ``model``'s device, each weight cast once
    from the training model's fp32 masters to the dtype it keeps -- the
    same weights ``params_from_jax`` builds from those masters' values.
    The weights are copies: later steps do not reach them."""
    clone = lambda t: t.detach().clone()                     # noqa: E731
    tree = {"embed": {"table": clone(model.embed)},
            "layers": (_layer_tree(layer, clone) for layer in model.layers),
            "final_norm": {"scale": clone(model.final_norm)}}
    if not model.cfg.tie_embeddings:
        tree["unembed"] = {"table": clone(model.unembed_f32)}
    return Model(model.cfg, tree, device=model.embed.device)
