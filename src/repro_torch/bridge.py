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
{"scale"}``, no ffn; DeepSeek-V3's multi-token-prediction head
``params["mtp"]``: norm_h, norm_e, proj and an ("attn", "mlp") block;
an encoder-decoder's ``params["encoder"]`` stacked on the encoder's own
``n_rep``, ``enc_norm`` and, in each decoder layer, ``norm_cross`` and
``cross``; a VLM's ``vision_proj`` {w1, b1, w2, b2})
-- so the bridge only unstacks.  Weights the
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

On a mesh, each weight of a ``Model`` -- drawn (``mesh_placer``, cut as
it is drawn), loaded from the reference's arrays (``params_from_jax(...,
mesh=)``, each array cut before it becomes a tensor), or carried whole
into a training model (``place_on_mesh``) -- becomes a DTensor holding
this rank's block as the reference's rules place it
(``sharding.rules.param_spec`` of its reference path, in the mode's
``ShardingConfig``: train mode FSDP-cuts dense weights over ``"data"``,
serve mode keeps them whole there); the tied table stays one master.
A serving engine on a mesh takes only a model placed so
(``check_serve_placed``).
``gather_named`` is the way back: every master (or moment) gathered
whole, which ``named_to_numpy`` and ``params_to_numpy`` then read;
``copy_sources`` writes a DTensor's block of each array.

The caller turns the reference's arrays into numpy first; this module
imports neither ``jax`` nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import (Model, PaperNet, encoder_cfg,
                                      layer_path)

# mixer norms the reference nests as {"scale": t}; ``Layer`` flattens them
NESTED_SCALES = ("q_norm", "k_norm", "kv_norm", "ln_x")
# top-level keys of the reference's tree the port serves from
SERVED_KEYS = ("embed", "decoder", "final_norm", "unembed", "mtp",
               "encoder", "enc_norm", "vision_proj")


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


def params_from_jax(tree, cfg, *, device="cuda", train=False,
                    param_dtype=torch.float32, mesh=None) -> Model:
    """The reference's params (a tree of numpy arrays) as the port's
    ``Model`` on ``device``, each weight cast once to ``cfg.dtype``; or,
    with ``train``, a training ``Model`` of trainable masters of
    ``param_dtype``, one per leaf of the tree (reference bf16 arrays
    carry over bitwise into bf16 masters).  With ``mesh``, each array
    is cut to this rank's block before it becomes a tensor (the rules
    of the train or serve mode) and the weights are DTensors.  A key the
    port does not serve, or one that ``cfg`` has no place for (an
    encoder without ``is_encoder_decoder``, a projector without the
    vision frontend), raises rather than being dropped silently."""
    served = set(SERVED_KEYS)
    if not cfg.is_encoder_decoder:
        served -= {"encoder", "enc_norm"}
    if cfg.frontend != "vision":
        served.discard("vision_proj")
    unknown = sorted(set(tree) - served)
    if unknown:
        raise ValueError(f"params_from_jax: the port does not serve the "
                         f"reference's {unknown}")
    dev = resolve_device(device)
    if mesh is None:
        conv = lambda t, path: _map(_tensor, t)              # noqa: E731
    else:
        from repro_torch.sharding.comm import MeshComm
        comm, mode = MeshComm(mesh), "train" if train else "serve"
        conv = lambda t, path: _map_leaves(                  # noqa: E731
            t, path, lambda p, a: _placed(cfg, comm, p, a, mode))
    ecfg = encoder_cfg(cfg)
    # a generator: Model draws one layer's tensors at a time
    port = {"embed": conv(tree["embed"], "embed"),
            "layers": (conv(t, layer_path("decoder", cfg, i)) for i, t in
                       enumerate(layer_trees(cfg, tree["decoder"]))),
            "final_norm": conv(tree["final_norm"], "final_norm")}
    if "encoder" in tree:
        port["encoder"] = (conv(t, layer_path("encoder", ecfg, i))
                           for i, t in enumerate(layer_trees(
                               ecfg, tree["encoder"])))
    for key in ("unembed", "mtp", "enc_norm", "vision_proj"):
        if key in tree:
            port[key] = conv(tree[key], key)
    return Model(cfg, port, device=dev, train=train,
                 param_dtype=param_dtype)


def _layer_tree(layer, leaf) -> dict:
    """A ``Layer``'s weights in the reference's per-layer layout (mixer
    norms nested as {"scale"}), each through ``leaf``."""
    def ffn_tree(node):
        return {k: leaf(v) if isinstance(v, torch.Tensor) else ffn_tree(v)
                for k, v in node.items()}

    nest = lambda d: {k: ({"scale": leaf(v)} if k in NESTED_SCALES
                          else leaf(v)) for k, v in d.items()}
    tree = {"norm1": {"scale": leaf(layer.norm1)}, "mixer": nest(layer.mixer),
            "norm2": {"scale": leaf(layer.norm2)}}
    if layer.ffn is not None:
        tree["ffn"] = ffn_tree(layer.ffn)
    if layer.cross is not None:
        tree["norm_cross"] = {"scale": leaf(layer.norm_cross)}
        tree["cross"] = nest(layer.cross)
    return tree


def params_to_numpy(model: Model, cfg) -> dict:
    """The inverse of ``params_from_jax``: the reference's tree layout
    (layers restacked on ``n_rep``) as numpy arrays of the port's
    weights -- bitwise the input when the compute dtype is fp32 or the
    model holds fp32 masters (``train``)."""
    np_ = lambda t: t.detach().float().cpu().numpy() \
        if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
    out = {"embed": {"table": np_(model.unembed_f32) if cfg.tie_embeddings
                     else np_(model.embed)},
           "decoder": _stack_layers(cfg, model.layers, np_),
           "final_norm": {"scale": np_(model.final_norm)}}
    if not cfg.tie_embeddings:
        out["unembed"] = {"table": np_(model.unembed_f32)}
    if model.mtp is not None:
        out["mtp"] = _mtp_tree(model.mtp, np_)
    if model.encoder is not None:
        out["encoder"] = _stack_layers(encoder_cfg(cfg), model.encoder, np_)
        out["enc_norm"] = {"scale": np_(model.enc_norm)}
    if model.vision_proj is not None:
        out["vision_proj"] = {k: np_(v) for k, v in
                              model.vision_proj.items()}
    return out


def _stack_layers(cfg, layers, leaf) -> dict:
    """A stack's layers in the reference's layout: {"prefix": {layer{i}},
    "blocks": {layer{j}: stacked on n_rep}}."""
    prefix, pattern, n_rep = cfg.block_structure()
    trees = [_layer_tree(layer, leaf) for layer in layers]
    n_pre, P = len(prefix), len(pattern)
    return {"prefix": {f"layer{i}": trees[i] for i in range(n_pre)},
            "blocks": {f"layer{j}": _stack([trees[n_pre + rep * P + j]
                                            for rep in range(n_rep)])
                       for j in range(P)}}


def _mtp_tree(head, leaf) -> dict:
    """An ``MTPHead``'s weights in the reference's layout, each through
    ``leaf``."""
    return {"norm_h": {"scale": leaf(head.norm_h)},
            "norm_e": {"scale": leaf(head.norm_e)},
            "proj": leaf(head.proj), "block": _layer_tree(head.block, leaf)}


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
             "final_norm": "final_norm/scale", "enc_norm": "enc_norm/scale"}


def reference_key(model, name) -> tuple:
    """(reference path, n_rep index or None) of the port's trainable
    parameter ``name`` of ``model``.  A decoder ``Model``: the embedding
    (a tied table is the one master ``embed``), the final norm, and
    ``layers.{i}.*`` -- an unrolled prefix layer, or repetition ``rep``
    of super-block layer ``j``, whose leaf is stacked on ``n_rep``.  Any
    other module (a Table-1 ``PaperNet``: ``layers.0.w`` ->
    ``layers/0/w``): its dotted name with slashes, unstacked.  The MTP
    head's ``mtp.*`` are ``mtp/*``, its norms and its block's nested as
    {"scale"}.  An encoder-decoder's ``encoder.{i}.*`` are the
    encoder's layers, stacked on its own ``n_rep``; a VLM's
    ``vision_proj.*`` are ``vision_proj/*``."""
    if not isinstance(model, Model):
        return name.replace(".", "/"), None
    if name in _TOP_KEYS:
        return _TOP_KEYS[name], None
    head, *rest = name.split(".")
    if head == "mtp":
        if rest[0] in ("norm_h", "norm_e"):
            rest.append("scale")
        elif rest[0] == "block":
            rest = ["block"] + _nest_scale(rest[1:])
        return "/".join(["mtp", *rest]), None
    if head == "vision_proj":
        return "/".join([head, *rest]), None
    stacks = {"layers": ("decoder", model.cfg),
              "encoder": ("encoder", encoder_cfg(model.cfg))}
    if head not in stacks:
        raise ValueError(f"no reference path for the port's {name!r}")
    top, cfg = stacks[head]
    i, *rest = rest
    i = int(i)
    prefix, pattern, _ = cfg.block_structure()
    rep = None if i < len(prefix) else (i - len(prefix)) // len(pattern)
    return "/".join([layer_path(top, cfg, i), *_nest_scale(rest)]), rep


def _nest_scale(rest) -> list:
    """A layer's parameter path, with "scale" appended where the
    reference nests a norm as {"scale"}."""
    if rest[0] in ("norm1", "norm2", "norm_cross") or (
            rest[0] in ("mixer", "cross") and rest[1] in NESTED_SCALES):
        return rest + ["scale"]
    return rest


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
    training model of one repetition of each stack (an encoder-decoder's
    encoder too) and an 8-row table, drawn on the CPU (a full-width
    layer is held for the call)."""
    from repro_torch.models.model import init_model
    prefix, pattern, n_rep = cfg.block_structure()
    small = cfg.with_overrides(num_layers=len(prefix) + len(pattern),
                               vocab_size=8)
    reps = {"decoder": n_rep}
    if cfg.is_encoder_decoder:
        e_pre, e_pat, reps["encoder"] = encoder_cfg(cfg).block_structure()
        small = small.with_overrides(encoder_layers=len(e_pre) + len(e_pat))
    model = init_model(small, device="cpu", train=True)
    masters = dict(model.named_parameters())
    shapes = {}
    for path, (names, stacked) in reference_groups(model, masters).items():
        shp = tuple(masters[names[0]].shape)
        if path in ("embed/table", "unembed/table"):
            shp = (cfg.vocab_size,) + shp[1:]
        shapes[path] = ((reps[path.split("/")[0]],) + shp) if stacked \
            else shp
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
    unstacking ``n_rep``; a DTensor takes its block of the array."""
    for ts, a in sources:
        for t, s in zip(ts, torch.from_numpy(a)):
            if _is_dtensor(t):
                t.to_local().copy_(s[_block(t)])
            else:
                t.copy_(s)


# --------------------------------------------------------------------------
# a training Model on a mesh
# --------------------------------------------------------------------------

def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _block(t) -> tuple:
    """The slices of a DTensor's local block into its whole tensor."""
    from repro_torch.sharding.comm import MeshComm
    from repro_torch.sharding.rules import local_slices
    comm = MeshComm(t.device_mesh)
    return local_slices(tuple(t.shape), spec_of(t), dict(comm.sizes),
                        comm.coord)


def spec_of(t) -> tuple:
    """The rules' spec (axes per tensor dim) of a DTensor's placements."""
    from torch.distributed.tensor import Shard
    axes = [[] for _ in t.shape]
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(pl, Shard):
            axes[pl.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)


@torch.no_grad()
def _placed(cfg, comm, path, t, mode="train"):
    """A DTensor of ``t`` (the whole leaf at reference ``path``, a tensor
    or a numpy array) holding this rank's block, placed by the rules of
    ``mode`` ("train" or "serve")."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import (ShardingConfig, local_slices,
                                            param_spec, placements)
    spec = param_spec(cfg, comm.sizes, path, tuple(t.shape),
                      ShardingConfig.for_mode(mode))
    cut = local_slices(tuple(t.shape), spec, comm.sizes, comm.coord)
    block = (_tensor(np.asarray(t)[cut]) if isinstance(t, np.ndarray)
             else t.detach()[cut].clone())
    return DTensor.from_local(block, comm.mesh, placements(spec, comm.names),
                              run_check=False)


def check_serve_placed(model, mesh):
    """Raise unless every weight of ``model`` is a DTensor on ``mesh``
    placed by the serve-mode rules -- drawn so (``init_model(...,
    place=mesh_placer(cfg, mesh, mode="serve"))``) or loaded so
    (``params_from_jax(..., mesh=)``).  A whole model is not cut here:
    serving weights never exist whole on a rank of a mesh."""
    from repro_torch.sharding.comm import MeshComm
    from repro_torch.sharding.rules import ShardingConfig, param_spec
    comm, sh = MeshComm(mesh), ShardingConfig.for_mode("serve")
    for name, p in model.named_parameters():
        path, _ = reference_key(model, name)
        want = param_spec(model.cfg, comm.sizes, path, tuple(p.shape), sh)
        if (not _is_dtensor(p) or p.device_mesh != mesh
                or spec_of(p) != want):
            raise ValueError(
                f"{name} is not placed on the serve mesh by the serve-mode "
                f"rules (want {want}); draw the model with init_model(..., "
                "place=bridge.mesh_placer(cfg, mesh, mode='serve')) or load "
                "it with params_from_jax(..., mesh=mesh)")


def _leaves(tree, path):
    """(reference path, leaf) of every tensor of a unit's tree."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, f"{path}/{k}")


def _map_leaves(tree, path, fn):
    if not isinstance(tree, dict):
        return fn(path, tree)
    return {k: _map_leaves(v, f"{path}/{k}", fn) for k, v in tree.items()}


def mesh_placer(cfg, mesh, mode="train"):
    """``models.init_model``'s ``place=`` on ``mesh``: every leaf a
    DTensor holding this rank's block, placed by the rules of ``mode``
    ("train", or "serve" for a serving model) on its reference path, cut
    as soon as it is drawn.  Each unit is drawn
    twice: on the meta device first, which draws nothing and tells
    which leaf (path and shape) each draw becomes; then for real, in the
    same order from the same generator, each draw cut to its block and
    the whole tensor dropped before the next is drawn.  The weights are
    those of drawing the whole model and cutting it, and the peak is
    the blocks plus one whole leaf (its fp32 draw and its cast)."""
    from repro_torch.models.layers import on_draw
    from repro_torch.sharding.comm import MeshComm
    comm = MeshComm(mesh)

    def place(prefix, draw, device, generator):
        drawn = []
        with on_draw(lambda t: drawn.append(t) or t):
            ghost = draw(torch.device("meta"), None)
        where = {id(leaf if leaf._base is None else leaf._base):
                 (path, tuple(leaf.shape)) for path, leaf in
                 _leaves(ghost, prefix)}
        if any(id(t) not in where for t in drawn):
            raise ValueError(f"{prefix}: a draw is not a leaf (or a view "
                             "of one) of its tree; it cannot be placed "
                             "as drawn")
        plan = iter([where[id(t)] for t in drawn])
        blocks = {}

        def cut(t):
            path, shape = next(plan)
            blocks[path] = _placed(cfg, comm, path, t.reshape(shape), mode)
            return torch.empty(t.shape, dtype=t.dtype, device="meta")

        with on_draw(cut):
            tree = draw(device, generator)
        return _map_leaves(tree, prefix, lambda path, leaf: blocks.pop(
            path) if path in blocks else _placed(cfg, comm, path, leaf,
                                                 mode))

    return place


def place_on_mesh(model, mesh):
    """Every master of a training ``model`` (one whole copy on each rank,
    carried from the reference) replaced IN PLACE by a DTensor master
    holding this rank's block, placed by the train-mode rules of its
    reference path; a tied table stays one master.  Returns ``model``.
    A model drawn from a seed is placed as it is drawn
    (``mesh_placer``), one loaded from the reference's arrays as they
    are read (``params_from_jax(..., mesh=)``)."""
    from repro_torch.sharding.comm import MeshComm
    comm = MeshComm(mesh)
    names = {id(p): n for n, p in model.named_parameters()}
    placed = {}
    for mod in model.modules():
        for key, p in list(mod._parameters.items()):
            if p is None:
                continue
            if id(p) not in placed:
                path, _ = reference_key(model, names[id(p)])
                placed[id(p)] = torch.nn.Parameter(
                    _placed(model.cfg, comm, path, p),
                    requires_grad=p.requires_grad)
            mod._parameters[key] = placed[id(p)]
    return model


def gather_named(named) -> dict:
    """{name: the whole tensor} of ``named`` ({name: tensor}), each
    DTensor gathered from its blocks -- a collective: every rank of the
    mesh calls it.  Other tensors pass as they are."""
    from repro_torch.sharding.comm import MeshComm, full_tensor
    comms = {}
    out = {}
    for k, t in named.items():
        if _is_dtensor(t):
            mesh = t.device_mesh
            comm = comms.setdefault(id(mesh), MeshComm(mesh))
            out[k] = full_tensor(t, comm)
        else:
            out[k] = t
    return out


def serving_model(model: Model) -> Model:
    """A serving ``Model`` on ``model``'s device, each weight cast once
    from the training model's masters to the dtype it keeps -- the
    same weights ``params_from_jax`` builds from those masters' values.
    The weights are copies: later steps do not reach them."""
    clone = lambda t: t.detach().clone()                     # noqa: E731
    tree = {"embed": {"table": clone(model.embed)},
            "layers": (_layer_tree(layer, clone) for layer in model.layers),
            "final_norm": {"scale": clone(model.final_norm)}}
    if model.encoder is not None:
        tree["encoder"] = (_layer_tree(layer, clone)
                           for layer in model.encoder)
        tree["enc_norm"] = {"scale": clone(model.enc_norm)}
    if model.vision_proj is not None:
        tree["vision_proj"] = {k: clone(v)
                               for k, v in model.vision_proj.items()}
    if not model.cfg.tie_embeddings:
        tree["unembed"] = {"table": clone(model.unembed_f32)}
    if model.mtp is not None:
        tree["mtp"] = _mtp_tree(model.mtp, clone)
    return Model(model.cfg, tree, device=model.embed.device)
