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

The caller turns the reference's arrays into numpy first; this module
imports neither ``jax`` nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model

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
    port = {"embed": _map(_tensor, tree["embed"]),
            "layers": [_map(_tensor, t)
                       for t in layer_trees(cfg, tree["decoder"])],
            "final_norm": _map(_tensor, tree["final_norm"])}
    if "unembed" in tree:
        port["unembed"] = _map(_tensor, tree["unembed"])
    return Model(cfg, port, device=dev, train=train)


def params_to_numpy(model: Model, cfg) -> dict:
    """The inverse of ``params_from_jax``: the reference's tree layout
    (layers restacked on ``n_rep``) as numpy arrays of the port's
    weights -- bitwise the input when the compute dtype is fp32 or the
    model holds fp32 masters (``train``)."""
    prefix, pattern, n_rep = cfg.block_structure()
    np_ = lambda t: t.detach().float().cpu().numpy() \
        if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()

    def layer_tree(layer):
        mixer = {k: ({"scale": np_(v)} if k in NESTED_SCALES else np_(v))
                 for k, v in layer.mixer.items()}
        tree = {"norm1": {"scale": np_(layer.norm1)}, "mixer": mixer,
                "norm2": {"scale": np_(layer.norm2)}}
        if layer.ffn is not None:
            tree["ffn"] = ffn_tree(layer.ffn)
        return tree

    def ffn_tree(node):
        return {k: np_(v) if isinstance(v, torch.Tensor) else ffn_tree(v)
                for k, v in node.items()}

    trees = [layer_tree(layer) for layer in model.layers]
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


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)
