"""Partition rules: parameters, batches, caches -> mesh axes per dimension.

Port of ``repro.sharding.rules``.  Mesh axes: ``("data", "model")`` on
one pod, ``("pod", "data", "model")`` over several.  The batch and the
gradient averaging span ``pod`` x ``data`` (the paper's method); inside
a replica, weights are tensor-sharded over ``model`` (heads, ffn,
experts, vocab) and, in train mode, FSDP-sharded over ``data`` so the
optimizer state scales like ZeRO.  A dimension is sharded only when it
divides evenly.

The rules are pure functions of a config, a mesh's axis sizes, the
reference's parameter path (``bridge.reference_key``: e.g.
``decoder/blocks/layer0/mixer/wq``) and the leaf's shape WITHOUT the
reference's stacked ``n_rep`` lead (the port unstacks its layers).  A
spec is a tuple with one entry per tensor dimension: ``None``, an axis
name, or a tuple of axis names (a dimension split over ``("data",
"model")`` is data-major: rank (d, m) holds block ``d * |model| + m``,
as JAX lays it out).  ``placements`` turns a spec into the DTensor
placements, one per mesh dimension.  The reference's ``REPRO_BASELINE``
switch (a TPU-era measurement) has no counterpart: the default rules
only.
"""
from __future__ import annotations

import dataclasses
import math
import re


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    fsdp_dense: bool = True      # shard dense weights' input dim over "data"
    fsdp_experts: str = "auto"   # "auto": experts over (data,model) if divisible
    cache_seq_axis: str = "model"   # decode KV-cache seq dim sharding
    shard_batch: bool = True

    @staticmethod
    def for_mode(mode: str) -> "ShardingConfig":
        if mode == "train":
            return ShardingConfig(fsdp_dense=True)
        # serving: keep weights resident (no per-layer FSDP all-gathers)
        return ShardingConfig(fsdp_dense=False)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, of an object with the
    reference's ``axis_names`` and ``shape`` mapping, or of a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def dp_axes(mesh) -> tuple:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def _size(axes, axis) -> int:
    return axes.get(axis, 1)


def _div(dim, n) -> bool:
    return n > 1 and dim % n == 0


def param_spec(cfg, mesh, path: str, shape,
               sh: ShardingConfig = ShardingConfig()) -> tuple:
    """The spec of one parameter, by its reference path; ``shape`` is
    the unstacked leaf's."""
    axes = mesh_axes(mesh)
    body = tuple(shape)
    model = _size(axes, "model")
    data = _size(axes, "data") if sh.fsdp_dense else 1
    nd = len(body)
    name = path.rsplit("/", 1)[-1]
    rep = (None,) * nd

    def _fsdp(dim):
        return "data" if _div(dim, data) else None

    def _tp(dim):
        return "model" if _div(dim, model) else None

    # ---- MoE experts: (E, d, f) / (E, f, d) ----
    if re.search(r"/experts/w_(up|gate|down)$", path):
        E = body[0]
        dsz = _size(axes, "data")
        if sh.fsdp_experts == "auto" and _div(E, dsz * model):
            return (("data", "model"), None, None)    # full expert-parallel
        if _div(E, model):
            # expert-TP: E over model, the FFN dim over data
            is_down = path.endswith("w_down")
            f_dim = body[1] if is_down else body[2]
            f_ax = "data" if _div(f_dim, dsz) else None
            return ("model", f_ax, None) if is_down else ("model", None, f_ax)
        return (None, None, None)
    if name == "router":
        return (None, None)

    # ---- embeddings / unembedding (V, d): vocab over model only ----
    if name == "table":
        return (_tp(body[0]), None)

    # ---- attention: heads over model, else head_dim ----
    if name == "wq" and nd == 3:              # (d, h, hd)
        if _div(body[1], model):
            return (_fsdp(body[0]), "model", None)
        return (_fsdp(body[0]), None, _tp(body[2]))
    if name in ("wk", "wv") and nd == 3:      # (d, hk, hd)
        if _div(body[1], model):
            return (_fsdp(body[0]), "model", None)
        # fewer kv heads than the model axis: replicated (GQA under TP)
        return (_fsdp(body[0]), None, None)
    if name == "wo" and nd == 3:              # (h, hd, d)
        if _div(body[0], model):
            return ("model", None, _fsdp(body[2]))
        return (None, _tp(body[1]), _fsdp(body[2]))
    if name in ("bq", "bk", "bv"):            # (h, hd)
        if _div(body[0], model):
            return ("model", None)
        return (None, _tp(body[1]))
    if name in ("w_uq", "w_uk", "w_uv"):      # (r, H, dim)  MLA up-projs
        return (None, _tp(body[1]), None)
    if name in ("w_dq", "w_dkv"):             # (d, r)  MLA down-projs
        return (_fsdp(body[0]), None)

    # ---- MLP ----
    if name in ("w_up", "w_gate"):            # (d, ff)
        return (_fsdp(body[0]), _tp(body[1]))
    if name == "w_down":                      # (ff, d)
        return (_tp(body[0]), _fsdp(body[1]))

    # ---- Mamba ----
    if name in ("in_x", "in_z"):              # (d, dI)
        return (_fsdp(body[0]), _tp(body[1]))
    if name == "conv_w":                      # (dc, dI)
        return (None, _tp(body[1]))
    if name in ("conv_b", "D", "dt_bias"):    # (dI,)
        return (_tp(body[0]),)
    if name == "x_proj":                      # (dI, dt_rank + 2 ds)
        return (_tp(body[0]), None)
    if name == "dt_proj":                     # (dt_rank, dI)
        return (None, _tp(body[1]))
    if name == "A_log":                       # (dI, dS)
        return (_tp(body[0]), None)
    if name == "out_proj":                    # (dI, d)
        return (_tp(body[0]), _fsdp(body[1]))

    # ---- RWKV-6 ----
    if name in ("wr", "wk", "wv", "wg") and nd == 2:   # (d, H * K)
        return (_fsdp(body[0]), _tp(body[1]))
    if name == "u":                           # (H, K)
        return (_tp(body[0]), None)
    if name == "cm_wk":                       # (d, ff)
        return (_fsdp(body[0]), _tp(body[1]))
    if name == "cm_wv":                       # (ff, d)
        return (_tp(body[0]), _fsdp(body[1]))
    # cm_wr, the decay / mix LoRAs and bases, the projector's w1 / w2,
    # the MTP head's proj, norms, biases: replicated
    return rep


def param_specs(cfg, mesh, shapes: dict,
                sh: ShardingConfig | None = None) -> dict:
    """{path: spec} for {reference path: unstacked shape}."""
    sh = sh or ShardingConfig()
    return {path: param_spec(cfg, mesh, path, shp, sh)
            for path, shp in shapes.items()}


# --------------------------------------------------------------------------
# batch / cache specs
# --------------------------------------------------------------------------

def _dp_entry(axes_names):
    return axes_names if len(axes_names) > 1 else axes_names[0]


def batch_spec(mesh, batch_size: int) -> tuple:
    """The batch dimension's spec: over pod x data when it divides,
    else replicated (``(None,)``)."""
    axes = mesh_axes(mesh)
    dp = dp_axes(axes)
    n = math.prod(_size(axes, a) for a in dp)
    if batch_size % n == 0 and batch_size >= n:
        return (_dp_entry(dp),)
    return (None,)


def cache_spec(cfg, mesh, path: str, shape, batch_size: int,
               sh: ShardingConfig) -> tuple:
    """A slab-cache leaf's spec: (B, S, ...) kv / (B, ...) states, by
    the reference path's last name; ``shape`` unstacked."""
    axes = mesh_axes(mesh)
    body = tuple(shape)
    dp = dp_axes(axes)
    n_dp = math.prod(_size(axes, a) for a in dp)
    b_axis = _dp_entry(dp) if (sh.shard_batch and body[0] % n_dp == 0
                               and body[0] >= n_dp) else None
    seq_ax = sh.cache_seq_axis
    model = _size(axes, seq_ax)
    name = path.rsplit("/", 1)[-1]
    if name in ("k", "v"):              # (B, S, hk, hd)
        return (b_axis, seq_ax if _div(body[1], model) else None, None, None)
    if name in ("ckv", "krope"):        # (B, S, r)
        return (b_axis, seq_ax if _div(body[1], model) else None, None)
    if name == "ssm":                   # (B, dI, dS)
        return (b_axis, "model" if _div(body[1], model) else None, None)
    if name == "conv":                  # (B, dc - 1, dI)
        return (b_axis, None, "model" if _div(body[2], model) else None)
    if name == "state":                 # rwkv (B, H, K, V)
        return (b_axis, "model" if _div(body[1], model) else None, None, None)
    if name in ("shift_tm", "shift_cm"):  # (B, d)
        return (b_axis, None)
    return (None,) * len(body)


def pool_spec(cfg, mesh, path: str, shape, slot_axis: int) -> tuple:
    """A paged-pool leaf's spec: token-major pooled leaves keep the
    token axis whole and shard features over ``model`` (k / v heads,
    else head_dim; MLA's latent and rope widths); per-slot leaves
    (``slot_axis >= 0``) are replicated."""
    body = tuple(shape)
    if slot_axis >= 0:
        return (None,) * len(body)
    model = _size(mesh_axes(mesh), "model")
    name = path.rsplit("/", 1)[-1]
    if name in ("k", "v"):              # (N, hk, hd)
        if _div(body[1], model):
            return (None, "model", None)
        if _div(body[2], model):
            return (None, None, "model")
        return (None, None, None)
    if name in ("ckv", "krope"):        # (N, r)
        return (None, "model" if _div(body[1], model) else None)
    return (None,) * len(body)


# --------------------------------------------------------------------------
# specs as DTensor placements, and a rank's block
# --------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh_dim_names):
    """The DTensor placements of ``spec``, one per mesh dimension:
    ``Shard(i)`` where tensor dim i is split over that axis, else
    ``Replicate()``.  A dim split over several axes gets ``Shard(i)`` on
    each, and DTensor splits it in mesh-dimension order -- data-major,
    as the spec's tuple lists the axes."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for i, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a in where:
                raise ValueError(f"axis {a!r} splits two dims of {spec}")
            where[a] = i
    order = [a for a in mesh_dim_names if a in where]
    for entry in spec:
        ax = _entry_axes(entry)
        if list(ax) != [a for a in order if a in ax]:
            raise ValueError(f"{spec}: a dim's axes must follow the mesh's "
                             f"order {tuple(mesh_dim_names)}")
    unknown = set(where) - set(mesh_dim_names)
    if unknown:
        raise ValueError(f"{spec} names axes {sorted(unknown)} the mesh "
                         f"{tuple(mesh_dim_names)} lacks")
    return [Shard(where[a]) if a in where else Replicate()
            for a in mesh_dim_names]


def local_slices(shape, spec, mesh, coord: dict) -> tuple:
    """The slices of the rank at ``coord`` ({axis: index}) into a tensor
    of ``shape`` laid out by ``spec``: along a dim split over (a1, a2,
    ...) the block index is a1-major."""
    axes = mesh_axes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        block, n = 0, 1
        for a in _entry_axes(entry):
            block = block * axes[a] + coord[a]
            n *= axes[a]
        size = dim // n
        out.append(slice(block * size, (block + 1) * size))
    return tuple(out)
