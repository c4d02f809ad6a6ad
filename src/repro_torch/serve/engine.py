"""Serving: slab prefill / decode steps, the lockstep ``ServeEngine``, and
the constructor surface ``make_engine`` / ``make_engine_from_checkpoint``.

Port of ``repro.serve.engine``.  ``ServeEngine`` is the host-side
lockstep loop over a slab KV cache of (batch, max_len) per layer: one
whole-prompt prefill, then one decode step per token for every slot at
once, greedy or sampled, with ONE blocking host round-trip per token
when an EOS is set (``bool(done.all())``).  It is the equivalence
reference for the continuous engine (``serve.scheduler``) and the
baseline of the host-sync story.  It serves every decoder-only text
architecture the port has (a VLM or an encoder-decoder takes
``apply_model``'s slab prefill and decode instead, as in the
reference, whose engine takes token prompts only): each attention call but MLA's slab decode (plain ops, as in
the reference) runs through ``chunked_attention``, the flash-attention
kernel on the card; each whole-prompt prefill of a Mamba or RWKV-6
layer runs its scan kernel, each decode step its one-step update.

Each ``generate()`` starts its recurrent layers from a zero state, so
it gives what a fresh engine gives.  The reference's engine keeps its
cache across calls and its recurrent prefill reads the state, shifts
and conv tail the previous batch left; the port does not carry them.

On a serve mesh (``mesh=``) the weights come placed by the serve-mode
rules (``bridge.check_serve_placed``) and the slab by
``rules.cache_spec``: where the batch divides over pod x data each
replica holds and computes its own rows (and the logits are gathered
over the replicas before each sample, which every rank draws for the
whole batch from the same generator), the sequence (or state) dim of
every leaf cut over ``"model"``; each call
runs under the scoped serve topology (``sharding.ctx``), where a layer
reads its slab gathered over ``"model"`` and writes its block back.  A
batch that splits must fill every slot.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.bridge import check_serve_placed, params_from_jax
from repro_torch.device import resolve_device
from repro_torch.models.model import (Model, apply_model, check_slab_ported,
                                      check_token_serving, compute_dtype,
                                      init_cache)
from repro_torch.serve.sampling import SamplingConfig, sample
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.comm import MeshComm, all_gather, own_block


def make_prefill_step(cfg):
    def prefill(model, tokens, cache, **frontends):
        """Fill the slab from 0 with (B, S) tokens; the next-token
        logits (B, V) at each sequence's last position.  ``frontends``:
        a VLM's ``vision_embeds`` or an encoder-decoder's
        ``src_embeds`` (``models.batch_inputs``)."""
        out = apply_model(cfg, model, tokens, mode="prefill", cache=cache,
                          cache_pos=0, last_only=True, **frontends)
        return out["logits"][:, -1]
    return prefill


def make_decode_step(cfg):
    def decode(model, tokens, cache, cache_pos):
        """Append (B, 1) tokens at the int ``cache_pos`` of every slot;
        their next-token logits (B, V)."""
        out = apply_model(cfg, model, tokens, mode="decode", cache=cache,
                          cache_pos=cache_pos)
        return out["logits"][:, -1]
    return decode


def _first_rows(layer, B):
    """A slab layer's first ``B`` rows (views), its placement kept."""
    rows = {name: t[:B] for name, t in layer.items()}
    return (shctx.Placed(rows, layer.split)
            if isinstance(layer, shctx.Placed) else rows)


class ServeEngine:
    """Batched generation over fixed slots: greedy or sampled
    (temperature / top-k / nucleus via SamplingConfig, drawn from a
    ``torch.Generator`` seeded with ``seed``).  Lockstep: a new batch
    cannot start until every slot retires, and every token costs a
    blocking host sync when ``eos_id`` is set (``host_syncs`` counts
    them); ``dispatches`` counts the model calls and the samples.  The
    slab cache is in the model's compute dtype on its device; the rows
    a batch uses are zeroed before its prefill (every batch starts from
    a zero recurrent state, the K/V slabs are overwritten)."""

    def __init__(self, cfg, model: Model, *, batch_size, max_len,
                 eos_id: Optional[int] = None,
                 sampling: SamplingConfig = SamplingConfig(), seed: int = 0,
                 mesh=None):
        check_slab_ported(cfg)
        check_token_serving(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self._topo = self._comm = None
        self._split = False
        if mesh is not None:
            from repro_torch.sharding.rules import batch_spec
            check_serve_placed(model, mesh)
            self._topo = shctx.ServeTopology.from_mesh(mesh)
            self._comm = MeshComm(mesh)
            self._split = batch_spec(mesh, batch_size) != (None,)
        self.model = model
        self.device = model.embed.device
        self.max_len = max_len
        self.batch = batch_size
        self.eos_id = eos_id
        self.sampling = sampling
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = (init_cache(cfg, compute_dtype(cfg), batch=batch_size,
                                 max_len=max_len, device=self.device)
                      if mesh is None else self._placed_cache())
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)
        self.host_syncs = 0
        self.dispatches = 0

    def _placed_cache(self) -> list:
        """This rank's blocks of the slab (``rules.cache_spec``), zeros."""
        from repro_torch.sharding.rules import ShardingConfig, cache_spec
        comm, sh = self._comm, ShardingConfig.for_mode("serve")
        shapes = init_cache(self.cfg, compute_dtype(self.cfg),
                            batch=self.batch, max_len=self.max_len,
                            device="meta")
        return shctx.place_cache(shapes, lambda i, name, shape: cache_spec(
            self.cfg, comm.sizes, f"layers/{i}/{name}", shape, self.batch,
            sh), comm, self.device)

    def _rows(self, t):
        """This replica's rows of a batch-major tensor (all of them when
        the batch does not split)."""
        if not self._split:
            return t
        for a in self._comm.dp_axes:
            t = own_block(t, self._comm, a, 0)
        return t

    def _whole(self, t):
        """A batch-major tensor of this replica's rows gathered over the
        replicas, pod-major."""
        if not self._split:
            return t
        for a in reversed(self._comm.dp_axes):
            t = all_gather(t, self._comm, a, 0)
        return t

    def _next(self, logits):
        """The next tokens (B, 1) of the whole batch: a cut batch's
        logits are gathered over the replicas first, so every rank
        samples the same rows with the same draws as one device."""
        self.dispatches += 1
        return sample(self._whole(logits), self._gen, self.sampling)[:, None]

    def generate(self, prompts, max_new_tokens: int):
        """prompts: (B, S0) int tensor or array of equal lengths (pad
        upstream), B <= batch_size.  Returns (B, n) int32 on the
        engine's device, n <= max_new_tokens (fewer when every slot hit
        EOS).  A retired slot emits ``eos_id`` from then on."""
        tokens = torch.as_tensor(prompts).to(self.device, torch.int32)
        B, S0 = tokens.shape
        if B > self.batch:
            raise ValueError(f"{B} prompts for {self.batch} slots")
        if self._split and B != self.batch:
            raise ValueError(f"{B} prompts for {self.batch} slots: a batch "
                             "cut over the mesh's replicas fills every slot")
        if S0 + max_new_tokens - 1 > self.max_len:
            raise ValueError(f"prompt {S0} + {max_new_tokens} new tokens "
                             f"overrun max_len={self.max_len}")
        with shctx.serving(self._topo, self._split):
            return self._generate(tokens, max_new_tokens)

    def _generate(self, tokens, max_new_tokens):
        B, S0 = tokens.shape
        cache = self.cache if self._split else [
            _first_rows(layer, B) for layer in self.cache]
        tokens = self._rows(tokens)
        for layer, (kind, _) in zip(cache, self.cfg.layer_pattern()):
            if kind != "attn":              # the recurrent rows start at 0
                for t in layer.values():
                    t.zero_()
        logits = self._prefill(self.model, tokens, cache)
        self.dispatches += 1
        pos = S0
        tok = self._next(logits)
        outs = [tok]
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        if self.eos_id is not None:
            done = done | (tok[:, 0] == self.eos_id)
        for _ in range(max_new_tokens - 1):
            logits = self._decode(self.model, self._rows(tok), cache, pos)
            self.dispatches += 1
            pos += 1
            tok = self._next(logits)
            if self.eos_id is not None:
                # retired slots must stop leaking live samples into
                # the output: pin them to eos_id (pad) once done
                tok = torch.where(done[:, None],
                                  torch.full_like(tok, self.eos_id), tok)
                done = done | (tok[:, 0] == self.eos_id)
                outs.append(tok)
                self.host_syncs += 1          # the per-token round-trip
                if bool(done.all()):
                    break
            else:
                outs.append(tok)
        return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# constructor surface (launcher)
# --------------------------------------------------------------------------

def make_engine(cfg, params, *, engine="continuous", batch_size=4,
                max_len=256, eos_id=None,
                sampling: SamplingConfig = SamplingConfig(), seed=0,
                device="cuda", mesh=None, **kw):
    """Build a serving engine on ``device`` (the card by default).

    params -- a ``Model`` already on ``device``, or the reference's
              parameter tree as numpy arrays (loaded through the bridge).
    engine="continuous" -- the paged ``ContinuousScheduler``; extra kw
              go to it (page_size, num_pages, prefill_chunk,
              decode_chunk, pad_id, tenant_quota, prefix_cache,
              spec_decode).
    engine="legacy" -- the lockstep slab ``ServeEngine``; it takes no
              extra kw.
    mesh   -- a serve mesh (``launch.mesh.make_serve_mesh``,
              ``make_production_mesh``) to serve on: reference arrays are
              cut to this rank's blocks as they load; a ``Model`` must
              already be placed so (``bridge.check_serve_placed``);
              None: one device.
    """
    if engine not in ("continuous", "legacy"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'continuous' or 'legacy')")
    if engine == "legacy" and kw:
        raise TypeError(f"legacy engine takes no {sorted(kw)}")
    dev = resolve_device(device)
    if isinstance(params, Model):
        if params.embed.device.type != dev.type:
            raise ValueError(f"model lives on {params.embed.device}, "
                             f"engine asked for {dev}")
        model = params
    else:
        model = params_from_jax(params, cfg, device=dev, mesh=mesh)
    if engine == "legacy":
        return ServeEngine(cfg, model, batch_size=batch_size,
                           max_len=max_len, eos_id=eos_id,
                           sampling=sampling, seed=seed, mesh=mesh)
    return ContinuousScheduler(cfg, model, slots=batch_size, max_len=max_len,
                               eos_id=eos_id, sampling=sampling,
                               seed=seed, mesh=mesh, **kw)


def make_engine_from_checkpoint(ckpt_dir, cfg, *, step=None, device="cuda",
                                **engine_kw):
    """Close the train-and-serve loop: serve the params of a checkpoint
    written by either package's training stack -- sharded (a replicated
    layout of any world size) or the legacy npz -- restored read-only
    on the host (``checkpoint.restore_serve_params``: the ``params/``
    members only, no optimizer state) and cast once to the serving
    dtypes on ``device`` (the card by default).  The whole tree is
    restored, auxiliary heads with the trunk: ``params["mtp"]`` of an
    ``mtp_depth > 0`` architecture, which ``spec_decode`` drafts from.
    The engine's ``restored_step`` is the step served.  ``engine_kw`` go to
    :func:`make_engine`."""
    from repro_torch.checkpoint import restore_serve_params
    dev = resolve_device(device)
    tree, at = restore_serve_params(ckpt_dir, cfg, step)
    eng = make_engine(cfg, tree, device=dev, **engine_kw)
    eng.restored_step = at
    return eng
