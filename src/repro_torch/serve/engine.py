"""Serving: slab prefill / decode steps, the lockstep ``ServeEngine``, and
the constructor surface ``make_engine`` / ``make_engine_from_checkpoint``.

Port of ``repro.serve.engine``.  ``ServeEngine`` is the host-side
lockstep loop over a slab KV cache of (batch, max_len) per layer: one
whole-prompt prefill, then one decode step per token for every slot at
once, greedy or sampled, with ONE blocking host round-trip per token
when an EOS is set (``bool(done.all())``).  It is the equivalence
reference for the continuous engine (``serve.scheduler``) and the
baseline of the host-sync story.  Every attention call of it runs
through ``chunked_attention``, the flash-attention kernel on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.bridge import params_from_jax
from repro_torch.device import resolve_device
from repro_torch.models.model import (Model, apply_model, check_slab_ported,
                                      compute_dtype, init_cache)
from repro_torch.serve.sampling import SamplingConfig, sample
from repro_torch.serve.scheduler import ContinuousScheduler


def make_prefill_step(cfg):
    def prefill(model, tokens, cache):
        """Fill the slab from 0 with (B, S) tokens; the next-token
        logits (B, V) at each sequence's last position."""
        out = apply_model(cfg, model, tokens, mode="prefill", cache=cache,
                          cache_pos=0, last_only=True)
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


class ServeEngine:
    """Batched generation over fixed slots: greedy or sampled
    (temperature / top-k / nucleus via SamplingConfig, drawn from a
    ``torch.Generator`` seeded with ``seed``).  Lockstep: a new batch
    cannot start until every slot retires, and every token costs a
    blocking host sync when ``eos_id`` is set (``host_syncs`` counts
    them); ``dispatches`` counts the model calls and the samples.  The
    slab cache is in the model's compute dtype on its device."""

    def __init__(self, cfg, model: Model, *, batch_size, max_len,
                 eos_id: Optional[int] = None,
                 sampling: SamplingConfig = SamplingConfig(), seed: int = 0):
        check_slab_ported(cfg)
        self.cfg = cfg
        self.model = model
        self.device = model.embed.device
        self.max_len = max_len
        self.batch = batch_size
        self.eos_id = eos_id
        self.sampling = sampling
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = init_cache(cfg, compute_dtype(cfg), batch=batch_size,
                                max_len=max_len, device=self.device)
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)
        self.host_syncs = 0
        self.dispatches = 0

    def _next(self, logits):
        self.dispatches += 1
        return sample(logits, self._gen, self.sampling)[:, None]

    def generate(self, prompts, max_new_tokens: int):
        """prompts: (B, S0) int tensor or array of equal lengths (pad
        upstream), B <= batch_size.  Returns (B, n) int32 on the
        engine's device, n <= max_new_tokens (fewer when every slot hit
        EOS).  A retired slot emits ``eos_id`` from then on."""
        tokens = torch.as_tensor(prompts).to(self.device, torch.int32)
        B, S0 = tokens.shape
        if B > self.batch:
            raise ValueError(f"{B} prompts for {self.batch} slots")
        if S0 + max_new_tokens - 1 > self.max_len:
            raise ValueError(f"prompt {S0} + {max_new_tokens} new tokens "
                             f"overrun max_len={self.max_len}")
        cache = [{name: t[:B] for name, t in layer.items()}
                 for layer in self.cache]
        logits = self._prefill(self.model, tokens, cache)
        self.dispatches += 1
        pos = S0
        tok = self._next(logits)
        outs = [tok]
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        if self.eos_id is not None:
            done = done | (tok[:, 0] == self.eos_id)
        for _ in range(max_new_tokens - 1):
            logits = self._decode(self.model, tok, cache, pos)
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
                device="cuda", **kw):
    """Build a serving engine on ``device`` (the card by default).

    params -- a ``Model`` already on ``device``, or the reference's
              parameter tree as numpy arrays (loaded through the bridge).
    engine="continuous" -- the paged ``ContinuousScheduler``; extra kw
              go to it (page_size, num_pages, prefill_chunk,
              decode_chunk, pad_id, tenant_quota).
    engine="legacy" -- the lockstep slab ``ServeEngine``; it takes no
              extra kw.
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
        model = params_from_jax(params, cfg, device=dev)
    if engine == "legacy":
        return ServeEngine(cfg, model, batch_size=batch_size,
                           max_len=max_len, eos_id=eos_id,
                           sampling=sampling, seed=seed)
    return ContinuousScheduler(cfg, model, slots=batch_size, max_len=max_len,
                               eos_id=eos_id, sampling=sampling,
                               seed=seed, **kw)


def make_engine_from_checkpoint(ckpt_dir, cfg, *, step=None, device="cuda",
                                **engine_kw):
    """Close the train-and-serve loop: serve the params of a checkpoint
    written by either package's training stack -- sharded (a replicated
    layout of any world size) or the legacy npz -- restored read-only
    on the host (``checkpoint.restore_serve_params``: the ``params/``
    members only, no optimizer state) and cast once to the serving
    dtypes on ``device`` (the card by default).  The engine's
    ``restored_step`` is the step served.  ``engine_kw`` go to
    :func:`make_engine`."""
    from repro_torch.checkpoint import restore_serve_params
    dev = resolve_device(device)
    tree, at = restore_serve_params(ckpt_dir, cfg, step)
    eng = make_engine(cfg, tree, device=dev, **engine_kw)
    eng.restored_step = at
    return eng
