"""Serving constructor surface: ``make_engine``.

Port of ``repro.serve.engine.make_engine`` for the continuous engine.
The lockstep slab ``ServeEngine`` joins with the slab-cache slice.
"""
from __future__ import annotations

from repro_torch.bridge import params_from_jax
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.sampling import SamplingConfig
from repro_torch.serve.scheduler import ContinuousScheduler


def make_engine(cfg, params, *, engine="continuous", batch_size=4,
                max_len=256, eos_id=None,
                sampling: SamplingConfig = SamplingConfig(), seed=0,
                device="cuda", **kw):
    """Build a serving engine on ``device`` (the card by default).

    params -- a ``Model`` already on ``device``, or the reference's
              parameter tree as numpy arrays (loaded through the bridge).
    Extra kw go to ``ContinuousScheduler`` (page_size, num_pages,
    prefill_chunk, decode_chunk, pad_id, tenant_quota).
    """
    dev = resolve_device(device)
    if engine != "continuous":
        raise ValueError(f"unknown engine {engine!r}: the port serves "
                         "engine='continuous'")
    if isinstance(params, Model):
        if params.embed.device.type != dev.type:
            raise ValueError(f"model lives on {params.embed.device}, "
                             f"engine asked for {dev}")
        model = params
    else:
        model = params_from_jax(params, cfg, device=dev)
    return ContinuousScheduler(cfg, model, slots=batch_size, max_len=max_len,
                               eos_id=eos_id, sampling=sampling,
                               seed=seed, **kw)
