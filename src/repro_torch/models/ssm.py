"""RWKV-6 (Finch) and Mamba-1 mixers for serving and training.

Port of ``repro.models.ssm``, in the reference's modes: ``"decode"``
with one token takes the one-step update, every other call (a decode
call of several tokens, a slab ``"prefill"``, a ``"train"`` forward)
the whole-segment scan through ``kernels.ops``, as the reference's
models call theirs, so ``ops.set_default_impl`` steers it; under the
default "auto" it is the CUDA kernel on the card (differentiable
through its ``autograd.Function``).  Training has no
cache and starts from a zero state.  A layer's recurrent cache is, for RWKV-6,
``{"state": (B, H, K, K) fp32, "shift_tm": (B, d), "shift_cm": (B, d)}``
(shifts in the compute dtype) and, for Mamba, ``{"ssm": (B, dI, dS)
fp32, "conv": (B, d_conv - 1, dI)}`` (the conv tail in the compute
dtype).  Where the reference returns a new cache, these functions
update the one they are given IN PLACE (``copy_``): a B=1 prefill call
receives row views ``t[slot:slot+1]`` of the serving cache, so writing
into them lands in the slot's rows with no merge step.

Weights keep the reference's layouts: RWKV mu (5, d), mix_A (5, d, r),
mix_B (5, r, d), decay_A (d, r), decay_B (r, d), u (H, K); Mamba
conv_w (d_conv, dI), A_log (dI, dS); projections (d_in, d_out).  What
the reference reads in fp32 (``FP32_WEIGHTS``: RWKV's ``u`` and
``w_base``, Mamba's ``A_log`` and ``D``) stays fp32; the rest is cast
to the compute dtype at use, as the reference's ``.astype(dt)`` (a
no-op for a serving model's weights, cast once at load).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import mamba_scan, mamba_step, wkv6, wkv6_step
from repro_torch.models.layers import dense_init, rmsnorm, truncated_normal

# weights the reference reads in fp32 whatever the compute dtype
FP32_WEIGHTS = ("u", "w_base", "A_log", "D")


def init_rwkv6(cfg, *, generator, device="cpu", dtype):
    """Weights of one RWKV-6 block (time mix and channel mix), as a tree
    in the reference's layout: drawn in fp32, each cast to ``dtype`` as
    it is drawn except ``FP32_WEIGHTS``."""
    rc = cfg.rwkv
    d = cfg.d_model
    H, K = d // rc.head_dim, rc.head_dim
    f32 = dict(generator=generator, device=device)
    kw = dict(f32, dtype=dtype)
    return {
        "mu_base": truncated_normal((d,), 0.02, **kw),
        "mu": truncated_normal((5, d), 0.02, **kw),
        "mix_A": truncated_normal((5, d, rc.mix_lora), 0.02, **kw),
        "mix_B": truncated_normal((5, rc.mix_lora, d), 0.02, **kw),
        "w_base": truncated_normal((d,), 0.02, shift=-6.0, **f32),
        "decay_A": truncated_normal((d, rc.decay_lora), 0.02, **kw),
        "decay_B": truncated_normal((rc.decay_lora, d), 0.02, **kw),
        "u": truncated_normal((H, K), 0.02, **f32),
        "wr": dense_init(d, d, **kw),
        "wk": dense_init(d, d, **kw),
        "wv": dense_init(d, d, **kw),
        "wg": dense_init(d, d, **kw),
        "wo": dense_init(d, d, **kw),
        "ln_x": {"scale": torch.ones((K,), device=device)},
        "cm_mu_r": truncated_normal((d,), 0.02, **kw),
        "cm_mu_k": truncated_normal((d,), 0.02, **kw),
        "cm_wr": dense_init(d, d, **kw),
        "cm_wk": dense_init(d, cfg.d_ff, **kw),
        "cm_wv": dense_init(cfg.d_ff, d, **kw),
    }


def make_rwkv6_cache(cfg, batch, dtype, *, device="cpu"):
    rc = cfg.rwkv
    d = cfg.d_model
    H, K = d // rc.head_dim, rc.head_dim
    return {
        "state": torch.zeros((batch, H, K, K), dtype=torch.float32,
                             device=device),
        "shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _token_shift(x, prev):
    """x: (B, S, d); prev: (B, d) last token of the previous segment."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p, x, x_prev):
    """Finch data-dependent token shift: one mix per (w, k, v, r, g)."""
    B, S, d = x.shape
    dt = x.dtype
    xx = x_prev - x
    base = x + xx * p["mu_base"].to(dt)                            # (B,S,d)
    n, _, r = p["mix_A"].shape
    # einsum("bsd,ndr->bsnr") as one matmul over the flattened LoRAs
    a = p["mix_A"].to(dt).permute(1, 0, 2).reshape(d, n * r)
    t = torch.tanh(base @ a).reshape(B * S, n, r).transpose(0, 1)  # (n,BS,r)
    lora = torch.bmm(t, p["mix_B"].to(dt)).reshape(n, B, S, d)     # nrd
    mixed = x[None] + xx[None] * (p["mu"].to(dt)[:, None, None, :] + lora)
    return tuple(mixed[i] for i in range(n))                       # (B,S,d)


def apply_rwkv6_time_mix(cfg, p, x, *, mode="decode", cache=None):
    """x: (B, S, d) -> (B, S, d).  A one-token ``"decode"`` call takes
    the one-step update ``wkv6_step``; every other call (``"prefill"``,
    ``"train"``, a longer decode call) the chunked ``wkv6`` (the CUDA
    kernel on the card).  ``cache`` (or zeros when None, as in training)
    supplies the carried state and token shift; a given cache receives
    the new ``state`` and ``shift_tm`` in place."""
    rc = cfg.rwkv
    B, S, d = x.shape
    dt = x.dtype
    H, K = d // rc.head_dim, rc.head_dim
    prev = (cache["shift_tm"].to(dt) if cache is not None
            else torch.zeros((B, d), dtype=dt, device=x.device))
    xw, xk, xv, xr, xg = _ddlerp(p, x, _token_shift(x, prev))

    r = (xr @ p["wr"].to(dt)).reshape(B, S, H, K)
    k = (xk @ p["wk"].to(dt)).reshape(B, S, H, K)
    v = (xv @ p["wv"].to(dt)).reshape(B, S, H, K)
    g = F.silu(xg @ p["wg"].to(dt))
    w_log = -torch.exp(
        p["w_base"].float() + (torch.tanh(xw @ p["decay_A"].to(dt))
                               @ p["decay_B"].to(dt)).float()
    ).reshape(B, S, H, K)

    state0 = (cache["state"] if cache is not None
              else torch.zeros((B, H, K, K), dtype=torch.float32,
                               device=x.device))
    if mode == "decode" and S == 1:
        y, state = wkv6_step(r[:, 0], k[:, 0], v[:, 0], w_log[:, 0],
                             p["u"], state0)
        y = y[:, None]
    else:
        y, state = wkv6(r, k, v, w_log, p["u"], state0)

    y = rmsnorm(p["ln_x"], y.to(dt).reshape(B, S, H, K), cfg.norm_eps)
    out = (y.reshape(B, S, d) * g) @ p["wo"].to(dt)
    if cache is not None:
        cache["state"].copy_(state)
        cache["shift_tm"].copy_(x[:, -1, :])
    return out


def apply_rwkv6_channel_mix(cfg, p, x, *, cache=None):
    """x: (B, S, d) -> (B, S, d); a given cache receives ``shift_cm``
    in place."""
    dt = x.dtype
    B = x.shape[0]
    prev = (cache["shift_cm"].to(dt) if cache is not None
            else torch.zeros((B, x.shape[-1]), dtype=dt, device=x.device))
    xx = _token_shift(x, prev) - x
    xk = x + xx * p["cm_mu_k"].to(dt)
    xr = x + xx * p["cm_mu_r"].to(dt)
    kk = torch.square(torch.relu(xk @ p["cm_wk"].to(dt)))
    out = torch.sigmoid(xr @ p["cm_wr"].to(dt)) * (kk @ p["cm_wv"].to(dt))
    if cache is not None:
        cache["shift_cm"].copy_(x[:, -1, :])
    return out


# ==========================================================================
# Mamba-1 (selective scan)
# ==========================================================================

def init_mamba(cfg, *, generator, device="cpu", dtype):
    """Weights of one Mamba mixer, as a tree in the reference's layout
    (split x / z input projections): the projections drawn in fp32 and
    cast to ``dtype`` as drawn; the dt bias, A_log and D computed in
    fp32 (the layer casts the small dt bias)."""
    mc = cfg.mamba
    d = cfg.d_model
    dI = mc.expand * d
    dt_rank = max(1, d // 16)
    kw = dict(generator=generator, device=device, dtype=dtype)
    # dt bias initialised so softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand((dI,), generator=generator, device=device)
    dt_init = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    dt_bias = dt_init + torch.log1p(-torch.exp(-dt_init))  # inverse softplus
    return {
        "in_x": dense_init(d, dI, **kw),
        "in_z": dense_init(d, dI, **kw),
        "conv_w": truncated_normal((mc.d_conv, dI), 0.5 / np.sqrt(mc.d_conv),
                                   **kw),
        "conv_b": torch.zeros((dI,), device=device),
        "x_proj": dense_init(dI, dt_rank + 2 * mc.d_state, **kw),
        "dt_proj": dense_init(dt_rank, dI, std=dt_rank ** -0.5, **kw),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(
            1, mc.d_state + 1, dtype=torch.float32, device=device)
        ).expand(dI, mc.d_state).contiguous(),
        "D": torch.ones((dI,), device=device),
        "out_proj": dense_init(dI, d, **kw),
    }


def make_mamba_cache(cfg, batch, dtype, *, device="cpu"):
    mc = cfg.mamba
    dI = mc.expand * cfg.d_model
    return {"ssm": torch.zeros((batch, dI, mc.d_state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, mc.d_conv - 1, dI), dtype=dtype,
                                device=device)}


def _causal_conv(p, x, cache, mc):
    """Depthwise causal conv over time.  x: (B, S, dI).  Returns
    silu(conv(x)) and the last ``d_conv - 1`` inputs (the new conv
    tail), which the caller writes into the cache."""
    B, S, dI = x.shape
    dt = x.dtype
    prev = (cache["conv"].to(dt) if cache is not None
            else torch.zeros((B, mc.d_conv - 1, dI), dtype=dt,
                             device=x.device))
    xp = torch.cat([prev, x], dim=1)                     # (B, S+dc-1, dI)
    w = p["conv_w"].to(dt)                               # (dc, dI)
    out = xp[:, 0:S] * w[0]
    for i in range(1, mc.d_conv):
        out = out + xp[:, i:i + S] * w[i]
    out = out + p["conv_b"].to(dt)
    return F.silu(out), xp[:, -(mc.d_conv - 1):]


def apply_mamba(cfg, p, x, *, mode="decode", cache=None):
    """x: (B, S, d) -> (B, S, d).  A one-token ``"decode"`` call takes
    the one-step update ``mamba_step``; every other call (``"prefill"``,
    ``"train"``, a longer decode call) the selective scan ``mamba_scan``
    (the CUDA kernel on the card).  ``cache`` (or zeros when None, as in
    training) supplies the carried state and conv tail; a given cache
    receives the new ``ssm`` and ``conv`` in place."""
    mc = cfg.mamba
    B, S, d = x.shape
    dt_ = x.dtype
    dI = mc.expand * d
    dt_rank = p["dt_proj"].shape[0]

    xs = x @ p["in_x"].to(dt_)
    z = x @ p["in_z"].to(dt_)
    xs, new_conv = _causal_conv(p, xs, cache, mc)

    proj = xs @ p["x_proj"].to(dt_)
    dt_low = proj[..., :dt_rank]
    Bm = proj[..., dt_rank:dt_rank + mc.d_state]
    Cm = proj[..., dt_rank + mc.d_state:]
    dt_full = F.softplus(dt_low @ p["dt_proj"].to(dt_)
                         + p["dt_bias"].to(dt_))
    A = -torch.exp(p["A_log"].float())

    state0 = (cache["ssm"] if cache is not None
              else torch.zeros((B, dI, mc.d_state), dtype=torch.float32,
                               device=x.device))
    if mode == "decode" and S == 1:
        y, state = mamba_step(xs[:, 0], dt_full[:, 0], A, Bm[:, 0],
                              Cm[:, 0], p["D"], state0)
        y = y[:, None]
    else:
        y, state = mamba_scan(xs, dt_full, A, Bm, Cm, p["D"], state0)

    out = (y.to(dt_) * F.silu(z)) @ p["out_proj"].to(dt_)
    if cache is not None:
        cache["ssm"].copy_(state)
        cache["conv"].copy_(new_conv)
    return out
