"""A CPU model of the algebra of the WKV-6 kernel (``csrc/wkv6.cu``),
held to the port's plain versions at ``chip_smoke.py``'s bars.

The kernel computes each chunk of at most 32 steps as 16-row sub-chunks.
The score block of rows in the second sub-chunk against columns in the
first factors at the first sub-chunk's last row (``L_ref``), as the
product of the two bounded operands r * exp(Lp - L_ref) and
k * exp(L_ref - L); the two diagonal blocks keep the clipped exponential
per term and the bonus u.  Every product -- that block, (r e^Lp) @ S,
scores @ v and (k e^(L_last - L))^T @ v -- runs on the tensor cores with
split operands: a = hi + lo in the product type (bf16 for bf16 calls,
tf32 for fp32 calls), d = lo_a hi_b + hi_a lo_b + hi_a hi_b with fp32
sums.  The model below does the same in PyTorch on the CPU; it lives
here, on no path of the port.  The last cases pin why the split exists:
operands rounded once to bf16 break the bf16 bar on the clip-free
main-path chunk.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv6 import EXP_CLIP, wkv6_chunked, wkv6_ref

torch.set_num_threads(2)

# chip_smoke.py's bars: fp32 to the reference's own WKV bar; bf16 y and
# state also one bf16 step relative
WKV_ATOL, WKV_BF16_RTOL = 5e-4, 2 ** -7
TILE, SUB = 32, 16


def round_bf16(x):
    return x.to(torch.bfloat16).float()


def round_tf32(x):
    """fp32 to tf32, nearest with ties away from zero (``cvt.rna``): add
    half of the dropped 13 bits to the magnitude, then clear them."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, rnd, *, split, exact_b=False):
    """a @ b over the last / first axes as the kernel's mma.sync runs it:
    split operands (hi + lo) and three products, or one rounding each
    (``split=False``); fp32 sums."""
    ah = rnd(a)
    bh = b if exact_b else rnd(b)
    out = ah @ bh
    if split:
        out = (rnd(a - ah) @ bh) + out
        if not exact_b:
            out = (ah @ rnd(b - bh)) + out
    return out


def factored_chunk(S, r, k, v, wl, u, rnd, *, split, exact_v):
    """One chunk.  S: (B, H, K, K); r, k, v, wl: (B, c, H, K) with c <= 32,
    fp32.  Returns the new state and y (B, c, H, K)."""
    B, c, H, K = r.shape
    pad = TILE - c                                    # the kernel's zero rows
    r, k, v, wl = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in (r, k, v, wl))
    # (B, H, TILE, K) from here on
    r, k, v, wl = (a.permute(0, 2, 1, 3) for a in (r, k, v, wl))
    L = torch.cumsum(wl, dim=2)
    Lp = L - wl
    Llast = L[:, :, -1:]
    Lref = L[:, :, SUB - 1:SUB]
    scores = torch.zeros(B, H, TILE, TILE)
    tri = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), diagonal=-1)
    for blk in range(TILE // SUB):
        s = slice(blk * SUB, (blk + 1) * SUB)
        D = (Lp[:, :, s, None] - L[:, :, None, s]).clamp(EXP_CLIP, 0.0)
        W = torch.exp(D) * tri[None, None, :, :, None]
        diag = torch.einsum("bhtk,bhjk,bhtjk->bhtj", r[:, :, s], k[:, :, s], W)
        bonus = torch.einsum("bhtk,hk,bhtk->bht", r[:, :, s], u, k[:, :, s])
        scores[:, :, s, s] = diag + torch.diag_embed(bonus)
    r_off = r[:, :, SUB:] * torch.exp(Lp[:, :, SUB:] - Lref)
    k_off = k[:, :, :SUB] * torch.exp(Lref - L[:, :, :SUB])
    scores[:, :, SUB:, :SUB] = product(r_off, k_off.transpose(-1, -2), rnd,
                                       split=split)
    y = (product(r * torch.exp(Lp), S, rnd, split=split)
         + product(scores, v, rnd, split=split, exact_b=exact_v))
    k_sc = k * torch.exp(Llast - L)
    S_new = torch.exp(Llast).transpose(-1, -2) * S + product(
        k_sc.transpose(-1, -2), v, rnd, split=split, exact_b=exact_v)
    return S_new, y.permute(0, 2, 1, 3)[:, :c]


def factored_wkv6(r, k, v, wl, u, s0, *, dtype, split=True):
    """The kernel's algebra over a call: chunks of min(32, T) steps; bf16
    calls take bf16 products (v exact) and round y to bf16, fp32 calls
    take tf32 products."""
    bf = dtype == torch.bfloat16
    rnd = round_bf16 if bf else round_tf32
    B, T, H, K = r.shape
    C = min(TILE, T)
    S = s0.float()
    ys = []
    for t0 in range(0, T, C):
        sl = slice(t0, min(t0 + C, T))
        S, y = factored_chunk(S, *(a[:, sl].float() for a in (r, k, v, wl)),
                              u.float(), rnd, split=split, exact_v=bf)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return (round_bf16(y) if bf else y), S


def wkv_inputs(seed, B, T, H, K, decay):
    """chip_smoke.py's ``wkv_case``: r, k, v ~ N(0, 1); log-decays
    -exp(N(0, 1)), or -decay * exp(0.3 N(0, 1)) to reach the -60 clip;
    u and a nonzero carried state ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    if decay:
        wl = -decay * np.exp(0.3 * rng.standard_normal((B, T, H, K)))
    else:
        wl = -np.exp(rng.standard_normal((B, T, H, K)))
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in
                 (r, k, v, wl.astype(np.float32), u, s0))


def tolerance_used(got, want, rtol):
    """The largest |got - want| / (atol + rtol |want|): <= 1 passes."""
    return ((got.float() - want.float()).abs()
            / (WKV_ATOL + rtol * want.float().abs())).max().item()


CASES = [
    # B, T, H, K, decay (0: the reference's decays; > 0 reaches the clip)
    (1, 1, 2, 64, 0.0),
    (2, 2, 2, 32, 0.0),
    (1, 17, 3, 64, 0.0),
    (2, 31, 2, 32, 0.0),
    (1, 32, 4, 64, 0.0),      # the serving path's chunk (H cut from 32)
    (2, 33, 2, 64, 0.0),      # a second chunk of one step
    (2, 80, 2, 32, 0.0),      # three chunks carry the state
    (1, 64, 2, 64, 2.5),      # decays past the -60 clip, two chunks
    (2, 32, 2, 32, 2.5),
]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])   # 3xTF32, bf16 hi + lo
@pytest.mark.parametrize("case", CASES)
def test_factored_model_matches_plain(case, precision):
    B, T, H, K, decay = case
    r, k, v, wl, u, s0 = wkv_inputs(sum(case[:4]), B, T, H, K, decay)
    if decay:                 # the clip is reached: |L_j - Lp_t| > 60 in a chunk
        L = torch.cumsum(wl[:, :32], dim=1)
        assert (L[:, -1] - L[:, 0] < -60).any()
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    r, k, v = (a.to(dtype) for a in (r, k, v))
    y, s = factored_wkv6(r, k, v, wl, u, s0, dtype=dtype)
    rtol = WKV_BF16_RTOL if dtype == torch.bfloat16 else 0.0
    y_c, s_c = wkv6_chunked(r, k, v, wl, u, s0)
    used = max(tolerance_used(y, y_c, rtol), tolerance_used(s, s_c, rtol))
    assert used <= 1.0, f"{used:.3f} of the tolerance"
    # the naive scan: the chunked form's own re-association on top
    y_r, s_r = wkv6_ref(r, k, v, wl, u, s0)
    used = max(tolerance_used(y, y_r, rtol), tolerance_used(s, s_r, rtol))
    assert used <= 1.0, f"{used:.3f} of the tolerance against the scan"


@pytest.mark.parametrize("split,within", [(True, True), (False, False)],
                         ids=["split", "single-rounding"])
def test_factored_model_split_is_needed(split, within):
    """The serving path's clip-free chunk (B 1, T 32, K 64) in bf16:
    split operands stay within the bf16 bar, operands rounded once to
    bf16 do not."""
    case = (1, 32, 4, 64, 0.0)
    r, k, v, wl, u, s0 = wkv_inputs(sum(case[:4]), *case)
    r, k, v = (a.to(torch.bfloat16) for a in (r, k, v))
    y, s = factored_wkv6(r, k, v, wl, u, s0, dtype=torch.bfloat16,
                         split=split)
    y_c, s_c = wkv6_chunked(r, k, v, wl, u, s0)
    used = max(tolerance_used(y, y_c, WKV_BF16_RTOL),
               tolerance_used(s, s_c, WKV_BF16_RTOL))
    assert (used <= 1.0) == within, f"{used:.3f} of the tolerance"
