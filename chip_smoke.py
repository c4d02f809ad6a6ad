"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [--max-splits N]   (phases 1-2)

Phases (each fails the run if it goes wrong):
  1. the card's name and power limit; build every CUDA kernel of the
     serving paths from ``src/repro_torch/csrc`` with nvcc for sm_90a,
     one nvcc per source, all started together;
  2. each kernel against its plain PyTorch version at the main paths'
     full-width shapes, fp32 and bf16, with its time, the plain
     version's, the one-call PyTorch yardstick's (where there is one)
     and the bound; the flash kernel also at the training shape (B 1,
     S = T = 4096), forward and the gradients of its autograd Function;
  3. the qwen3 path: full-width qwen3-1.7b in bf16 (weights from a seed)
     serves 16 requests on 8 slots through the continuous scheduler,
     with every attention call launched through the paged-decode kernel;
  4. parity: a 2-layer full-width qwen3 in fp32 gives the same greedy
     tokens on the card (kernel) as on the CPU (plain version);
  5. the RWKV-6 path: full-width, full-depth rwkv6-1.6b in bf16 serves
     the same traffic, with every prefill chunk of two or more tokens
     launched through the WKV6 kernel in each of its 24 layers;
  6. parity: a 2-layer full-width rwkv6-1.6b in fp32 gives the same
     greedy tokens on the card (kernel) as on the CPU (plain version);
  7. the Jamba path: jamba-v0.1-52b at full width, its depth cut to one
     8-layer super-block (7 Mamba layers, 1 attention layer, MoE in every
     other layer), serves the same traffic in bf16, with every prefill
     chunk of two or more tokens launched through the selective-scan
     kernel in each Mamba layer and every attention call through the
     paged-decode kernel;
  8. parity: a 2-layer full-width Jamba in fp32 -- (Mamba, MLP) then
     (attention, MoE) -- gives the same greedy tokens on the card
     (kernels) as on the CPU (plain versions);
  9. the DeepSeek-V3 path: deepseek-v3-671b at full width, its depth cut
     to its first 4 layers (3 dense layers, 1 MoE layer of 256 experts),
     serves the same traffic in bf16, with every MLA layer of every
     model call launched through the absorbed-MLA paged-decode kernel;
 10. parity: a 2-layer full-width DeepSeek-V3 in fp32 -- (MLA, dense
     MLP) then (MLA, MoE), the routed experts cut 256 -> 16 for this
     phase only -- gives the same greedy tokens on the card (kernel) as
     on the CPU (plain version);
 11. the lockstep slab path: full-width, full-depth qwen3-1.7b in bf16
     serves 8 requests of 512 prompt tokens (64 greedy new tokens each)
     through ``ServeEngine``, with every attention call -- the
     whole-prompt prefill and each decode step, in every layer --
     launched through the flash-attention kernel;
 12. parity: a 2-layer full-width qwen3-1.7b in fp32 gives the same
     greedy tokens through the lockstep engine on the card (kernel) as
     on the CPU (plain version);
 13. the training path: full-width, full-depth qwen3-1.7b, bf16 compute
     on fp32 masters, AdamW, takes 1 + 5 steps on one batch of 2 x 4096
     tokens in 2 microbatches with per-layer remat, every attention
     forward (and its recompute) launched through the flash kernel;
 14. parity: a 2-layer full-width qwen3-1.7b in fp32 takes 3 AdamW steps
     on the card (kernel forward) and on the CPU (plain version) with
     agreeing losses and params;
 15. the paper's claim: MNIST-DNN and CIFAR10-CNN at Table-1 width take
     5 SGD steps on the card equal to the CPU's (fp32, TF32 off; the
     CNN held to 1e-5 after its first step, to 1e-4 after the fifth);
     the MNIST-DNN launcher under torchrun, 2 gloo ranks sharing the
     card, equals the card's sequential run for flat and bucketed, and
     4 ranks (pod 2 x data 2) for hierarchical; weight averaging every
     2 steps leaves the ranks bitwise equal after steps 2 and 4;
 16. full-width qwen3-1.7b through ``Trainer(model_cfg=...)`` over a
     world of one NCCL rank, dp=flat then dp=bucketed, 3 steps on phase
     13's batch: the losses equal phase 13's first 3 bit for bit, with
     exactly 3 x 2 x 28 x 2 = 336 flash_attention launches a run;
 17. checkpoints: phase 16's bucketed trainer (full-width, full-depth
     qwen3-1.7b after 3 steps) saves asynchronously with its data cursor
     (20.6 GB of fp32 masters, m and v) and takes step 4 while the
     writer publishes; a fresh trainer restores the checkpoint to
     masters, m and v equal to a host copy taken at the save, bit for
     bit; it serves phase 3's traffic, and so does
     ``make_engine_from_checkpoint``, with bitwise-equal greedy tokens
     and exactly 28 x 282 = 7896 paged_flash_decode launches each; then
     its step gives step 4's loss bit for bit (112 flash_attention
     launches).  The checkpoint is deleted at the phase's end.
 18. the ZeRO ladder.  (a) full-width, full-depth qwen3-1.7b through
     ``Trainer(model_cfg=...)`` over phase 16's world of one NCCL rank,
     dp = zero1, zero2, zero3 and zero1 with overlap=True, 3 steps each
     on phase 13's batch: exactly 112 flash_attention launches a step,
     zero1's losses phase 16's flat losses bit for bit (one rank's
     reduce-scatter is a copy and AdamW is elementwise), zero2's and
     zero3's within 1e-5, peak under 80 GB; the reduce-scatter and
     all-gather ms (SyncTimer) and the memory between steps printed.
     (b) 2 gloo ranks sharing the card (torchrun of this script), full
     width at depth 4 (reduced: num_layers 28 -> 4), each rank 1 x 4096
     tokens of phase 13's batch, dp = flat, zero1, zero2, zero3, 3 steps
     each: the losses within 1e-5 of flat's, zero3's memory between
     steps at most 0.55 x flat's, zero1's moments 1/2; zero3 saves at
     step 3 with save_async (every rank its own worker file) and takes
     step 4; a one-rank bucketed trainer restores that checkpoint, its
     step 4 gives zero3's step-4 loss within 1e-5, and Trainer.serve()
     of both serves phase 3's traffic at depth 4 with equal greedy
     tokens and 4 x 282 paged_flash_decode launches each.  The
     checkpoint is deleted at the phase's end.
The last lines are the kernels' JSON record, the card's name and power
limit, and the result line.  Without a card, or outside the repository,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,        # dense tensor-core bf16
            torch.float32: 67e12}          # fp32 outside the tensor cores
# kernel vs plain version on the card: fp32 is held to the reference's
# own kernel bar; bf16 to its 8-bit mantissa (the plain version also
# rounds the probabilities to bf16 before the value product)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# wkv6: fp32 to the reference's own WKV bar (tests/test_kernels.py; the
# chunked form re-associates the time sums); bf16 y additionally to one
# bf16 step (2^-7 relative), since both sides round fp32 sums taken in
# another order to bf16
WKV_ATOL, WKV_BF16_RTOL = 5e-4, 2 ** -7
# mamba_scan: the reference's own Mamba bar (tests/test_kernels.py), and
# one bf16 step of y in bf16, for the same reason as wkv6
MAMBA_ATOL, MAMBA_BF16_RTOL = 5e-4, 2 ** -7
POISON = 1e4
# the init peak the DeepSeek-V3 phase must stay under: the resident
# model plus one 15 GB fp32 expert tensor being drawn
DEEPSEEK_INIT_PEAK_GIB = 48.0

# the serving run of phase 3
SLOTS, REQUESTS, NEW_TOKENS = 8, 16, 64
PROMPT_MIN, PROMPT_MAX = 64, 512
PAGE_SIZE, DECODE_CHUNK, PREFILL_CHUNK = 16, 8, 32
MAX_LEN = -(-(PROMPT_MAX + NEW_TOKENS + DECODE_CHUNK) // PAGE_SIZE) * PAGE_SIZE
SERVE_KW = dict(batch_size=SLOTS, max_len=MAX_LEN, page_size=PAGE_SIZE,
                decode_chunk=DECODE_CHUNK, prefill_chunk=PREFILL_CHUNK)
# the lockstep slab run of phase 11: 8 requests of 512 prompt tokens
LEGACY_BATCH, LEGACY_PROMPT, LEGACY_MAX_LEN = 8, 512, 592
# the training run of phases 13-14: qwen3-1.7b on 2 x 4096 tokens (the
# reference's train_4k length, repro/configs/base.py:315) in 2 microbatches
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_TIMED = 2, 4096, 2, 5
TRAIN_LR = 3e-4
# the flash backward (plain, q-chunked) against autograd of the plain
# forward, as max |err| / max |grad| over dq, dk, dv: fp32 re-associates
# sums over 4096 rows; bf16 rounds each chunk's products to bf16 where
# the unchunked version rounds once
TRAIN_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# phase 14 (card vs CPU, fp32): step 1 runs on equal weights; later
# steps follow AdamW, whose g / (|g| + eps) moves an entry whose
# gradient is near eps = 1e-8 by up to lr a step on rounding alone
TRAIN_LOSS_RTOL_FIRST, TRAIN_LOSS_RTOL_LATER = 1e-5, 1e-4
# phase 15: the Table-1 nets, fp32 with TF32 off, card vs CPU and
# data-parallel vs sequential (5 steps; the reference's DP bar is 1e-6 on
# the CPU, and the card's fp32 products re-associate the sums)
PAPER_STEPS, PAPER_BATCH, PAPER_SAMPLES, PAPER_TOL = 5, 256, 4096, 1e-5
# ... the CNNs held to PAPER_TOL after their first step (equal weights)
# and to this after 5: max-pool routes each gradient to its window's
# argmax, and at lr 0.1 CIFAR10-CNN's loss rises (2.43 -> 7.88), so a
# near-tie that two fp32 summation orders decide apart moves whole
# entries and the steps grow it; two calls on the same inputs read
# 1.35e-5 and 5.3e-6
CNN_LATER_TOL = 1e-4
# phase 16: full-width qwen3-1.7b through the Trainer, phase 13's batch
DP_STEPS = 3
# phase 17: where the checkpoint goes (gitignored; deleted at the end)
CKPT_DIR = os.path.join(ROOT, "build", "ckpt_phase17")
# phase 18: the ZeRO runs; (b)'s depth, its ranks' files and checkpoint
ZERO_STRATEGIES = (("zero1", False), ("zero2", False), ("zero3", False),
                   ("zero1", True))
ZERO_LAYERS, ZERO_RANKS = 4, 2
ZERO_LOSS_TOL = 1e-5          # the reference's fp32 training bar
ZERO3_MEM_RATIO = 0.55        # zero3's bytes between steps / flat's
ZERO_DIR = os.path.join(ROOT, "build", "zero_phase18")
# the reference's FLASH_CASES (tests/test_kernels.py)
FLASH_CASES = [
    # B, S, T, h, hk, hd, causal, window
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 96, 160, 4, 4, 64, True, 0),       # right-aligned decode-style
    (2, 128, 128, 8, 2, 128, True, 48),    # sliding window
    (1, 64, 64, 2, 1, 64, False, 0),       # bidirectional, MQA
    (1, 33, 70, 2, 2, 64, True, 0),        # ragged (padding paths)
]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def paged_case(rng, B, S, h, hk, hd, ps, W, lengths):
    """q, poisoned token-major pools, table and positions; slot b has
    lengths[b] tokens written and its S queries at the last S of them."""
    n_pages = W * B + 2
    k = np.full((n_pages * ps, hk, hd), POISON, np.float32)
    v = np.full((n_pages * ps, hk, hd), POISON, np.float32)
    table = np.zeros((B, W), np.int32)
    nxt = 1
    for b in range(B):
        for w in range(-(-int(lengths[b]) // ps)):
            table[b, w] = nxt
            n = min(ps, int(lengths[b]) - w * ps)
            k[nxt * ps:nxt * ps + n] = rng.standard_normal((n, hk, hd))
            v[nxt * ps:nxt * ps + n] = rng.standard_normal((n, hk, hd))
            nxt += 1
    q = rng.standard_normal((B, S, h, hd)).astype(np.float32)
    pos = np.stack([np.arange(L - S, L) for L in lengths]).astype(np.int32)
    return q, k, v, table, pos


def time_ms(fn, flush, iters=20):
    """Median device time of fn() over iters calls, each timed alone with
    CUDA events after the L2 cache was flushed (the serving path finds a
    layer's pool cold: 28 layers' pools exceed the 50 MB L2).  The card
    spins for about 5 ms before the start event, so the host has
    enqueued all of fn() by then and the events time the device's work,
    not the host's launch overhead; the median drops a call whose
    enqueue a host stall still made outlast the spin."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(10_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_paged_decode(dev, flush, h=16, windowed=True, tag=""):
    """The paged kernel at h query heads over 8 kv heads of 128 (qwen3-
    1.7b: h=16; Jamba's attention layer: h=32)."""
    import torch.nn.functional as F
    from repro_torch.kernels import gqa_split
    from repro_torch.kernels.paged_decode import (
        paged_flash_decode, paged_flash_decode_ref, visible_tokens)
    from repro_torch.models.attention import PagedView, paged_read

    hk, ps = 8, PAGE_SIZE
    W = MAX_LEN // ps
    rng = np.random.default_rng(0)
    cases = [
        ("decode B=8 S=1, slots 1..max_len tokens", 8, 1, 0,
         np.linspace(1, W * ps, 8).astype(int), 128),
        ("prefill chunk B=1 S=32", 1, 32, 0, np.array([PROMPT_MAX]), 128),
    ]
    if windowed:
        # every key of the windowed chunk's early splits is masked; the
        # narrower heads run the other builds of the bf16 kernel
        cases += [("windowed chunk B=4 S=32 window=100", 4, 32, 100,
                   np.array([40, 200, 333, 560]), 128),
                  ("decode B=8 S=1 hd=64", 8, 1, 0,
                   np.linspace(1, W * ps, 8).astype(int), 64),
                  ("prefill chunk B=1 S=32 hd=32", 1, 32, 0,
                   np.array([PROMPT_MAX]), 32)]
    cases = [(tag + name, *rest) for name, *rest in cases]
    rows = []
    for name, B, S, window, lengths, hd in cases:
        host = paged_case(rng, B, S, h, hk, hd, ps, W, lengths)
        poisoned = [torch.from_numpy(x == POISON).to(dev) for x in host[1:3]]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(x).to(dev, dtype) for x in host[:3])
            table, pos = (torch.from_numpy(x).to(dev) for x in host[3:])
            got = paged_flash_decode(q, k, v, table, pos, page_size=ps,
                                     window=window)
            want = paged_flash_decode_ref(q, k, v, table, pos, page_size=ps,
                                          window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                fail(f"paged_flash_decode {name} {dtype}: max |err| {err}")
            # poisoned trash page / unwritten storage: 1e4 -> 1e8 must not
            # change one bit of the output
            big_k, big_v = (torch.where(m, 1e8, x.float()).to(dtype)
                            for m, x in zip(poisoned, (k, v)))
            again = paged_flash_decode(q, big_k, big_v, table, pos,
                                       page_size=ps, window=window)
            if not torch.equal(got, again):
                fail(f"paged_flash_decode {name} {dtype}: trash leaked")
            # the one-call yardstick: SDPA over the pre-gathered slab
            view = PagedView(table, ps)
            k_full, kv_pos = paged_read(k, view)
            v_full, _ = paged_read(v, view)
            mask = kv_pos[None, None, :] <= pos[:, :, None]
            if window:
                mask &= kv_pos[None, None, :] > pos[:, :, None] - window
            qt, kt_, vt = (x.transpose(1, 2).contiguous()
                           for x in (q, k_full, v_full))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt_, vt, attn_mask=mask[:, None], enable_gqa=True)
            ms = time_ms(lambda: paged_flash_decode(
                q, k, v, table, pos, page_size=ps, window=window), flush)
            plain_ms = time_ms(lambda: paged_flash_decode_ref(
                q, k, v, table, pos, page_size=ps, window=window), flush)
            library_ms = time_ms(sdpa, flush)
            # bound: each visible K/V row read once, q read and out
            # written once; operations 4*hd per visible (query, key)
            n_vis = visible_tokens(host[4], W, ps, window)
            el = q.element_size()
            n_bytes = (n_vis * hk * hd * 2 * el + 2 * q.numel() * el
                       + table.numel() * 4 + pos.numel() * 4)
            kv_pos_np = np.arange(W * ps)
            vis_pairs = 0
            for b in range(B):
                for s in range(S):
                    p = host[4][b, s]
                    m = kv_pos_np <= p
                    if window:
                        m &= kv_pos_np > p - window
                    vis_pairs += int(m.sum())
            ops = 4 * hd * h * vis_pairs
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dtype] * 1e3
            rows.append({
                "case": name, "dtype": str(dtype).replace("torch.", ""),
                "splits": (gqa_split.plan(B * hk, h // hk * S, W * ps)[1]
                           if dtype == torch.bfloat16 else 1),
                "max_abs_err": err, "tol": tol, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "ops": ops})
            print(f"  paged_flash_decode {name:40s} {rows[-1]['dtype']:8s} "
                  f"splits {rows[-1]['splits']}  "
                  f"err {err:.2e} (tol {tol:g})  kernel {ms:.4f} ms  "
                  f"plain {plain_ms:.4f} ms  sdpa-on-slab {library_ms:.4f} ms"
                  f"  bound {rows[-1]['bound_ms']:.4f} ms "
                  f"({rows[-1]['bound_by']})")
    return rows


def mla_case(rng, B, S, h, r, rope, ps, W, lengths):
    """q_lat, q_rope, poisoned token-major latent and rope-key pools,
    table and positions; slot b has lengths[b] tokens written and its S
    queries at the last S of them."""
    n_pages = W * B + 2
    ckv = np.full((n_pages * ps, r), POISON, np.float32)
    krope = np.full((n_pages * ps, rope), POISON, np.float32)
    table = np.zeros((B, W), np.int32)
    nxt = 1
    for b in range(B):
        for w in range(-(-int(lengths[b]) // ps)):
            table[b, w] = nxt
            n = min(ps, int(lengths[b]) - w * ps)
            ckv[nxt * ps:nxt * ps + n] = rng.standard_normal((n, r))
            krope[nxt * ps:nxt * ps + n] = rng.standard_normal((n, rope))
            nxt += 1
    q_lat = rng.standard_normal((B, S, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((B, S, h, rope)).astype(np.float32)
    pos = np.stack([np.arange(L - S, L) for L in lengths]).astype(np.int32)
    return q_lat, q_rope, ckv, krope, table, pos


def sdpa_backend(*args, **kw):
    """The backend PyTorch's dispatcher picks for these SDPA inputs."""
    from torch.nn.attention import SDPBackend
    try:
        choice = torch._fused_sdp_choice(*args, **kw)
    except (AttributeError, RuntimeError) as e:
        return f"not determined ({type(e).__name__})"
    for backend in SDPBackend.__members__.values():
        if backend.value == choice:
            return backend.name
    return str(choice)


def check_paged_decode_mla(dev, flush):
    """The absorbed-MLA kernel at deepseek-v3-671b's widths: 128 query
    heads over one latent of 512 and a rope key of 64, page 16."""
    import torch.nn.functional as F
    from repro_torch.kernels import mla_split
    from repro_torch.kernels.paged_decode import (
        paged_flash_decode_mla, paged_flash_decode_mla_ref, visible_tokens)
    from repro_torch.models.attention import PagedView, paged_read

    h, r, rope, ps = 128, 512, 64, PAGE_SIZE
    W = MAX_LEN // ps
    scale = float(np.float32(1 / np.sqrt(128 + 64)))     # 1/sqrt(nope+rope)
    rng = np.random.default_rng(3)
    cases = [
        ("decode B=8 S=1, slots ~512 tokens", 8, 1, 0,
         rng.integers(480, 545, 8)),
        ("prefill chunk B=1 S=32, 544 tokens", 1, 32, 0, np.array([544])),
        ("ragged windowed chunk B=4 S=32 window=100", 4, 32, 100,
         np.array([40, 200, 333, 560])),
    ]
    rows = []
    for name, B, S, window, lengths in cases:
        host = mla_case(rng, B, S, h, r, rope, ps, W, lengths)
        poisoned = [torch.from_numpy(x == POISON).to(dev) for x in host[2:4]]
        for dtype in (torch.float32, torch.bfloat16):
            ins = [torch.from_numpy(x).to(dev, dtype) for x in host[:4]]
            table, pos = (torch.from_numpy(x).to(dev) for x in host[4:])
            args = (*ins, table, pos)
            kw = dict(page_size=ps, scale=scale, window=window)
            got = paged_flash_decode_mla(*args, **kw)
            want = paged_flash_decode_mla_ref(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                fail(f"paged_flash_decode_mla {name} {dtype}: max |err| "
                     f"{err}")
            # poisoned trash page / unwritten storage: 1e4 -> 1e8 must not
            # change one bit of the output
            big = [torch.where(m, 1e8, x.float()).to(dtype)
                   for m, x in zip(poisoned, ins[2:4])]
            again = paged_flash_decode_mla(*ins[:2], *big, table, pos, **kw)
            if not torch.equal(got, again):
                fail(f"paged_flash_decode_mla {name} {dtype}: trash leaked")
            # the one-call yardstick: SDPA on the pre-gathered slab, q =
            # [q_lat | q_rope], k = [ckv | krope] (576 wide), v = ckv
            view = PagedView(table, ps)
            ckv_c, kv_pos = paged_read(ins[2], view)
            kr_c, _ = paged_read(ins[3], view)
            mask = kv_pos[None, None, :] <= pos[:, :, None]
            if window:
                mask &= kv_pos[None, None, :] > pos[:, :, None] - window
            qt = torch.cat(ins[:2], -1).transpose(1, 2).contiguous()
            kt = torch.cat([ckv_c, kr_c], -1)[:, None].contiguous()
            vt = ckv_c[:, None].contiguous()
            sdpa_kw = dict(attn_mask=mask[:, None], scale=scale,
                           enable_gqa=True)
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          **sdpa_kw)
            sdpa_err = (sdpa().transpose(1, 2).float()
                        - want.float()).abs().max().item()
            backend = sdpa_backend(qt, kt, vt, mask[:, None], 0.0, False,
                                   scale=scale, enable_gqa=True)
            ms = time_ms(lambda: paged_flash_decode_mla(*args, **kw), flush)
            plain_ms = time_ms(lambda: paged_flash_decode_mla_ref(*args, **kw),
                               flush)
            library_ms = time_ms(sdpa, flush)
            # bound: each visible latent and rope row read once, q read and
            # out written once; 2 (2 r + rope) operations per visible
            # (query row, key)
            n_vis = visible_tokens(host[5], W, ps, window)
            el = ins[0].element_size()
            n_bytes = (n_vis * (r + rope) * el
                       + (2 * ins[0].numel() + ins[1].numel()) * el
                       + table.numel() * 4 + pos.numel() * 4)
            kv_pos_np = np.arange(W * ps)
            vis_pairs = 0
            for b in range(B):
                for s_ in range(S):
                    p = host[5][b, s_]
                    m = kv_pos_np <= p
                    if window:
                        m &= kv_pos_np > p - window
                    vis_pairs += int(m.sum())
            ops = 2 * (2 * r + rope) * h * vis_pairs
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dtype] * 1e3
            # bf16: two-warpgroup wgmma blocks of 64 rows, keys split over
            # a cluster; fp32: the first version's FMA kernel
            if dtype == torch.bfloat16:
                warps, splits = mla_split.plan(B, h * S, W * ps)
                n_blocks = mla_split.blocks(B, h * S, splits)
            else:
                rt = 16 if B * -(-h * S // 16) >= 132 else 8
                warps, splits, n_blocks = 8, 1, B * -(-h * S // rt)
            rows.append({
                "case": name, "dtype": str(dtype).replace("torch.", ""),
                "warps": warps, "splits": splits, "blocks": n_blocks,
                "max_abs_err": err, "tol": tol, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "sdpa_backend": backend, "sdpa_max_abs_err": sdpa_err,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "ops": ops})
            print(f"  paged_flash_decode_mla {name:42s} "
                  f"{rows[-1]['dtype']:8s} warps {warps} splits {splits} "
                  f"blocks {n_blocks}  "
                  f"err {err:.2e} (tol {tol:g})  kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  sdpa-on-slab {library_ms:.4f} ms "
                  f"({backend}, err {sdpa_err:.1e})  bound "
                  f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}: "
                  f"{n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
    return rows


def flash_bound(B, S, T, h, hk, hd, causal, window, el):
    """Bytes (q, k, v read once, out written once) and operations (4 hd
    per visible (query head row, key) pair) of one flash call."""
    n_bytes = (2 * B * S * h * hd + 2 * B * T * hk * hd) * el
    qpos = np.arange(S)[:, None] + (T - S)
    kpos = np.arange(T)[None, :]
    vis = np.ones((S, T), bool)
    if causal:
        vis &= kpos <= qpos
    if window:
        vis &= kpos > qpos - window
    return n_bytes, 4 * hd * h * B * int(vis.sum())


def check_flash_attention(dev, flush):
    """The flash kernel against its plain version: the reference's own
    FLASH_CASES, a strided slab slice with a poisoned tail, and the two
    full-width shapes of the slab path (timed beside SDPA)."""
    import torch.nn.functional as F
    from repro_torch.kernels import gqa_split
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    rng = np.random.default_rng(4)
    hk, hd = 8, 128                                     # qwen3-1.7b widths

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def splits(q, k):
        B, S, h = q.shape[:3]
        T, hk = k.shape[1:3]
        return (gqa_split.plan(B * hk, h // hk * S, T)[1]
                if q.dtype == torch.bfloat16 else 1)

    def compare(name, q, k, v, causal=True, window=0):
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[q.dtype]
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            fail(f"flash_attention {name} {q.dtype}: max |err| {err}")
        return got, err

    rows = []
    for case in FLASH_CASES:
        B, S, T, h, hk_, hd_, causal, window = case
        host = (normal(B, S, h, hd_), normal(B, T, hk_, hd_),
                normal(B, T, hk_, hd_))
        for dtype in (torch.float32, torch.bfloat16):
            name = f"FLASH_CASES {case}"
            q, k, v = (x.to(dtype) for x in host)
            _, err = compare(name, q, k, v, causal, window)
            rows.append({"case": name, "dtype": str(dtype)[6:],
                         "splits": splits(q, k), "max_abs_err": err,
                         "tol": TOL[dtype]})
            print(f"  flash_attention {name:44s} {rows[-1]['dtype']:8s} "
                  f"splits {rows[-1]['splits']}  err {err:.2e} "
                  f"(tol {TOL[dtype]:g})")
    full = [
        # name, B, S, T (valid keys), slab length, causal
        (f"prefill B={LEGACY_BATCH} S=T={LEGACY_PROMPT}", LEGACY_BATCH,
         LEGACY_PROMPT, LEGACY_PROMPT, LEGACY_PROMPT),
        (f"decode B={LEGACY_BATCH} S=1 T={LEGACY_PROMPT + NEW_TOKENS} (slab "
         "slice)", LEGACY_BATCH, 1, LEGACY_PROMPT + NEW_TOKENS,
         LEGACY_MAX_LEN),
        ("strided chunk B=3 S=7 T=300 (slab slice)", 3, 7, 300,
         LEGACY_MAX_LEN),
    ]
    for name, B, S, T, L, in full:
        host = (normal(B, S, 16, hd), normal(B, L, hk, hd),
                normal(B, L, hk, hd))
        for dtype in (torch.float32, torch.bfloat16):
            q, kc, vc = (x.to(dtype) for x in host)
            for t in (kc, vc):
                t[:, T:] = POISON                     # the unwritten tail
            k, v = kc[:, :T], vc[:, :T]
            got, err = compare(name, q, k, v)
            for t in (kc, vc):
                t[:, T:] = 1e8
            if not torch.equal(flash_attention(q, k, v), got):
                fail(f"flash_attention {name} {dtype}: the slab's tail "
                     "leaked")
            row = {"case": name, "dtype": str(dtype)[6:],
                   "splits": splits(q, k), "max_abs_err": err,
                   "tol": TOL[dtype]}
            rows.append(row)
            if name.startswith("strided"):
                print(f"  flash_attention {name:44s} {row['dtype']:8s} "
                      f"splits {row['splits']}  err "
                      f"{err:.2e} (tol {TOL[dtype]:g}); poisoned tail "
                      "changes no bit")
                continue
            # the one-call yardstick: SDPA in (B, h, S, hd) layout, GQA;
            # is_causal is exact at S == T, a decode step needs no mask
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            causal = S == T
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            backend = sdpa_backend(qt, kt, vt, None, 0.0, causal,
                                   enable_gqa=True)
            row["ms"] = time_ms(lambda: flash_attention(q, k, v), flush)
            row["plain_ms"] = time_ms(lambda: flash_attention_ref(q, k, v),
                                      flush)
            row["library_ms"] = time_ms(sdpa, flush)
            row["sdpa_backend"] = backend
            n_bytes, ops = flash_bound(B, S, T, 16, hk, hd, True, 0,
                                       q.element_size())
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dtype] * 1e3
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=n_bytes, ops=ops)
            print(f"  flash_attention {name:44s} {row['dtype']:8s} splits "
                  f"{row['splits']}  err {err:.2e} (tol {TOL[dtype]:g})  "
                  f"kernel {row['ms']:.4f} ms"
                  f"  plain {row['plain_ms']:.4f} ms  sdpa "
                  f"{row['library_ms']:.4f} ms ({backend})  bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                  f"{n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
    return rows


def flash_bwd_bound(B, S, T, h, hk, hd, causal, el):
    """Bytes (q, k, v and the output gradient read once; dq, dk, dv
    written once) and operations of the attention backward: 10 hd per
    visible (query head row, key) pair -- the scores recomputed, then
    the four products dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q."""
    n_bytes = (4 * B * S * h * hd + 4 * B * T * hk * hd) * el
    _, fwd_ops = flash_bound(B, S, T, h, hk, hd, causal, 0, el)
    return n_bytes, fwd_ops // 4 * 10


def check_flash_train(dev, flush):
    """The flash kernel at the training shape (B 1, S = T = TRAIN_SEQ,
    qwen3's 16 q / 8 kv heads of 128, causal): the forward against the
    plain version, and the gradients of ``FlashAttention`` (the kernel's
    forward, the plain q-chunked backward) against autograd of the plain
    version; times beside cuDNN SDPA's forward and forward + backward
    and beside the bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_ref, flash_attention_ref)

    B, S, h, hk, hd = 1, TRAIN_SEQ, 16, 8, 128
    rng = np.random.default_rng(13)
    host = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((B, S, h, hd), (B, S, hk, hd), (B, S, hk, hd),
                          (B, S, h, hd))]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (x.to(dev, dtype) for x in host)
        got = flash_attention(q, k, v)
        want = flash_attention_ref(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=TOL[dtype],
                              rtol=TOL[dtype]):
            fail(f"flash_attention train shape {dtype}: max |err| {err}")
        del got, want
        # the Function's gradients against autograd of the plain version
        reset_launch_counts()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention(*leaves).backward(dout)
        if launch_counts().get("flash_attention", 0) != 1:
            fail("the autograd Function did not launch the kernel once")
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention_ref(*ref_leaves).backward(dout)
        grad_err = 0.0
        for name, a, b in zip("qkv", leaves, ref_leaves):
            rel = ((a.grad.float() - b.grad.float()).abs().max()
                   / b.grad.float().abs().max()).item()
            grad_err = max(grad_err, rel)
            if not rel <= TRAIN_GRAD_TOL[dtype]:
                fail(f"flash_attention backward d{name} {dtype}: max |err| "
                     f"/ max |grad| {rel:.2e} > {TRAIN_GRAD_TOL[dtype]:g}")
        del leaves, ref_leaves
        torch.cuda.synchronize()
        row = {"case": f"train B={B} S=T={S} causal", "dtype": str(dtype)[6:],
               "max_abs_err": err, "tol": TOL[dtype],
               "grad_rel_err": grad_err,
               "grad_tol": TRAIN_GRAD_TOL[dtype]}
        print(f"  flash_attention {row['case']:44s} {row['dtype']:8s} err "
              f"{err:.2e} (tol {TOL[dtype]:g}); dq, dk, dv max |err| / "
              f"max |grad| {grad_err:.2e} (tol "
              f"{TRAIN_GRAD_TOL[dtype]:g})")
        if dtype == torch.float32:
            rows.append(row)
            continue
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, dout))
        sdpa = lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True)
        grads = [t.clone().requires_grad_() for t in (qt, kt, vt)]
        row["ms"] = time_ms(lambda: flash_attention(q, k, v), flush)
        row["plain_ms"] = time_ms(lambda: flash_attention_ref(q, k, v), flush)
        row["bwd_plain_ms"] = time_ms(
            lambda: flash_attention_bwd_ref(q, k, v, dout, causal=True),
            flush, iters=5)
        row["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt), flush)
        row["library_fwd_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(sdpa(*grads), grads, dot), flush)
        row["sdpa_backend"] = sdpa_backend(qt, kt, vt, None, 0.0, True,
                                           enable_gqa=True)
        for key, (n_bytes, ops) in (
                ("", flash_bound(B, S, S, h, hk, hd, True, 0, 2)),
                ("bwd_", flash_bwd_bound(B, S, S, h, hk, hd, True, 2))):
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dtype] * 1e3
            row.update({f"{key}bound_ms": max(t_bytes, t_ops),
                        f"{key}bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        f"{key}bytes": n_bytes, f"{key}ops": ops})
        del grads
        rows.append(row)
        print(f"  flash_attention {row['case']:44s} bfloat16 forward: kernel "
              f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  sdpa "
              f"{row['library_ms']:.4f} ms ({row['sdpa_backend']})  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); backward: plain "
              f"{row['bwd_plain_ms']:.4f} ms  sdpa forward + backward "
              f"{row['library_fwd_bwd_ms']:.4f} ms  bound "
              f"{row['bwd_bound_ms']:.4f} ms ({row['bwd_bound_by']}: "
              f"{row['bwd_ops'] / 1e9:.1f} GFLOP)")
    return rows


# --------------------------------------------------------------------------
# phase 3 / 4: the serving path
# --------------------------------------------------------------------------

def wkv_case(rng, B, T, H, K, decay):
    """r, k, v ~ N(0, 1); log-decays -exp(N(0, 1)) as in the reference's
    tests, or -decay * exp(0.3 N(0, 1)) to reach the -60 clip; u and a
    nonzero carried state ~ N(0, 1)."""
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    if decay:
        wl = -decay * np.exp(0.3 * rng.standard_normal((B, T, H, K)))
    else:
        wl = -np.exp(rng.standard_normal((B, T, H, K)))
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, wl.astype(np.float32), u, s0


def wkv_bound(B, T, H, K, el, chunk=32):
    """Bytes each input read once and each output written once, and the
    fp32 operations of the chunked form on these inputs (a ragged last
    chunk counts only its real steps)."""
    n = B * T * H * K
    n_bytes = 3 * n * el + n * 4 + H * K * 4 + 2 * B * H * K * K * 4 + n * el
    C = min(chunk, T)
    ops = 0
    for t0 in range(0, T, C):
        c = min(C, T - t0)
        ops += (2 * c * K * K              # carried state: (r e^Lp) @ S
                + c * (c + 1) * K          # scores @ v, diagonal included
                + 2 * c * K * K + K * K    # S' = e^L S + k_sc^T v
                + 4 * K * c * (c - 1) // 2 + 3 * c * K)  # scores, bonus
    return n_bytes, B * H * ops


def check_wkv6(dev, flush):
    from repro_torch.kernels.wkv6 import wkv6, wkv6_chunked

    H, K = 32, 64                                    # rwkv6-1.6b widths
    rng = np.random.default_rng(1)
    cases = [
        ("prefill chunk B=1 T=32", 1, 32, 0.0),
        ("ragged B=2 T=80, 3 chunks", 2, 80, 0.0),
        ("clip B=1 T=64, decay ~-2.5/step", 1, 64, 2.5),
        ("prompt tail B=1 T=17", 1, 17, 0.0),
    ]
    rows = []
    for name, B, T, decay in cases:
        host = wkv_case(rng, B, T, H, K, decay)
        if decay:     # the clip is reached: |L_j - Lp_t| > 60 in a chunk
            L = np.cumsum(host[3][:, :32], axis=1)
            if not (L[:, -1] - L[:, 0] < -60).any():
                fail(f"wkv6 {name}: decays do not reach the clip")
        for dtype in (torch.float32, torch.bfloat16):
            r, k, v = (torch.from_numpy(x).to(dev, dtype) for x in host[:3])
            wl, u, s0 = (torch.from_numpy(x).to(dev) for x in host[3:])
            y, s = wkv6(r, k, v, wl, u, s0)
            y_want, s_want = wkv6_chunked(r, k, v, wl, u, s0)
            torch.cuda.synchronize()
            err = max((y.float() - y_want.float()).abs().max().item(),
                      (s - s_want).abs().max().item())
            rtol = WKV_BF16_RTOL if dtype == torch.bfloat16 else 0.0
            # the largest |err| / (atol + rtol |want|): <= 1 passes
            used = max(((got - want).abs() / (WKV_ATOL + rtol * want.abs()))
                       .max().item() for got, want in
                       ((y.float(), y_want.float()), (s, s_want)))
            if used > 1.0:
                fail(f"wkv6 {name} {dtype}: max |err| {err}, {used:.3f} of "
                     "the tolerance")
            ms = time_ms(lambda: wkv6(r, k, v, wl, u, s0), flush)
            plain_ms = time_ms(lambda: wkv6_chunked(r, k, v, wl, u, s0),
                               flush)
            n_bytes, ops = wkv_bound(B, T, H, K, r.element_size())
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[torch.float32] * 1e3
            rows.append({
                "case": name, "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "tol": WKV_ATOL, "rtol": rtol,
                "tolerance_used": used,
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "ops": ops})
            print(f"  wkv6 {name:34s} {rows[-1]['dtype']:8s} err {err:.2e} "
                  f"(atol {WKV_ATOL:g}, rtol {rtol:g}: {used:.3f} of the "
                  f"tolerance)  kernel {ms:.4f} ms  "
                  f"plain {plain_ms:.4f} ms  bound {rows[-1]['bound_ms']:.4f}"
                  f" ms ({rows[-1]['bound_by']}, {n_bytes / 1e6:.2f} MB)")
    return rows


def mamba_case(rng, Bb, T, dI, dS, R=256):
    """The reference test's distributions: dt = softplus(N(0, 1)),
    A = -exp(N(0, 1)), the rest N(0, 1); B and C are returned inside one
    (Bb, T, R + 2 dS) projection, as ``apply_mamba`` slices them."""
    x = rng.standard_normal((Bb, T, dI)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, T, dI)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((dI, dS)))).astype(np.float32)
    proj = rng.standard_normal((Bb, T, R + 2 * dS)).astype(np.float32)
    D = rng.standard_normal((dI,)).astype(np.float32)
    h0 = rng.standard_normal((Bb, dI, dS)).astype(np.float32)
    return x, dt, A, proj, D, h0


def mamba_bound(Bb, T, dI, dS, el):
    """Bytes each input read once and each output written once (x, dt,
    B, C, y in the compute dtype; A, D, the state in and out in fp32),
    and the fp32 operations of the scan: per (step, channel, state) the
    decay product, its exponential, the two-term update and the output
    product and sum; per (step, channel) dt * x and D * x + sum."""
    n_bytes = (3 * Bb * T * dI * el + 2 * Bb * T * dS * el
               + (dI * dS + dI + 2 * Bb * dI * dS) * 4)
    ops = Bb * T * dI * (7 * dS + 3)
    return n_bytes, ops


def check_mamba(dev, flush):
    from repro_torch.kernels.mamba_scan import mamba_ref, mamba_scan

    dI, dS, R = 8192, 16, 256                     # jamba-v0.1-52b widths
    rng = np.random.default_rng(2)
    cases = [
        ("prefill chunk B=1 T=32", 1, 32),
        ("ragged B=2 T=75, 3 staged tiles", 2, 75),
        ("prompt tail B=1 T=17", 1, 17),
    ]
    rows = []
    for name, Bb, T in cases:
        x, dt, A, proj, D, h0 = mamba_case(rng, Bb, T, dI, dS, R)
        for dtype in (torch.float32, torch.bfloat16):
            xt, dtt = (torch.from_numpy(a).to(dev, dtype) for a in (x, dt))
            pr = torch.from_numpy(proj).to(dev, dtype)
            Bm, Cm = pr[..., R:R + dS], pr[..., R + dS:]
            At, Dt, ht = (torch.from_numpy(a).to(dev) for a in (A, D, h0))
            args = (xt, dtt, At, Bm, Cm, Dt, ht)
            y, s = mamba_scan(*args)
            y_want, s_want = mamba_ref(*args)
            torch.cuda.synchronize()
            err = max((y.float() - y_want).abs().max().item(),
                      (s - s_want).abs().max().item())
            rtol = MAMBA_BF16_RTOL if dtype == torch.bfloat16 else 0.0
            used = max(((y.float() - y_want).abs()
                        / (MAMBA_ATOL + rtol * y_want.abs())).max().item(),
                       ((s - s_want).abs() / MAMBA_ATOL).max().item())
            if used > 1.0:
                fail(f"mamba_scan {name} {dtype}: max |err| {err}, "
                     f"{used:.3f} of the tolerance")
            ms = time_ms(lambda: mamba_scan(*args), flush)
            plain_ms = time_ms(lambda: mamba_ref(*args), flush)
            n_bytes, ops = mamba_bound(Bb, T, dI, dS, xt.element_size())
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[torch.float32] * 1e3
            rows.append({
                "case": name, "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "tol": MAMBA_ATOL, "rtol": rtol,
                "tolerance_used": used,
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "ops": ops})
            print(f"  mamba_scan {name:34s} {rows[-1]['dtype']:8s} err "
                  f"{err:.2e} (atol {MAMBA_ATOL:g}, rtol {rtol:g}: "
                  f"{used:.3f} of the tolerance)  kernel {ms:.4f} ms  "
                  f"plain {plain_ms:.4f} ms  bound "
                  f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}, "
                  f"{n_bytes / 1e6:.2f} MB)")
    return rows


def multi_token_chunks(lens, chunk=PREFILL_CHUNK):
    """Prefill calls with two or more tokens (the ones that run wkv6)."""
    return sum(1 for n in lens for s in range(0, int(n), chunk)
               if min(chunk, int(n) - s) >= 2)


def serve(cfg, model, prompts, new_tokens, **kw):
    from repro_torch.serve import ContinuousScheduler
    sch = ContinuousScheduler(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                              page_size=PAGE_SIZE, decode_chunk=DECODE_CHUNK,
                              prefill_chunk=PREFILL_CHUNK, **kw)
    return sch, sch.generate(prompts, new_tokens)


def serve_rwkv(dev, lens):
    """Phases 5 and 6: full-width full-depth rwkv6-1.6b in bf16 on the
    phase-3 traffic, then card-vs-CPU fp32 greedy parity at 2 layers.
    Returns the wkv6 launches of the phase-5 run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model

    cfg = get_config("rwkv6-1.6b")
    rng = np.random.default_rng(0)
    rng.integers(PROMPT_MIN, PROMPT_MAX + 1, REQUESTS)   # phase 3's lengths
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    numel = sum(p.numel() for p in model.layers.parameters()) + sum(
        t.numel() for t in (model.embed, model.unembed_f32, model.final_norm))
    print(f"phase 5: {cfg.name} ({cfg.param_count() / 1e9:.3f} B params by "
          f"the reference's formula, {numel / 1e9:.3f} B allocated; "
          f"{cfg.num_layers} layers, bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    serve(cfg, model, prompts[:2], 4)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    reset_launch_counts()
    t0 = time.perf_counter()
    sch, outs = serve(cfg, model, prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = sch.stats()
    multi = multi_token_chunks(lens)
    launches = counts.get("wkv6", 0)
    if launches != cfg.num_layers * multi:
        fail(f"wkv6 launched {launches} times, expected {cfg.num_layers} x "
             f"{multi} prefill calls of >= 2 tokens")
    if counts.get("paged_flash_decode", 0):
        fail("paged_flash_decode launched on the attention-free path")
    if len(outs) != REQUESTS or any(
            len(o) != NEW_TOKENS or o.min() < 0 or o.max() >= cfg.vocab_size
            for o in outs):
        fail("served outputs have the wrong length or out-of-vocab tokens")
    for i, layer in enumerate(sch.kv.cache):
        if not all(torch.isfinite(t).all() for t in layer.values()):
            fail(f"layer {i}: recurrent state is not finite")
    n_tok = sum(len(o) for o in outs)
    ttft = sorted(st["ttft_s"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 5: {REQUESTS} requests ({int(lens.sum())} prompt tokens) x "
          f"{NEW_TOKENS} new tokens on {SLOTS} slots in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s, TTFT p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, "
          f"{st['syncs_per_token']:.4f} host syncs/token, peak memory "
          f"{peak_gib:.2f} GiB ({resident_gib:.2f} GiB resident at the "
          f"start), recurrent state {st['state_bytes'] // SLOTS} "
          f"B per slot ({st['state_bytes'] / 2**20:.1f} MiB in all); wkv6 "
          f"launches {launches} = {cfg.num_layers} x {multi} of "
          f"{st['prefill_dispatches']} prefill calls (the rest are one-token "
          f"chunks: wkv6_step)")
    del model, sch
    torch.cuda.empty_cache()

    small = cfg.with_overrides(num_layers=2, dtype="float32")
    prompts6 = [p[:n] for p, n in zip(prompts[:4], (7, 40, 70, 33))]
    got = {}
    for where in ("cpu", "cuda"):
        m = init_model(small, seed=1, device="cpu")
        if where == "cuda":
            m = m.to(dev)
        reset_launch_counts()
        got[where] = serve(small, m, prompts6, 12)[1]
    if launch_counts().get("wkv6", 0) != 2 * multi_token_chunks(
            [len(p) for p in prompts6]):
        fail("phase 6: the card run did not launch wkv6 on every chunk")
    for a, b in zip(got["cpu"], got["cuda"]):
        if not np.array_equal(a, b):
            fail(f"rwkv fp32 greedy tokens differ card vs CPU: {a} vs {b}")
    print(f"phase 6: 2-layer full-width rwkv6 fp32 greedy tokens equal on "
          f"card and CPU for {len(prompts6)} requests x 12 tokens")
    return launches


def serve_jamba(dev, lens):
    """Phases 7 and 8: jamba-v0.1-52b at full width cut to one 8-layer
    super-block in bf16 on the phase-3 traffic, then card-vs-CPU fp32
    greedy parity at 2 full-width layers.  Returns the mamba_scan and
    paged_flash_decode launches of the phase-7 run."""
    import copy

    from repro_torch.configs import get_config, one_card_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model

    cfg = one_card_config("jamba-v0.1-52b")
    kinds = [mixer for mixer, _ in cfg.layer_pattern()]
    rng = np.random.default_rng(0)
    rng.integers(PROMPT_MIN, PROMPT_MAX + 1, REQUESTS)   # phase 3's lengths
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 7: {cfg.name} cut to {cfg.num_layers} layers, full width "
          f"({cfg.param_count() / 1e9:.3f} B params of "
          f"{get_config(cfg.name).param_count() / 1e9:.3f} B; "
          f"{kinds.count('mamba')} Mamba + {kinds.count('attn')} attention "
          f"layers, {sum(f == 'moe' for _, f in cfg.layer_pattern())} MoE "
          f"of {cfg.moe.num_experts} experts, bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s, peak memory during init "
          f"{init_peak_gib:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after")
    serve(cfg, model, prompts[:2], 4)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    reset_launch_counts()
    t0 = time.perf_counter()
    sch, outs = serve(cfg, model, prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = sch.stats()
    multi = multi_token_chunks(lens)
    model_calls = st["prefill_dispatches"] + DECODE_CHUNK * st[
        "decode_dispatches"]
    scans = counts.get("mamba_scan", 0)
    paged = counts.get("paged_flash_decode", 0)
    if scans != kinds.count("mamba") * multi:
        fail(f"mamba_scan launched {scans} times, expected "
             f"{kinds.count('mamba')} x {multi} prefill calls of >= 2 tokens")
    if paged != kinds.count("attn") * model_calls:
        fail(f"paged_flash_decode launched {paged} times, expected "
             f"{kinds.count('attn')} x {model_calls} model calls")
    if counts.get("wkv6", 0):
        fail("wkv6 launched on the Jamba path")
    if len(outs) != REQUESTS or any(
            len(o) != NEW_TOKENS or o.min() < 0 or o.max() >= cfg.vocab_size
            for o in outs):
        fail("served outputs have the wrong length or out-of-vocab tokens")
    for i, layer in enumerate(sch.kv.cache):
        if not all(torch.isfinite(t).all() for t in layer.values()):
            fail(f"layer {i}: cache is not finite")
    n_tok = sum(len(o) for o in outs)
    ttft = sorted(st["ttft_s"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 7: {REQUESTS} requests ({int(lens.sum())} prompt tokens) x "
          f"{NEW_TOKENS} new tokens on {SLOTS} slots in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s, TTFT p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, "
          f"{st['syncs_per_token']:.4f} host syncs/token, peak memory "
          f"{peak_gib:.2f} GiB ({resident_gib:.2f} GiB resident at the "
          f"start), pool {st['pool_bytes'] / 2**20:.1f} MiB, recurrent state "
          f"{st['state_bytes'] // SLOTS} B per slot "
          f"({st['state_bytes'] / 2**20:.1f} MiB in all); mamba_scan "
          f"launches {scans} = {kinds.count('mamba')} x {multi} of "
          f"{st['prefill_dispatches']} prefill calls, paged_flash_decode "
          f"launches {paged} = {kinds.count('attn')} x "
          f"({st['prefill_dispatches']} prefill calls + {DECODE_CHUNK} x "
          f"{st['decode_dispatches']} decode ticks)")
    del model, sch
    torch.cuda.empty_cache()

    # phase 8: Jamba's smoke pattern at full width in fp32, weights drawn
    # on the card (16 fp32 experts are 11.3 GB) and copied to the CPU
    small = cfg.with_overrides(num_layers=2, dtype="float32",
                               attn_layer_period=2, attn_layer_offset=1)
    prompts8 = [p[:n] for p, n in zip(prompts[:4], (7, 40, 70, 33))]
    t0 = time.perf_counter()
    m_card = init_model(small, seed=1, device=dev)
    m_cpu = copy.deepcopy(m_card.cpu())
    m_card.to(dev)
    print(f"phase 8: {small.layer_pattern()} at full width in fp32 "
          f"({small.param_count() / 1e9:.2f} B params) drawn on the card and "
          f"copied to the CPU in {time.perf_counter() - t0:.1f} s")
    got = {}
    for where, m in (("cpu", m_cpu), ("cuda", m_card)):
        reset_launch_counts()
        t0 = time.perf_counter()
        got[where] = serve(small, m, prompts8, 12)[1]
        print(f"  {where}: {time.perf_counter() - t0:.1f} s")
    want = multi_token_chunks([len(p) for p in prompts8])
    if launch_counts().get("mamba_scan", 0) != want:
        fail("phase 8: the card run did not launch mamba_scan on every chunk")
    for a, b in zip(got["cpu"], got["cuda"]):
        if not np.array_equal(a, b):
            fail(f"jamba fp32 greedy tokens differ card vs CPU: {a} vs {b}")
    print(f"phase 8: 2-layer full-width Jamba fp32 greedy tokens equal on "
          f"card and CPU for {len(prompts8)} requests x 12 tokens")
    del m_card, m_cpu
    torch.cuda.empty_cache()
    return scans, paged


def serve_deepseek(dev, lens):
    """Phases 9 and 10: deepseek-v3-671b at full width cut to its first 4
    layers in bf16 on the phase-3 traffic, then card-vs-CPU fp32 greedy
    parity at 2 full-width layers with 16 routed experts.  Returns the
    paged_flash_decode_mla launches of the phase-9 run."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config, one_card_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model

    cfg = one_card_config("deepseek-v3-671b")
    pattern = cfg.layer_pattern()
    rng = np.random.default_rng(0)
    rng.integers(PROMPT_MIN, PROMPT_MAX + 1, REQUESTS)   # phase 3's lengths
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    numel = sum(p.numel() for p in model.parameters())
    print(f"phase 9: {cfg.name} cut to {cfg.num_layers} layers, full width "
          f"({sum(f == 'mlp' for _, f in pattern)} dense of d_ff "
          f"{cfg.moe.dense_d_ff} + {sum(f == 'moe' for _, f in pattern)} MoE "
          f"of {cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.num_shared_experts} shared; MLA q_lora "
          f"{cfg.mla.q_lora_rank}, kv_lora {cfg.mla.kv_lora_rank}, rope "
          f"{cfg.mla.qk_rope_head_dim}; bf16): {cfg.param_count() / 1e9:.3f} "
          f"B params by the reference's formula (of "
          f"{get_config(cfg.name).param_count() / 1e9:.1f} B; it counts the "
          f"dense MLPs at d_ff {cfg.d_ff}), {numel / 1e9:.3f} B allocated; "
          f"initialised in {time.perf_counter() - t0:.1f} s, peak memory "
          f"during init {init_peak_gib:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after")
    if init_peak_gib > DEEPSEEK_INIT_PEAK_GIB:
        fail(f"deepseek init peak {init_peak_gib:.2f} GiB exceeds "
             f"{DEEPSEEK_INIT_PEAK_GIB} GiB")
    serve(cfg, model, prompts[:2], 4)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    reset_launch_counts()
    t0 = time.perf_counter()
    sch, outs = serve(cfg, model, prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = sch.stats()
    model_calls = st["prefill_dispatches"] + DECODE_CHUNK * st[
        "decode_dispatches"]
    mla = counts.get("paged_flash_decode_mla", 0)
    if mla != cfg.num_layers * model_calls:
        fail(f"paged_flash_decode_mla launched {mla} times, expected "
             f"{cfg.num_layers} x {model_calls} model calls")
    for other in ("paged_flash_decode", "wkv6", "mamba_scan"):
        if counts.get(other, 0):
            fail(f"{other} launched on the DeepSeek path")
    if len(outs) != REQUESTS or any(
            len(o) != NEW_TOKENS or o.min() < 0 or o.max() >= cfg.vocab_size
            for o in outs):
        fail("served outputs have the wrong length or out-of-vocab tokens")
    for i, layer in enumerate(sch.kv.cache):
        if not all(torch.isfinite(t).all() for t in layer.values()):
            fail(f"layer {i}: latent pool is not finite")
    n_tok = sum(len(o) for o in outs)
    ttft = sorted(st["ttft_s"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 9: {REQUESTS} requests ({int(lens.sum())} prompt tokens) x "
          f"{NEW_TOKENS} new tokens on {SLOTS} slots in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s, TTFT p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, "
          f"{st['syncs_per_token']:.4f} host syncs/token, peak memory "
          f"{peak_gib:.2f} GiB ({resident_gib:.2f} GiB resident at the "
          f"start), pool {st['pool_bytes']} B "
          f"({st['pool_bytes'] / 2**20:.1f} MiB); paged_flash_decode_mla "
          f"launches {mla} = {cfg.num_layers} x ({st['prefill_dispatches']} "
          f"prefill calls + {DECODE_CHUNK} x {st['decode_dispatches']} "
          f"decode ticks)")
    del model, sch
    torch.cuda.empty_cache()

    # phase 10: two full-width layers in fp32, the routed experts cut to
    # 16 (256 fp32 experts are 45 GB of host memory for one layer); drawn
    # on the card and copied to the CPU
    small = cfg.with_overrides(
        num_layers=2, dtype="float32",
        moe=dataclasses.replace(cfg.moe, num_experts=16,
                                first_dense_layers=1))
    prompts10 = [p[:n] for p, n in zip(prompts[:4], (7, 40, 70, 33))]
    t0 = time.perf_counter()
    m_card = init_model(small, seed=1, device=dev)
    m_cpu = copy.deepcopy(m_card.cpu())
    m_card.to(dev)
    numel = sum(p.numel() for p in m_card.parameters())
    print(f"phase 10: {small.layer_pattern()} at full width in fp32, routed "
          f"experts cut 256 -> {small.moe.num_experts} for this phase only "
          f"(top-{small.moe.top_k}, {small.moe.num_shared_experts} shared, "
          f"d_expert {small.moe.d_expert}; {numel / 1e9:.2f} B params "
          f"allocated) drawn on the card and copied to the CPU in "
          f"{time.perf_counter() - t0:.1f} s")
    got = {}
    for where, m in (("cpu", m_cpu), ("cuda", m_card)):
        reset_launch_counts()
        t0 = time.perf_counter()
        sch, got[where] = serve(small, m, prompts10, 12)
        print(f"  {where}: {time.perf_counter() - t0:.1f} s")
    st = sch.stats()
    calls = st["prefill_dispatches"] + DECODE_CHUNK * st["decode_dispatches"]
    if launch_counts().get("paged_flash_decode_mla", 0) != 2 * calls:
        fail("phase 10: the card run did not launch paged_flash_decode_mla "
             "in every MLA layer of every model call")
    for a, b in zip(got["cpu"], got["cuda"]):
        if not np.array_equal(a, b):
            fail(f"deepseek fp32 greedy tokens differ card vs CPU: {a} vs {b}")
    print(f"phase 10: 2-layer full-width DeepSeek-V3 fp32 greedy tokens equal "
          f"on card and CPU for {len(prompts10)} requests x 12 tokens")
    del m_card, m_cpu, sch
    torch.cuda.empty_cache()
    return mla


def serve_legacy(dev):
    """Phases 11 and 12: full-width, full-depth qwen3-1.7b in bf16
    through the lockstep slab engine, then card-vs-CPU fp32 greedy
    parity at 2 full-width layers.  Returns the flash_attention launches
    of the phase-11 run."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen3-1.7b")
    prompts = synthetic_tokens(np.random.default_rng(0), LEGACY_BATCH,
                               LEGACY_PROMPT, cfg.vocab_size)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"phase 11: {cfg.name} ({cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads x "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}, bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    ServeEngine(cfg, model, batch_size=LEGACY_BATCH,
                max_len=LEGACY_MAX_LEN).generate(prompts[:2, :64], 4)
    torch.cuda.synchronize()
    model_gib = torch.cuda.memory_allocated() / 2**30
    eng = ServeEngine(cfg, model, batch_size=LEGACY_BATCH,
                      max_len=LEGACY_MAX_LEN)
    cache_bytes = sum(t.numel() * t.element_size() for layer in eng.cache
                      for t in layer.values())
    resident_gib = torch.cuda.memory_allocated() / 2**30
    # the batch's time to first token: a prefill and its sample
    t0 = time.perf_counter()
    eng.generate(prompts, 1).cpu()
    ttft = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    dispatches0, syncs0 = eng.dispatches, eng.host_syncs
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out = out.cpu().numpy()
    launches = counts.get("flash_attention", 0)
    if launches != cfg.num_layers * NEW_TOKENS:
        fail(f"flash_attention launched {launches} times, expected "
             f"{cfg.num_layers} x {NEW_TOKENS} (one prefill and "
             f"{NEW_TOKENS - 1} decode calls)")
    for other in ("paged_flash_decode", "paged_flash_decode_mla", "wkv6",
                  "mamba_scan"):
        if counts.get(other, 0):
            fail(f"{other} launched on the lockstep slab path")
    if out.shape != (LEGACY_BATCH, NEW_TOKENS) or out.min() < 0 \
            or out.max() >= cfg.vocab_size:
        fail(f"slab outputs have shape {out.shape} or out-of-vocab tokens")
    for i, layer in enumerate(eng.cache):
        if not all(torch.isfinite(t[:, :LEGACY_PROMPT + NEW_TOKENS - 1]).all()
                   for t in layer.values()):
            fail(f"layer {i}: slab cache is not finite")
    n_tok = out.size
    syncs = eng.host_syncs - syncs0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 11: {LEGACY_BATCH} requests x {LEGACY_PROMPT} prompt tokens "
          f"x {NEW_TOKENS} new tokens through ServeEngine(batch_size="
          f"{LEGACY_BATCH}, max_len={LEGACY_MAX_LEN}) in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s, prefill wall (the batch's TTFT) "
          f"{ttft * 1e3:.1f} ms, {syncs / n_tok:.4f} host syncs/token "
          f"({eng.dispatches - dispatches0} dispatches); memory: model "
          f"{model_gib:.2f} GiB, resident {resident_gib:.2f} GiB with the "
          f"slab cache of {cache_bytes} B ({cache_bytes / 2**20:.1f} MiB), "
          f"peak {peak_gib:.2f} GiB; flash_attention launches {launches} = "
          f"{cfg.num_layers} x (1 prefill + {NEW_TOKENS - 1} decode calls), "
          f"paged_flash_decode 0")
    del model, eng
    torch.cuda.empty_cache()

    # phase 12: two full-width layers in fp32, card vs CPU
    small = cfg.with_overrides(num_layers=2, dtype="float32")
    prompts12, new12 = prompts[:2, :64], 16
    m = init_model(small, seed=1, device="cpu")
    got = {}
    for where in ("cpu", "cuda"):
        if where == "cuda":
            m = m.to(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        got[where] = ServeEngine(small, m, batch_size=2,
                                 max_len=64 + new12).generate(
                                     prompts12, new12).cpu().numpy()
        print(f"  {where}: {time.perf_counter() - t0:.1f} s")
    if launch_counts().get("flash_attention", 0) != 2 * new12:
        fail("phase 12: the card run did not launch flash_attention in "
             "every layer of every model call")
    if not np.array_equal(got["cpu"], got["cuda"]):
        fail(f"lockstep fp32 greedy tokens differ card vs CPU: "
             f"{got['cpu']} vs {got['cuda']}")
    print(f"phase 12: 2-layer full-width qwen3 fp32 greedy tokens through "
          f"the lockstep engine equal on card and CPU for 2 requests x "
          f"{new12} tokens")
    del m
    torch.cuda.empty_cache()
    return launches


def train_qwen(dev):
    """Phases 13 and 14: full-width, full-depth qwen3-1.7b trained in
    bf16 on fp32 masters (AdamW), then card-vs-CPU fp32 training at 2
    full-width layers.  Returns the flash_attention launches of the
    phase-13 run and its numbers."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, start_state, trainable)

    cfg = get_config("qwen3-1.7b")
    tc = TrainConfig(optimizer="adamw", lr=TRAIN_LR, microbatches=TRAIN_MICRO,
                     remat=True)
    batch = make_batch(cfg, np.random.default_rng(0), TRAIN_BATCH, TRAIN_SEQ)
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, seed=0, device=dev)
    step, _ = make_train_step(cfg, tc)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainable(state.params).values())
    print(f"phase 13: {cfg.name} ({n_params / 1e9:.3f} B fp32 masters, "
          f"{cfg.num_layers} layers, bf16 compute) and AdamW state "
          f"initialised in {time.perf_counter() - t0:.1f} s, resident "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, walls = [], []
    for i in range(1 + TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))           # synchronises
        walls.append(time.perf_counter() - t0)
    counts = launch_counts()
    launches = counts.get("flash_attention", 0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = (1 + TRAIN_TIMED) * TRAIN_MICRO * cfg.num_layers * 2
    if launches != want:
        fail(f"phase 13: flash_attention launched {launches} times, expected "
             f"{want} = {1 + TRAIN_TIMED} steps x {TRAIN_MICRO} microbatches x "
             f"{cfg.num_layers} layers x 2 (forward + remat recompute)")
    for other in ("paged_flash_decode", "paged_flash_decode_mla", "wkv6",
                  "mamba_scan"):
        if counts.get(other, 0):
            fail(f"{other} launched on the training path")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"phase 13: losses {losses} are not finite and falling")
    wall = float(np.median(walls[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n_params * tokens / wall / PEAK_OPS[torch.bfloat16]
    out = {"step_ms": wall * 1e3, "tokens_per_s": tokens / wall,
           "peak_gib": peak_gib, "mfu": mfu, "losses": losses,
           "step_walls_ms": [w * 1e3 for w in walls]}
    print(f"phase 13: {1 + TRAIN_TIMED} AdamW steps (lr {TRAIN_LR:g}) on one "
          f"batch of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} "
          f"microbatches, remat per layer: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; flash_attention "
          f"launches {launches} = {1 + TRAIN_TIMED} x {TRAIN_MICRO} x "
          f"{cfg.num_layers} x 2 (forward + recompute)")
    print(f"phase 13: step wall median {wall * 1e3:.1f} ms (first, untimed "
          f"{walls[0] * 1e3:.1f} ms)")
    print(f"phase 13: {tokens / wall:.1f} tokens/s")
    print(f"phase 13: peak memory {peak_gib:.2f} GiB")
    print(f"phase 13: mfu {mfu:.4f} (6 N tokens a step, N = {n_params}, "
          f"over {PEAK_OPS[torch.bfloat16] / 1e12:.0f} TFLOP/s bf16 dense)")
    del state, step
    torch.cuda.empty_cache()

    # phase 14: two full-width layers in fp32, card vs CPU
    small = cfg.with_overrides(num_layers=2, dtype="float32")
    tc = TrainConfig(optimizer="adamw", lr=TRAIN_LR)
    batch = make_batch(small, np.random.default_rng(14), 2, 256)
    got = {}
    for where in ("cpu", "cuda"):
        # drawn on the CPU from one seed, then moved: the same masters
        model = init_model(small, seed=1, device="cpu", train=True).to(
            dev if where == "cuda" else "cpu")
        step, opt = make_train_step(small, tc)
        state = start_state(model, opt)
        reset_launch_counts()
        t0 = time.perf_counter()
        losses = []
        for _ in range(3):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        got[where] = (losses, {k: p.detach().cpu() for k, p in
                               trainable(model).items()})
        print(f"  {where}: 3 steps in {time.perf_counter() - t0:.1f} s, "
              f"losses {losses}")
    if launch_counts().get("flash_attention", 0) != 3 * 2 * 2:
        fail("phase 14: the card run did not launch flash_attention in every "
             "layer (3 steps x 2 layers x 2, with the remat recompute)")
    (cpu_l, cpu_p), (card_l, card_p) = got["cpu"], got["cuda"]
    rel = [abs(a - b) / abs(a) for a, b in zip(cpu_l, card_l)]
    gap = max((cpu_p[k] - card_p[k]).abs().max().item() for k in cpu_p)
    if not rel[0] <= TRAIN_LOSS_RTOL_FIRST:
        fail(f"phase 14: step 1's loss differs card vs CPU by {rel[0]:.2e} "
             f"relative > {TRAIN_LOSS_RTOL_FIRST:g}")
    if not max(rel[1:]) <= TRAIN_LOSS_RTOL_LATER or not gap <= 3 * TRAIN_LR:
        fail(f"phase 14: later losses differ by {max(rel[1:]):.2e} relative "
             f"(> {TRAIN_LOSS_RTOL_LATER:g}?) or a param by {gap:.2e} "
             f"(> 3 lr = {3 * TRAIN_LR:g}?)")
    print(f"phase 14: 2-layer full-width qwen3 fp32, 3 AdamW steps on 2 x 256 "
          f"tokens, card vs CPU: step-1 loss {rel[0]:.2e} relative (tol "
          f"{TRAIN_LOSS_RTOL_FIRST:g}), steps 2-3 {max(rel[1:]):.2e} (tol "
          f"{TRAIN_LOSS_RTOL_LATER:g}), largest param gap {gap:.2e} (tol "
          f"3 lr = {3 * TRAIN_LR:g}); flash_attention in every layer")
    del got, state, step, model
    torch.cuda.empty_cache()
    return launches, out


# --------------------------------------------------------------------------
# phases 15 / 16: the paper's synchronous data parallelism
# --------------------------------------------------------------------------

def run_ranks(args, n, timeout=300, module=True):
    """``python -m torch.distributed.run --standalone --nproc-per-node n``
    of ``args`` (a module and its flags, or with ``module=False`` a
    script and its flags), in its own session, killed with every rank
    it started if it outlasts ``timeout``.  Fails the run if it fails;
    returns the wall seconds."""
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), *(["-m"] if module else []), *args]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{' '.join(args)} over {n} ranks outlasted {timeout} s")
    if proc.returncode:
        print(out[-6000:])
        fail(f"{' '.join(args)} over {n} ranks exited {proc.returncode}")
    for line in out.splitlines():
        if line.startswith(("trainer:", "epoch", "mesh:", "phase 18")):
            print(f"    {line}")
    return time.perf_counter() - t0


def load_dump(d, step, rank):
    with np.load(os.path.join(d, f"step{step}_rank{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


def max_gap(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def paper_dp(dev):
    """Phase 15: the paper's claim on the card.  The Table-1 nets'
    sequential step equals the CPU's; MNIST-DNN data-parallel over gloo
    ranks sharing the card equals the card's sequential run; weight
    averaging leaves the ranks bitwise equal at its sync points."""
    import shutil
    import tempfile
    from repro_torch import optim
    from repro_torch.api import Trainer
    from repro_torch.configs.paper_nets import CIFAR10_CNN, MNIST_DNN
    from repro_torch.data import make_dataset
    from repro_torch.launch import mnist_dnn_dp
    from repro_torch.models import apply_paper_net, init_paper_net
    from repro_torch.train import cross_entropy

    out = {}
    for net in (MNIST_DNN, CIFAR10_CNN):
        ds = make_dataset(net.dataset, n=PAPER_BATCH, as_images=True)
        x = ds.x.reshape(PAPER_BATCH, -1) if net.kind == "dnn" else ds.x
        batch = {"x": x, "y": ds.y}
        got = {}
        for where in ("cpu", "cuda"):
            model = init_paper_net(net, seed=0, device="cpu")
            trainer = Trainer.create(
                loss_fn=lambda m, b, net=net: cross_entropy(
                    apply_paper_net(net, m, b["x"]), b["y"]),
                params=model, optimizer=optim.sgd(0.1), device=where)
            losses, params = [], []
            for _ in range(PAPER_STEPS):
                losses.append(float(trainer.step(batch)["loss"]))
                params.append(trainer.params)
            got[where] = (losses, params)
        first, last = (max_gap(got["cpu"][1][i], got["cuda"][1][i])
                       for i in (0, -1))
        tol = PAPER_TOL if net.kind == "dnn" else CNN_LATER_TOL
        if not (first <= PAPER_TOL and last <= tol):
            fail(f"phase 15: {net.name} card vs CPU params differ by "
                 f"{first:.2e} after one SGD step (tol {PAPER_TOL:g}) and "
                 f"{last:.2e} after {PAPER_STEPS} (tol {tol:g})")
        out[f"{net.name}_card_vs_cpu"] = {"step1": first, "last": last}
        print(f"phase 15: {net.name} (Table-1 width, fp32, TF32 off), "
              f"{PAPER_STEPS} SGD(0.1) steps on {PAPER_BATCH} samples, "
              f"card vs CPU: largest param gap {first:.2e} after step 1 "
              f"(tol {PAPER_TOL:g}), {last:.2e} after step {PAPER_STEPS} "
              f"(tol {tol:g}); losses {got['cuda'][0]}")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="dp_", dir=os.path.join(ROOT, "build"))
    data = ["--samples", str(PAPER_SAMPLES), "--epochs", "1"]
    common = [*data, "--steps", str(PAPER_STEPS), "--backend", "gloo"]
    seq = os.path.join(root, "seq")
    mnist_dnn_dp.main([*data, "--steps", str(PAPER_STEPS), "--sequential",
                       "--device", "cuda", "--dump", seq])
    want = load_dump(seq, PAPER_STEPS, 0)
    for strategy in ("flat", "bucketed"):
        d = os.path.join(root, strategy)
        wall = run_ranks(["repro_torch.launch.mnist_dnn_dp", *common,
                          "--strategy", strategy, "--dump", d], 2)
        gaps = [max_gap(want, load_dump(d, PAPER_STEPS, r)) for r in (0, 1)]
        if not max(gaps) <= PAPER_TOL:
            fail(f"phase 15: {strategy} over 2 gloo ranks differs from the "
                 f"sequential run by {max(gaps):.2e} > {PAPER_TOL:g}")
        out[f"mnist_dp2_{strategy}_vs_sequential"] = max(gaps)
        print(f"phase 15: MNIST-DNN, 2 gloo ranks on one card, {strategy}: "
              f"{PAPER_STEPS} momentum steps equal the card's sequential "
              f"run within {max(gaps):.2e} (tol {PAPER_TOL:g}); torchrun "
              f"wall {wall:.1f} s")
    d = os.path.join(root, "weights")
    run_ranks(["repro_torch.launch.mnist_dnn_dp", *data, "--steps", "4",
               "--backend", "gloo", "--sync", "weights", "--sync-period",
               "2", "--dump", d], 2)
    equal = [max_gap(load_dump(d, s, 0), load_dump(d, s, 1)) == 0.0
             for s in (1, 2, 3, 4)]
    if equal != [False, True, False, True]:
        fail(f"phase 15: weight averaging every 2 steps left the ranks "
             f"equal after steps 1-4 as {equal}, want [False, True, False, "
             "True]")
    print("phase 15: MNIST-DNN, 2 gloo ranks, sync=weights every 2 steps: "
          "ranks bitwise equal after steps 2 and 4, different after 1 and 3")
    # gloo's reduce-scatter and all-gather take the card's tensors
    d = os.path.join(root, "hier")
    wall = run_ranks(["repro_torch.launch.mnist_dnn_dp", *common,
                      "--strategy", "hierarchical", "--pods", "2",
                      "--dump", d], 4)
    gaps = [max_gap(want, load_dump(d, PAPER_STEPS, r)) for r in range(4)]
    if not max(gaps) <= PAPER_TOL:
        fail(f"phase 15: hierarchical over 2 x 2 gloo ranks differs from "
             f"the sequential run by {max(gaps):.2e} > {PAPER_TOL:g}")
    out["mnist_dp4_hierarchical_vs_sequential"] = max(gaps)
    print(f"phase 15: MNIST-DNN, 4 gloo ranks (pod 2 x data 2) on one card, "
          f"hierarchical: equal to the sequential run within "
          f"{max(gaps):.2e} (tol {PAPER_TOL:g}); torchrun wall {wall:.1f} s")
    shutil.rmtree(root)
    return out


def dp_qwen(dev, phase13_losses, prompts, serve_launches):
    """Phase 16: full-width qwen3-1.7b through ``Trainer(model_cfg=...)``
    over a world of one NCCL rank, dp=flat then dp=bucketed, on phase
    13's batch; then phase 17 on the bucketed trainer.  Returns the
    flash launches and numbers of each run, and phase 17's numbers."""
    import socket
    import torch.distributed as dist
    from repro_torch.api import Trainer
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.train import TrainConfig

    cfg = get_config("qwen3-1.7b")
    batch = make_batch(cfg, np.random.default_rng(0), TRAIN_BATCH, TRAIN_SEQ)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    mesh = make_dp_mesh(1)
    want = (DP_STEPS * TRAIN_MICRO * cfg.num_layers * 2)
    out = {}

    def create(strategy):
        return Trainer.create(
            cfg, optimizer="adamw", lr=TRAIN_LR,
            dp=DPConfig(strategy=strategy, microbatches=TRAIN_MICRO),
            mesh=mesh, train_cfg=TrainConfig(remat=True), seed=0,
            device=dev)

    for strategy in ("flat", "bucketed"):
        torch.cuda.empty_cache()
        trainer = create(strategy)
        desc = trainer.describe()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, walls = [], []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer.step(batch)["loss"]))
            walls.append(time.perf_counter() - t0)
        launches = launch_counts().get("flash_attention", 0)
        sync = trainer.sync_ms()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if launches != want:
            fail(f"phase 16 ({strategy}): flash_attention launched "
                 f"{launches} times, expected {want} = {DP_STEPS} x "
                 f"{TRAIN_MICRO} x {cfg.num_layers} x 2")
        if losses != phase13_losses[:DP_STEPS]:
            fail(f"phase 16 ({strategy}): losses {losses} are not phase "
                 f"13's first {DP_STEPS}, {phase13_losses[:DP_STEPS]}, bit "
                 "for bit")
        out[strategy] = {"launches": launches, "losses": losses,
                         "step_walls_ms": [w * 1e3 for w in walls],
                         "grad_sync_ms": sync, "peak_gib": peak,
                         "allreduce_bytes_per_sync":
                             desc["allreduce_bytes_per_sync"]}
        print(f"phase 16: {cfg.name} full width through Trainer(model_cfg), "
              f"dp={strategy} over one NCCL rank, {DP_STEPS} AdamW steps on "
              f"phase 13's batch: losses {losses} == phase 13's bit for "
              f"bit; flash_attention launches {launches}")
        print(f"phase 16 ({strategy}): step walls "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; grad_sync "
              f"{', '.join(f'{m:.2f}' for m in sync)} ms (CUDA events); "
              f"{desc['allreduce_bytes_per_sync'] / 2**30:.3f} GiB handed to "
              f"the collectives a step; peak memory {peak:.2f} GiB")
        if strategy == "flat":
            del trainer
    ckpt_out = checkpoint_qwen(dev, trainer, lambda: create("bucketed"),
                               cfg, batch, prompts, serve_launches)
    del trainer
    zero_out = {"nccl": zero_qwen(dev, cfg, batch, mesh,
                                  out["flat"]["losses"])}
    zero_out["gloo"] = zero_gloo(dev, cfg, batch, mesh, prompts,
                                 serve_launches // cfg.num_layers)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out, ckpt_out, zero_out


# --------------------------------------------------------------------------
# phase 18: the ZeRO ladder
# --------------------------------------------------------------------------

def _steps(trainer, batch, n, dev):
    """``n`` steps: losses, walls (s), the memory allocated after each
    (bytes, the card synchronised), flash launches a step, and the
    SyncTimer spans by label."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    losses, walls, between, flash = [], [], [], []
    for _ in range(n):
        torch.cuda.synchronize(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        losses.append(float(trainer.step(batch)["loss"]))
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        flash.append(launch_counts().get("flash_attention", 0))
        between.append(torch.cuda.memory_allocated(dev))
    return losses, walls, between, flash, trainer.sync_ms_by_label()


def zero_qwen(dev, cfg, batch, mesh, flat_losses):
    """Phase 18a: full-width, full-depth qwen3-1.7b under each ZeRO
    strategy over the world of one NCCL rank, on phase 13's batch."""
    import gc
    from repro_torch.api import Trainer
    from repro_torch.core import DPConfig
    from repro_torch.train import TrainConfig
    want_flash = TRAIN_MICRO * cfg.num_layers * 2
    out = {}
    for strategy, overlap in ZERO_STRATEGIES:
        name = strategy + ("+overlap" if overlap else "")
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer.create(
            cfg, optimizer="adamw", lr=TRAIN_LR,
            dp=DPConfig(strategy=strategy, microbatches=TRAIN_MICRO,
                        overlap=overlap),
            mesh=mesh, train_cfg=TrainConfig(remat=True), seed=0,
            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls, between, flash, spans = _steps(trainer, batch,
                                                      DP_STEPS, dev)
        peak = torch.cuda.max_memory_allocated()
        desc = trainer.describe()
        del trainer
        if any(f != want_flash for f in flash):
            fail(f"phase 18a ({name}): flash_attention launched {flash} "
                 f"times a step, expected {want_flash} = {TRAIN_MICRO} x "
                 f"{cfg.num_layers} x 2")
        if strategy == "zero1" and losses != flat_losses:
            fail(f"phase 18a ({name}): losses {losses} are not phase 16's "
                 f"flat losses {flat_losses} bit for bit")
        gap = max(abs(a - b) for a, b in zip(losses, flat_losses))
        if gap > ZERO_LOSS_TOL:
            fail(f"phase 18a ({name}): losses {losses} differ from phase "
                 f"16's flat losses {flat_losses} by {gap:.2e}")
        if peak >= 80e9:
            fail(f"phase 18a ({name}): peak {peak / 1e9:.1f} GB")
        rs, ag = spans.get("reduce_scatter", []), spans.get("all_gather", [])
        out[name] = {"losses": losses, "loss_gap_to_flat": gap,
                     "flash_launches_a_step": flash,
                     "step_walls_ms": [w * 1e3 for w in walls],
                     "reduce_scatter_ms": rs, "all_gather_ms": ag,
                     "peak_bytes": peak, "between_steps_bytes": between,
                     "memory_entry": desc["memory_per_device_bytes"]}
        print(f"phase 18a ({name}): {cfg.name} full width and depth over "
              f"one NCCL rank, {DP_STEPS} AdamW steps on phase 13's batch: "
              f"losses {losses} ({'bitwise' if gap == 0 else f'{gap:.1e}'} "
              f"to phase 16's flat); flash_attention {flash} a step; step "
              f"walls {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; "
              f"reduce_scatter {', '.join(f'{m:.2f}' for m in rs)} ms, "
              f"all_gather {', '.join(f'{m:.2f}' for m in ag)} ms (CUDA "
              f"events); peak {peak / 2**30:.2f} GiB, between steps "
              f"{between[-1] / 2**30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zero_gloo(dev, cfg, batch, mesh, prompts, model_calls):
    """Phase 18b: torchrun of this script over 2 gloo ranks sharing the
    card (``zero_rank``), then, here, a one-rank bucketed trainer that
    restores the ranks' zero3 checkpoint, takes step 4 and serves."""
    import gc
    import shutil
    from repro_torch.api import Trainer
    from repro_torch.core import DPConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import TrainConfig
    small = cfg.with_overrides(num_layers=ZERO_LAYERS)
    shutil.rmtree(ZERO_DIR, ignore_errors=True)
    os.makedirs(ZERO_DIR)
    np.savez(os.path.join(ZERO_DIR, "prompts.npz"),
             *[np.asarray(p) for p in prompts])
    gc.collect()
    torch.cuda.empty_cache()
    try:
        wall = run_ranks([os.path.abspath(__file__), "--zero-rank",
                          ZERO_DIR], ZERO_RANKS, timeout=600, module=False)
        with open(os.path.join(ZERO_DIR, "ranks.json")) as f:
            ranks = json.load(f)
        with np.load(os.path.join(ZERO_DIR, "tokens.npz")) as f:
            rank_tokens = [f[k] for k in sorted(f.files,
                                                key=lambda k: int(k[4:]))]
        trainer = Trainer.create(
            small, optimizer="adamw", lr=TRAIN_LR,
            dp=DPConfig(strategy="bucketed", microbatches=TRAIN_MICRO),
            mesh=mesh, train_cfg=TrainConfig(remat=True), seed=1,
            device=dev)
        t0 = time.perf_counter()
        at = trainer.restore(os.path.join(ZERO_DIR, "ckpt"))
        restore_s = time.perf_counter() - t0
        loss4 = float(trainer.step(batch)["loss"])
        eng = trainer.serve(**SERVE_KW)
        reset_launch_counts()
        toks = eng.generate(prompts, NEW_TOKENS)
        paged = launch_counts().get("paged_flash_decode", 0)
        del eng, trainer
    finally:
        shutil.rmtree(ZERO_DIR, ignore_errors=True)
    z3 = ranks["zero3"]
    if at != DP_STEPS or abs(loss4 - z3["loss4"]) > ZERO_LOSS_TOL:
        fail(f"phase 18b: the bucketed trainer restored step {at}, its step "
             f"4 gave loss {loss4!r}, zero3's own {z3['loss4']!r}")
    want = ZERO_LAYERS * model_calls
    if paged != want or z3["paged_launches"] != want:
        fail(f"phase 18b: paged_flash_decode launched {paged} (restored "
             f"trainer) and {z3['paged_launches']} (zero3 ranks) times, "
             f"expected {ZERO_LAYERS} x {model_calls} model calls")
    if len(toks) != len(rank_tokens) or any(
            not np.array_equal(a, b) for a, b in zip(toks, rank_tokens)):
        fail("phase 18b: Trainer.serve() of the zero3 ranks and of the "
             "restored bucketed trainer gave different greedy tokens")
    ranks["restored"] = {"step": at, "loss4": loss4, "restore_s": restore_s,
                         "paged_launches": paged}
    ranks["torchrun_wall_s"] = wall
    print(f"phase 18b: the zero3 checkpoint (2 ranks) restored into a "
          f"one-rank bucketed trainer in {restore_s:.1f} s; its step 4 gave "
          f"{loss4!r}, zero3's own {z3['loss4']!r}; Trainer.serve() of both "
          f"gave equal greedy tokens for {len(prompts)} requests x "
          f"{NEW_TOKENS}, paged_flash_decode launches {paged} and "
          f"{z3['paged_launches']}; torchrun {wall:.1f} s")
    print(f"phase 18b: {json.dumps(ranks)}")
    gc.collect()
    torch.cuda.empty_cache()
    return ranks


def zero_rank(outdir):
    """One of phase 18b's gloo ranks (run by torchrun): full-width qwen3
    at depth 4 under flat, zero1, zero2 and zero3, 3 steps each on this
    rank's 1 x 4096 tokens of phase 13's batch; zero3 saves, steps and
    serves.  Rank 0 writes the numbers."""
    import gc
    sys.path.insert(0, SRC)
    import torch.distributed as dist
    from repro_torch.api import Trainer
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import init_from_env
    from repro_torch.train import TrainConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh, dev = init_from_env("gloo", "cuda")
    rank = dist.get_rank()
    full = get_config("qwen3-1.7b")
    cfg = full.with_overrides(num_layers=ZERO_LAYERS)
    batch = make_batch(cfg, np.random.default_rng(0), TRAIN_BATCH, TRAIN_SEQ)
    with np.load(os.path.join(outdir, "prompts.npz")) as f:
        prompts = [f[k] for k in sorted(f.files, key=lambda k: int(k[4:]))]
    want_flash = cfg.num_layers * 2
    res = {}
    for strategy in ("flat", "zero1", "zero2", "zero3"):
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer.create(
            cfg, optimizer="adamw", lr=TRAIN_LR,
            dp=DPConfig(strategy=strategy), mesh=mesh,
            train_cfg=TrainConfig(remat=True), seed=0, device=dev)
        n_params = trainer.describe()["params"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls, between, flash, spans = _steps(trainer, batch,
                                                      DP_STEPS, dev)
        if any(f != want_flash for f in flash):
            raise SystemExit(f"rank {rank} ({strategy}): flash launched "
                             f"{flash} times a step, expected {want_flash}")
        st = trainer.state
        r = {"losses": losses, "step_walls_ms": [w * 1e3 for w in walls],
             "spans_ms": spans, "between_steps_bytes": between,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "params": n_params}
        if st.layout.sharded:
            r["moment_elems"] = st.opt_state["m"]["flat"].numel()
            r["shard_len"] = st.layout.shard_len
        if strategy == "zero3":
            ck = os.path.join(outdir, "ckpt")
            t0 = time.perf_counter()
            rec = trainer.save_async(ck)
            r["save_blocking_s"] = time.perf_counter() - t0
            r["save_bytes_this_rank"] = rec["bytes"]
            r["loss4"] = float(trainer.step(batch)["loss"])
            stats = trainer.finish_saves()
            r["write_s"] = stats["last_write_s"]
            eng = trainer.serve(**SERVE_KW)
            if rank == 0:
                reset_launch_counts()
                toks = eng.generate(prompts, NEW_TOKENS)
                r["paged_launches"] = launch_counts().get(
                    "paged_flash_decode", 0)
                np.savez(os.path.join(outdir, "tokens.npz"), *toks)
            del eng
            dist.barrier()
        res[strategy] = r
        del trainer, st
    if rank == 0:
        flat = res["flat"]
        for name, r in res.items():
            r["loss_gap_to_flat"] = max(abs(a - b) for a, b in
                                        zip(r["losses"], flat["losses"]))
            r["between_ratio_to_flat"] = (r["between_steps_bytes"][-1]
                                          / flat["between_steps_bytes"][-1])
        bad = [n for n, r in res.items()
               if r["loss_gap_to_flat"] > ZERO_LOSS_TOL]
        if bad:
            raise SystemExit(f"phase 18b: {bad} losses differ from flat's "
                             f"by more than {ZERO_LOSS_TOL:g}")
        if res["zero3"]["between_ratio_to_flat"] > ZERO3_MEM_RATIO:
            raise SystemExit(f"phase 18b: zero3 holds "
                             f"{res['zero3']['between_ratio_to_flat']:.3f} "
                             f"of flat's bytes between steps")
        for name in ("zero1", "zero2", "zero3"):
            if res[name]["moment_elems"] * ZERO_RANKS < res[name]["params"]:
                raise SystemExit(f"phase 18b: {name}'s moments are not 1/2")
        print(f"phase 18b: {cfg.name} full width, reduced: num_layers "
              f"{full.num_layers} -> {ZERO_LAYERS} "
              f"({res['flat']['params'] / 1e9:.3f} B params by "
              f"Trainer.describe), {ZERO_RANKS} gloo ranks on one card, "
              f"1 x {TRAIN_SEQ} tokens a rank, {DP_STEPS} AdamW steps:",
              flush=True)
        for name, r in res.items():
            print(f"phase 18b ({name}): losses {r['losses']} (gap to flat "
                  f"{r['loss_gap_to_flat']:.1e}); step walls "
                  f"{', '.join(f'{w:.0f}' for w in r['step_walls_ms'])} ms; "
                  f"between steps {r['between_steps_bytes'][-1] / 2**30:.2f} "
                  f"GiB a rank ({r['between_ratio_to_flat']:.3f} x flat's, "
                  f"{r['between_steps_bytes'][-1] / r['params']:.2f} B a "
                  f"param); peak {r['peak_bytes'] / 2**30:.2f} GiB",
                  flush=True)
        with open(os.path.join(outdir, "ranks.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def machine_room(path):
    """(free disk GB under ``path``, available host memory GB), printing
    ``df -h`` and ``free -g`` of the card's machine."""
    import shutil
    for cmd in (["df", "-h", path], ["free", "-g"]):
        res = subprocess.run(cmd, capture_output=True, text=True)
        for line in res.stdout.strip().splitlines():
            print(f"    {line}")
    with open("/proc/meminfo") as f:
        avail = next(int(ln.split()[1]) for ln in f
                     if ln.startswith("MemAvailable")) * 1024
    return shutil.disk_usage(path).free / 1e9, avail / 1e9


def checkpoint_qwen(dev, trainer, create, cfg, batch, prompts,
                    serve_launches):
    """Phase 17 on phase 16's bucketed trainer after its 3 steps: save
    asynchronously, step while the writer publishes, restore into a
    fresh trainer, hold the restored state to a host copy taken at the
    save, serve from the trainer and from the checkpoint, then step.
    Returns the phase's numbers."""
    import gc
    import shutil
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import data_cursor
    from repro_torch.serve import make_engine_from_checkpoint
    from repro_torch.train import trainable

    def state_of(t):
        masters = trainable(t.state.params)
        return {"params": masters, "m": t.state.opt_state["m"],
                "v": t.state.opt_state["v"]}

    at = trainer.state.step
    n_bytes = 3 * 4 * sum(p.numel()
                          for p in trainable(trainer.state.params).values())
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    disk_gb, mem_gb = machine_room(CKPT_DIR)
    # host memory holds the copy below beside the snapshot, then beside
    # the eager restore's read
    if disk_gb < 1.2 * n_bytes / 1e9 or mem_gb < 2.2 * n_bytes / 1e9:
        fail(f"phase 17: {disk_gb:.1f} GB of disk and {mem_gb:.1f} GB of "
             f"host memory free; the {n_bytes / 1e9:.1f} GB checkpoint "
             "needs 1.2x and 2.2x that: cut the depth")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        saved = {kind: {k: t.detach().to("cpu", copy=True)
                        for k, t in leaves.items()}
                 for kind, leaves in state_of(trainer).items()}
        t0 = time.perf_counter()
        rec = trainer.save_async(CKPT_DIR, extra=data_cursor(0, at))
        returned = time.perf_counter()
        reset_launch_counts()
        loss4 = float(trainer.step(batch)["loss"])
        step4_wall = time.perf_counter() - returned
        step4_flash = launch_counts().get("flash_attention", 0)
        stats = trainer.finish_saves()
        published = time.perf_counter() - t0
        trainer.state = None     # free its masters, moments and gradients
        gc.collect()
        torch.cuda.empty_cache()

        fresh = create()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored_at = fresh.restore(CKPT_DIR)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if restored_at != at or fresh.state.step != at or \
                fresh.state.opt_state["step"] != at:
            fail(f"phase 17: restored step {restored_at} / "
                 f"{fresh.state.step}, saved at {at}")
        for kind, leaves in state_of(fresh).items():
            for k, t in leaves.items():
                if not torch.equal(t, saved[kind][k].to(t.device)):
                    fail(f"phase 17: restored {kind} {k} differs from the "
                         "host copy taken at the save")
        del saved
        gc.collect()

        outs, launches, serve_s = {}, {}, {}
        for src in ("trainer", "checkpoint"):
            t0 = time.perf_counter()
            eng = (fresh.serve(**SERVE_KW) if src == "trainer" else
                   make_engine_from_checkpoint(CKPT_DIR, cfg, device=dev,
                                               **SERVE_KW))
            torch.cuda.synchronize()
            serve_s[src] = time.perf_counter() - t0
            reset_launch_counts()
            outs[src] = eng.generate(prompts, NEW_TOKENS)
            st = eng.stats()
            launches[src] = launch_counts().get("paged_flash_decode", 0)
            calls = st["prefill_dispatches"] + DECODE_CHUNK * st[
                "decode_dispatches"]
            if launches[src] != cfg.num_layers * calls or \
                    launches[src] != serve_launches:
                fail(f"phase 17 ({src}): paged_flash_decode launched "
                     f"{launches[src]} times, expected {cfg.num_layers} x "
                     f"{calls} model calls = phase 3's {serve_launches}")
            del eng
            torch.cuda.empty_cache()
        if len(outs["trainer"]) != len(outs["checkpoint"]) or any(
                not np.array_equal(a, b)
                for a, b in zip(outs["trainer"], outs["checkpoint"])):
            fail("phase 17: Trainer.serve() and "
                 "make_engine_from_checkpoint gave different greedy tokens")
        if len(outs["trainer"]) != len(prompts) or any(
                len(o) != NEW_TOKENS or o.min() < 0
                or o.max() >= cfg.vocab_size for o in outs["trainer"]):
            fail("phase 17: served outputs have the wrong length or "
                 "out-of-vocab tokens")

        reset_launch_counts()
        loss4_again = float(fresh.step(batch)["loss"])
        flash = launch_counts().get("flash_attention", 0)
        if loss4_again != loss4:
            fail(f"phase 17: the step after the restore gave loss "
                 f"{loss4_again!r}, the uninterrupted step 4 {loss4!r}")
        want_flash = TRAIN_MICRO * cfg.num_layers * 2
        if flash != want_flash or step4_flash != want_flash:
            fail(f"phase 17: flash_attention launched {step4_flash} and "
                 f"{flash} times a step, expected {want_flash}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del fresh
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"step": at, "bytes": rec["bytes"],
           "bytes_published": stats["bytes_published"],
           "save_async_blocking_s": rec["blocking_s"],
           "write_s": stats["last_write_s"],
           "write_gb_per_s": rec["bytes"] / 1e9 / stats["last_write_s"],
           "save_to_publish_s": published, "step4_wall_s": step4_wall,
           "restore_s": restore_s, "trainer_serve_build_s":
               serve_s["trainer"], "serve_restore_s": serve_s["checkpoint"],
           "loss4": loss4, "paged_flash_decode_launches": launches,
           "flash_attention_launches_a_step": flash,
           "peak_device_gib": peak, "requests": len(prompts)}
    print(f"phase 17: {cfg.name} full width and depth, step {at} saved "
          f"asynchronously ({rec['bytes'] / 1e9:.3f} GB of fp32 masters, m "
          f"and v) while step 4 ran (loss {loss4!r}); restored masters, m "
          f"and v == the host copy taken at the save, bit for bit; the "
          f"step after the restore gave {loss4!r} bit for bit; "
          f"Trainer.serve() == make_engine_from_checkpoint greedy tokens "
          f"for {len(prompts)} requests x {NEW_TOKENS}, paged_flash_decode "
          f"launches {launches['trainer']} and {launches['checkpoint']}")
    print(f"phase 17: {json.dumps(out)}")
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1-2 only (build, kernels vs plain "
                         "versions, timings) and print no result line")
    ap.add_argument("--max-splits", type=int, default=None,
                    help="cap the bf16 attention kernels' split-KV count "
                         "(GQA and MLA; 1: no split), to time the split's "
                         "share of phase 2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this checks the port on a "
             "CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels import (build, gqa_split, launch_counts,
                                     mla_split, reset_launch_counts)
    from repro_torch.models import init_model

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    stems = ("paged_decode", "paged_decode_mla", "wkv6", "mamba_scan",
             "flash_attention")
    build.load_libraries(stems)
    print(f"phase 1: built {len(stems)} kernels in parallel in "
          f"{time.perf_counter() - t0:.1f} s")
    for stem in stems:
        info = build.build_info[stem]
        ptxas = [ln.strip() for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "smem" in ln
                 or re.search(r"[1-9]\d* bytes spill", ln)]
        print(f"  csrc/{stem}.cu: nvcc {info['seconds']:.1f} s; ptxas: "
              f"{ptxas}")

    # ---- phase 2: kernels vs plain versions -------------------------------
    if args.max_splits is not None:
        gqa_split.MAX_SPLITS = mla_split.MAX_SPLITS = args.max_splits
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    print("phase 2: kernels against their plain versions "
          f"(paged_flash_decode tolerance fp32 {TOL[torch.float32]:g}, bf16 "
          f"{TOL[torch.bfloat16]:g}; times are device ms per call)")
    rows = check_paged_decode(dev, flush)
    jamba_rows = check_paged_decode(dev, flush, h=32, windowed=False,
                                    tag="jamba h=32: ")
    print(f"  wkv6 tolerance: atol {WKV_ATOL:g} in fp32, the reference's own "
          "WKV bar (the chunked form re-associates the time sums); bf16 y "
          f"also rtol {WKV_BF16_RTOL:g}, one bf16 step, since both sides "
          "round fp32 sums taken in another order to bf16")
    wkv_rows = check_wkv6(dev, flush)
    print(f"  mamba_scan tolerance: atol {MAMBA_ATOL:g} in fp32, the "
          "reference's own Mamba bar; bf16 y also rtol "
          f"{MAMBA_BF16_RTOL:g}, one bf16 step; B and C are strided column "
          "slices of one projection, as on the serving path")
    mamba_rows = check_mamba(dev, flush)
    print(f"  paged_flash_decode_mla tolerance: fp32 {TOL[torch.float32]:g}, "
          f"bf16 {TOL[torch.bfloat16]:g} (as paged_flash_decode); the trash "
          "page and unwritten rows hold 1e4, then 1e8, and the output must "
          "not change one bit")
    mla_rows = check_paged_decode_mla(dev, flush)
    print(f"  flash_attention tolerance: fp32 {TOL[torch.float32]:g}, bf16 "
          f"{TOL[torch.bfloat16]:g} (both round the probabilities to bf16, "
          "the plain version after normalising, the kernel before); a slab "
          "slice's tail holds 1e4, then 1e8, and the output must not change "
          "one bit")
    flash_rows = check_flash_attention(dev, flush)
    print(f"  flash_attention at the training shape: forward tolerance as "
          f"above; gradients max |err| / max |grad| fp32 "
          f"{TRAIN_GRAD_TOL[torch.float32]:g}, bf16 "
          f"{TRAIN_GRAD_TOL[torch.bfloat16]:g} (the backward is plain "
          "PyTorch recomputing 1024-row q-chunks; fp32 re-associates sums "
          "over 4096 rows, bf16 rounds each chunk's products)")
    train_rows = check_flash_train(dev, flush)
    del flush
    if args.kernels_only:
        print(json.dumps({"phase2": {
            "max_splits": gqa_split.MAX_SPLITS,
            "mla_max_splits": mla_split.MAX_SPLITS,
            "paged_flash_decode": rows + jamba_rows, "wkv6": wkv_rows,
            "mamba_scan": mamba_rows, "paged_flash_decode_mla": mla_rows,
            "flash_attention": flash_rows + train_rows}}))
        print(card_line())
        return

    # ---- phase 3: the main path, full width, bf16 -------------------------
    cfg = get_config("qwen3-1.7b")
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"phase 3: {cfg.name} ({cfg.param_count() / 1e9:.2f} B params, "
          f"{cfg.num_layers} layers, bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    serve(cfg, model, prompts[:2], 4)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    reset_launch_counts()
    t0 = time.perf_counter()
    sch, outs = serve(cfg, model, prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = sch.stats()
    model_calls = st["prefill_dispatches"] + DECODE_CHUNK * st[
        "decode_dispatches"]
    launches = counts.get("paged_flash_decode", 0)
    if launches != cfg.num_layers * model_calls:
        fail(f"paged_flash_decode launched {launches} times, expected "
             f"{cfg.num_layers} x {model_calls} model calls")
    if counts.get("wkv6", 0):
        fail("wkv6 launched on the attention-only path")
    if len(outs) != REQUESTS or any(
            len(o) != NEW_TOKENS or o.min() < 0 or o.max() >= cfg.vocab_size
            for o in outs):
        fail("served outputs have the wrong length or out-of-vocab tokens")
    n_tok = sum(len(o) for o in outs)
    ttft = sorted(st["ttft_s"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 3: {REQUESTS} requests ({int(lens.sum())} prompt tokens, "
          f"{PROMPT_MIN}-{PROMPT_MAX} each) x {NEW_TOKENS} new tokens on "
          f"{SLOTS} slots in {wall:.3f} s: {n_tok / wall:.1f} tokens/s, "
          f"TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms, "
          f"{st['syncs_per_token']:.4f} host syncs/token, peak memory "
          f"{peak_gib:.2f} GiB ({resident_gib:.2f} GiB resident at the "
          f"start), pool {st['pool_bytes'] / 2**20:.0f} MiB; "
          f"paged_flash_decode launches {launches} = {cfg.num_layers} x "
          f"({st['prefill_dispatches']} prefill calls + {DECODE_CHUNK} x "
          f"{st['decode_dispatches']} decode ticks)")
    del model, sch
    torch.cuda.empty_cache()

    # ---- phase 4: card vs CPU greedy parity, fp32 -------------------------
    small = cfg.with_overrides(num_layers=2, dtype="float32")
    prompts4 = [p[:n] for p, n in zip(prompts[:4], (7, 40, 70, 33))]
    got = {}
    for where in ("cpu", "cuda"):
        m = init_model(small, seed=1, device="cpu")
        if where == "cuda":
            m = m.to(dev)
        got[where] = serve(small, m, prompts4, 12)[1]
    for a, b in zip(got["cpu"], got["cuda"]):
        if not np.array_equal(a, b):
            fail(f"fp32 greedy tokens differ card vs CPU: {a} vs {b}")
    print(f"phase 4: 2-layer full-width fp32 greedy tokens equal on card and "
          f"CPU for {len(prompts4)} requests x 12 tokens")
    del m
    torch.cuda.empty_cache()
    wkv_launches = serve_rwkv(dev, lens)
    scan_launches, jamba_paged_launches = serve_jamba(dev, lens)
    mla_launches = serve_deepseek(dev, lens)
    flash_launches = serve_legacy(dev)
    train_launches, train_out = train_qwen(dev)
    paper_out = paper_dp(dev)
    dp_out, ckpt_out, zero_out = dp_qwen(dev, train_out["losses"], prompts,
                                         launches)

    decode_bf16, chunk_bf16 = (
        next(r for r in rows if r["case"] == case and r["dtype"] == "bfloat16")
        for case in ("decode B=8 S=1, slots 1..max_len tokens",
                     "prefill chunk B=1 S=32"))
    entry = {
        "name": "paged_flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:141",
        "launches": launches, "launches_jamba": jamba_paged_launches,
        "launches_from_checkpoint": ckpt_out["paged_flash_decode_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + jamba_rows
                           if r["dtype"] == "bfloat16"),
        "ms": decode_bf16["ms"], "plain_ms": decode_bf16["plain_ms"],
        "bound_ms": decode_bf16["bound_ms"],
        "bound_by": decode_bf16["bound_by"],
        "library_ms": decode_bf16["library_ms"],
        "chunk": {key: chunk_bf16[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "cases": rows + jamba_rows,
    }
    wkv_bf16 = next(r for r in wkv_rows if r["case"].startswith("prefill")
                    and r["dtype"] == "bfloat16")
    wkv_entry = {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:36",
        "launches": wkv_launches,
        "max_abs_err": max(r["max_abs_err"] for r in wkv_rows
                           if r["dtype"] == "bfloat16"),
        "ms": wkv_bf16["ms"], "plain_ms": wkv_bf16["plain_ms"],
        "bound_ms": wkv_bf16["bound_ms"],
        "bound_by": wkv_bf16["bound_by"],
        "library_ms": None,
        "cases": wkv_rows,
    }
    scan_bf16 = next(r for r in mamba_rows if r["case"].startswith("prefill")
                     and r["dtype"] == "bfloat16")
    mamba_entry = {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:27",
        "launches": scan_launches,
        "max_abs_err": max(r["max_abs_err"] for r in mamba_rows
                           if r["dtype"] == "bfloat16"),
        "ms": scan_bf16["ms"], "plain_ms": scan_bf16["plain_ms"],
        "bound_ms": scan_bf16["bound_ms"],
        "bound_by": scan_bf16["bound_by"],
        "library_ms": None,
        "cases": mamba_rows,
    }
    mla_bf16, mla_chunk = (
        next(r for r in mla_rows if r["case"].startswith(case)
             and r["dtype"] == "bfloat16") for case in ("decode", "prefill"))
    mla_entry = {
        "name": "paged_flash_decode_mla", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_mla.cu",
        "replaces": "src/repro/kernels/paged_decode.py:240",
        "launches": mla_launches,
        "max_abs_err": max(r["max_abs_err"] for r in mla_rows
                           if r["dtype"] == "bfloat16"),
        "ms": mla_bf16["ms"], "plain_ms": mla_bf16["plain_ms"],
        "bound_ms": mla_bf16["bound_ms"],
        "bound_by": mla_bf16["bound_by"],
        "library_ms": mla_bf16["library_ms"],
        "sdpa_backend": mla_bf16["sdpa_backend"],
        "chunk": {key: mla_chunk[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "sdpa_backend", "splits", "blocks")},
        "cases": mla_rows,
    }
    timed = {r["case"].split()[0]: r for r in flash_rows
             if "ms" in r and r["dtype"] == "bfloat16"}
    train_bf16 = next(r for r in train_rows if r["dtype"] == "bfloat16")
    flash_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": flash_launches,
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows + train_rows
                           if r["dtype"] == "bfloat16"),
        "ms": timed["decode"]["ms"], "plain_ms": timed["decode"]["plain_ms"],
        "bound_ms": timed["decode"]["bound_ms"],
        "bound_by": timed["decode"]["bound_by"],
        "library_ms": timed["decode"]["library_ms"],
        "sdpa_backend": timed["decode"]["sdpa_backend"],
        "prefill": {key: timed["prefill"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "sdpa_backend")},
        "launches_train": train_launches,
        "launches_dp_train": {k: v["launches"] for k, v in dp_out.items()},
        "launches_zero_a_step": {k: v["flash_launches_a_step"]
                                 for k, v in zero_out["nccl"].items()},
        "dp_train": dp_out, "paper_dp": paper_out, "checkpoint": ckpt_out,
        "zero": zero_out,
        "train": {**{key: train_bf16[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "sdpa_backend", "bwd_plain_ms", "library_fwd_bwd_ms",
            "bwd_bound_ms", "bwd_bound_by", "grad_rel_err")},
            "step": train_out},
        "cases": flash_rows + train_rows,
    }
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry, wkv_entry, mamba_entry,
                                  mla_entry, flash_entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--zero-rank"]:
        zero_rank(sys.argv[2])
    else:
        main()
