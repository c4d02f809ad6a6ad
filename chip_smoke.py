"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each fails the run if it goes wrong):
  1. the card's name and power limit; build every CUDA kernel of the
     serving path from ``src/repro_torch/csrc`` with nvcc for sm_90a;
  2. each kernel against its plain PyTorch version at the main path's
     full-width shapes, fp32 and bf16, with its time, the plain
     version's, the one-call PyTorch yardstick's and the bound;
  3. the main path: full-width qwen3-1.7b in bf16 (weights from a seed)
     serves 16 requests on 8 slots through the continuous scheduler,
     with every attention call launched through the kernel;
  4. parity: a 2-layer full-width variant in fp32 gives the same greedy
     tokens on the card (kernel) as on the CPU (plain version).
The last lines are the kernels' JSON record, the card's name and power
limit, and the result line.  Without a card, or outside the repository,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
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
POISON = 1e4

# the serving run of phase 3
SLOTS, REQUESTS, NEW_TOKENS = 8, 16, 64
PROMPT_MIN, PROMPT_MAX = 64, 512
PAGE_SIZE, DECODE_CHUNK, PREFILL_CHUNK = 16, 8, 32
MAX_LEN = -(-(PROMPT_MAX + NEW_TOKENS + DECODE_CHUNK) // PAGE_SIZE) * PAGE_SIZE


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
    """Mean device time of fn() over iters calls, each timed alone with
    CUDA events after the L2 cache was flushed (the serving path finds a
    layer's pool cold: 28 layers' pools exceed the 50 MB L2).  The card
    spins for about a millisecond before the start event, so the host
    has enqueued all of fn() by then and the events time the device's
    work, not the host's launch overhead."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def check_paged_decode(dev, flush):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode import (
        paged_flash_decode, paged_flash_decode_ref, visible_tokens)
    from repro_torch.models.attention import PagedView, paged_read

    h, hk, hd, ps = 16, 8, 128, PAGE_SIZE            # qwen3-1.7b widths
    W = MAX_LEN // ps
    rng = np.random.default_rng(0)
    cases = [
        ("decode B=8 S=1, slots 1..max_len tokens", 8, 1, 0,
         np.linspace(1, W * ps, 8).astype(int)),
        ("prefill chunk B=1 S=32", 1, 32, 0, np.array([PROMPT_MAX])),
        ("windowed chunk B=4 S=32 window=100", 4, 32, 100,
         np.array([40, 200, 333, 560])),
    ]
    rows = []
    for name, B, S, window, lengths in cases:
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
                "max_abs_err": err, "tol": tol, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "ops": ops})
            print(f"  paged_flash_decode {name:40s} {rows[-1]['dtype']:8s} "
                  f"err {err:.2e} (tol {tol:g})  kernel {ms:.4f} ms  "
                  f"plain {plain_ms:.4f} ms  sdpa-on-slab {library_ms:.4f} ms"
                  f"  bound {rows[-1]['bound_ms']:.4f} ms "
                  f"({rows[-1]['bound_by']})")
    return rows


# --------------------------------------------------------------------------
# phase 3 / 4: the serving path
# --------------------------------------------------------------------------

def serve(cfg, model, prompts, new_tokens, **kw):
    from repro_torch.serve import ContinuousScheduler
    sch = ContinuousScheduler(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                              page_size=PAGE_SIZE, decode_chunk=DECODE_CHUNK,
                              prefill_chunk=PREFILL_CHUNK, **kw)
    return sch, sch.generate(prompts, new_tokens)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this checks the port on a "
             "CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, launch_counts, reset_launch_counts
    from repro_torch.models import init_model

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    build.load_library("paged_decode")
    info = build.build_info["paged_decode"]
    regs = [ln.strip() for ln in info["ptxas"].splitlines()
            if "registers" in ln]
    print(f"phase 1: built csrc/paged_decode.cu in {info['seconds']:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s); ptxas: {regs}")

    # ---- phase 2: kernels vs plain versions -------------------------------
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    print("phase 2: kernels against their plain versions "
          f"(tolerance fp32 {TOL[torch.float32]:g}, bf16 "
          f"{TOL[torch.bfloat16]:g}; times are device ms per call)")
    rows = check_paged_decode(dev, flush)
    del flush

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
          f"{peak_gib:.2f} GiB, pool {st['pool_bytes'] / 2**20:.0f} MiB; "
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
        _, got[where] = serve(small, m, prompts4, 12)
    for a, b in zip(got["cpu"], got["cuda"]):
        if not np.array_equal(a, b):
            fail(f"fp32 greedy tokens differ card vs CPU: {a} vs {b}")
    print(f"phase 4: 2-layer full-width fp32 greedy tokens equal on card and "
          f"CPU for {len(prompts4)} requests x 12 tokens")

    decode_bf16 = next(r for r in rows if r["case"].startswith("decode")
                       and r["dtype"] == "bfloat16")
    entry = {
        "name": "paged_flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:141",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "bfloat16"),
        "ms": decode_bf16["ms"], "plain_ms": decode_bf16["plain_ms"],
        "bound_ms": decode_bf16["bound_ms"],
        "bound_by": decode_bf16["bound_by"],
        "library_ms": decode_bf16["library_ms"],
        "cases": rows,
    }
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
