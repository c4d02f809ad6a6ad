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
     S = T = 4096), forward and the gradients of its autograd Function
     (the backward kernel, csrc/flash_attention_bwd.cu), and at MLA's
     widths (q, k 192, v 128; 128 heads) at the slab prefill and
     training shapes, forward and gradients; at every training form the
     forward's output bitwise with and without its log-sum-exp (every
     block shape) and two backward calls bitwise; the backward kernel
     against its tiled plain version at small forms (every width pair,
     g 1 to 48, causal, windowed, non-causal S != T); the gradients
     of the WKV6 and MambaScan Functions at the training shapes (B 1,
     T 4096, 32 heads of 64; Bb 1, T 2048, dI 8192, dS 16), fp32 and
     bf16, against autograd of the plain chunked forms, and their
     backward kernels (csrc/wkv6_bwd.cu, csrc/mamba_scan_bwd.cu) against
     the plain backwards and, in fp32, against the float64 gradient of
     the sequential recurrence, two calls bitwise equal, timed beside
     them;
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
     on fp32 masters, AdamW, takes 1 + 3 steps on one batch of 2 x 4096
     tokens in 2 microbatches with per-layer remat, every attention
     forward (and its recompute) launched through the flash kernel and
     every attention backward through the flash backward kernel (224 =
     4 x 2 x 28 flash_attention_bwd launches; a spy sees the plain
     backward run 0 times); every training phase after it checks its
     flash_attention_bwd launches too, one a backward;
 14. parity: a 2-layer full-width qwen3-1.7b in fp32 takes 3 AdamW steps
     on the card (kernel forward and backward) and on the CPU (plain
     version) with
     agreeing losses and params;
 15. the paper's claim: MNIST-DNN and CIFAR10-CNN at Table-1 width take
     5 SGD steps on the card equal to the CPU's (fp32, TF32 off; the
     CNN held to 1e-5 after its first step, to 1e-4 after the fifth);
     the MNIST-DNN launcher under torchrun, 2 gloo ranks sharing the
     card, equals the card's sequential run for flat and bucketed, and
     4 ranks (pod 2 x data 2) for hierarchical; weight averaging every
     2 steps leaves the ranks bitwise equal after steps 2 and 4 (the four
     launches run side by side, beside the card-vs-CPU steps);
 16. full-width qwen3-1.7b through ``Trainer(model_cfg=...)`` over a
     world of one NCCL rank, dp=flat then dp=bucketed, 3 steps on phase
     13's batch: the losses equal phase 13's first 3 bit for bit, with
     exactly 3 x 2 x 28 x 2 = 336 flash_attention launches a run;
 17. checkpoints: a bucketed trainer over the same rank (full-width
     qwen3-1.7b cut to 4 layers, after 3 steps) saves asynchronously
     with its data cursor (6.15 GB of fp32 masters, m and v) and takes
     step 4 while the writer publishes; a fresh trainer restores the
     checkpoint to masters, m and v equal to a host copy taken at the
     save, bit for bit; it serves phase 3's traffic, and so does
     ``make_engine_from_checkpoint``, with bitwise-equal greedy tokens
     and exactly 4 x 282 = 1128 paged_flash_decode launches each; then
     its step gives step 4's loss bit for bit (16 = 2 x 4 x 2
     flash_attention launches).  The checkpoint is deleted at the
     phase's end; the full-depth 20.6 GB one was cut for phase 28's time.
 18. the ZeRO ladder.  (a) full-width, full-depth qwen3-1.7b through
     ``Trainer(model_cfg=...)`` over phase 16's world of one NCCL rank,
     dp = zero1, zero2, zero3 and zero1 with overlap=True, 3 steps each
     on phase 13's batch: exactly 112 flash_attention launches a step,
     zero1's losses phase 16's flat losses bit for bit (one rank's
     reduce-scatter is a copy and AdamW is elementwise), zero2's and
     zero3's within 1e-5, peak under 80 GB; the reduce-scatter and
     all-gather ms (SyncTimer) and the memory between steps printed.
     (b) 2 gloo ranks sharing the card (torchrun of this script), full
     width at depth 2 (reduced: num_layers 28 -> 2; 4 until phase 31
     needed the time), each rank 1 x 4096
     tokens of phase 13's batch, dp = flat, zero1, zero2, zero3, 2 steps
     each (3 until phase 27 needed the time): the losses within 1e-5 of
     flat's, zero3's memory between steps at most 0.55 x flat's, zero1's
     moments 1/2; zero3 saves at step 2 with save_async (every rank its
     own worker file) and takes step 3; a one-rank bucketed trainer
     restores that checkpoint, its step 3 gives zero3's step-3 loss
     within 1e-5, and Trainer.serve()
     of both serves phase 3's traffic at depth 2 with equal greedy
     tokens and 2 x 282 paged_flash_decode launches each.  The
     checkpoint is deleted at the phase's end.
 19. the lockstep slab path of the other three models, bf16, phase 11's
     traffic: rwkv6-1.6b (nothing cut) with exactly 24 wkv6 launches
     (one whole-prompt scan a layer), jamba-v0.1-52b at its 8-layer cut
     with 7 mamba_scan and 64 flash_attention launches, deepseek-v3-671b
     at its 4-layer cut with 4 flash_attention launches at (192, 128)
     (its slab decode is plain ops); then each at 2 full-width layers in
     fp32 gives the same greedy tokens on the card as on the CPU
     (DeepSeek's routed experts cut 256 -> 16 there);
 20. training full-width, full-depth rwkv6-1.6b on phase 13's batch, 1 +
     3 AdamW steps, bf16 on fp32 masters, remat: exactly 384 wkv6
     launches and 192 = 4 x 2 x 24 wkv6_bwd launches (the WKV6 Function:
     kernel forward, backward kernel; one backward a layer a
     microbatch); then
     2 fp32 layers card vs CPU (phase 14's form), 2 steps (3 until phase
     31 needed the time);
 21. training Jamba cut to 2 layers (3.742 B; SGD, 1 x 2048 tokens, 1 +
     3 steps, 16 mamba_scan and 8 = 4 x 2 mamba_scan_bwd launches) and
     DeepSeek-V3 cut to 1 layer
     (MLA + dense MLP, with its MTP head; AdamW, phase 13's batch, 1 + 3
     steps, 24 = 4 x 2 x (2 + 1) flash_attention launches at (192, 128):
     the head's block is not rematted; its mtp_ce printed; peak under
     80 GB); then each at 2 fp32 layers card vs CPU, SGD, the routed
     experts cut (Jamba 16 -> 4, DeepSeek 256 -> 16; DeepSeek's with the
     head), 2 steps (Jamba's 3 until phase 31 needed the time; the CPU
     half takes 8-16 s a step), the card halves with one scan backward
     launch a layer a step; a spy sees the scans' plain backwards run 0
     times on CUDA tensors in phases 20-21;
 22. the prefix cache and the front door: phase 3's model serves 16
     requests on 8 slots, 4 templates of 256 tokens each shared by 4
     requests, each with a unique suffix of 32-256 tokens, without the
     prefix cache and with it through ``FrontDoor``: the tokens equal
     bitwise, prefix_hit_tokens exactly 12 x 256 = 3072, the exact
     paged_flash_decode launches of each run, and only the tree's
     references left in the pool; then a 2-layer full-width qwen3 in
     fp32: the card's cached tokens equal the CPU's uncached ones with
     a copy-on-write fork, and with a pool sized down so that the tree
     evicts;
 23. speculative decoding with the MTP head: (i) phase 9's model
     (DeepSeek-V3 at its 4-layer cut, with its published MTP head, bf16)
     serves phase 3's traffic at k = 0, 2 and 4 (max_len 624): exactly
     4 paged_flash_decode_mla launches a model call (a verify forward is
     one call; the draft head launches no attention kernel) and one
     decode host sync a tick; acceptance, tokens a verify step, decode
     dispatches a token and the share of requests equal to k = 0
     printed; phase 10's fp32 model (with its head) gives the CPU's k = 0
     tokens at k = 2 and 4 on the card; (ii) qwen3-1.7b at 2 full-width
     layers with an MTP head, fp32, trained 40 Adam steps through
     ``Trainer(model_cfg=...)`` on the alternating [3, 5] stream: k = 4
     tokens equal k = 0's on the card, acceptance >= 0.6, decode
     dispatches and host syncs a token down >= 1.8x, and an EOS
     mid-chunk emits nothing after it.
 24. the four decoder-only newcomers at full width, bf16, one at a
     time, each reduced to 8 layers for the script's time limit (each
     stack repeats one layer: granite-20b (MQA, g 48) 52 -> 8,
     qwen2.5-32b (g 5, qkv bias) 64 -> 8, deepseek-coder-33b (g 7) 62
     -> 8, deepseek-moe-16b (MHA, a dense first layer then MoE of 64
     experts + 2 shared) 28 -> 8) serve phase 3's traffic through the
     continuous scheduler: exactly 8 x 282 = 2256 paged_flash_decode
     launches each; tokens/s,
     TTFT, peak memory and the device's idle share over one traced decode
     tick and one prefill chunk; granite also serves phase 11's traffic
     through the lockstep engine (512 = 8 x 64 flash_attention
     launches at g 48);
 25. the two frontends at full width and depth, bf16, through
     ``apply_model``'s slab prefill and greedy decode (the reference's
     only serving path for them): seamless-m4t-large-v2 on 8 sources of
     1024 frame embeddings with 8-token target prompts, 64 new tokens
     (3096 flash_attention launches: 24 encoder + 48 prefill + 63 x 48
     decode); llava-next-mistral-7b on 8 requests of 2880 image
     embeddings + 128 tokens, 64 new (2048 = 32 x 64); then each at 2
     full-width layers in fp32, batch 1, 8 new tokens, card vs CPU with
     equal greedy tokens and prefill logits within 1e-4 (llava on 256
     image rows + 256 tokens, the reference's make_batch rule at seq
     512);
 26. training: seamless-m4t-large-v2 at full size and
     llava-next-mistral-7b reduced to 8 of its 32 layers (AdamW's state
     for 7.24 B does not fit), 1 + 3 AdamW steps (lr 3e-4), bf16 on fp32
     masters, remat, on the reference's train_4k batch of 2 x 4096 (4096
     frames + 4096 targets; 2048 image rows + 2048 tokens) in 2
     microbatches: exactly 1152 and 128 flash_attention launches; then
     each at 2 full-width layers (seamless with 2 encoder layers) in
     fp32, 2 AdamW steps on one sequence of 128, card vs CPU with phase
     14's bars;
 27. bf16 masters and gradients: (a) llava-next-mistral-7b at full
     width and depth (32 layers, 7.24 B) with the reference's pairing
     for a model that does not fit otherwise -- bf16 masters and
     gradients, SGD at lr 1e-3 -- 1 + 3 steps on phase 26's batch in 2
     microbatches with remat: exactly 512 flash_attention launches,
     finite losses, masters and gradients bf16, its bytes between steps
     beside perf_model.dp_memory_report's; (b) 2 of its layers at full
     width, fp32 compute on bf16 masters, 2 SGD steps card vs CPU within
     one bf16 ulp a step; (c) zero3 with bf16 masters against flat over
     one NCCL rank at phase 18b's 2-layer qwen3, 3 AdamW steps; (d) the
     asynchronous parameter server on MNIST-DNN, 8 workers, 64 ticks,
     beside the synchronous steps on the same stream;
 28. the full config on a mesh: torchrun of ``chip_smoke.py --mesh-rank``
     over 4 gloo ranks sharing the card, a (data 2, model 2) mesh: (a)
     qwen3-1.7b and (b) deepseek-moe-16b (its MoE expert-parallel, the
     all_to_all over "data") at full width cut to 2 layers, fp32 with
     TF32 off, every master and moment placed by the sharding rules,
     2 momentum / 2 SGD steps of 4 x 512 tokens (momentum cut from 3
     for the script's time limit), held to the one-device
     step within 1e-5 (the MoE's in one microbatch a data shard, whose
     aux is the mesh's), each rank's flash launches exactly steps x
     layers x 2 on its own heads, its bytes between steps and step
     walls printed; (c) qwen3 again on 2 x 512 tokens in two one-row
     microbatches, whose rows do not divide data 2: each row's sequence
     is cut over "data" (the sequence split, attention over the keys
     gathered up to the rank's block), 2 momentum steps held to the
     one-device step in the same microbatches within 1e-5, each rank's
     flash launches exactly steps x microbatches x layers x 2; (a')
     qwen3 over one NCCL rank on a (1, 1) mesh, bitwise the one-device
     step.
 29. serving on a mesh: phase 28's torchrun goes on, on the same 4 gloo
     ranks and (data 2, model 2) mesh, fp32 with TF32 off: (a)
     qwen3-1.7b at full width cut to 8 layers, deepseek-moe-16b at full
     width cut to 4 layers (its MoE decode expert-parallel over data x model)
     and granite-20b cut to 2 (its one kv head does not divide model 2:
     the pool cut on head_dim, the slots' pages gathered before the
     kernel), weights drawn straight to each rank's blocks by the
     serve-mode rules, serve 4 prompts of 13-97 tokens x 16 greedy
     tokens through the continuous scheduler: tokens equal to the
     one-device engine's on the same weights, every sample's logits
     within 1e-5 (granite's within 1e-5 of its largest |logit|), each
     rank's pool half the pool, each rank's paged_flash_decode launches
     exactly layers x model calls on its own 8 q / 4 kv (deepseek: 8 /
     8; granite: 24 / 1) heads; then qwen3 at 2 layers through the
     lockstep ServeEngine, 4 x 64 prompt tokens, 2 rows a data replica:
     tokens equal, logits within 1e-5, each rank's flash_attention
     launches exactly layers x 16 model calls; (b) qwen3 at 4 layers
     over one NCCL rank on a (1, 1) mesh: logits and tokens bitwise the
     one-device engine's.  Phase 2 holds the paged kernel at each of
     (a)'s per-rank forms and the flash kernel at the lockstep one.
 30. the dry run (``repro_torch.launch.dryrun``) counts phase 13's own
     step on the meta device, on a one-rank mesh of PyTorch's fake
     process group in this process: its predicted peak within 0.85-1.15x
     phase 13's measured peak, its FLOPs against 6 N tokens (the useful
     ratio), its roofline on ``H100_SXM`` beside phase 13's step wall,
     and ``H100_SXM``'s memory within 2 % of the card's.
 31. ``kernels/ops.py`` on the card: (a) the flash kernel at every block
     shape it is built for (``ops.set_flash_blocks``: the plan, 16- and
     128-row bf16 blocks, 16- and 64-row fp32 blocks, each split count
     of the 16-row blocks), fp32 and bf16, at qwen3-1.7b's slab prefill
     (B 8, S = T = 512), slab decode (B 8, S 1, T 576) and training
     forward (B 1, S = T = 4096): each within phase 2's bars of the
     plain version and timed as phase 2 times; (b) ``ops.flash_attention``
     / ``wkv6`` / ``mamba_scan`` on CUDA tensors: "auto" and "cuda"
     launch the kernel once, "ref" and "chunked" none, all within the
     bars; (c) ``launch.serve`` at full-width qwen3-1.7b cut to 4 layers,
     fp32, 4 requests x 16 greedy tokens with --decode-kernel cuda and
     plain: bitwise equal tokens, layers x model calls paged launches
     and 0, each report naming its kernel; (d) the three ported examples
     (``launch/quickstart.py``, ``serve_batched.py``,
     ``long_context_decode.py``) at their defaults, the last with wkv6
     launches.
Phases 3, 16 and 17 also print the cost model's predictions
(``repro_torch.core.perf_model`` with H100 presets) beside what the
card measured: a decode step, the gradient all-reduce at p = 2, 4, 8
(no cross-card number can be measured) and a checkpoint's copy and
write.  Each group of phases prints its wall seconds.
Phase 2 also holds both paged kernels at speculative decode's verify
shape (B 8, S = k = 4, per-slot positions, ~512 tokens a slot), the
GQA paged kernel at the newcomers' group sizes ((h, hk) = (48, 1), (40,
8), (56, 8), (16, 16)) and the flash kernel at the encoder-decoder's and
the VLM's forms (bidirectional and non-causal cross-attention at (64,
64), S != T; llava's prefill at S = T = 3008, h 32 / hk 8), at
granite's lockstep forms (h 48 / hk 1: prefill S = T = 512, decode S 1
against a 576-key slab slice) and at seamless's training shapes ((64,
64), h = hk = 16, S = T = 4096, causal and non-causal, forward and
gradients) and at phase 28's per-rank training form (B 2, S = T = 512,
8 q / 4 kv heads of 128).
The last lines are the kernels' JSON record, the card's name and power
limit, and the result line.  Without a card, or outside the repository,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import re
import signal
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
# phase 22: templated traffic for the prefix cache -- 4 templates
# ("system prompts") of 256 tokens, requests 4t..4t+3 sharing template t,
# each with a unique suffix of 32-256 tokens; every match is 256 tokens, a
# multiple of the prefill chunk
PREFIX_TEMPLATES, PREFIX_TEMPLATE_LEN = 4, 256
PREFIX_SUFFIX_MIN, PREFIX_SUFFIX_MAX = 32, 256
# phase 23: speculative decode; (i) DeepSeek-V3 serves phase 3's traffic at
# these k (max_len covers the k = 4 slack, decode_chunk * k + k = 36);
# (ii) a head trained on the alternating [3, 5] stream
SPEC_KS, SPEC_MAX_LEN = (0, 2, 4), 624
SPEC_TRAIN_STEPS = 40
# phase 2's verify-chunk case (speculative decode at k = 4, B = 8)
VERIFY_CASE = "verify B=8 S=4, slots ~512 tokens"
# the lockstep slab run of phase 11: 8 requests of 512 prompt tokens
LEGACY_BATCH, LEGACY_PROMPT, LEGACY_MAX_LEN = 8, 512, 592
# the training run of phases 13-14: qwen3-1.7b on 2 x 4096 tokens (the
# reference's train_4k length, repro/configs/base.py:315) in 2 microbatches
# the training phases (13, 20, 26) take 1 + TRAIN_TIMED steps: 1 + 5
# until phase 29 needed the time
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_TIMED = 2, 4096, 2, 3
TRAIN_LR = 3e-4
# the flash backward (the kernel, or a plain backward) against autograd
# of the plain forward, as max |err| / max |grad| over dq, dk, dv: fp32
# re-associates sums over 4096 rows; bf16 rounds P and dS to bf16 for the
# products and takes D = rowsum(dO o O) from the bf16 output, where
# autograd of the plain version rounds P once
TRAIN_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the scan backward kernels against the plain backwards on the same
# cotangents, max |err| / max |grad|, both tighter than TRAIN_GRAD_TOL.
# fp32: two fp32 evaluations of one gradient; at the training calls on an
# H100 each lay within 2.3e-6 of the float64 sequential gradient (WKV6's
# chunked form loses that much to cancellation in both; Mamba's within
# 1.1e-6; phase 2 prints both and holds the kernel to this bar against
# it), so they differ by at most about the sum: 5e-6.  bf16: each
# gradient is such an fp32 value rounded once to bf16, so the two differ
# by at most one bf16 step at the largest gradient, 2^-7 of max |grad|
SCAN_BWD_TOL = {torch.float32: 5e-6, torch.bfloat16: 2.0 ** -7}
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
# phase 17's depth (full depth, 20.6 GB, until phase 28 needed the time)
CKPT_LAYERS = 4
# phase 18: the ZeRO runs; (b)'s depth, its ranks' files and checkpoint
ZERO_STRATEGIES = (("zero1", False), ("zero2", False), ("zero3", False),
                   ("zero1", True))
# (b)'s and phase 27 (c)'s depth (4 until phase 31 needed the time)
ZERO_LAYERS, ZERO_RANKS = 2, 2
# (b)'s steps a strategy before the checkpoint (3 until phase 27 needed
# the time)
ZERO_GLOO_STEPS = 2
ZERO_LOSS_TOL = 1e-5          # the reference's fp32 training bar
ZERO3_MEM_RATIO = 0.55        # zero3's bytes between steps / flat's
ZERO_DIR = os.path.join(ROOT, "build", "zero_phase18")
# phases 20-21: Jamba (cut to 2 layers) trains on 1 x 2048 tokens; Jamba
# and DeepSeek-V3 (cut to 1 layer) take 1 + 3 steps
JAMBA_TRAIN_SEQ, ARCH_TRAIN_STEPS = 2048, 3
# their card-vs-CPU checks: steps on the CPU (rwkv6 and Jamba took 3
# until phase 31 needed the time; step 2 is the later-steps bar's)
ARCH_PARITY_STEPS = 2
# phase 28: full-width configs cut to 2 layers on a (data 2, model 2) mesh
# of 4 gloo ranks sharing the card, fp32 with TF32 off, held to the
# one-device step (the reference's fp32 training bar); (b)'s capacity
# factor drops no token (>= E / k = 64 / 6)
MESH_SHAPE, MESH_LAYERS = (2, 2), 2
MESH_INIT_SLACK = 16 * 2 ** 20   # allocator rounding, generator state
MESH_BATCH, MESH_SEQ, MESH_LR = 4, 512, 1e-2
# case: (optimizer, steps, microbatches, rows); "arch/seq" takes 2 x 512
# tokens in one-row microbatches, the sequence split over "data"
MESH_CASES = {"qwen3-1.7b": ("momentum", 2, 1, MESH_BATCH),
              "deepseek-moe-16b": ("sgd", 2, 1, MESH_BATCH),
              "qwen3-1.7b/seq": ("momentum", 2, 2, 2)}
MESH_CF, MESH_TOL = 16.0, 1e-5
# phase 30: the dry run's count of phase 13's step against phase 13's
# measured peak; H100_SXM's memory against the card's
DRYRUN_PEAK_BAND, DRYRUN_MEM_TOL = (0.85, 1.15), 0.02
MESH_DIR = os.path.join(ROOT, "build", "mesh_phase28")
# phase 29: serving on the (data 2, model 2) mesh of phase 28, fp32 with
# TF32 off: qwen3-1.7b cut to 8 layers (28 until the scan backward checks
# needed the time), deepseek-moe-16b cut to 4 layers
# (rank 0's one-device reference of all 28 would not fit beside the
# ranks' blocks), granite-20b cut to 2 (its one kv head does not divide
# model 2: the pool is cut on head_dim and gathered before the kernel);
# 4 prompts of different lengths, 16 greedy tokens each
SERVE_MESH_LAYERS = {"qwen3-1.7b": 8, "deepseek-moe-16b": 4,
                     "granite-20b": 2}
SERVE_MESH_LENS, SERVE_MESH_NEW, SERVE_MESH_TOL = (40, 97, 13, 64), 16, 1e-5
# ... granite's bar is relative to its largest logit: its sums run over
# rows of 6144 and 24576 (3x and 4x qwen3's), and its first run read
# 1.06e-05 absolute against SERVE_MESH_TOL with equal tokens
SERVE_MESH_FALLBACK_RTOL = 1e-5
SERVE_MESH_MAX_LEN = -(-(max(SERVE_MESH_LENS) + SERVE_MESH_NEW + DECODE_CHUNK)
                       // PAGE_SIZE) * PAGE_SIZE
# ... the lockstep slab engine: qwen3-1.7b at 2 layers, 4 prompts of 64
# tokens, 2 rows a data replica
SERVE_MESH_SLAB_LAYERS, SERVE_MESH_SLAB_BATCH = 2, 4
SERVE_MESH_SLAB_PROMPT = 64
SERVE_MESH_NCCL_LAYERS = 4
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


def check_bwd(tag, counts, want):
    """The flash backward kernel's launches in a training run: one for
    each backward of ``FlashAttention`` (a rematted layer's forward
    launches twice, its backward once).  Returns the count."""
    got = counts.get("flash_attention_bwd", 0)
    if got != want:
        fail(f"{tag}: flash_attention_bwd launched {got} times, expected "
             f"{want} (one a FlashAttention backward)")
    return got


# each group of phases' wall seconds, in the order they ran
PHASE_S = {}


def run_phase(label, fn, *args):
    """``fn(*args)``, its wall seconds printed and kept under ``label``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[label] = time.perf_counter() - t0
    print(f"{label}: {PHASE_S[label]:.1f} s")
    return out


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


def time_ms(fn, flush, iters=10):
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


# phase 2, the newcomers' group sizes: (h, hk) of granite-20b (MQA),
# qwen2.5-32b, deepseek-coder-33b and deepseek-moe-16b (MHA), hd 128
NEW_GROUPS = ((48, 1), (40, 8), (56, 8), (16, 16))


def group_cases(rng):
    """The newcomers' paged cases: a decode step and a prefill chunk with
    ~512 tokens a slot."""
    return [("decode B=8 S=1, slots ~512 tokens", 8, 1, 0,
             rng.integers(480, 545, 8), 128),
            ("prefill chunk B=1 S=32", 1, 32, 0, np.array([PROMPT_MAX]),
             128)]


def check_paged_decode(dev, flush, h=16, windowed=True, tag="", hk=8,
                       cases=None, max_len=MAX_LEN):
    """The paged kernel at h query heads over hk kv heads of 128 (qwen3-
    1.7b: h=16, hk=8; Jamba's attention layer: h=32; ``cases`` replaces
    the default decode and chunk cases), page tables of ``max_len``
    tokens a slot."""
    import torch.nn.functional as F
    from repro_torch.kernels import gqa_split
    from repro_torch.kernels.paged_decode import (
        paged_flash_decode, paged_flash_decode_ref, visible_tokens)
    from repro_torch.models.attention import PagedView, paged_read

    ps = PAGE_SIZE
    W = max_len // ps
    rng = np.random.default_rng(0)
    cases = cases or [
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
                   np.array([PROMPT_MAX]), 32),
                  # speculative decode's verify chunk: k = 4 query rows a
                  # slot at per-slot positions
                  (VERIFY_CASE, 8, 4, 0, rng.integers(480, 545, 8), 128)]
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
            # bf16: the shared GQA core's plan; fp32: the FMA kernel's
            # blocks of up to 16 group rows
            if dtype == torch.bfloat16:
                warps, splits = gqa_split.plan(B * hk, h // hk * S, W * ps)
                n_blocks = gqa_split.blocks(B * hk, h // hk * S, warps,
                                            splits)
            else:
                rt = min(16, h // hk * S)
                warps, splits = None, 1
                n_blocks = B * hk * -(-(h // hk * S) // rt)
            rows.append({
                "case": name, "dtype": str(dtype).replace("torch.", ""),
                "warps": warps, "splits": splits, "blocks": n_blocks,
                "max_abs_err": err, "tol": tol, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "ops": ops})
            print(f"  paged_flash_decode {name:40s} {rows[-1]['dtype']:8s} "
                  f"splits {splits} blocks {n_blocks}  "
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
        # speculative decode's verify chunk: k = 4 query positions a slot
        (VERIFY_CASE, 8, 4, 0, rng.integers(480, 545, 8)),
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


def check_flash_attention(dev, flush, h=16, hk=8, full=None):
    """The flash kernel against its plain version: the reference's own
    FLASH_CASES, a strided slab slice with a poisoned tail, and the two
    full-width shapes of the slab path (timed beside SDPA), at h query
    heads over hk kv heads of 128 (qwen3-1.7b's 16 / 8).  ``full``: only
    these slab cases (name, B, S, T, slab length; a name starting
    "strided" is not timed), without FLASH_CASES."""
    import torch.nn.functional as F
    from repro_torch.kernels import gqa_split
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    rng = np.random.default_rng(4)
    hd = 128

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
    for case in FLASH_CASES if full is None else ():
        B, S, T, h_, hk_, hd_, causal, window = case
        host = (normal(B, S, h_, hd_), normal(B, T, hk_, hd_),
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
    full = full or [
        # name, B, S, T (valid keys), slab length
        (f"prefill B={LEGACY_BATCH} S=T={LEGACY_PROMPT}", LEGACY_BATCH,
         LEGACY_PROMPT, LEGACY_PROMPT, LEGACY_PROMPT),
        (f"decode B={LEGACY_BATCH} S=1 T={LEGACY_PROMPT + NEW_TOKENS} (slab "
         "slice)", LEGACY_BATCH, 1, LEGACY_PROMPT + NEW_TOKENS,
         LEGACY_MAX_LEN),
        ("strided chunk B=3 S=7 T=300 (slab slice)", 3, 7, 300,
         LEGACY_MAX_LEN),
    ]
    for name, B, S, T, L, in full:
        host = (normal(B, S, h, hd), normal(B, L, hk, hd),
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
            n_bytes, ops = flash_bound(B, S, T, h, hk, hd, True, 0,
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


def check_flash_new_forms(dev, flush):
    """The flash kernel at the forms the encoder-decoder and the VLM give
    it: seamless's (64, 64) widths, 16 heads, bidirectional (its
    encoder, S = T = 1024) and non-causal cross-attention (a decode step,
    S 1 against 1024 frames; a prefill of 255 targets against 256);
    llava's slab prefill, (128, 128), 32 q / 8 kv heads, causal, S = T =
    2880 image rows + 128 tokens; and granite's lockstep slab forms, 48 q
    heads on one kv head (g = 48), phase 11's prefill (S = T = 512) and
    its last decode step (S 1 against 576 keys of the 592-row slab, the
    tail poisoned).  Each against its plain version, timed beside SDPA,
    with its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import gqa_split
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    rng = np.random.default_rng(25)
    cases = [
        # name, B, S, T, h, hk, hd, causal
        ("bidirectional B=8 S=T=1024 (64, 64) h=hk=16", 8, 1024, 1024, 16,
         16, 64, False),
        ("cross decode B=8 S=1 T=1024 (64, 64) h=hk=16", 8, 1, 1024, 16, 16,
         64, False),
        ("cross prefill B=8 S=255 T=256 (64, 64) h=hk=16", 8, 255, 256, 16,
         16, 64, False),
        ("llava prefill B=8 S=T=3008 (128, 128) h=32 hk=8", 8, 3008, 3008,
         32, 8, 128, True),
        (f"granite prefill B={LEGACY_BATCH} S=T={LEGACY_PROMPT} h=48 hk=1",
         LEGACY_BATCH, LEGACY_PROMPT, LEGACY_PROMPT, 48, 1, 128, True),
        (f"granite decode B={LEGACY_BATCH} S=1 T="
         f"{LEGACY_PROMPT + NEW_TOKENS} h=48 hk=1 (slab slice)", LEGACY_BATCH,
         1, LEGACY_PROMPT + NEW_TOKENS, 48, 1, 128, True),
    ]
    rows = []
    for name, B, S, T, h, hk, hd, causal in cases:
        # a slab slice: the keys are the first T rows of the engine's
        # LEGACY_MAX_LEN-row cache, whose unwritten tail holds POISON
        L = LEGACY_MAX_LEN if "slab slice" in name else T
        host = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for shape in ((B, S, h, hd), (B, L, hk, hd),
                                               (B, L, hk, hd))]
        for dtype in (torch.float32, torch.bfloat16):
            q, kc, vc = (x.to(dtype) for x in host)
            for t in (kc, vc):
                t[:, T:] = POISON
            k, v = kc[:, :T], vc[:, :T]
            got = flash_attention(q, k, v, causal=causal)
            want = flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                fail(f"flash_attention {name} {dtype}: max |err| {err}")
            if L > T:
                for t in (kc, vc):
                    t[:, T:] = 1e8
                if not torch.equal(flash_attention(q, k, v, causal=causal),
                                   got):
                    fail(f"flash_attention {name} {dtype}: the slab's tail "
                         "leaked")
            del got, want
            # SDPA's is_causal aligns top-left: exact at S == T, and a
            # decode step (S 1) sees every key without a mask
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa_causal = causal and S == T
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=sdpa_causal, enable_gqa=True)
            backend = sdpa_backend(qt, kt, vt, None, 0.0, sdpa_causal,
                                   enable_gqa=True)
            row = {"case": name, "dtype": str(dtype)[6:],
                   "splits": (gqa_split.plan(B * hk, h // hk * S, T)[1]
                              if dtype == torch.bfloat16 else 1),
                   "max_abs_err": err, "tol": tol,
                   "ms": time_ms(lambda: flash_attention(q, k, v,
                                                         causal=causal),
                                 flush),
                   "plain_ms": time_ms(lambda: flash_attention_ref(
                       q, k, v, causal=causal), flush, iters=5),
                   "library_ms": time_ms(sdpa, flush),
                   "sdpa_backend": backend}
            n_bytes, ops = flash_bound(B, S, T, h, hk, hd, causal, 0,
                                       q.element_size())
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dtype] * 1e3
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=n_bytes, ops=ops)
            rows.append(row)
            print(f"  flash_attention {name:48s} {row['dtype']:8s} splits "
                  f"{row['splits']}  err {err:.2e} (tol {tol:g})  kernel "
                  f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  sdpa "
                  f"{row['library_ms']:.4f} ms ({backend})  bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                  f"{n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
            del q, k, v, kc, vc, qt, kt, vt
            torch.cuda.empty_cache()
    return rows


def flash_bwd_bound(B, S, T, h, hk, hd, causal, el):
    """Bytes (q, k, v and the output gradient read once; dq, dk, dv
    written once) and operations of the attention backward: 10 hd per
    visible (query head row, key) pair -- the scores recomputed, then
    the four products dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q."""
    n_bytes = (4 * B * S * h * hd + 4 * B * T * hk * hd) * el
    _, fwd_ops = flash_bound(B, S, T, h, hk, hd, causal, 0, el)
    return n_bytes, fwd_ops // 4 * 10


def sdpa_bwd_ms(sdpa, qt, kt, vt, dot, flush):
    """SDPA's forward + backward through autograd, and its backward alone
    (the forward's graph built once and kept; ``torch.autograd.grad`` of it
    timed): the backward kernel's like-for-like yardstick."""
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    fwd_bwd = time_ms(lambda: torch.autograd.grad(sdpa(*leaves), leaves, dot),
                      flush)
    out = sdpa(*leaves)
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, dot,
                                              retain_graph=True), flush)
    return fwd_bwd, bwd


def split_bwd_kernels(dev, rows):
    """The bf16 backward's two kernels apart (``dq_bf16``, ``dkdv_bf16``:
    device ms a call, torch.profiler over three calls, warm L2) at each
    training form timed in phase 2 (``bwd_form`` in its row), on inputs
    drawn anew (the kernels' time depends on the shapes and the mask, not
    on the values)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import (_launch,
                                                     flash_attention_bwd)
    gen = torch.Generator(device=dev).manual_seed(0)
    for row in rows:
        B, S, h, hk, hd, hdv, causal = row["bwd_form"]
        q, k, v, dout = (torch.randn(shape, generator=gen, device=dev,
                                     dtype=torch.bfloat16)
                         for shape in ((B, S, h, hd), (B, S, hk, hd),
                                       (B, S, hk, hdv), (B, S, h, hdv)))
        out, lse = _launch(q, k, v, causal, 0, with_lse=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
            torch.cuda.synchronize()
        row["bwd_kernels_ms"] = {
            m.group(1): ev.device_time_total / ev.count / 1e3
            for ev in prof.key_averages()
            if (m := re.search(r"(dq_bf16|dkdv_bf16)<", ev.key))}
        split = row["bwd_kernels_ms"]
        print(f"  flash_attention_bwd {row['case']:44s} kernel "
              f"{row['bwd_ms']:.4f} ms: " + (
                  f"dq {split['dq_bf16']:.4f} + dk/dv "
                  f"{split['dkdv_bf16']:.4f} ms (torch.profiler)"
                  if len(split) == 2 else "not measured (torch.profiler saw "
                  "no kernel of the two)"))
        del q, k, v, dout, out, lse


def check_lse_and_bwd_repeat(name, q, k, v, dout, causal, window=0):
    """The forward's output bit for bit the same with and without the
    log-sum-exp at every block shape it is built for (``block_choices``),
    and two backward calls bit for bit equal.  Returns the launch's
    output and log-sum-exp at the plan's block shape."""
    from repro_torch.kernels.flash_attention import (
        _launch, block_choices, flash_attention_bwd)
    for block_q, block_kv in block_choices(q.dtype, k.shape[1]):
        plain = _launch(q, k, v, causal, window, block_q, block_kv)
        out, _ = _launch(q, k, v, causal, window, block_q, block_kv,
                         with_lse=True)
        if not torch.equal(out, plain):
            fail(f"flash_attention {name} {q.dtype}: the output changes "
                 f"when the log-sum-exp is written (blocks {block_q}, "
                 f"{block_kv})")
        del plain, out
    out, lse = _launch(q, k, v, causal, window, with_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                window=window)
    second = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                 window=window)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"flash_attention_bwd {name} {q.dtype}: two calls differ")
    return out, lse


LSE_TOL = 1e-4     # |lse - plain lse|: fp32 sums of a row's exponentials


def check_flash_bwd_cases(dev):
    """The backward kernel against ``flash_attention_bwd_tiled`` (the same
    algorithm and schedule) and the forward's log-sum-exp against
    ``flash_attention_lse_ref`` at the small forms ``BWD_FORMS`` (every
    width pair, group sizes 1 to 48, causal, windowed and non-causal with
    S != T), fp32 and bf16 (gradients as max |err| / max |grad| at
    ``BWD_TILED_TOL``)."""
    from repro_torch.kernels.flash_attention import (
        BWD_FORMS, BWD_TILED_TOL, _launch, flash_attention_bwd,
        flash_attention_bwd_tiled, flash_attention_lse_ref)
    rows = []
    for case in BWD_FORMS:
        B, S, T, h, hk, hd, hdv, causal, window = case
        rng = np.random.default_rng(sum(case))
        host = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for shape in ((B, S, h, hd), (B, T, hk, hd),
                                       (B, T, hk, hdv), (B, S, h, hdv))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (x.to(dev, dtype) for x in host)
            out, lse = _launch(q, k, v, causal, window, with_lse=True)
            lse_err = (lse - flash_attention_lse_ref(
                q, k, causal=causal, window=window)).abs().max().item()
            got = flash_attention_bwd(q, k, v, out, lse, dout,
                                      causal=causal, window=window)
            want = flash_attention_bwd_tiled(q, k, v, out, lse, dout,
                                             causal=causal, window=window)
            err = max(((a.float() - b.float()).abs().max()
                       / b.float().abs().max()).item()
                      for a, b in zip(got, want))
            if not err <= BWD_TILED_TOL[dtype] or not lse_err <= LSE_TOL:
                fail(f"flash_attention_bwd {case} {dtype}: max |err| / max "
                     f"|grad| {err:.2e} against the tiled version, lse "
                     f"|err| {lse_err:.2e}")
            rows.append({"case": f"bwd {case}", "dtype": str(dtype)[6:],
                         "grad_rel_err": err, "lse_err": lse_err})
            print(f"  flash_attention_bwd {str(case):44s} "
                  f"{str(dtype)[6:]:8s} vs tiled {err:.2e} (tol "
                  f"{BWD_TILED_TOL[dtype]:g}); lse {lse_err:.1e} (tol "
                  f"{LSE_TOL:g})")
    return rows


def check_flash_train(dev, flush, case=None, h=16, hk=8, hd=128,
                      causal=True, B=1, S=TRAIN_SEQ):
    """The flash kernel at a training shape (B 1, S = T = TRAIN_SEQ; by
    default qwen3's 16 q / 8 kv heads of 128, causal; seamless's
    encoder and decoder give it 16 / 16 heads of 64, non-causal and
    causal; phase 28's ranks B 2, S = T = 512, 8 / 4 heads of 128): the
    forward against the plain version, and the gradients of
    ``FlashAttention`` (the kernel's forward and its backward kernel)
    against autograd of the plain version; the forward bitwise with and
    without the log-sum-exp, two backward calls bitwise; times of the
    backward kernel, the plain backward, SDPA's forward and forward +
    backward, beside the bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
        flash_attention_ref)

    case = case or f"train B={B} S=T={S} causal"
    rng = np.random.default_rng(13)
    host = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((B, S, h, hd), (B, S, hk, hd), (B, S, hk, hd),
                          (B, S, h, hd))]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (x.to(dev, dtype) for x in host)
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=TOL[dtype],
                              rtol=TOL[dtype]):
            fail(f"flash_attention {case} {dtype}: max |err| {err}")
        del got, want
        # the Function's gradients against autograd of the plain version
        reset_launch_counts()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention(*leaves, causal=causal).backward(dout)
        counts = launch_counts()
        if counts.get("flash_attention", 0) != 1 or counts.get(
                "flash_attention_bwd", 0) != 1:
            fail("the autograd Function did not launch the forward and the "
                 f"backward kernel once each: {counts}")
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention_ref(*ref_leaves, causal=causal).backward(dout)
        grad_err = grad_abs = 0.0
        for name, a, b in zip("qkv", leaves, ref_leaves):
            diff = (a.grad.float() - b.grad.float()).abs().max()
            rel = (diff / b.grad.float().abs().max()).item()
            grad_err, grad_abs = max(grad_err, rel), max(grad_abs,
                                                         diff.item())
            if not rel <= TRAIN_GRAD_TOL[dtype]:
                fail(f"flash_attention {case} backward d{name} {dtype}: max "
                     f"|err| / max |grad| {rel:.2e} > "
                     f"{TRAIN_GRAD_TOL[dtype]:g}")
        del leaves, ref_leaves
        out, lse = check_lse_and_bwd_repeat(case, q, k, v, dout, causal)
        torch.cuda.synchronize()
        row = {"case": case, "dtype": str(dtype)[6:],
               "max_abs_err": err, "tol": TOL[dtype],
               "grad_rel_err": grad_err, "grad_max_abs_err": grad_abs,
               "grad_tol": TRAIN_GRAD_TOL[dtype]}
        print(f"  flash_attention {row['case']:44s} {row['dtype']:8s} err "
              f"{err:.2e} (tol {TOL[dtype]:g}); dq, dk, dv max |err| / "
              f"max |grad| {grad_err:.2e} (tol "
              f"{TRAIN_GRAD_TOL[dtype]:g}); forward bitwise with and "
              "without lse at every block shape, two backward calls "
              "bitwise")
        if dtype == torch.float32:
            rows.append(row)
            continue
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, dout))
        sdpa = lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=causal, enable_gqa=True)
        row["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=causal),
                            flush)
        row["plain_ms"] = time_ms(
            lambda: flash_attention_ref(q, k, v, causal=causal), flush)
        row["bwd_ms"] = time_ms(lambda: flash_attention_bwd(
            q, k, v, out, lse, dout, causal=causal), flush)
        row["bwd_plain_ms"] = time_ms(
            lambda: flash_attention_bwd_ref(q, k, v, dout, causal=causal),
            flush, iters=5)
        row["bwd_form"] = (B, S, h, hk, hd, hd, causal)
        row["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt), flush)
        row["library_fwd_bwd_ms"], row["library_bwd_ms"] = sdpa_bwd_ms(
            sdpa, qt, kt, vt, dot, flush)
        row["sdpa_backend"] = sdpa_backend(qt, kt, vt, None, 0.0, causal,
                                           enable_gqa=True)
        for key, (n_bytes, ops) in (
                ("", flash_bound(B, S, S, h, hk, hd, causal, 0, 2)),
                ("bwd_", flash_bwd_bound(B, S, S, h, hk, hd, causal, 2))):
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dtype] * 1e3
            row.update({f"{key}bound_ms": max(t_bytes, t_ops),
                        f"{key}bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        f"{key}bytes": n_bytes, f"{key}ops": ops})
        rows.append(row)
        print(f"  flash_attention {row['case']:44s} bfloat16 forward: kernel "
              f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  sdpa "
              f"{row['library_ms']:.4f} ms ({row['sdpa_backend']})  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); backward: kernel "
              f"{row['bwd_ms']:.4f} ms  plain "
              f"{row['bwd_plain_ms']:.4f} ms  sdpa backward "
              f"{row['library_bwd_ms']:.4f} ms (forward + backward "
              f"{row['library_fwd_bwd_ms']:.4f})  bound "
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


# --------------------------------------------------------------------------
# phase 2, the whole-sequence branches: MLA's widths in the flash
# kernel, and the gradients of the two scan kernels' autograd Functions
# --------------------------------------------------------------------------

def mla_flash_bound(B, S, T, h, dqk, dv, el, backward=False):
    """Bytes (q, k, v read once, out written once; the backward also
    reads the output gradient and writes dq, dk, dv) and operations of
    a causal call at q/k width dqk and v width dv, h = hk: 2 (dqk + dv)
    per visible (head row, key) pair forward; the backward recomputes
    the scores and runs four products, 2 (3 dqk + 2 dv)."""
    qkv = B * S * h * dqk + B * T * h * (dqk + dv)
    n_bytes = (2 * qkv + 2 * B * S * h * dv if backward
               else qkv + B * S * h * dv) * el
    vis = B * h * (S * (S + 1) // 2 + S * (T - S))
    return n_bytes, 2 * (3 * dqk + 2 * dv if backward else dqk + dv) * vis


def bound_of(n_bytes, ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def check_flash_mla(dev, flush):
    """The flash kernel at MLA's widths (DeepSeek-V3: q and k 192 = nope
    128 + rope 64, v 128, h = hk = 128), causal: the slab prefill (B 8,
    S = T = 512) and the training forward (B 1, S = T = 4096) against
    the plain version, fp32 and bf16, and at the training shape the
    gradients of ``FlashAttention`` (its forward and backward kernels)
    against autograd of the plain version (heads are independent at h =
    hk: the plain version runs 32 at a time, to bound its fp32 scores),
    the forward bitwise with and without the log-sum-exp and two
    backward calls bitwise.  bf16 times beside SDPA with E != Ev and the
    bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
        flash_attention_ref)

    h, dqk, dv, group = 128, 192, 128, 32
    rng = np.random.default_rng(23)
    rows = []
    for name, B, S in ((f"mla prefill B={LEGACY_BATCH} S=T={LEGACY_PROMPT}",
                        LEGACY_BATCH, LEGACY_PROMPT),
                       (f"mla train B=1 S=T={TRAIN_SEQ}", 1, TRAIN_SEQ)):
        train = B == 1
        host = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for shape in ((B, S, h, dqk), (B, S, h, dqk),
                                       (B, S, h, dv), (B, S, h, dv))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (x.to(dev, dtype) for x in host)
            got = flash_attention(q, k, v)
            err = 0.0
            for g in range(0, h, group):
                sl = slice(g, g + group)
                want = flash_attention_ref(q[:, :, sl], k[:, :, sl],
                                           v[:, :, sl])
                part = got[:, :, sl].float()
                err = max(err, (part - want.float()).abs().max().item())
                if not torch.allclose(part, want.float(), atol=TOL[dtype],
                                      rtol=TOL[dtype]):
                    fail(f"flash_attention {name} {dtype}: max |err| {err}")
                del want
            del got
            row = {"case": name, "dtype": str(dtype)[6:], "widths": [dqk, dv],
                   "max_abs_err": err, "tol": TOL[dtype]}
            msg = ""
            if train:
                reset_launch_counts()
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                flash_attention(*leaves).backward(dout)
                counts = launch_counts()
                if counts.get("flash_attention", 0) != 1 or counts.get(
                        "flash_attention_bwd", 0) != 1:
                    fail("the autograd Function did not launch the forward "
                         f"and backward kernels once each at MLA's widths: "
                         f"{counts}")
                ref_grads = [torch.empty_like(t) for t in (q, k, v)]
                for g in range(0, h, group):
                    sl = slice(g, g + group)
                    part = [t[:, :, sl].clone().requires_grad_()
                            for t in (q, k, v)]
                    flash_attention_ref(*part).backward(dout[:, :, sl])
                    for ref_grad, t in zip(ref_grads, part):
                        ref_grad[:, :, sl] = t.grad
                    del part
                gerr = gabs = 0.0
                for i, (leaf, ref_grad) in enumerate(zip(leaves, ref_grads)):
                    diff = (leaf.grad.float() - ref_grad.float()).abs().max()
                    rel = (diff / ref_grad.float().abs().max()).item()
                    gerr, gabs = max(gerr, rel), max(gabs, diff.item())
                    if not rel <= TRAIN_GRAD_TOL[dtype]:
                        fail(f"flash_attention {name} backward d{'qkv'[i]} "
                             f"{dtype}: max |err| / max |grad| {rel:.2e}")
                del leaves, ref_grads
                out, lse = check_lse_and_bwd_repeat(name, q, k, v, dout,
                                                    True)
                row.update(grad_rel_err=gerr, grad_max_abs_err=gabs,
                           grad_tol=TRAIN_GRAD_TOL[dtype])
                msg = (f"; dq, dk, dv max |err| / max |grad| {gerr:.2e} (tol "
                       f"{TRAIN_GRAD_TOL[dtype]:g}); forward bitwise with and "
                       "without lse, two backward calls bitwise")
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                                   for x in (q, k, v, dout))
                sdpa = lambda *a: F.scaled_dot_product_attention(
                    *a, is_causal=True)
                row["ms"] = time_ms(lambda: flash_attention(q, k, v), flush)
                row["plain_ms"] = time_ms(
                    lambda: flash_attention_ref(q, k, v), flush,
                    iters=5 if train else 20)
                row["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt), flush)
                row["sdpa_backend"] = sdpa_backend(qt, kt, vt, None, 0.0,
                                                   True)
                row.update(bound_of(*mla_flash_bound(B, S, S, h, dqk, dv, 2),
                                    dtype))
                msg += (f"  kernel {row['ms']:.4f} ms  plain "
                        f"{row['plain_ms']:.4f} ms  sdpa "
                        f"{row['library_ms']:.4f} ms ({row['sdpa_backend']})"
                        f"  bound {row['bound_ms']:.4f} ms "
                        f"({row['bound_by']}: {row['ops'] / 1e9:.1f} GFLOP)")
                if train:
                    row["bwd_ms"] = time_ms(lambda: flash_attention_bwd(
                        q, k, v, out, lse, dout), flush)
                    row["bwd_form"] = (B, S, h, h, dqk, dv, True)
                    row["bwd_plain_ms"] = time_ms(
                        lambda: flash_attention_bwd_ref(q, k, v, dout),
                        flush, iters=5)
                    row["library_fwd_bwd_ms"], row["library_bwd_ms"] = (
                        sdpa_bwd_ms(sdpa, qt, kt, vt, dot, flush))
                    b = bound_of(*mla_flash_bound(B, S, S, h, dqk, dv, 2,
                                                  backward=True), dtype)
                    row.update({f"bwd_{key}": val for key, val in b.items()})
                    msg += (f"; backward: kernel {row['bwd_ms']:.4f} ms  "
                            f"plain "
                            f"{row['bwd_plain_ms']:.4f} ms  sdpa backward "
                            f"{row['library_bwd_ms']:.4f} ms (forward + "
                            f"backward {row['library_fwd_bwd_ms']:.4f})  "
                            f"bound {row['bwd_bound_ms']:.4f} ms")
                del qt, kt, vt, dot
            rows.append(row)
            print(f"  flash_attention {name:30s} (192, 128) {row['dtype']:8s} "
                  f"err {err:.2e} (tol {TOL[dtype]:g}){msg}")
            del q, k, v, dout
            torch.cuda.empty_cache()
    return rows


def wkv_bwd_bound(B, T, H, K, el, chunk=32):
    """Bytes of the backward (r, k, v, dy read and dr, dk, dv written in
    the compute dtype; w_log, u, the state and its cotangent read and
    dw_log, du, dstate0 written in fp32) and the fp32 operations of the
    gradient of the chunked form on these inputs, a ragged last chunk
    counting its real steps: per chunk the state recurrence, (k e^(Ll -
    L)) G, S dy, G v and (r e^Lp)^T dy (each C K K multiply-adds), e^Ll
    S . G, dA = dy v^T and A^T dy over the lower triangle, A's, dr's and
    dk's decayed pair terms (4 an entry, as the forward's scores count)."""
    n = B * T * H * K
    n_bytes = (4 * n * el + n * 4 + H * K * 4 + 2 * B * H * K * K * 4
               + 3 * n * el + n * 4 + H * K * 4 + B * H * K * K * 4)
    C = min(chunk, T)
    ops = 0
    for t0 in range(0, T, C):
        c = min(C, T - t0)
        ops += (5 * 2 * c * K * K + 3 * K * K
                + 2 * 2 * K * c * (c + 1) // 2
                + 3 * 4 * K * c * (c - 1) // 2 + 6 * c * K)
    return n_bytes, B * H * ops


def mamba_bwd_bound(Bb, T, dI, dS, el):
    """Bytes of the backward (x, dt, B, C, dy read and dx, ddt, dB, dC
    written in the compute dtype; A, D, the state and its cotangent read
    and dA, dD, dstate0 written in fp32) and its fp32 operations: per
    (step, channel, state) the recurrence that gives h_{t-1} (4, its
    exponential included) and the reverse step (14: the decay's
    exponential, h_t, dC's and dB's products, g's two updates, the dx,
    ddt and dA terms); per (step, channel) 6."""
    n_bytes = (5 * Bb * T * dI * el + 4 * Bb * T * dS * el
               + 2 * (dI * dS + dI) * 4 + 3 * Bb * dI * dS * 4)
    return n_bytes, Bb * T * dI * (18 * dS + 6)


def check_scan_grads(dev, flush):
    """The gradients of ``WKV6`` and ``MambaScan`` (the kernel forward
    and the backward kernels, ``csrc/wkv6_bwd.cu`` and
    ``csrc/mamba_scan_bwd.cu``) at the training shapes -- rwkv6-1.6b's B
    1, T 4096, H 32, K 64 and Jamba's Bb 1, T 2048, dI 8192, dS 16 (B
    and C strided column slices of one projection) -- in fp32 and bf16:
    the Function's gradients against autograd of the plain chunked
    forms, with a cotangent on y and on the final state, at
    TRAIN_GRAD_TOL; the backward kernel against the plain backward
    (``wkv6_chunked_bwd``, ``mamba_chunked_bwd``) on the same
    cotangents at SCAN_BWD_TOL, with and without the state's cotangent,
    and in fp32 against the float64 gradient of the sequential recurrence
    (``wkv6_ref_bwd``, ``mamba_ref_bwd``) at the same bar, the plain
    backward's distance printed beside it; two backward calls bitwise
    equal.  bf16: times of the kernel forward,
    the plain forward, the backward kernel and the plain backward beside
    the bounds."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.mamba_scan import (mamba_chunked,
                                                mamba_chunked_bwd,
                                                mamba_ref_bwd, mamba_scan,
                                                mamba_scan_bwd)
    from repro_torch.kernels.wkv6 import (wkv6, wkv6_bwd, wkv6_chunked,
                                          wkv6_chunked_bwd, wkv6_ref_bwd)
    seq_bwd = {"wkv6": wkv6_ref_bwd, "mamba_scan": mamba_ref_bwd}

    rng = np.random.default_rng(29)
    B, T, H, K = 1, TRAIN_SEQ, 32, 64
    w_host = [torch.from_numpy(x) for x in wkv_case(rng, B, T, H, K, 0.0)]
    w_cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((B, T, H, K), (B, H, K, K))]
    Bb, Tm, dI, dS, R = 1, JAMBA_TRAIN_SEQ, 8192, 16, 256
    x, dt, A, proj, D, h0 = (torch.from_numpy(a) for a in
                             mamba_case(rng, Bb, Tm, dI, dS, R))
    m_cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((Bb, Tm, dI), (Bb, dI, dS))]
    scans = {
        "wkv6": (f"train B={B} T={T} H={H} K={K}", wkv6, wkv6_chunked,
                 wkv6_bwd, wkv6_chunked_bwd, lambda dtype: [
                     t.to(dev, dtype if i < 3 else torch.float32)
                     for i, t in enumerate(w_host)], w_cot,
                 lambda el: wkv_bound(B, T, H, K, el),
                 lambda el: wkv_bwd_bound(B, T, H, K, el)),
        "mamba_scan": (f"train Bb={Bb} T={Tm} dI={dI} dS={dS}", mamba_scan,
                       mamba_chunked, mamba_scan_bwd, mamba_chunked_bwd,
                       lambda dtype: [
                           x.to(dev, dtype), dt.to(dev, dtype), A.to(dev),
                           *(t.to(dev, dtype) for t in (
                               proj[..., R:R + dS], proj[..., R + dS:])),
                           D.to(dev), h0.to(dev)], m_cot,
                       lambda el: mamba_bound(Bb, Tm, dI, dS, el),
                       lambda el: mamba_bwd_bound(Bb, Tm, dI, dS, el)),
    }
    rows = {}
    for kname, (case, fn, plain, kbwd, bwd, inputs, cot, bound,
                bwd_bound) in scans.items():
        rows[kname] = []
        for dtype in (torch.float32, torch.bfloat16):
            args = inputs(dtype)
            ds = cot[1].to(dev)
            dy = cot[0].to(dev)
            reset_launch_counts()
            leaves = [a.clone().requires_grad_() for a in args]
            y, s = fn(*leaves)
            ((y.float() * dy).sum() + (s * ds).sum()).backward()
            counts = launch_counts()
            if counts.get(kname, 0) != 1 or counts.get(f"{kname}_bwd", 0) != 1:
                fail(f"{kname}: the autograd Function launched the forward "
                     f"{counts.get(kname, 0)} and the backward "
                     f"{counts.get(f'{kname}_bwd', 0)} times, not once each")
            ref_leaves = [a.clone().requires_grad_() for a in args]
            y_ref, s_ref = plain(*ref_leaves)
            ((y_ref.float() * dy).sum() + (s_ref * ds).sum()).backward()
            gerr = 0.0
            for i, (a, b) in enumerate(zip(leaves, ref_leaves)):
                rel = ((a.grad.float() - b.grad.float()).abs().max()
                       / b.grad.float().abs().max()).item()
                gerr = max(gerr, rel)
                if not rel <= TRAIN_GRAD_TOL[dtype]:
                    fail(f"{kname} backward, input {i}, {dtype}: max |err| / "
                         f"max |grad| {rel:.2e} > {TRAIN_GRAD_TOL[dtype]:g}")
            del leaves, ref_leaves, y, s, y_ref, s_ref
            # the backward kernel against the plain backward, the same
            # cotangents (dy in the compute dtype, as autograd passes it)
            dy = dy.to(dtype)
            kerr, kabs, f64 = 0.0, 0.0, {}
            for dstate in (ds, None):
                got = kbwd(*args, dy, dstate)
                again = kbwd(*args, dy, dstate)
                want = bwd(*args, dy, dstate)
                if dtype == torch.float32 and dstate is not None:
                    # the yardstick: the sequential recurrence's gradient
                    # in float64
                    exact = seq_bwd[kname](*(a.double() for a in args),
                                           dy.double(), ds.double())
                    f64 = {side: max(
                        ((a.double() - e).abs().max()
                         / e.abs().max()).item() for a, e in zip(grads, exact))
                        for side, grads in (("kernel", got), ("plain", want))}
                    del exact
                    if not f64["kernel"] <= SCAN_BWD_TOL[dtype]:
                        fail(f"{kname}_bwd {dtype}: max |err| / max |grad| "
                             f"{f64['kernel']:.2e} against the float64 "
                             f"gradient > {SCAN_BWD_TOL[dtype]:g}")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{kname}_bwd {dtype}: two calls on the same inputs "
                         "differ")
                for i, (a, b) in enumerate(zip(got, want)):
                    d = (a.float() - b.float()).abs().max().item()
                    rel = d / b.float().abs().max().item()
                    kerr, kabs = max(kerr, rel), max(kabs, d)
                    if not rel <= SCAN_BWD_TOL[dtype]:
                        fail(f"{kname}_bwd {dtype}, gradient {i}, dstate "
                             f"{'given' if dstate is not None else 'None'}: "
                             f"max |err| / max |grad| {rel:.2e} against the "
                             f"plain backward > {SCAN_BWD_TOL[dtype]:g}")
                del got, again, want
            torch.cuda.synchronize()
            row = {"case": case, "dtype": str(dtype)[6:],
                   "grad_rel_err": gerr, "grad_tol": TRAIN_GRAD_TOL[dtype],
                   "bwd_rel_err": kerr, "bwd_max_abs_err": kabs,
                   "bwd_tol": SCAN_BWD_TOL[dtype], "bwd_bitwise_repeat": True}
            if f64:
                row["bwd_f64_rel_err"] = f64["kernel"]
                row["plain_bwd_f64_rel_err"] = f64["plain"]
            if dtype == torch.bfloat16:
                row["ms"] = time_ms(lambda: fn(*args), flush)
                row["plain_ms"] = time_ms(lambda: plain(*args), flush,
                                          iters=5)
                row["bwd_ms"] = time_ms(lambda: kbwd(*args, dy, ds), flush)
                row["bwd_plain_ms"] = time_ms(
                    lambda: bwd(*args, dy, ds), flush, iters=5)
                row["library_ms"] = None
                row.update(bound_of(*bound(2), torch.float32))
                row.update({f"bwd_{k}": v for k, v in bound_of(
                    *bwd_bound(2), torch.float32).items()})
            rows[kname].append(row)
            timing = (f"  forward: kernel {row['ms']:.4f} ms  plain "
                      f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f}"
                      f" ms ({row['bound_by']}); backward: kernel "
                      f"{row['bwd_ms']:.4f} ms  plain {row['bwd_plain_ms']:.4f}"
                      f" ms  bound {row['bwd_bound_ms']:.4f} ms "
                      f"({row['bwd_bound_by']}, "
                      f"{row['bwd_bytes'] / 1e6:.1f} MB, "
                      f"{row['bwd_ops'] / 1e9:.2f} GFLOP)"
                      if "ms" in row else "")
            print(f"  {kname} {case:34s} {row['dtype']:8s} Function gradients "
                  f"max |err| / max |grad| {gerr:.2e} (tol "
                  f"{TRAIN_GRAD_TOL[dtype]:g}); backward kernel vs plain "
                  f"{kerr:.2e} (tol {SCAN_BWD_TOL[dtype]:g}), two calls "
                  f"bitwise" + (f"; vs float64: kernel {f64['kernel']:.2e} "
                                f"(tol {SCAN_BWD_TOL[dtype]:g}), plain "
                                f"{f64['plain']:.2e}" if f64 else "")
                  + timing)
            del args
            torch.cuda.empty_cache()
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


DECODE_TIMED_TICKS = 4


def decode_tick_model(cfg, model, prompts):
    """Phase 3, the cost model beside the card: the first SLOTS requests
    admitted (prefilled), then DECODE_TIMED_TICKS fused decode ticks of
    DECODE_CHUNK steps, timed on the host clock ending in a synchronize;
    beside ``perf_model.decode_step_time`` with the H100 presets (HBM3
    3.35 TB/s, bf16 989 TFLOP/s) for the bytes a step streams -- every
    weight but the gathered embedding, the fp32 unembedding included --
    and the slots' KV at their mean context.  Returns the numbers."""
    from repro_torch.core import perf_model as pm
    from repro_torch.serve import ContinuousScheduler
    sch = ContinuousScheduler(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                              page_size=PAGE_SIZE, decode_chunk=DECODE_CHUNK,
                              prefill_chunk=PREFILL_CHUNK)
    for p in prompts[:SLOTS]:
        sch.submit(p, NEW_TOKENS)
    sch._admit()
    sch._decode_tick()                                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_TIMED_TICKS):
        sch._decode_tick()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (DECODE_TIMED_TICKS * DECODE_CHUNK)
    # context mid-run: the prompt plus the warm-up and half the timed steps
    ctx = float(np.mean([len(p) for p in prompts[:SLOTS]])) + DECODE_CHUNK * (
        1 + DECODE_TIMED_TICKS / 2)
    param_bytes = sum(p.numel() * p.element_size()
                      for k, p in model.named_parameters() if k != "embed")
    n_active = cfg.param_count() - cfg.vocab_size * cfg.d_model
    kv = pm.kv_bytes_per_token(cfg) * ctx
    model_s = pm.decode_step_time(param_bytes, kv, batch=SLOTS,
                                  flops_per_token=2.0 * n_active,
                                  hbm_bw=pm.H100_HBM_BW,
                                  flops_rate=pm.H100_BF16_FLOPS)
    del sch
    out = {"measured_step_ms": step_s * 1e3, "model_step_ms": model_s * 1e3,
           "param_bytes": param_bytes, "kv_bytes_per_seq": kv,
           "mean_context": ctx}
    print(f"phase 3: a decode step measured {step_s * 1e3:.3f} ms (mean of "
          f"{DECODE_TIMED_TICKS} fused ticks of {DECODE_CHUNK} steps, "
          f"{SLOTS} slots at ~{ctx:.0f} tokens, host clock); perf_model."
          f"decode_step_time predicts {model_s * 1e3:.3f} ms (H100 presets: "
          f"{param_bytes / 1e9:.3f} GB of weights + {SLOTS} x "
          f"{kv / 1e6:.2f} MB of KV at 3.35 TB/s) -- a prediction, "
          f"{step_s / model_s:.1f}x below the measured step")
    return out


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
    layers (with its MTP head) in bf16 on the phase-3 traffic, then
    card-vs-CPU fp32 greedy parity at 2 full-width layers with 16 routed
    experts; phase 23 (i), speculative decode on both models.  Returns
    the paged_flash_decode_mla launches of the phase-9 run and phase 23's
    numbers."""
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
    del sch
    spec_out = spec_deepseek(dev, cfg, model, prompts)
    del model
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
    # phase 23 (i), fp32: the same model with its MTP head, spec decode on
    # the card against the CPU's plain decode
    kw = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE_SIZE,
              prefill_chunk=PREFILL_CHUNK, decode_chunk=DECODE_CHUNK)
    spec_out["fp32"] = {}
    for k in SPEC_KS[1:]:
        outs, st, _, _ = spec_serve(small, m_card, prompts10, 12, k, **kw)
        for a, b in zip(got["cpu"], outs):
            if not np.array_equal(a, b):
                fail(f"phase 23: fp32 spec_decode={k} tokens on the card "
                     f"differ from the CPU's plain decode: {b} vs {a}")
        spec_out["fp32"][k] = st["spec_decode"]["acceptance"]
    print(f"phase 23: 2-layer full-width DeepSeek-V3 fp32 with its MTP head "
          f"(routed experts cut as in phase 10): the card's k = "
          f"{' and '.join(str(k) for k in SPEC_KS[1:])} tokens equal the "
          f"CPU's k = 0 tokens for {len(prompts10)} requests x 12 "
          f"(acceptance {spec_out['fp32']})")
    del m_card, m_cpu, sch
    torch.cuda.empty_cache()
    return mla, spec_out


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
    # a spy on the plain backward: no CUDA tensor may reach it here
    fa_mod = sys.modules["repro_torch.kernels.flash_attention"]
    plain_bwd, plain_calls = fa_mod.flash_attention_bwd_ref, []

    def spy(q, *a, **kw):
        plain_calls.append(q.device.type)
        return plain_bwd(q, *a, **kw)

    fa_mod.flash_attention_bwd_ref = spy
    losses, walls = [], []
    try:
        for i in range(1 + TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))           # synchronises
            walls.append(time.perf_counter() - t0)
    finally:
        fa_mod.flash_attention_bwd_ref = plain_bwd
    if plain_calls:
        fail(f"phase 13: the plain flash backward ran {len(plain_calls)} "
             f"times on {sorted(set(plain_calls))} tensors")
    counts = launch_counts()
    launches = counts.get("flash_attention", 0)
    bwd_launches = check_bwd("phase 13", counts, (1 + TRAIN_TIMED)
                             * TRAIN_MICRO * cfg.num_layers)
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
           "step_walls_ms": [w * 1e3 for w in walls],
           "bwd_launches": bwd_launches, "plain_bwd_calls": len(plain_calls)}
    print(f"phase 13: {1 + TRAIN_TIMED} AdamW steps (lr {TRAIN_LR:g}) on one "
          f"batch of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} "
          f"microbatches, remat per layer: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; flash_attention "
          f"launches {launches} = {1 + TRAIN_TIMED} x {TRAIN_MICRO} x "
          f"{cfg.num_layers} x 2 (forward + recompute), flash_attention_bwd "
          f"{bwd_launches} = {1 + TRAIN_TIMED} x {TRAIN_MICRO} x "
          f"{cfg.num_layers}; the plain backward ran 0 times")
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
    check_bwd("phase 14", launch_counts(), 3 * 2)
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

def start_ranks(args, n, module=True):
    """Start ``python -m torch.distributed.run --standalone
    --nproc-per-node n`` of ``args`` (a module and its flags, or with
    ``module=False`` a script and its flags) in its own session, its
    output to a file; ``finish_ranks`` waits for it."""
    import tempfile
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), *(["-m"] if module else []), *args]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    log = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    atexit.register(stop_ranks, proc)    # a failed check exits early
    return proc, log, time.perf_counter(), args, n


def stop_ranks(proc):
    """Kill a ``start_ranks`` launch with every rank it started, if it is
    still running."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish_ranks(started, timeout=300):
    """Wait for a ``start_ranks`` launch, killed with every rank it started
    if it outlasts ``timeout`` seconds from its start.  Fails the run if it
    fails; returns its wall seconds."""
    proc, log, t0, args, n = started
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_ranks(proc)
        fail(f"{' '.join(args)} over {n} ranks outlasted {timeout} s")
    wall = time.perf_counter() - t0
    log.seek(0)
    out = log.read()
    log.close()
    if proc.returncode:
        print(out[-6000:])
        fail(f"{' '.join(args)} over {n} ranks exited {proc.returncode}")
    for line in out.splitlines():
        if line.startswith(("trainer:", "epoch", "mesh:", "phase 18")):
            print(f"    {line}")
    return wall


def run_ranks(args, n, timeout=300, module=True):
    """``start_ranks`` of ``args`` over ``n`` ranks, then
    ``finish_ranks``: returns the wall seconds."""
    return finish_ranks(start_ranks(args, n, module), timeout)


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

    # the four MNIST-DNN launches run side by side, beside the card-vs-CPU
    # checks below (each picks its own free rendezvous port)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="dp_", dir=os.path.join(ROOT, "build"))
    data = ["--samples", str(PAPER_SAMPLES), "--epochs", "1"]
    common = [*data, "--steps", str(PAPER_STEPS), "--backend", "gloo"]
    launcher = "repro_torch.launch.mnist_dnn_dp"
    started = {strategy: start_ranks(
        [launcher, *common, "--strategy", strategy, "--dump",
         os.path.join(root, strategy)], 2) for strategy in ("flat", "bucketed")}
    started["weights"] = start_ranks(
        [launcher, *data, "--steps", "4", "--backend", "gloo", "--sync",
         "weights", "--sync-period", "2", "--dump",
         os.path.join(root, "weights")], 2)
    started["hier"] = start_ranks(
        [launcher, *common, "--strategy", "hierarchical", "--pods", "2",
         "--dump", os.path.join(root, "hier")], 4)

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

    seq = os.path.join(root, "seq")
    mnist_dnn_dp.main([*data, "--steps", str(PAPER_STEPS), "--sequential",
                       "--device", "cuda", "--dump", seq])
    want = load_dump(seq, PAPER_STEPS, 0)
    for strategy in ("flat", "bucketed"):
        d = os.path.join(root, strategy)
        wall = finish_ranks(started[strategy])
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
    finish_ranks(started["weights"])
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
    wall = finish_ranks(started["hier"])
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
        bwd = check_bwd(f"phase 16 ({strategy})", launch_counts(),
                        DP_STEPS * TRAIN_MICRO * cfg.num_layers)
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
        out[strategy] = {"launches": launches, "bwd_launches": bwd,
                         "losses": losses,
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
        out[strategy]["comm_time_s"] = desc["comm_time_s"]
        if strategy == "flat":
            out[strategy]["predicted_ms"] = comm_predictions(
                4.0 * desc["params"], desc["comm_time_s"], sync)
        del trainer
    # phase 17 on a CKPT_LAYERS-deep bucketed trainer after DP_STEPS steps
    torch.cuda.empty_cache()
    ckpt_cfg = cfg.with_overrides(num_layers=CKPT_LAYERS)

    def create_ckpt():
        return Trainer.create(
            ckpt_cfg, optimizer="adamw", lr=TRAIN_LR,
            dp=DPConfig(strategy="bucketed", microbatches=TRAIN_MICRO),
            mesh=mesh, train_cfg=TrainConfig(remat=True), seed=0,
            device=dev)

    trainer = create_ckpt()
    for _ in range(DP_STEPS):
        trainer.step(batch)
    ckpt_out = checkpoint_qwen(
        dev, trainer, create_ckpt, ckpt_cfg, batch, prompts,
        serve_launches // cfg.num_layers * CKPT_LAYERS)
    del trainer
    zero_out = {"nccl": zero_qwen(dev, cfg, batch, mesh,
                                  out["flat"]["losses"])}
    zero_out["gloo"] = zero_gloo(dev, cfg, batch, mesh, prompts,
                                 serve_launches // cfg.num_layers)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out, ckpt_out, zero_out


def comm_predictions(v_bytes, comm_time_s, sync_ms):
    """Phase 16, the cost model: ``allreduce_comm_time`` of a step's fp32
    gradients on NVLink 4 at p = 2, 4 and 8 -- predictions, since one
    card measures no wire -- beside the one-rank grad_sync."""
    from repro_torch.core import perf_model as pm
    pred = {p: pm.allreduce_comm_time(v_bytes, p=p, fabric=pm.H100_NVLINK4)
            * 1e3 for p in (1, 2, 4, 8)}
    print(f"phase 16 (flat): perf_model.allreduce_comm_time of "
          f"{v_bytes / 1e9:.3f} GB of fp32 gradients over NVLink 4 (450 GB/s "
          f"a direction, NVIDIA's H100 SXM datasheet; latency assumed "
          f"{pm.H100_NVLINK4.alpha * 1e6:g} us) -- predictions, no "
          f"cross-card number can be measured here: p = 2 {pred[2]:.2f} ms, "
          f"p = 4 {pred[4]:.2f} ms, p = 8 {pred[8]:.2f} ms; the model gives "
          f"{pred[1]:g} at p = 1, where the measured one-rank grad_sync "
          f"{', '.join(f'{m:.2f}' for m in sync_ms)} ms is the collective's "
          f"own overhead; Trainer.describe()['comm_time_s'] = "
          f"{comm_time_s!r} (p = 1, the reference's fabric)")
    return pred


# --------------------------------------------------------------------------
# phase 18: the ZeRO ladder
# --------------------------------------------------------------------------

def _steps(trainer, batch, n, dev):
    """``n`` steps: losses, walls (s), the memory allocated after each
    (bytes, the card synchronised), flash launches a step (each step's
    flash_attention_bwd launches checked: half its forwards, under
    remat), and the SyncTimer spans by label."""
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
        # every caller's trainer rematerialises its layers
        check_bwd("a ZeRO step", launch_counts(), flash[-1] // 2)
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
    restores the ranks' zero3 checkpoint, takes the step after it and
    serves."""
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
        loss_next = float(trainer.step(batch)["loss"])
        eng = trainer.serve(**SERVE_KW)
        reset_launch_counts()
        toks = eng.generate(prompts, NEW_TOKENS)
        paged = launch_counts().get("paged_flash_decode", 0)
        del eng, trainer
    finally:
        shutil.rmtree(ZERO_DIR, ignore_errors=True)
    z3 = ranks["zero3"]
    if at != ZERO_GLOO_STEPS or abs(loss_next - z3["loss_next"]) > \
            ZERO_LOSS_TOL:
        fail(f"phase 18b: the bucketed trainer restored step {at}, its next "
             f"step gave loss {loss_next!r}, zero3's own "
             f"{z3['loss_next']!r}")
    want = ZERO_LAYERS * model_calls
    if paged != want or z3["paged_launches"] != want:
        fail(f"phase 18b: paged_flash_decode launched {paged} (restored "
             f"trainer) and {z3['paged_launches']} (zero3 ranks) times, "
             f"expected {ZERO_LAYERS} x {model_calls} model calls")
    if len(toks) != len(rank_tokens) or any(
            not np.array_equal(a, b) for a, b in zip(toks, rank_tokens)):
        fail("phase 18b: Trainer.serve() of the zero3 ranks and of the "
             "restored bucketed trainer gave different greedy tokens")
    ranks["restored"] = {"step": at, "loss_next": loss_next,
                         "restore_s": restore_s,
                         "paged_launches": paged}
    ranks["torchrun_wall_s"] = wall
    print(f"phase 18b: the zero3 checkpoint (2 ranks) restored into a "
          f"one-rank bucketed trainer in {restore_s:.1f} s; its step "
          f"{at + 1} gave {loss_next!r}, zero3's own {z3['loss_next']!r}; "
          f"Trainer.serve() of both "
          f"gave equal greedy tokens for {len(prompts)} requests x "
          f"{NEW_TOKENS}, paged_flash_decode launches {paged} and "
          f"{z3['paged_launches']}; torchrun {wall:.1f} s")
    print(f"phase 18b: {json.dumps(ranks)}")
    gc.collect()
    torch.cuda.empty_cache()
    return ranks


# --------------------------------------------------------------------------
# phases 19-21: the whole-sequence branches of the other architectures
# --------------------------------------------------------------------------

def _cut_moe(cfg, experts):
    """``cfg`` with its routed experts cut to ``experts`` (a card-vs-CPU
    parity run only: fp32 experts are 45 GB a DeepSeek-V3 layer, 11.3 GB
    a Jamba one, in host memory)."""
    import dataclasses
    return cfg.with_overrides(moe=dataclasses.replace(
        cfg.moe, num_experts=experts,
        first_dense_layers=min(cfg.moe.first_dense_layers, 1)))


def _slab_parity(dev, name, small, prompts, new, cut=""):
    """Card vs CPU fp32 greedy tokens through ``ServeEngine``: weights
    drawn on the card, copied to the CPU.  Returns the card run's
    launches."""
    import copy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine

    m_card = init_model(small, seed=1, device=dev)
    m_cpu = copy.deepcopy(m_card.cpu())
    m_card.to(dev)
    got = {}
    for where, m in (("cpu", m_cpu), ("cuda", m_card)):
        reset_launch_counts()
        t0 = time.perf_counter()
        got[where] = ServeEngine(small, m, batch_size=len(prompts),
                                 max_len=prompts.shape[1] + new).generate(
                                     prompts, new).cpu().numpy()
        print(f"  {where}: {time.perf_counter() - t0:.1f} s")
    counts = launch_counts()
    if not np.array_equal(got["cpu"], got["cuda"]):
        fail(f"phase 19 ({name}): lockstep fp32 greedy tokens differ card vs "
             f"CPU: {got['cpu']} vs {got['cuda']}")
    print(f"phase 19: 2-layer full-width {name} fp32 {small.layer_pattern()}"
          f"{cut}: greedy tokens through the lockstep engine equal on card "
          f"and CPU for {len(prompts)} requests x {new} tokens; card launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    del m_card, m_cpu
    torch.cuda.empty_cache()
    return counts


def serve_slab_archs(dev):
    """Phase 19: rwkv6-1.6b (nothing cut), jamba-v0.1-52b and
    deepseek-v3-671b (their one-card cuts) in bf16 through the lockstep
    slab engine on phase 11's traffic, every whole-prompt scan and every
    flash call launched through its kernel; then card-vs-CPU fp32 greedy
    parity of each at 2 full-width layers.  Returns each model's
    launches and numbers."""
    from repro_torch.configs import one_card_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine

    out = {}
    for arch in ("rwkv6-1.6b", "jamba-v0.1-52b", "deepseek-v3-671b"):
        cfg = one_card_config(arch)
        kinds = [m for m, _ in cfg.layer_pattern()]
        want = {"wkv6": kinds.count("rwkv6"),
                "mamba_scan": kinds.count("mamba"),
                # MLA's slab decode is plain ops: its prefill only
                "flash_attention": kinds.count("attn") * (
                    1 if cfg.attention == "mla" else NEW_TOKENS)}
        prompts = synthetic_tokens(np.random.default_rng(0), LEGACY_BATCH,
                                   LEGACY_PROMPT, cfg.vocab_size)
        t0 = time.perf_counter()
        model = init_model(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        ServeEngine(cfg, model, batch_size=LEGACY_BATCH,
                    max_len=LEGACY_MAX_LEN).generate(prompts[:2, :64], 4)
        torch.cuda.synchronize()
        eng = ServeEngine(cfg, model, batch_size=LEGACY_BATCH,
                          max_len=LEGACY_MAX_LEN)
        resident_gib = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        eng.generate(prompts, 1).cpu()                 # the batch's TTFT
        ttft = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        dispatches0, syncs0 = eng.dispatches, eng.host_syncs
        reset_launch_counts()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        toks = toks.cpu().numpy()
        got = {k: counts.get(k, 0) for k in want}
        if got != want:
            fail(f"phase 19 ({arch}): launches {got}, expected {want}")
        for other in ("paged_flash_decode", "paged_flash_decode_mla"):
            if counts.get(other, 0):
                fail(f"phase 19 ({arch}): {other} launched on the slab path")
        if toks.shape != (LEGACY_BATCH, NEW_TOKENS) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            fail(f"phase 19 ({arch}): outputs of shape {toks.shape} or "
                 "out-of-vocab tokens")
        for i, layer in enumerate(eng.cache):
            if not all(torch.isfinite(t).all() for t in layer.values()):
                fail(f"phase 19 ({arch}): layer {i}'s slab cache is not "
                     "finite")
        n_tok = toks.size
        res = {"layers": cfg.num_layers, "init_s": init_s,
               "prefill_wall_ms": ttft * 1e3, "tokens_per_s": n_tok / wall,
               "wall_s": wall, "host_syncs_per_token":
                   (eng.host_syncs - syncs0) / n_tok,
               "dispatches": eng.dispatches - dispatches0,
               "resident_gib": resident_gib,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": got}
        out[arch] = res
        print(f"phase 19: {arch} ({cfg.num_layers} layers, full width, bf16, "
              f"initialised in {init_s:.1f} s), {LEGACY_BATCH} requests x "
              f"{LEGACY_PROMPT} prompt tokens x {NEW_TOKENS} new through "
              f"ServeEngine: prefill wall (the batch's TTFT) "
              f"{ttft * 1e3:.1f} ms, {n_tok / wall:.1f} tokens/s, "
              f"{res['host_syncs_per_token']:.4f} host syncs/token "
              f"({res['dispatches']} dispatches), resident "
              f"{resident_gib:.2f} GiB, peak {res['peak_gib']:.2f} GiB; "
              f"launches {got}")
        del model, eng
        torch.cuda.empty_cache()

        small = cfg.with_overrides(num_layers=2, dtype="float32")
        cut = ""
        if arch == "jamba-v0.1-52b":       # phase 8's (mamba, attention)
            small = small.with_overrides(attn_layer_period=2,
                                         attn_layer_offset=1)
        if arch == "deepseek-v3-671b":
            small = _cut_moe(small, 16)
            cut = (f", reduced: routed experts {cfg.moe.num_experts} -> 16 "
                   "(this check only)")
        counts = _slab_parity(dev, arch, small, prompts[:2, :64], 8, cut)
        kinds = [m for m, _ in small.layer_pattern()]
        if counts.get("wkv6", 0) != kinds.count("rwkv6") or \
                counts.get("mamba_scan", 0) != kinds.count("mamba") or \
                counts.get("flash_attention", 0) != kinds.count("attn") * (
                    1 if small.attention == "mla" else 8):
            fail(f"phase 19 ({arch}): the fp32 card run did not launch "
                 "every kernel of its path")
        res["parity_launches"] = {k: v for k, v in counts.items() if v}
    return out


def _train_run(dev, cfg, tc, batch, steps, tag):
    """1 + ``steps`` steps of ``cfg`` from seed 0 on one batch, bf16
    compute on fp32 masters: the launches (exactly one forward and one
    remat recompute a layer a microbatch of each layer's kernel), losses,
    walls, peak."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import init_train_state, make_train_step, trainable

    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, seed=0, device=dev)
    step, _ = make_train_step(cfg, tc)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainable(state.params).values())
    print(f"{tag}: {cfg.name} {cfg.layer_pattern()} ({n_params / 1e9:.3f} B "
          f"{tc.param_dtype} masters, bf16 compute, {tc.optimizer}) "
          f"initialised in "
          f"{time.perf_counter() - t0:.1f} s, resident "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # an MTP head's block runs its attention once a microbatch (the head
    # is not rematted)
    kinds = [m for m, _ in cfg.layer_pattern()] + ["mtp"] * cfg.mtp_depth
    launches_want = {
        kernel: (1 + steps) * tc.microbatches * (
            kinds.count(kind) * 2 + (kinds.count("mtp") if kind == "attn"
                                     else 0))
        for kernel, kind in (("wkv6", "rwkv6"), ("mamba_scan", "mamba"),
                             ("flash_attention", "attn"))}
    # one backward a layer a microbatch, the head's included
    launches_want["flash_attention_bwd"] = (1 + steps) * tc.microbatches * (
        kinds.count("attn") + kinds.count("mtp"))
    for kernel, kind in (("wkv6_bwd", "rwkv6"), ("mamba_scan_bwd", "mamba")):
        launches_want[kernel] = (1 + steps) * tc.microbatches * kinds.count(
            kind)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, walls = [], []
    mtp_ce = []
    for _ in range(1 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))           # synchronises
        walls.append(time.perf_counter() - t0)
        if "mtp_ce" in metrics:
            mtp_ce.append(float(metrics["mtp_ce"]))
    counts = launch_counts()
    got = {k: counts.get(k, 0) for k in launches_want}
    if got != launches_want:
        fail(f"{tag} ({cfg.name}): launches {got}, expected {launches_want}")
    for other in ("paged_flash_decode", "paged_flash_decode_mla"):
        if counts.get(other, 0):
            fail(f"{tag}: {other} launched on the training path")
    if not all(np.isfinite(losses)):
        fail(f"{tag} ({cfg.name}): losses {losses} are not finite")
    wall = float(np.median(walls[1:]))
    tokens = int(np.prod(batch["tokens"].shape))
    res = {"params": n_params, "optimizer": tc.optimizer,
           "step_ms": wall * 1e3, "tokens_per_s": tokens / wall,
           "mfu": 6 * n_params * tokens / wall / PEAK_OPS[torch.bfloat16],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "losses": losses, "step_walls_ms": [w * 1e3 for w in walls],
           "launches": got}
    if mtp_ce:
        res["mtp_ce"] = mtp_ce
    print(f"{tag}: {1 + steps} steps on {tuple(batch['tokens'].shape)} "
          f"tokens ({tc.microbatches} microbatches, remat per layer): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step wall median "
          f"{res['step_ms']:.1f} ms (first {walls[0] * 1e3:.1f} ms), "
          f"{res['tokens_per_s']:.1f} tokens/s, mfu {res['mfu']:.4f}, peak "
          f"{res['peak_gib']:.2f} GiB; launches {got}"
          + (f"; mtp_ce {', '.join(f'{x:.4f}' for x in mtp_ce)}"
             if mtp_ce else ""))
    if res["peak_gib"] * 2**30 >= 80e9:
        fail(f"{tag} ({cfg.name}): peak {res['peak_gib']:.2f} GiB does not "
             "fit the card")
    del state, step
    torch.cuda.empty_cache()
    return res


def _train_parity(dev, tag, small, tc, batch, cut="", steps=3):
    """Card vs CPU fp32: ``steps`` steps from the same masters (drawn on
    the card, copied to the CPU).  Step 1's loss to TRAIN_LOSS_RTOL_FIRST,
    the later ones to TRAIN_LOSS_RTOL_LATER (phase 14's bars).  Under
    AdamW each param to 2 x steps x lr: a step moves an entry by at most
    lr (|m_hat| / sqrt(v_hat) <= 1 for the first steps at beta1^2 <
    beta2), so two runs from equal masters lie at most that far apart,
    and an entry
    whose gradient is within the two devices' rounding of zero can use
    all of it (rwkv6's ln_x magnifies such rounding, PERF.md §6)."""
    import copy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model
    from repro_torch.train import make_train_step, start_state, trainable

    m_card = init_model(small, seed=1, device=dev, train=True)
    m_cpu = copy.deepcopy(m_card.cpu())
    m_card.to(dev)
    got = {}
    for where, model in (("cpu", m_cpu), ("cuda", m_card)):
        step, opt = make_train_step(small, tc)
        state = start_state(model, opt)
        reset_launch_counts()
        t0 = time.perf_counter()
        losses = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        got[where] = (losses, {k: p.detach().cpu() for k, p in
                               trainable(model).items()})
        print(f"  {where}: {steps} steps in {time.perf_counter() - t0:.1f} s, "
              f"losses {losses}")
        del state, step
    counts = {k: v for k, v in launch_counts().items() if v}
    kinds = [m for m, _ in small.layer_pattern()]
    for kernel, kind in (("wkv6", "rwkv6"), ("mamba_scan", "mamba"),
                         ("flash_attention", "attn")):
        head = small.mtp_depth if kind == "attn" else 0    # not rematted
        calls = kinds.count(kind)
        if kind == "attn" and small.is_encoder_decoder:
            # each decoder layer attends twice (self, cross), and each
            # encoder layer once
            calls = 2 * calls + small.encoder_layers
        if counts.get(kernel, 0) != steps * tc.microbatches * (
                calls * (2 if tc.remat else 1) + head):
            fail(f"{tag}: the card run launched {kernel} "
                 f"{counts.get(kernel, 0)} times, not in every {kind} layer")
        if kind == "attn":
            check_bwd(tag, counts, steps * tc.microbatches * (calls + head))
        elif counts.get(f"{kernel}_bwd", 0) != steps * tc.microbatches * calls:
            fail(f"{tag}: the card run launched {kernel}_bwd "
                 f"{counts.get(f'{kernel}_bwd', 0)} times, not once a {kind} "
                 "layer's backward")
    (cpu_l, cpu_p), (card_l, card_p) = got["cpu"], got["cuda"]
    rel = [abs(a - b) / abs(a) for a, b in zip(cpu_l, card_l)]
    gap = max((cpu_p[k] - card_p[k]).abs().max().item() for k in cpu_p)
    lr = tc.lr
    if not rel[0] <= TRAIN_LOSS_RTOL_FIRST or \
            not max(rel[1:]) <= TRAIN_LOSS_RTOL_LATER:
        fail(f"{tag}: card vs CPU losses differ by {rel} relative")
    if tc.optimizer != "sgd" and not gap <= 2 * steps * lr:
        fail(f"{tag}: a param differs card vs CPU by {gap:.2e} > "
             f"{2 * steps} lr")
    shape = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    print(f"{tag}: 2-layer full-width {small.name} fp32 "
          f"{small.layer_pattern()}{cut}, {steps} {tc.optimizer} steps (lr "
          f"{lr:g}) on {shape}, card vs CPU: "
          f"step-1 loss {rel[0]:.2e} relative (tol "
          f"{TRAIN_LOSS_RTOL_FIRST:g}), steps 2-{steps} {max(rel[1:]):.2e} "
          f"(tol "
          f"{TRAIN_LOSS_RTOL_LATER:g}), largest param gap {gap:.2e}; card "
          f"launches {json.dumps(counts)}")
    del m_card, m_cpu, got
    torch.cuda.empty_cache()
    return {"loss_rel": rel, "param_gap": gap, "launches": counts}


@contextlib.contextmanager
def spy_plain_scan_bwds(calls):
    """Record the device of every call of the scans' plain backwards (the
    chunk-recomputing ``wkv6_chunked_bwd`` / ``mamba_chunked_bwd`` and the
    tiled versions) into ``calls`` while the block runs."""
    mods = [sys.modules[f"repro_torch.kernels.{m}"]
            for m in ("wkv6", "mamba_scan")]
    names = {mods[0]: ("wkv6_chunked_bwd", "wkv6_bwd_tiled"),
             mods[1]: ("mamba_chunked_bwd", "mamba_bwd_tiled")}
    saved = [(mod, name, getattr(mod, name)) for mod in mods
             for name in names[mod]]

    def spy(name, fn):
        def wrapped(first, *a, **kw):
            calls.append((name, first.device.type))
            return fn(first, *a, **kw)
        return wrapped
    for mod, name, fn in saved:
        setattr(mod, name, spy(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_archs(dev):
    """Phases 20 and 21: full-width training of rwkv6-1.6b (full depth,
    AdamW, phase 13's batch), Jamba cut to 2 layers (SGD, 1 x 2048
    tokens) and DeepSeek-V3 cut to 1 layer (MLA + dense MLP, with its MTP
    head; AdamW, phase 13's batch), each with its exact launches (the
    scans' backward kernels included); then card-vs-CPU fp32 parity at 2
    layers (DeepSeek's with the head).  A spy sees the scans' plain
    backwards run on no CUDA tensor.  Returns the numbers and the plain
    backwards' calls on CUDA tensors (0)."""
    calls = []
    with spy_plain_scan_bwds(calls):
        out = _train_archs(dev)
    on_card = [name for name, where in calls if where == "cuda"]
    if on_card:
        fail(f"phases 20-21: a plain scan backward ran {len(on_card)} times "
             f"on CUDA tensors ({sorted(set(on_card))})")
    print(f"phases 20-21: the scans' plain backwards ran 0 times on CUDA "
          f"tensors ({len(calls)} calls in all)")
    return out, len(on_card)


def _train_archs(dev):
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.train import TrainConfig

    out = {}
    adamw = TrainConfig(optimizer="adamw", lr=TRAIN_LR,
                        microbatches=TRAIN_MICRO, remat=True)
    cfg = get_config("rwkv6-1.6b")
    batch = make_batch(cfg, np.random.default_rng(0), TRAIN_BATCH, TRAIN_SEQ)
    out["rwkv6-1.6b"] = _train_run(dev, cfg, adamw, batch, TRAIN_TIMED,
                                   "phase 20")
    small = cfg.with_overrides(num_layers=2, dtype="float32")
    out["rwkv6-1.6b"]["parity"] = _train_parity(
        dev, "phase 20", small, TrainConfig(optimizer="adamw", lr=TRAIN_LR),
        make_batch(small, np.random.default_rng(14), 2, 256),
        steps=ARCH_PARITY_STEPS)

    sgd = TrainConfig(optimizer="sgd", lr=1e-2, remat=True)
    full = get_config("jamba-v0.1-52b")
    cfg = full.with_overrides(num_layers=2)
    batch = make_batch(cfg, np.random.default_rng(0), 1, JAMBA_TRAIN_SEQ)
    res = _train_run(dev, cfg, sgd, batch, ARCH_TRAIN_STEPS, "phase 21")
    res["reduced"] = f"num_layers {full.num_layers} -> 2"
    out["jamba-v0.1-52b"] = res
    small = _cut_moe(cfg.with_overrides(
        dtype="float32", attn_layer_period=2, attn_layer_offset=1), 4)
    res["parity"] = _train_parity(
        dev, "phase 21", small, sgd,
        make_batch(small, np.random.default_rng(21), 1, 128),
        f", reduced: routed experts {full.moe.num_experts} -> 4 (this check "
        "only)", steps=ARCH_PARITY_STEPS)

    full = get_config("deepseek-v3-671b")
    cfg = full.with_overrides(num_layers=1)
    batch = make_batch(cfg, np.random.default_rng(0), TRAIN_BATCH, TRAIN_SEQ)
    res = _train_run(dev, cfg, adamw, batch, ARCH_TRAIN_STEPS, "phase 21")
    res["reduced"] = f"num_layers {full.num_layers} -> 1"
    out["deepseek-v3-671b"] = res
    small = _cut_moe(full.with_overrides(num_layers=2, dtype="float32"), 16)
    res["parity"] = _train_parity(
        dev, "phase 21", small, sgd,
        make_batch(small, np.random.default_rng(21), 1, 128),
        f", reduced: routed experts {full.moe.num_experts} -> 16 (this "
        "check only)", steps=ARCH_PARITY_STEPS)
    return out


def zero_rank(outdir):
    """One of phase 18b's gloo ranks (run by torchrun): full-width qwen3
    at depth ZERO_LAYERS under flat, zero1, zero2 and zero3, ZERO_GLOO_STEPS steps
    each on this rank's 1 x 4096 tokens of phase 13's batch; zero3
    saves, steps and serves.  Rank 0 writes the numbers."""
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
                                                      ZERO_GLOO_STEPS, dev)
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
            r["loss_next"] = float(trainer.step(batch)["loss"])
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
              f"1 x {TRAIN_SEQ} tokens a rank, {ZERO_GLOO_STEPS} AdamW steps:",
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
        check_bwd("phase 17 (step 4)", launch_counts(),
                  TRAIN_MICRO * cfg.num_layers)
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
        check_bwd("phase 17 (restored step 4)", launch_counts(),
                  TRAIN_MICRO * cfg.num_layers)
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
    print(f"phase 17: {cfg.name} full width, reduced: num_layers 28 -> "
          f"{cfg.num_layers}, step {at} saved "
          f"asynchronously ({rec['bytes'] / 1e9:.3f} GB of fp32 masters, m "
          f"and v) while step 4 ran (loss {loss4!r}); restored masters, m "
          f"and v == the host copy taken at the save, bit for bit; the "
          f"step after the restore gave {loss4!r} bit for bit; "
          f"Trainer.serve() == make_engine_from_checkpoint greedy tokens "
          f"for {len(prompts)} requests x {NEW_TOKENS}, paged_flash_decode "
          f"launches {launches['trainer']} and {launches['checkpoint']}")
    from repro_torch.core import perf_model as pm
    model = pm.ckpt_overhead(rec["bytes"], step_time_s=step4_wall,
                             d2h=pm.H100_PCIE5_D2H, disk=pm.CKPT_DISK)
    out["ckpt_overhead_model"] = model
    print(f"phase 17: perf_model.ckpt_overhead of {rec['bytes'] / 1e9:.3f} "
          f"GB (device->host on PCIe Gen5 x16, 64 GB/s a direction, the "
          f"H100 SXM datasheet; the disk at the reference's assumed 2 GB/s) "
          f"predicts save_async blocking {model['async_s']:.2f} s (measured "
          f"{rec['blocking_s']:.2f} s) and a write of "
          f"{model['publish_lag_s']:.2f} s (measured "
          f"{stats['last_write_s']:.2f} s)")
    print(f"phase 17: {json.dumps(out)}")
    return out

# --------------------------------------------------------------------------
# phase 22: the prefix cache and the front door
# --------------------------------------------------------------------------

def _tree_only(sch):
    """Whether only the radix tree holds references in the pool."""
    return (sorted(sch.kv._refs) == sorted(sch.prefix.pages())
            and all(r == 1 for r in sch.kv._refs.values()))


def prefix_qwen(dev, cfg, model):
    """Phase 22: phase 3's model (full-width, full-depth qwen3-1.7b, bf16,
    seed 0) serves 16 templated requests without the prefix cache, then
    with it through ``FrontDoor``; the tokens must be equal bitwise and
    the hits exactly 12 x 256.  Then the fp32 2-layer check: the card's
    cached tokens == the CPU's uncached tokens, with a copy-on-write fork
    and a pool sized down so that the tree evicts.  Returns the numbers."""
    import copy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model
    from repro_torch.serve import ContinuousScheduler, FrontDoor

    rng = np.random.default_rng(0)
    templates = [rng.integers(0, cfg.vocab_size, PREFIX_TEMPLATE_LEN)
                 .astype(np.int32) for _ in range(PREFIX_TEMPLATES)]
    suffixes = rng.integers(PREFIX_SUFFIX_MIN, PREFIX_SUFFIX_MAX + 1,
                            REQUESTS)
    per = REQUESTS // PREFIX_TEMPLATES
    prompts = [np.concatenate([templates[i // per], rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)])
        for i, n in enumerate(suffixes)]
    lens = [len(p) for p in prompts]
    hit = [i % per != 0 for i in range(REQUESTS)]
    # the launches the code makes, one a layer a model call: ceil(S / 32)
    # prefill calls a request (ceil((S - 256) / 32) after a hit), and two
    # waves of 8 requests, each ceil(63 / 8) ticks of 8 decode steps
    chunks = lambda n: -(-n // PREFILL_CHUNK)                   # noqa: E731
    ticks = REQUESTS // SLOTS * -(-(NEW_TOKENS - 1) // DECODE_CHUNK)
    prefill_calls = {
        False: sum(chunks(n) for n in lens),
        True: sum(chunks(n - PREFIX_TEMPLATE_LEN * h)
                  for n, h in zip(lens, hit))}
    want = {c: cfg.num_layers * (prefill_calls[c] + DECODE_CHUNK * ticks)
            for c in (False, True)}
    outs, res = {}, {}
    for cached in (False, True):
        sch = ContinuousScheduler(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                                  page_size=PAGE_SIZE,
                                  prefill_chunk=PREFILL_CHUNK,
                                  decode_chunk=DECODE_CHUNK,
                                  prefix_cache=cached)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        if cached:
            fd = FrontDoor(sch)
            handles = [fd.submit(p, NEW_TOKENS) for p in prompts]
            fd.drain()
            outs[cached] = [h.result() for h in handles]
        else:
            outs[cached] = sch.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = sch.stats()
        launches = launch_counts().get("paged_flash_decode", 0)
        tag = "cached" if cached else "uncached"
        if launches != want[cached] or st["decode_dispatches"] != ticks \
                or st["prefill_dispatches"] != prefill_calls[cached]:
            fail(f"phase 22 ({tag}): paged_flash_decode launched {launches} "
                 f"times in {st['prefill_dispatches']} prefill calls and "
                 f"{st['decode_dispatches']} ticks, expected {want[cached]} "
                 f"= {cfg.num_layers} x ({prefill_calls[cached]} + "
                 f"{DECODE_CHUNK} x {ticks})")
        ttft = sorted(st["ttft_s"])
        n_tok = sum(len(o) for o in outs[cached])
        res[tag] = {"wall_s": wall, "tokens_per_s": n_tok / wall,
                    "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
                    "prefill_calls": st["prefill_dispatches"],
                    "decode_ticks": st["decode_dispatches"],
                    "paged_flash_decode_launches": launches,
                    "prefix_hit_tokens": st["prefix_hit_tokens"],
                    "prefix_hit_rate": st["prefix_hit_rate"]}
        if cached:
            res[tag]["prefix_cache"] = st["prefix_cache"]
            res[tag]["tree_pages"] = sch.prefix.nodes
            if not _tree_only(sch):
                fail("phase 22: after the drain, references other than the "
                     "tree's remain in the pool")
        print(f"phase 22 ({tag}): {REQUESTS} requests ({sum(lens)} prompt "
              f"tokens) x {NEW_TOKENS} in {wall:.3f} s, "
              f"{n_tok / wall:.1f} tokens/s, TTFT p50 "
              f"{res[tag]['ttft_p50_ms']:.1f} ms, {st['prefill_dispatches']} "
              f"prefill calls, {st['decode_dispatches']} ticks, "
              f"paged_flash_decode launches {launches}, prefix hit tokens "
              f"{st['prefix_hit_tokens']} (rate "
              f"{st['prefix_hit_rate']:.4f})"
              + (f", {sch.prefix.nodes} pages in the tree, evictions "
                 f"{st['prefix_cache']['evictions']}" if cached else ""))
        del sch
    if any(not np.array_equal(a, b) for a, b in zip(outs[False],
                                                       outs[True])):
        fail("phase 22: cached and uncached bf16 greedy tokens differ")
    hits = res["cached"]["prefix_hit_tokens"]
    if hits != sum(hit) * PREFIX_TEMPLATE_LEN:
        fail(f"phase 22: prefix_hit_tokens {hits}, expected "
             f"{sum(hit)} x {PREFIX_TEMPLATE_LEN}")
    print(f"phase 22: the cached tokens (through FrontDoor) equal the "
          f"uncached ones bitwise for {REQUESTS} requests; hit tokens {hits} "
          f"= {sum(hit)} x {PREFIX_TEMPLATE_LEN}")

    # fp32, 2 full-width layers: the card's cached tokens == the CPU's
    # uncached tokens, on the reference test's shape of traffic (a shared
    # template, a match of 48 tokens -- not a multiple of the 32-token
    # chunk --, an exact repeat, and a page-aligned prompt served twice:
    # the copy-on-write fork), then a pool sized down so that the tree
    # must evict
    small = cfg.with_overrides(num_layers=2, dtype="float32")
    m_cpu = init_model(small, seed=1, device="cpu")
    m_card = copy.deepcopy(m_cpu).to(dev)
    rng = np.random.default_rng(22)
    tmpl = rng.integers(0, cfg.vocab_size, 48).astype(np.int32)
    sfx = [rng.integers(0, cfg.vocab_size, 3 + i).astype(np.int32)
           for i in range(3)]
    runs = {
        "cow": ([np.concatenate([tmpl, x]) for x in sfx]
                + [np.concatenate([tmpl, sfx[0]]), tmpl, tmpl],
                dict(slots=2, max_len=128, num_pages=40)),
        "evict": ([rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
                   for _ in range(5)],
                  dict(slots=1, max_len=64, num_pages=8)),
    }
    fp32 = {}
    for name, (ps_, kw) in runs.items():
        kw = dict(kw, page_size=PAGE_SIZE, prefill_chunk=PREFILL_CHUNK,
                  decode_chunk=4)
        want_t = ContinuousScheduler(small, m_cpu, **kw).generate(ps_, 8)
        sch = ContinuousScheduler(small, m_card, prefix_cache=True, **kw)
        forks = []
        fork = sch.kv.cow_fork
        sch.kv.cow_fork = lambda *a: forks.append(a) or fork(*a)
        reset_launch_counts()
        got_t = sch.generate(ps_, 8)
        st = sch.stats()
        calls = st["prefill_dispatches"] + 4 * st["decode_dispatches"]
        if launch_counts().get("paged_flash_decode", 0) != 2 * calls:
            fail(f"phase 22 ({name}): the card run did not launch "
                 "paged_flash_decode in every layer of every model call")
        for a, b in zip(want_t, got_t):
            if not np.array_equal(a, b):
                fail(f"phase 22 ({name}): card cached fp32 tokens differ from "
                     f"the CPU's uncached: {b} vs {a}")
        fp32[name] = {"prefix_hit_tokens": st["prefix_hit_tokens"],
                      "cow_forks": len(forks),
                      "evictions": st["prefix_cache"]["evictions"]}
        if name == "cow" and (len(forks) != 2 or st["prefix_hit_tokens"] !=
                              3 * 48 + 2 * 47):
            fail(f"phase 22 (cow): {len(forks)} copy-on-write forks and "
                 f"{st['prefix_hit_tokens']} hit tokens, expected 2 and "
                 f"{3 * 48 + 2 * 47}")
        if name == "evict" and st["prefix_cache"]["evictions"] < 1:
            fail("phase 22 (evict): the sized-down pool never evicted")
        if not _tree_only(sch):
            fail(f"phase 22 ({name}): references other than the tree's "
                 "remain in the pool")
        print(f"phase 22: 2-layer full-width qwen3 fp32, {name}: the card's "
              f"cached greedy tokens equal the CPU's uncached ones for "
              f"{len(ps_)} requests x 8 ({json.dumps(fp32[name])})")
        del sch
    del m_card, m_cpu
    torch.cuda.empty_cache()
    res["fp32"] = fp32
    return res


# --------------------------------------------------------------------------
# phase 23: speculative decoding with the MTP head
# --------------------------------------------------------------------------

def spec_serve(cfg, model, prompts, new_tokens, k, **kw):
    """Serve ``prompts`` at spec_decode ``k`` (0: plain decode) and check
    the launches: exactly one attention-kernel launch a layer a model call
    (a verify forward is one call), none from the draft head, and one
    decode host sync a tick.  Returns (outputs, stats, wall, launches)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ContinuousScheduler
    sch = ContinuousScheduler(cfg, model, spec_decode=k, **kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = sch.generate(prompts, new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sch.stats()
    counts = {n: c for n, c in launch_counts().items() if c}
    kernel = ("paged_flash_decode_mla" if cfg.attention == "mla"
              else "paged_flash_decode")
    calls = st["prefill_dispatches"] + kw["decode_chunk"] * st[
        "decode_dispatches"]
    if counts != {kernel: cfg.num_layers * calls}:
        fail(f"spec_decode={k}: launches {counts}, expected only {kernel} "
             f"= {cfg.num_layers} x {calls} model calls")
    if st["decode_host_syncs"] != st["decode_dispatches"]:
        fail(f"spec_decode={k}: {st['decode_host_syncs']} decode host syncs "
             f"in {st['decode_dispatches']} ticks")
    return outs, st, wall, counts[kernel]


def _agreement(ref, outs):
    """Share of requests whose tokens equal ``ref``'s, and the first
    divergence (request, index) or None."""
    same = [np.array_equal(a, b) for a, b in zip(ref, outs)]
    first = None
    for i, (a, b) in enumerate(zip(ref, outs)):
        n = min(len(a), len(b))
        d = np.flatnonzero(a[:n] != b[:n])
        if d.size or len(a) != len(b):
            first = (i, int(d[0]) if d.size else n)
            break
    return sum(same) / len(same), first


def spec_deepseek(dev, cfg, model, prompts):
    """Phase 23 (i): phase 9's model (DeepSeek-V3 at its 4-layer cut, with
    its MTP head, bf16) serves phase 3's traffic at k = 0, 2 and 4,
    max_len 624.  Returns the numbers of each k."""
    kw = dict(slots=SLOTS, max_len=SPEC_MAX_LEN, page_size=PAGE_SIZE,
              prefill_chunk=PREFILL_CHUNK, decode_chunk=DECODE_CHUNK)
    from repro_torch.serve import ContinuousScheduler
    res, outs = {}, {}
    for k in SPEC_KS:
        ContinuousScheduler(cfg, model, spec_decode=k, **kw).generate(
            prompts[:2], 4)                            # warm-up
        outs[k], st, wall, mla = spec_serve(cfg, model, prompts, NEW_TOKENS,
                                            k, **kw)
        n_tok = sum(len(o) for o in outs[k])
        if len(outs[k]) != REQUESTS or any(
                len(o) != NEW_TOKENS or o.min() < 0
                or o.max() >= cfg.vocab_size for o in outs[k]):
            fail(f"phase 23 (k={k}): outputs of the wrong length or "
                 "out-of-vocab tokens")
        sd = st.get("spec_decode", {})
        share, first = _agreement(outs[0], outs[k])
        res[k] = {"wall_s": wall, "tokens_per_s": n_tok / wall,
                  "decode_dispatches": st["decode_dispatches"],
                  "decode_dispatches_per_token":
                      st["decode_dispatches"] / n_tok,
                  "decode_host_syncs": st["decode_host_syncs"],
                  "acceptance": sd.get("acceptance"),
                  "tokens_per_verify_step": sd.get("tokens_per_step"),
                  "paged_flash_decode_mla_launches": mla,
                  "share_equal_to_k0": share, "first_divergence": first}
        print(f"phase 23 (k={k}): {cfg.name} at {cfg.num_layers} layers with "
              f"its MTP head, bf16, {REQUESTS} requests x {NEW_TOKENS}: "
              f"{wall:.3f} s, {n_tok / wall:.1f} tokens/s, acceptance "
              f"{sd.get('acceptance', 0.0):.4f}, "
              f"{sd.get('tokens_per_step', 1.0):.3f} tokens a verify step, "
              f"{st['decode_dispatches'] / n_tok:.4f} decode dispatches a "
              f"token, {st['decode_host_syncs']} host syncs in "
              f"{st['decode_dispatches']} ticks, paged_flash_decode_mla "
              f"launches {mla}; requests equal to k=0: {share:.4f}, first "
              f"divergence {first}")
    return res


def spec_trained(dev):
    """Phase 23 (ii): qwen3-1.7b at 2 full-width layers with an MTP head,
    fp32 (TF32 off), trained through ``Trainer(model_cfg=...)`` on the
    alternating [3, 5] stream; then k = 4 against k = 0 on the card:
    tokens equal, acceptance >= 0.6, decode dispatches and host syncs a
    token down >= 1.8x, and an EOS mid-chunk emits nothing after it."""
    from repro_torch.api import Trainer
    from repro_torch.bridge import serving_model
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-1.7b").with_overrides(num_layers=2,
                                                  dtype="float32",
                                                  mtp_depth=1)
    tok = np.tile(np.asarray([3, 5], np.int32), (8, 16))
    t0 = time.perf_counter()
    tr = Trainer.create(cfg, optimizer="adam", lr=TRAIN_LR, seed=0,
                        device=dev)
    losses = [float(tr.step({"tokens": tok})["loss"])
              for _ in range(SPEC_TRAIN_STEPS)]
    model = serving_model(tr.state.params)
    train_s = time.perf_counter() - t0
    del tr
    kw = dict(slots=4, max_len=128, page_size=PAGE_SIZE, prefill_chunk=8,
              decode_chunk=8)
    prompts = [np.tile(np.asarray([3, 5], np.int32), 4) for _ in range(4)]
    new = 32
    ref, base, _, l0 = spec_serve(cfg, model, prompts, new, 0, **kw)
    got, spec, wall, l4 = spec_serve(cfg, model, prompts, new, 4, **kw)
    if any(not np.array_equal(a, b) for a, b in zip(ref, got)):
        fail(f"phase 23 (trained): k=4 tokens differ from k=0: {got} vs "
             f"{ref}")
    sd = spec["spec_decode"]
    drop = {c: (base[c] / base["tokens_out"]) / (spec[c] / spec["tokens_out"])
            for c in ("decode_dispatches", "decode_host_syncs")}
    if sd["acceptance"] < 0.6 or min(drop.values()) < 1.8:
        fail(f"phase 23 (trained): acceptance {sd['acceptance']:.4f}, drops "
             f"{drop} (bars 0.6 and 1.8)")
    eos_kw = dict(kw, slots=2, decode_chunk=4, eos_id=5)
    eos_prompt = [np.tile(np.asarray([3, 5], np.int32), 6)]
    e0, _, _, _ = spec_serve(cfg, model, eos_prompt, 12, 0, **eos_kw)
    e4, _, _, _ = spec_serve(cfg, model, eos_prompt, 12, 4, **eos_kw)
    if e4[0].tolist() != [3, 5] or not np.array_equal(e0[0], e4[0]):
        fail(f"phase 23 (trained): EOS mid-chunk gave {e4[0]} (k=0 "
             f"{e0[0]}), expected [3, 5]")
    out = {"train_steps": SPEC_TRAIN_STEPS, "lr": TRAIN_LR,
           "train_s": train_s, "losses": losses[::10] + losses[-1:],
           "acceptance": sd["acceptance"],
           "tokens_per_verify_step": sd["tokens_per_step"],
           "drop": drop, "spec_wall_s": wall,
           "launches": {"k0": l0, "k4": l4}}
    print(f"phase 23 (trained): {cfg.layer_pattern()} + MTP head at full "
          f"width, fp32, {SPEC_TRAIN_STEPS} Adam steps (lr {TRAIN_LR:g}) on "
          f"the [3, 5] stream in {train_s:.1f} s (losses {out['losses']}); "
          f"k=4 tokens == k=0, acceptance {sd['acceptance']:.4f}, "
          f"{sd['tokens_per_step']:.3f} tokens a verify step, decode "
          f"dispatches a token down {drop['decode_dispatches']:.2f}x, host "
          f"syncs {drop['decode_host_syncs']:.2f}x; EOS mid-chunk -> "
          f"{e4[0].tolist()}")
    del model
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phases 24-26: the six newcomers -- four decoder-only stacks, the VLM and
# the encoder-decoder
# --------------------------------------------------------------------------

DENSE_MORE = ("granite-20b", "qwen2.5-32b", "deepseek-coder-33b",
              "deepseek-moe-16b")
# phase 24's depth cut, so that phases 27 and 29 fit the script's time
# limit (16 until phase 29's lockstep and head_dim-fallback runs): each
# stack repeats one layer (deepseek-moe-16b after its dense first one),
# and 8 of them drive the same kernel at the same group size
DENSE_MORE_LAYERS = {arch: 8 for arch in DENSE_MORE}
# phase 25: seamless's 8 sources of 1024 frames and 8-token target
# prompts; llava's 8 requests of 2880 image rows + 128 text tokens
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT = 8, 1024, 8
VLM_BATCH, VLM_TEXT = 8, 128
# ... and the fp32 parity runs at 2 full-width layers, batch 1, 8 new
# tokens: seamless on 128 frames; llava on the reference's make_batch rule
# at seq 512 (256 image rows, 256 tokens)
PARITY_NEW, PARITY_FRAMES, PARITY_SEQ = 8, 128, 512
# ... whose prefill logits may differ card vs CPU by at most this (both
# fp32 with TF32 off; the two devices' sums differ by ~1e-5 at d 4096)
PARITY_DLOGIT_TOL = 1e-4
# phase 26's card-vs-CPU fp32 check at 2 full-width layers (phase 14's
# form): 2 AdamW steps on one sequence of this length (seamless: 128
# frames + 128 targets; llava: 64 image rows + 64 tokens); the CPU's
# AdamW over ~0.6 B params takes most of its ~10 s a step
PARITY_TRAIN_SEQ = 128
# phase 26: llava trains at this depth (AdamW's state for 7.24 B does not
# fit one card)
VLM_TRAIN_LAYERS = 8


def _free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def serve_dense_more(dev, lens):
    """Phase 24: granite-20b, qwen2.5-32b, deepseek-coder-33b and
    deepseek-moe-16b at full width, each cut to DENSE_MORE_LAYERS
    layers, bf16, one at a time, serve
    phase 3's traffic through the continuous scheduler; a decode tick
    and a prefill chunk traced for the device's idle share; granite also
    serves phase 11's traffic through the lockstep engine.  Returns
    {arch: numbers}."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.profile_serve import trace
    from repro_torch.models import apply_model, init_model
    from repro_torch.models.attention import PagedView
    from repro_torch.serve import ContinuousScheduler, ServeEngine

    out = {}
    for arch in DENSE_MORE:
        cfg = get_config(arch)
        if arch in DENSE_MORE_LAYERS:
            cfg = cfg.with_overrides(num_layers=DENSE_MORE_LAYERS[arch])
        rng = np.random.default_rng(0)
        rng.integers(PROMPT_MIN, PROMPT_MAX + 1, REQUESTS)  # phase 3's lengths
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        torch.cuda.reset_peak_memory_stats()
        t_phase = t0 = time.perf_counter()
        model = init_model(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 2**30
        serve(cfg, model, [prompts[0][:PREFILL_CHUNK]], 2)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
        reset_launch_counts()
        t0 = time.perf_counter()
        sch, outs = serve(cfg, model, prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st = sch.stats()
        calls = st["prefill_dispatches"] + DECODE_CHUNK * st[
            "decode_dispatches"]
        launches = counts.get("paged_flash_decode", 0)
        if launches != cfg.num_layers * calls:
            fail(f"phase 24 ({arch}): paged_flash_decode launched {launches} "
                 f"times, expected {cfg.num_layers} x {calls} model calls")
        for other in ("paged_flash_decode_mla", "wkv6", "mamba_scan",
                      "flash_attention"):
            if counts.get(other, 0):
                fail(f"phase 24 ({arch}): {other} launched on the paged path")
        if len(outs) != REQUESTS or any(
                len(o) != NEW_TOKENS or o.min() < 0
                or o.max() >= cfg.vocab_size for o in outs):
            fail(f"phase 24 ({arch}): wrong lengths or out-of-vocab tokens")
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_tok = sum(len(o) for o in outs)
        # the device's idle share: one fused decode tick with every slot
        # busy, and one 32-token prefill chunk at position 256
        sch = ContinuousScheduler(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                                  page_size=PAGE_SIZE,
                                  decode_chunk=DECODE_CHUNK,
                                  prefill_chunk=PREFILL_CHUNK)
        for p in prompts[:SLOTS]:
            sch.submit(p, NEW_TOKENS)
        sch._admit()
        with torch.inference_mode():
            tick = trace(sch._decode_tick, dev, top=4)
            kv = sch.kv
            kv.free(0)
            kv.alloc(0, 256 + PREFILL_CHUNK)
            view = PagedView(kv.table([0]), PAGE_SIZE)
            toks = torch.from_numpy(prompts[0][:PREFILL_CHUNK]).to(dev)[None]
            pos = torch.full((1,), 256, dtype=torch.int32, device=dev)
            chunk = trace(lambda: apply_model(
                cfg, model, toks, cache=kv.slot_cache(0), cache_pos=pos,
                paged=view, logits=False), dev, top=4)
        del sch, kv
        trace_s = time.perf_counter() - t0 - wall
        rec = {"params": cfg.param_count(), "layers": cfg.num_layers,
               "reduced": (f"num_layers {get_config(arch).num_layers} -> "
                           f"{cfg.num_layers}" if arch in DENSE_MORE_LAYERS
                           else None),
               "group": cfg.num_heads // cfg.num_kv_heads,
               "init_s": init_s, "init_peak_gib": init_peak,
               "resident_gib": resident, "peak_gib": peak, "wall_s": wall,
               "tokens_per_s": n_tok / wall,
               "ttft_p50_ms": float(np.median(st["ttft_s"])) * 1e3,
               "model_calls": calls, "paged_launches": launches,
               "decode_tick": {k: tick[k] for k in (
                   "wall_ms", "device_busy_ms", "device_idle_share",
                   "kernel_launches", "top_kernels")},
               "prefill_chunk": {k: chunk[k] for k in (
                   "wall_ms", "device_busy_ms", "device_idle_share",
                   "kernel_launches", "top_kernels")}}
        print(f"phase 24: {arch} ({rec['params'] / 1e9:.3f} B params, "
              f"{cfg.num_layers} layers"
              + (f" (reduced: {rec['reduced']})" if rec["reduced"] else "")
              + f", {cfg.num_heads} q / "
              f"{cfg.num_kv_heads} kv heads x {cfg.head_dim} (g = "
              f"{rec['group']}), bf16; initialised in {init_s:.1f} s, init "
              f"peak {init_peak:.2f} GiB): {REQUESTS} requests "
              f"({int(lens.sum())} prompt tokens) x {NEW_TOKENS} new on "
              f"{SLOTS} slots in {wall:.3f} s: {rec['tokens_per_s']:.1f} "
              f"tokens/s, TTFT p50 {rec['ttft_p50_ms']:.1f} ms, peak memory "
              f"{peak:.2f} GiB ({resident:.2f} GiB resident); "
              f"paged_flash_decode launches {launches} = {cfg.num_layers} x "
              f"{calls}; idle share: decode tick "
              f"{tick['device_idle_share']:.3f} ({tick['device_busy_ms']:.2f} "
              f"of {tick['wall_ms']:.2f} ms), prefill chunk "
              f"{chunk['device_idle_share']:.3f} "
              f"({chunk['device_busy_ms']:.2f} of {chunk['wall_ms']:.2f} ms; "
              f"the traces took {trace_s:.1f} s)")
        if arch == "granite-20b":
            # phase 11's traffic through the lockstep engine: every
            # attention call through the flash kernel at g = 48
            legacy = synthetic_tokens(np.random.default_rng(0), LEGACY_BATCH,
                                      LEGACY_PROMPT, cfg.vocab_size)
            ServeEngine(cfg, model, batch_size=2,
                        max_len=LEGACY_MAX_LEN).generate(legacy[:2, :64], 4)
            eng = ServeEngine(cfg, model, batch_size=LEGACY_BATCH,
                              max_len=LEGACY_MAX_LEN)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            toks = eng.generate(legacy, NEW_TOKENS).cpu().numpy()
            lwall = time.perf_counter() - t0
            flash = launch_counts().get("flash_attention", 0)
            if flash != cfg.num_layers * NEW_TOKENS:
                fail(f"phase 24 (granite lockstep): flash_attention launched "
                     f"{flash} times, expected {cfg.num_layers} x "
                     f"{NEW_TOKENS}")
            if toks.shape != (LEGACY_BATCH, NEW_TOKENS) or toks.min() < 0 \
                    or toks.max() >= cfg.vocab_size:
                fail("phase 24 (granite lockstep): bad outputs")
            rec["lockstep"] = {"wall_s": lwall, "flash_launches": flash,
                               "tokens_per_s": toks.size / lwall}
            print(f"phase 24: {arch} through ServeEngine, {LEGACY_BATCH} x "
                  f"{LEGACY_PROMPT} prompt tokens x {NEW_TOKENS} new in "
                  f"{lwall:.3f} s: {toks.size / lwall:.1f} tokens/s; "
                  f"flash_attention launches {flash} = {cfg.num_layers} x "
                  f"(1 prefill + {NEW_TOKENS - 1} decode calls) at g = 48")
            del eng
        del model
        _free()
        rec["phase_s"] = time.perf_counter() - t_phase
        print(f"phase 24: {arch} took {rec['phase_s']:.1f} s in all")
        out[arch] = rec
    return out


def slab_generate(cfg, model, tokens, new, max_len, cross_len=0, **fronts):
    """Greedy generation through ``apply_model``'s slab prefill and decode
    (the reference's only serving path for a VLM or an encoder-decoder):
    (tokens (B, new) on the host, prefill seconds, wall seconds, the
    prefill's last logits).  One host sync, at the end."""
    from repro_torch.models import apply_model, compute_dtype, init_cache
    dev = tokens.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cache = init_cache(cfg, compute_dtype(cfg), batch=tokens.shape[0],
                       max_len=max_len, cross_len=cross_len, device=dev)
    sync()
    t0 = time.perf_counter()
    first = apply_model(cfg, model, tokens, cache=cache, cache_pos=0,
                        mode="prefill", last_only=True,
                        **fronts)["logits"][:, -1]
    sync()
    prefill_s = time.perf_counter() - t0
    # the image rows come first: the decode positions follow them
    pos = tokens.shape[1] + (fronts["vision_embeds"].shape[1]
                             if "vision_embeds" in fronts else 0)
    nxt = first.argmax(-1)[:, None]
    toks = [nxt]
    for i in range(new - 1):
        logits = apply_model(cfg, model, nxt, cache=cache, cache_pos=pos + i,
                             mode="decode")["logits"][:, -1]
        nxt = logits.argmax(-1)[:, None]
        toks.append(nxt)
    toks = torch.cat(toks, dim=1).cpu().numpy()
    return toks, prefill_s, time.perf_counter() - t0, first.float().cpu()


def _frontend_parity(dev, cfg):
    """Phase 25's check: ``cfg`` at 2 full-width layers (and 2 encoder
    layers) in fp32, batch 1, through slab prefill + PARITY_NEW greedy
    steps on the card and on the CPU from equal weights: equal tokens,
    prefill logits within PARITY_DLOGIT_TOL, the flash kernel in every
    attention call of the card's run."""
    import copy
    from repro_torch.data import make_batch, synthetic_tokens
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import batch_inputs, init_model

    arch = cfg.name
    small = cfg.with_overrides(num_layers=2, dtype="float32",
                               encoder_layers=min(cfg.encoder_layers, 2))
    rng = np.random.default_rng(1)
    if cfg.is_encoder_decoder:
        pb = {"src_embeds": rng.standard_normal(
            (1, PARITY_FRAMES, cfg.d_model), dtype=np.float32),
            "tgt_tokens": synthetic_tokens(rng, 1, ENCDEC_PROMPT,
                                           cfg.vocab_size)}
        cut = (f"{PARITY_FRAMES} frames, {ENCDEC_PROMPT} target prompt "
               "tokens")
    else:
        pb = make_batch(small, rng, 1, PARITY_SEQ)
        cut = (f"reduced: {pb['vision_embeds'].shape[1]} image rows (of "
               f"{cfg.num_frontend_tokens}) + {pb['tokens'].shape[1]} "
               f"tokens, the reference's make_batch rule at seq "
               f"{PARITY_SEQ}")
    m_card = init_model(small, seed=1, device=dev)
    m_cpu = copy.deepcopy(m_card.cpu())
    m_card.to(dev)
    got = {}
    for where, m in (("cpu", m_cpu), ("cuda", m_card)):
        on = torch.device("cpu") if where == "cpu" else dev
        tk, fr = batch_inputs({k: torch.from_numpy(v).to(on)
                               for k, v in pb.items()})
        rows = tk.shape[1] + (fr["vision_embeds"].shape[1]
                              if "vision_embeds" in fr else 0)
        reset_launch_counts()
        t0 = time.perf_counter()
        got[where] = slab_generate(
            small, m, tk, PARITY_NEW, rows + PARITY_NEW,
            PARITY_FRAMES if cfg.is_encoder_decoder else 0, **fr)
        print(f"  {where}: {time.perf_counter() - t0:.1f} s")
    card_flash = launch_counts().get("flash_attention", 0)
    want = (small.encoder_layers + 2 * small.num_layers * PARITY_NEW
            if cfg.is_encoder_decoder else small.num_layers * PARITY_NEW)
    if card_flash != want:
        fail(f"phase 25 ({arch} fp32): the card launched flash_attention "
             f"{card_flash} times, expected {want}")
    dlogit = (got["cpu"][3] - got["cuda"][3]).abs().max().item()
    if not np.array_equal(got["cpu"][0], got["cuda"][0]):
        fail(f"phase 25 ({arch} fp32): greedy tokens differ card vs CPU: "
             f"{got['cpu'][0]} vs {got['cuda'][0]}")
    if not dlogit <= PARITY_DLOGIT_TOL:
        fail(f"phase 25 ({arch} fp32): the prefill's logits differ card vs "
             f"CPU by {dlogit:.2e} > {PARITY_DLOGIT_TOL:g}")
    print(f"phase 25: 2-layer full-width {arch} fp32, batch 1 ({cut}): "
          f"greedy tokens equal on card and CPU for {PARITY_NEW} tokens; "
          f"max |d logit| of the prefill {dlogit:.2e} (tol "
          f"{PARITY_DLOGIT_TOL:g}); card flash_attention launches "
          f"{card_flash}")
    del m_card, m_cpu, got
    _free()
    return {"max_abs_dlogit": dlogit, "tol": PARITY_DLOGIT_TOL, "cut": cut,
            "card_flash_launches": card_flash}


def serve_frontends(dev):
    """Phase 25: seamless-m4t-large-v2 and llava-next-mistral-7b at full
    width and depth, bf16, through slab prefill + greedy decode; then
    each at 2 full-width layers in fp32, card vs CPU.  Returns
    {arch: numbers}."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model

    out = {}
    for arch in ("seamless-m4t-large-v2", "llava-next-mistral-7b"):
        cfg = get_config(arch)
        rng = np.random.default_rng(0)
        if cfg.is_encoder_decoder:
            B, n_tok = ENCDEC_BATCH, ENCDEC_PROMPT
            fronts = {"src_embeds": rng.standard_normal(
                (B, ENCDEC_FRAMES, cfg.d_model), dtype=np.float32)}
            cross, rows = ENCDEC_FRAMES, n_tok
            want = cfg.encoder_layers + 2 * cfg.num_layers * NEW_TOKENS
            how = (f"{cfg.encoder_layers} (encoder) + {2 * cfg.num_layers} "
                   f"(prefill) + {NEW_TOKENS - 1} x {2 * cfg.num_layers} "
                   "(decode)")
            what = (f"{B} sources of {ENCDEC_FRAMES} frame embeddings, "
                    f"{n_tok}-token target prompts, cross_len {cross}")
        else:
            B, n_tok = VLM_BATCH, VLM_TEXT
            fronts = {"vision_embeds": rng.standard_normal(
                (B, cfg.num_frontend_tokens, 1024), dtype=np.float32)}
            cross, rows = 0, cfg.num_frontend_tokens + n_tok
            want = cfg.num_layers * NEW_TOKENS
            how = (f"{cfg.num_layers} x (1 prefill + {NEW_TOKENS - 1} "
                   "decode calls)")
            what = (f"{B} requests of {cfg.num_frontend_tokens} image "
                    f"embeddings + {n_tok} text tokens")
        tokens = torch.from_numpy(synthetic_tokens(rng, B, n_tok,
                                                   cfg.vocab_size)).to(dev)
        fronts = {k: torch.from_numpy(v).to(dev) for k, v in fronts.items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init_model(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        max_len = rows + NEW_TOKENS
        slab_generate(cfg, model, tokens[:2, :4], 4, max_len, cross,
                      **{k: v[:2] for k, v in fronts.items()})   # warm-up
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
        reset_launch_counts()
        toks, prefill_s, wall, _ = slab_generate(cfg, model, tokens,
                                                 NEW_TOKENS, max_len, cross,
                                                 **fronts)
        counts = launch_counts()
        flash = counts.get("flash_attention", 0)
        if flash != want:
            fail(f"phase 25 ({arch}): flash_attention launched {flash} times, "
                 f"expected {want} = {how}")
        for other in ("paged_flash_decode", "paged_flash_decode_mla", "wkv6",
                      "mamba_scan"):
            if counts.get(other, 0):
                fail(f"phase 25 ({arch}): {other} launched on the slab path")
        if toks.shape != (B, NEW_TOKENS) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            fail(f"phase 25 ({arch}): outputs {toks.shape} or out of vocab")
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec = {"params": cfg.param_count(), "init_s": init_s,
               "resident_gib": resident, "peak_gib": peak,
               "prefill_ms": prefill_s * 1e3, "wall_s": wall,
               "tokens_per_s": toks.size / wall, "flash_launches": flash}
        print(f"phase 25: {arch} ({rec['params'] / 1e9:.3f} B params by the "
              f"reference's formula, {cfg.num_layers} layers"
              + (f" + {cfg.encoder_layers} encoder layers"
                 if cfg.is_encoder_decoder else "")
              + f", bf16; initialised in {init_s:.1f} s): {what}, "
              f"{NEW_TOKENS} greedy new tokens through apply_model's slab "
              f"prefill + decode in {wall:.3f} s: {rec['tokens_per_s']:.1f} "
              f"tokens/s, prefill {prefill_s * 1e3:.1f} ms, peak memory "
              f"{peak:.2f} GiB ({resident:.2f} GiB resident); flash_attention "
              f"launches {flash} = {how}")
        del model, fronts, tokens
        _free()

        rec["fp32_parity"] = _frontend_parity(dev, cfg)
        out[arch] = rec
    return out


def train_frontends(dev):
    """Phase 26: seamless-m4t-large-v2 at full size and
    llava-next-mistral-7b cut to 8 layers, 1 + 3 AdamW steps, bf16 on
    fp32 masters, remat, on 2 x 4096 in 2 microbatches; then each at 2
    full-width layers in fp32, 2 AdamW steps card vs CPU.  Returns
    {arch: numbers}."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, trainable)

    out = {}
    for arch, cut in (("seamless-m4t-large-v2", None),
                      ("llava-next-mistral-7b", VLM_TRAIN_LAYERS)):
        cfg = get_config(arch)
        if cut:
            cfg = cfg.with_overrides(num_layers=cut)
        tc = TrainConfig(optimizer="adamw", lr=TRAIN_LR,
                         microbatches=TRAIN_MICRO, remat=True)
        batch = make_batch(cfg, np.random.default_rng(0), TRAIN_BATCH,
                           TRAIN_SEQ)
        t0 = time.perf_counter()
        state = init_train_state(cfg, tc, seed=0, device=dev)
        step, _ = make_train_step(cfg, tc)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in trainable(state.params).values())
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, walls = [], []
        for _ in range(1 + TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            walls.append(time.perf_counter() - t0)
        flash = launch_counts().get("flash_attention", 0)
        per_micro = (cfg.encoder_layers + 2 * cfg.num_layers
                     if cfg.is_encoder_decoder else cfg.num_layers)
        want = (1 + TRAIN_TIMED) * TRAIN_MICRO * per_micro * 2
        bwd = check_bwd(f"phase 26 ({arch})", launch_counts(),
                        (1 + TRAIN_TIMED) * TRAIN_MICRO * per_micro)
        if flash != want:
            fail(f"phase 26 ({arch}): flash_attention launched {flash} times, "
                 f"expected {want} = {1 + TRAIN_TIMED} steps x {TRAIN_MICRO} "
                 f"microbatches x {per_micro} attention calls x 2 (forward + "
                 "remat recompute)")
        if not all(np.isfinite(losses)):
            fail(f"phase 26 ({arch}): losses {losses} are not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        wall = float(np.median(walls[1:]))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        mfu = 6 * n_params * tokens / wall / PEAK_OPS[torch.bfloat16]
        rec = {"params": n_params, "layers": cfg.num_layers,
               "cut": f"num_layers {get_config(arch).num_layers} -> {cut}"
               if cut else None, "init_s": init_s, "losses": losses,
               "step_ms": wall * 1e3,
               "step_walls_ms": [w * 1e3 for w in walls],
               "tokens_per_s": tokens / wall, "mfu": mfu, "peak_gib": peak,
               "flash_launches": flash, "bwd_launches": bwd}
        shape = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
        print(f"phase 26: {arch}"
              + (f" reduced: num_layers {get_config(arch).num_layers} -> "
                 f"{cut}" if cut else " at full size")
              + f" ({n_params / 1e9:.3f} B {tc.param_dtype} masters, bf16 "
              f"compute, "
              f"AdamW lr {TRAIN_LR:g}, remat) on {shape} in {TRAIN_MICRO} "
              f"microbatches: losses {', '.join(f'{x:.4f}' for x in losses)}; "
              f"step wall median {wall * 1e3:.1f} ms (first "
              f"{walls[0] * 1e3:.1f} ms), {tokens / wall:.1f} tokens/s, mfu "
              f"{mfu:.4f} (6 N tokens, {tokens} tokens a step), peak "
              f"{peak:.2f} GiB; flash_attention launches {flash} = "
              f"{1 + TRAIN_TIMED} x {TRAIN_MICRO} x {per_micro} x 2")
        del state, step, batch
        _free()
        # card vs CPU in fp32 at 2 full-width layers (phase 14's form)
        full = get_config(arch)
        small = full.with_overrides(num_layers=2, dtype="float32",
                                    encoder_layers=min(full.encoder_layers,
                                                       2))
        rec["parity"] = _train_parity(
            dev, "phase 26", small, TrainConfig(optimizer="adamw",
                                                lr=TRAIN_LR),
            make_batch(small, np.random.default_rng(26), 1, PARITY_TRAIN_SEQ),
            f", reduced: encoder_layers {full.encoder_layers} -> 2"
            if full.is_encoder_decoder else "", steps=2)
        out[arch] = rec
    return out


# --------------------------------------------------------------------------
# phase 27: bf16 masters and gradients, the cost model, the parameter server
# --------------------------------------------------------------------------

# phase 27: llava at full depth with the reference's bf16 pairing
# (launch/dryrun.py: bf16 masters and gradients with SGD at lr 1e-3), 1 + 3
# steps; (b) 2 full-width layers card vs CPU, 2 SGD steps; (d) the
# parameter server over MNIST-DNN
BF16_TRAIN_STEPS, BF16_LR, BF16_PARITY_STEPS = 3, 1e-3, 2
PS_WORKERS, PS_TICKS = 8, 64


def _ulps(a, b, start):
    """|a - b| in bf16 ulps (8 significant bits), the ulp at the largest
    of |a|, |b|, the entry's |start| and its tensor's largest move in
    ``b`` -- the bar of tests/test_torch_bf16_masters.py."""
    a, b, start = (t.detach().double().cpu() for t in (a, b, start))
    m = torch.maximum(torch.maximum(a.abs(), b.abs()), start.abs())
    m = torch.clamp(torch.maximum(m, (b - start).abs().max()), min=1e-38)
    return ((a - b).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7))


def _one_rank_world():
    """A world of one NCCL rank (the machine has one card) and its
    ("data",) mesh."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_dp_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    return make_dp_mesh(1)


def train_bf16_masters(dev):
    """Phase 27: (a) llava-next-mistral-7b at full width and depth with
    bf16 masters and gradients and SGD, 1 + 3 steps on phase 26's batch;
    (b) 2 of its layers at full width, fp32 compute on bf16 masters,
    card vs CPU; (c) zero3 with bf16 masters against flat over one NCCL
    rank at phase 18b's 4-layer qwen3; (d) the asynchronous parameter
    server on MNIST-DNN beside the synchronous step.  Each part is a
    function of its own, so nothing of one stays on the card in the
    next.  Returns the numbers."""
    from repro_torch.configs import get_config
    cfg = get_config("llava-next-mistral-7b")
    out = {"llava": _bf16_llava(dev, cfg)}
    _free()
    out["parity"] = _bf16_parity(dev, cfg)
    _free()
    out["zero3"] = _bf16_zero3(dev)
    _free()
    out["param_server"] = _param_server(dev)
    return out


def _bf16_llava(dev, cfg):
    """Phase 27a: ``cfg`` at full width and depth, bf16 masters and
    gradients, SGD, 1 + 3 steps on phase 26's batch."""
    from repro_torch.core import perf_model as pm
    from repro_torch.data import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, trainable)

    tc = TrainConfig(optimizer="sgd", lr=BF16_LR, microbatches=TRAIN_MICRO,
                     grad_dtype="bfloat16", param_dtype="bfloat16",
                     remat=True)
    batch = make_batch(cfg, np.random.default_rng(0), TRAIN_BATCH, TRAIN_SEQ)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, seed=0, device=dev)
    step, _ = make_train_step(cfg, tc)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    masters = trainable(state.params)
    n_params = sum(p.numel() for p in masters.values())
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, walls, between = [], [], []
    for _ in range(1 + BF16_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
        between.append(torch.cuda.memory_allocated())
    flash = launch_counts().get("flash_attention", 0)
    bwd = check_bwd("phase 27a", launch_counts(), (1 + BF16_TRAIN_STEPS)
                    * TRAIN_MICRO * cfg.num_layers)
    peak = torch.cuda.max_memory_allocated()
    want = (1 + BF16_TRAIN_STEPS) * TRAIN_MICRO * cfg.num_layers * 2
    if flash != want:
        fail(f"phase 27a: flash_attention launched {flash} times, expected "
             f"{want} = {1 + BF16_TRAIN_STEPS} x {TRAIN_MICRO} x "
             f"{cfg.num_layers} x 2 (forward + remat recompute)")
    if not all(np.isfinite(losses)):
        fail(f"phase 27a: losses {losses} are not finite")
    bad = [k for k, p in masters.items() if p.dtype != torch.bfloat16
           or p.grad is None or p.grad.dtype != torch.bfloat16]
    if bad:
        fail(f"phase 27a: masters or gradients not bf16 after a step: "
             f"{bad[:4]}")
    wall = float(np.median(walls[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_rep = pm.dp_memory_report(n_params, 0, 1, param_bytes=2,
                                    grad_bytes=2)
    rec = {
        "params": n_params, "layers": cfg.num_layers, "losses": losses,
        "init_s": init_s, "init_peak_gib": init_peak / 2**30,
        "step_ms": wall * 1e3, "step_walls_ms": [w * 1e3 for w in walls],
        "tokens_per_s": tokens / wall,
        "mfu": 6 * n_params * tokens / wall / PEAK_OPS[torch.bfloat16],
        "peak_gib": peak / 2**30, "between_steps_bytes": between,
        "model_bytes": model_rep["total_replicated"],
        "flash_launches": flash, "bwd_launches": bwd}
    print(f"phase 27a: {cfg.name} at full width and depth ({cfg.num_layers} "
          f"layers, {n_params / 1e9:.3f} B bf16 masters and gradients, SGD "
          f"lr {BF16_LR:g}, remat, initialised in {init_s:.1f} s, init peak "
          f"{rec['init_peak_gib']:.2f} GiB) on {tuple(batch['tokens'].shape)} "
          f"tokens + vision rows {tuple(batch['vision_embeds'].shape)} in "
          f"{TRAIN_MICRO} microbatches: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step wall median "
          f"{wall * 1e3:.1f} ms (first {walls[0] * 1e3:.1f} ms), "
          f"{rec['tokens_per_s']:.1f} tokens/s, mfu {rec['mfu']:.4f} (6 N "
          f"tokens / 989 TFLOP/s), peak {rec['peak_gib']:.2f} GiB; "
          f"flash_attention launches {flash} = {want}")
    print(f"phase 27a: bytes between steps {between[-1] / 1e9:.3f} GB "
          f"(memory_allocated) beside perf_model.dp_memory_report(N, 0, 1, "
          f"param_bytes=2, grad_bytes=2)'s replicated row "
          f"{rec['model_bytes'] / 1e9:.3f} GB (the model counts params "
          "and gradients only)")
    if peak >= 80e9:
        fail(f"phase 27a: peak {peak / 1e9:.1f} GB does not fit the card")
    return rec



def _bf16_parity(dev, cfg):
    """Phase 27b: 2 of ``cfg``'s layers at full width, fp32 compute on
    bf16 masters, SGD, card vs CPU within one bf16 ulp a step."""
    import copy
    from repro_torch.data import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model
    from repro_torch.train import (TrainConfig, make_train_step, start_state,
                                   trainable)

    small = cfg.with_overrides(num_layers=2, dtype="float32")
    ptc = TrainConfig(optimizer="sgd", lr=BF16_LR, param_dtype="bfloat16")
    pbatch = make_batch(small, np.random.default_rng(27), 1, PARITY_TRAIN_SEQ)
    m_card = init_model(small, seed=1, device=dev, train=True,
                        param_dtype=torch.bfloat16)
    start = {k: p.detach().cpu().clone()
             for k, p in trainable(m_card).items()}
    m_cpu = copy.deepcopy(m_card).cpu()
    got = {}
    for where, model in (("cpu", m_cpu), ("cuda", m_card)):
        pstep, popt = make_train_step(small, ptc)
        pstate = start_state(model, popt)
        reset_launch_counts()
        t0 = time.perf_counter()
        ls = []
        for _ in range(BF16_PARITY_STEPS):
            pstate, metrics = pstep(pstate, pbatch)
            ls.append(float(metrics["loss"]))
        got[where] = (ls, {k: p.detach().cpu()
                           for k, p in trainable(model).items()})
        print(f"  {where}: {BF16_PARITY_STEPS} steps in "
              f"{time.perf_counter() - t0:.1f} s, losses {ls}")
    pflash = launch_counts().get("flash_attention", 0)
    if pflash != BF16_PARITY_STEPS * small.num_layers * 2:
        fail(f"phase 27b: the card run launched flash_attention {pflash} "
             "times, not in every layer")
    check_bwd("phase 27b", launch_counts(),
              BF16_PARITY_STEPS * small.num_layers)
    (cpu_l, cpu_p), (card_l, card_p) = got["cpu"], got["cuda"]
    loss_gap = max(abs(a - b) for a, b in zip(cpu_l, card_l))
    worst = max(float(_ulps(card_p[k], cpu_p[k], start[k]).max())
                for k in cpu_p)
    equal = sum(int((card_p[k] == cpu_p[k]).sum()) for k in cpu_p)
    total = sum(v.numel() for v in cpu_p.values())
    if not loss_gap <= 1e-5:
        fail(f"phase 27b: card vs CPU losses differ by {loss_gap:.2e}")
    if not worst <= BF16_PARITY_STEPS:
        fail(f"phase 27b: a master differs card vs CPU by {worst:g} bf16 "
             f"ulps after {BF16_PARITY_STEPS} steps")
    print(f"phase 27b: 2-layer full-width {small.name} {small.layer_pattern()}"
          f", fp32 compute on bf16 masters, {BF16_PARITY_STEPS} SGD steps "
          f"(lr {BF16_LR:g}) on one sequence of {PARITY_TRAIN_SEQ} "
          f"positions, card vs CPU: losses within {loss_gap:.2e} (tol "
          f"1e-5), worst master {worst:g} bf16 ulps (tol "
          f"{BF16_PARITY_STEPS}, one a step), {equal / total:.6f} of "
          f"{total} masters bitwise equal; flash_attention {pflash}")
    return {"loss_gap": loss_gap, "worst_ulps": worst,
            "bitwise_share": equal / total, "launches": pflash}



def _bf16_zero3(dev):
    """Phase 27c: zero3 with bf16 masters against flat over one NCCL
    rank, phase 18b's 4-layer qwen3, AdamW."""
    import copy
    import torch.distributed as dist
    from repro_torch.api import Trainer
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig, get_strategy
    from repro_torch.core.train_state import host_params
    from repro_torch.data import make_batch
    from repro_torch.models import init_model
    from repro_torch.train import TrainConfig, trainable

    qcfg = get_config("qwen3-1.7b").with_overrides(num_layers=ZERO_LAYERS)
    qbatch = make_batch(qcfg, np.random.default_rng(0), TRAIN_BATCH,
                        TRAIN_SEQ)
    mesh = _one_rank_world()
    try:
        # drawn on the card, kept on the host: between steps the card
        # holds only the run's own state
        base = init_model(qcfg, seed=0, device=dev, train=True,
                          param_dtype=torch.bfloat16).cpu()
        qstart = {k: p.detach().clone() for k, p in trainable(base).items()}
        runs = {}
        for strategy in ("flat", "zero3"):
            t = Trainer.create(
                qcfg, params=copy.deepcopy(base), optimizer="adamw",
                lr=TRAIN_LR, dp=DPConfig(strategy=strategy,
                                         microbatches=TRAIN_MICRO),
                mesh=mesh, train_cfg=TrainConfig(remat=True), device=dev)
            ls, _, between, _, _ = _steps(t, qbatch, DP_STEPS, dev)
            n = t.describe()["params"]
            entry = get_strategy(strategy).memory_entry(
                n, t.optimizer.state_factor, 1, param_bytes=2, grad_bytes=2)
            runs[strategy] = {"losses": ls, "between_steps_bytes": between,
                              "memory_entry": entry,
                              "params": host_params(t.state, mesh)}
            del t
            _free()
        del base
    finally:
        dist.destroy_process_group()
    fl, z3 = runs["flat"], runs["zero3"]
    same = fl["losses"] == z3["losses"] and all(
        np.array_equal(fl["params"][k], z3["params"][k]) for k in fl["params"])
    worst = 0.0 if same else max(float(_ulps(
        torch.from_numpy(z3["params"][k]), torch.from_numpy(fl["params"][k]),
        qstart[k]).max()) for k in fl["params"])
    if not same and (worst > DP_STEPS or max(abs(a - b) for a, b in zip(
            fl["losses"], z3["losses"])) > ZERO_LOSS_TOL):
        fail(f"phase 27c: zero3 with bf16 masters differs from flat: losses "
             f"{z3['losses']} vs {fl['losses']}, worst {worst:g} ulps")
    for r in runs.values():
        del r["params"]
    for name, r in runs.items():
        e = r["memory_entry"]
        print(f"phase 27c ({name}): {qcfg.name} reduced: num_layers 28 -> "
              f"{ZERO_LAYERS}, bf16 masters, AdamW, {DP_STEPS} steps over one "
              f"NCCL rank: losses {r['losses']}; between steps "
              f"{r['between_steps_bytes'][-1] / 1e9:.3f} GB "
              f"(memory_allocated) beside memory_entry(param_bytes=2, "
              f"grad_bytes=2) params {e['params'] / 1e9:.3f} + grads "
              f"{e['grads'] / 1e9:.3f} + opt_state {e['opt_state'] / 1e9:.3f}"
              f" = {sum(e.values()) / 1e9:.3f} GB")
    print(f"phase 27c: zero3 vs flat with bf16 masters: "
          + ("losses and masters bitwise equal" if same else
             f"worst master {worst:g} bf16 ulps"))
    return {"bitwise": same, "worst_ulps": worst, **runs}


def _param_server(dev):
    """Phase 27d: the asynchronous parameter server on MNIST-DNN, 8
    workers over 64 ticks, and the synchronous steps (one worker) on the
    same stream."""
    from repro_torch import optim
    from repro_torch.configs.paper_nets import MNIST_DNN
    from repro_torch.core import make_ps_trainer
    from repro_torch.data import make_dataset
    from repro_torch.models import init_paper_net
    from repro_torch.train import cross_entropy

    ds = make_dataset(MNIST_DNN.dataset, n=PAPER_SAMPLES, as_images=True)
    x = torch.as_tensor(ds.x.reshape(PAPER_SAMPLES, -1), device=dev)
    y = torch.as_tensor(ds.y, device=dev)
    per = PAPER_SAMPLES // PS_TICKS
    ticks = (x.reshape(PS_TICKS, per, -1), y.reshape(PS_TICKS, per))
    net = init_paper_net(MNIST_DNN, seed=0, device=dev)
    names = [k for k, _ in net.named_parameters()]

    def ps_loss(p, b):
        return cross_entropy(torch.func.functional_call(
            _PaperLogits(MNIST_DNN, net), {f"net.{k}": p[k] for k in names},
            (b[0],)), b[1])

    res = {}
    for label, workers in (("async", PS_WORKERS), ("sync", 1)):
        opt = optim.sgd(0.1)
        params = {k: v.detach().clone() for k, v in net.named_parameters()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _, tick_losses = make_ps_trainer(ps_loss, opt, workers)(
            params, opt.init(params), ticks)
        final = float(ps_loss(params, (x, y)))
        res[label] = {"workers": workers, "first_tick_loss":
                      float(tick_losses[0]), "final_loss": final,
                      "wall_s": time.perf_counter() - t0}
    a, sq = res["async"], res["sync"]
    if not a["final_loss"] < a["first_tick_loss"]:
        fail(f"phase 27d: the async parameter server did not learn: final "
             f"loss {a['final_loss']:.4f}, first tick "
             f"{a['first_tick_loss']:.4f}")
    print(f"phase 27d: MNIST-DNN (Table-1 width) on phase 15's data, "
          f"{PS_TICKS} ticks of {per} samples, SGD lr 0.1 on the card: async "
          f"parameter server over {PS_WORKERS} workers final loss "
          f"{a['final_loss']:.4f} (first tick {a['first_tick_loss']:.4f}, "
          f"{a['wall_s']:.2f} s); synchronous sequential steps on the same "
          f"stream {sq['final_loss']:.4f} ({sq['wall_s']:.2f} s)")
    return res




class _PaperLogits(torch.nn.Module):
    """A Table-1 net's logits as a module, for ``functional_call``."""

    def __init__(self, spec, net):
        super().__init__()
        self.spec, self.net = spec, net

    def forward(self, x):
        from repro_torch.models import apply_paper_net
        return apply_paper_net(self.spec, self.net, x)

# --------------------------------------------------------------------------
# phase 28: the full-width configs on a (data, model) mesh
# --------------------------------------------------------------------------

def mesh_cfg(arch):
    """Phase 28's config of case ``arch`` ("arch" or "arch/seq"): full
    width, MESH_LAYERS layers, fp32; the MoE at MESH_CF."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch.split("/")[0]).with_overrides(
        num_layers=MESH_LAYERS,
                                          dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, capacity_factor=MESH_CF))
    return cfg


def one_device_tc(cfg, tc):
    """The one-device step phase 28 holds the mesh to: an MoE's aux is
    each data shard's own routing statistics on the mesh (the reference's
    expert-parallel aux), so the one device takes the batch as one
    microbatch a data shard, whose mean is the same objective."""
    import dataclasses
    return (tc if cfg.moe is None
            else dataclasses.replace(tc, microbatches=MESH_SHAPE[0]))


def mesh_steps(cfg, tc, mesh, dev, batch, steps):
    """``steps`` steps of ``cfg`` from seed 0 (on ``mesh``, or one device
    with ``mesh`` None): per step the loss, its ce and aux, the wall (the
    card synchronised), the flash launches and the bytes allocated after
    it; and the final masters, gathered whole."""
    import gc
    from repro_torch import bridge
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import (init_train_state, make_train_step,
                                   trainable)
    from repro_torch.models.layers import truncated_normal
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(cfg, tc, mesh=mesh, seed=0, device=dev)
    rec = {"init_peak_bytes": torch.cuda.max_memory_allocated(dev) - before,
           "init_bytes": torch.cuda.memory_allocated(dev) - before}
    # what drawing the largest leaf alone takes (the draw's temporaries)
    largest = max(p.numel() for p in trainable(state.params).values())
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    leaf = truncated_normal((largest,), 0.02, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    del leaf
    rec["draw_peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    step, _ = make_train_step(cfg, tc, mesh=mesh)
    rec.update({"losses": [], "ce": [], "aux": [], "walls_ms": [],
                "flash": [], "between_bytes": []})
    for _ in range(steps):
        torch.cuda.synchronize(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(dev)
        rec["walls_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["flash"].append(launch_counts().get("flash_attention", 0))
        check_bwd("a mesh step", launch_counts(), rec["flash"][-1] // 2
                  if tc.remat else rec["flash"][-1])
        rec["between_bytes"].append(torch.cuda.memory_allocated(dev) - before)
        for key in ("loss", "ce", "aux"):
            rec[key if key != "loss" else "losses"].append(float(m[key]))
    mixer = state.params.layers[0].mixer
    rec["heads"] = [int(getattr(mixer[k], "to_local", lambda: mixer[k])()
                        .shape[1]) for k in ("wq", "wk")]
    masters = bridge.gather_named(trainable(state.params))
    del state
    return rec, masters


def mesh_rank(outdir):
    """One of phase 28's gloo ranks (run by torchrun): each config of
    MESH_CASES on the (data 2, model 2) mesh; rank 0 then takes the same
    steps on one device and compares.  Rank 0 writes the numbers."""
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import init_from_env, make_serve_mesh
    from repro_torch.train import TrainConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh, dev = init_from_env("gloo", "cuda", mesh=lambda dt: make_serve_mesh(
        *MESH_SHAPE, device_type=dt))
    rank = dist.get_rank()
    res = {}
    for arch, (opt, steps, micro, rows) in MESH_CASES.items():
        cfg = mesh_cfg(arch)
        tc = TrainConfig(optimizer=opt, lr=MESH_LR, remat=True,
                         microbatches=micro)
        batch = make_batch(cfg, np.random.default_rng(28), rows, MESH_SEQ)
        got, full = mesh_steps(cfg, tc, mesh, dev, batch, steps)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, {k: got[k] for k in (
            "flash", "between_bytes", "walls_ms", "heads", "init_peak_bytes",
            "init_bytes", "draw_peak_bytes")})
        if rank == 0:
            one, ref = mesh_steps(cfg, one_device_tc(cfg, tc), None, dev,
                                  batch, steps)
            gap = max(float((full[k] - ref[k]).abs().max()) for k in ref)
            res[arch] = {"mesh": got, "one_device": one, "ranks": every,
                         "param_gap": gap, "n_params": sum(
                             int(t.numel()) for t in ref.values())}
            del ref
        del full
        dist.barrier()
    if rank == 0:
        with open(os.path.join(outdir, "ranks.json"), "w") as f:
            json.dump(res, f)
    serve_mesh_rank(mesh, dev, outdir)
    dist.barrier()
    dist.destroy_process_group()


def mesh_phases(dev):
    """Phases 28 and 29 (a) in one torchrun of this script over 4 gloo
    ranks sharing the card (``--mesh-rank``: training, then serving, on
    one (data 2, model 2) mesh), then each phase's checks and its one
    NCCL rank on a (1, 1) mesh."""
    import shutil
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    try:
        wall = run_ranks([os.path.abspath(__file__), "--mesh-rank", MESH_DIR],
                         MESH_SHAPE[0] * MESH_SHAPE[1], timeout=900,
                         module=False)
        got = {}
        for name in ("ranks", "serve_ranks"):
            with open(os.path.join(MESH_DIR, f"{name}.json")) as f:
                got[name] = json.load(f)
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    print(f"phases 28-29: torchrun {wall:.1f} s")
    return (train_mesh(dev, got["ranks"]),
            serve_mesh(dev, got["serve_ranks"]))


def train_mesh(dev, ranks):
    """Phase 28: (a) qwen3-1.7b and (b) deepseek-moe-16b (its layer 1 the
    expert-parallel MoE, all_to_all over "data") at full width on a
    (data 2, model 2) mesh of 4 gloo ranks sharing the card, held to the
    one-device step (``ranks``: what the ranks wrote); (a') qwen3 over
    one NCCL rank on a (1, 1) mesh, bitwise the one-device step."""
    import socket
    import torch.distributed as dist
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.train import TrainConfig
    out = {}
    for arch, r in ranks.items():
        cfg = mesh_cfg(arch)
        mesh, one = r["mesh"], r["one_device"]
        steps = len(one["losses"])
        micro = MESH_CASES[arch][2]
        want = steps * micro * cfg.num_layers * 2
        flash = [sum(rk["flash"]) for rk in r["ranks"]]
        if any(f != want for f in flash):
            fail(f"phase 28 ({arch}): flash_attention launched {flash} times "
                 f"on the ranks, expected {want} = {steps} steps x {micro} "
                 f"microbatches x {cfg.num_layers} layers x 2 (remat)")
        # each rank cut every leaf as it drew it: its peak while drawing
        # is its blocks (and moments) plus one whole leaf's draw
        peaks = [(rk["init_peak_bytes"], rk["init_bytes"]
                  + rk["draw_peak_bytes"] + MESH_INIT_SLACK)
                 for rk in r["ranks"]]
        if any(p > bound for p, bound in peaks):
            fail(f"phase 28 ({arch}): a rank's peak while drawing its mesh "
                 f"state exceeds its blocks plus one leaf's draw: {peaks}")
        gap = max(abs(a - b) for a, b in zip(mesh["losses"], one["losses"]))
        if gap > MESH_TOL or r["param_gap"] > MESH_TOL:
            fail(f"phase 28 ({arch}): mesh vs one device: losses "
                 f"{mesh['losses']} vs {one['losses']} ({gap:.2e}), params "
                 f"{r['param_gap']:.2e} (bar {MESH_TOL:g})")
        out[arch] = {"losses": mesh["losses"], "one_device_losses":
                     one["losses"], "loss_gap": gap, "aux": mesh["aux"],
                     "one_device_aux": one["aux"],
                     "param_gap": r["param_gap"], "flash_launches": flash,
                     "rank_heads": r["ranks"][0]["heads"],
                     "between_bytes": [rk["between_bytes"][-1]
                                       for rk in r["ranks"]],
                     "one_device_between_bytes": one["between_bytes"][-1],
                     "init_peak_bytes": [p for p, _ in peaks],
                     "init_peak_bound_bytes": [b for _, b in peaks],
                     "one_device_init_peak_bytes": one["init_peak_bytes"],
                     "walls_ms": [rk["walls_ms"] for rk in r["ranks"]],
                     "one_device_walls_ms": one["walls_ms"],
                     "n_params": r["n_params"]}
        h, hk = r["ranks"][0]["heads"]
        print(f"phase 28 ({arch}): full width, reduced: num_layers "
              f"{cfg.num_layers}, fp32, {steps} {MESH_CASES[arch][0]} steps "
              f"of {MESH_CASES[arch][3]} x {MESH_SEQ} tokens in {micro} "
              f"microbatch(es)"
              f"{', each row cut over data by sequence' if micro > 1 else ''}"
              f" on a (data "
              f"{MESH_SHAPE[0]}, model {MESH_SHAPE[1]}) mesh of 4 gloo ranks "
              f"sharing the card: losses {mesh['losses']} (one device "
              f"{one['losses']}{' in one microbatch a data shard' if cfg.moe else ''}"
              f"): gap {gap:.2e}, params {r['param_gap']:.2e} (bar "
              f"{MESH_TOL:g}); aux {mesh['aux']}; "
              f"flash_attention launches a rank {flash} on {h} q / {hk} kv "
              f"heads a rank")
        print(f"phase 28 ({arch}): bytes allocated between steps a rank "
              f"{', '.join(f'{b / 2**30:.2f}' for b in out[arch]['between_bytes'])}"
              f" GiB, the one-device state "
              f"{one['between_bytes'][-1] / 2**30:.2f} GiB; step walls a rank "
              f"{', '.join(f'{w:.0f}' for w in r['ranks'][0]['walls_ms'])} ms "
              "(gloo staged through host memory on one card, not a "
              "cross-card number), one device "
              f"{', '.join(f'{w:.0f}' for w in one['walls_ms'])} ms")
        print(f"phase 28 ({arch}): peak while drawing the mesh state a rank "
              f"{', '.join(f'{p / 2**30:.2f}' for p, _ in peaks)} GiB (bound: "
              f"its blocks and moments plus one leaf's draw, "
              f"{', '.join(f'{b / 2**30:.2f}' for _, b in peaks)} GiB); the "
              f"one-device state's {one['init_peak_bytes'] / 2**30:.2f} GiB")

    # (a') one NCCL rank on a (1, 1) mesh: bitwise the one-device step
    arch = "qwen3-1.7b"
    cfg = mesh_cfg(arch)
    opt, steps, _, _ = MESH_CASES[arch]
    tc = TrainConfig(optimizer=opt, lr=MESH_LR, remat=True)
    batch = make_batch(cfg, np.random.default_rng(28), MESH_BATCH, MESH_SEQ)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_serve_mesh(1, 1, device_type="cuda")
        got, full = mesh_steps(cfg, tc, mesh, dev, batch, steps)
        one, ref = mesh_steps(cfg, tc, None, dev, batch, steps)
    finally:
        dist.destroy_process_group()
    want = cfg.num_layers * 2
    if got["flash"] != [want] * steps:
        fail(f"phase 28 (a'): flash_attention launched {got['flash']} times "
             f"a step on the NCCL rank, expected {want} = {cfg.num_layers} "
             "layers x 2 (remat)")
    same = got["losses"] == one["losses"] and all(
        torch.equal(full[k], ref[k]) for k in ref)
    if not same:
        fail(f"phase 28 (a'): one NCCL rank on a (1, 1) mesh: losses "
             f"{got['losses']} vs one device {one['losses']}, not bitwise")
    del full, ref
    torch.cuda.empty_cache()
    out["nccl_1x1"] = {"losses": got["losses"], "flash_launches": got["flash"],
                       "walls_ms": got["walls_ms"]}
    print(f"phase 28 (a'): {arch} over one NCCL rank on a (1, 1) mesh, "
          f"{steps} {opt} steps: losses {got['losses']} == the one-device "
          f"step's, masters bitwise; flash_attention launches {got['flash']}")
    return out



# --------------------------------------------------------------------------
# phase 29: serving on a (data, model) mesh
# --------------------------------------------------------------------------

def serve_mesh_cfg(arch, layers=None):
    from repro_torch.configs import get_config
    return get_config(arch).with_overrides(
        num_layers=layers or SERVE_MESH_LAYERS[arch], dtype="float32")


def serve_mesh_prompts(cfg):
    rng = np.random.default_rng(29)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in SERVE_MESH_LENS]


def serve_mesh_rank_heads(cfg, model=MESH_SHAPE[1]):
    """(q heads, kv heads) a rank's attention kernel sees on a mesh of
    ``model``: both cut over "model", or every kv head where they do not
    divide (the pool cut on head_dim, gathered before the kernel)."""
    hk = cfg.num_kv_heads
    return cfg.num_heads // model, hk // model if hk % model == 0 else hk


def serve_mesh_rank_cases():
    """Phase 2's paged cases at phase 29's per-rank forms: a decode step
    of its slots mid-generation and a prefill chunk."""
    lens = np.array(SERVE_MESH_LENS)
    return [(f"decode B={len(lens)} S=1, phase 29's slots", len(lens), 1, 0,
             lens + SERVE_MESH_NEW // 2, 128),
            (f"prefill chunk B=1 S={PREFILL_CHUNK}", 1, PREFILL_CHUNK, 0,
             np.array([3 * PREFILL_CHUNK]), 128)]


def serve_mesh_slab_cases():
    """Phase 2's flash cases at phase 29's lockstep per-rank form."""
    B = SERVE_MESH_SLAB_BATCH // MESH_SHAPE[0]
    S, L = SERVE_MESH_SLAB_PROMPT, SERVE_MESH_SLAB_PROMPT + SERVE_MESH_NEW
    return [(f"mesh rank prefill B={B} S=T={S}", B, S, S, S),
            (f"mesh rank decode B={B} S=1 T={S + SERVE_MESH_NEW // 2} (slab "
             "slice)", B, 1, S + SERVE_MESH_NEW // 2, L)]


@contextlib.contextmanager
def recorded_logits(module, *names):
    """Every logits tensor handed to ``module``'s samplers ``names`` while
    the block runs, copied, in call order."""
    logits = []
    plain = [getattr(module, n) for n in names]

    def keep(fn):
        def rec(lg, *a, **k):
            logits.append(lg.detach().clone())
            return fn(lg, *a, **k)
        return rec

    for n, fn in zip(names, plain):
        setattr(module, n, keep(fn))
    try:
        yield logits
    finally:
        for n, fn in zip(names, plain):
            setattr(module, n, fn)


def serve_recorded(cfg, model, prompts, mesh=None):
    """The continuous scheduler over ``prompts`` (on ``mesh``, or one
    device), greedy; returns (scheduler, tokens, the logits of every
    sample in call order, the paged_flash_decode launches, wall ms)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ContinuousScheduler
    from repro_torch.serve import scheduler as sched_lib
    with recorded_logits(sched_lib, "sample", "masked_sample") as logits:
        sch = ContinuousScheduler(
            cfg, model, slots=len(prompts), max_len=SERVE_MESH_MAX_LEN,
            page_size=PAGE_SIZE, decode_chunk=DECODE_CHUNK,
            prefill_chunk=PREFILL_CHUNK, mesh=mesh)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = sch.generate(prompts, SERVE_MESH_NEW)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = launch_counts().get("paged_flash_decode", 0)
    return sch, outs, logits, launches, wall


def slab_recorded(cfg, model, prompts, mesh=None):
    """The lockstep ``ServeEngine`` over the (B, S) ``prompts`` (on
    ``mesh``, or one device), greedy; returns (tokens, the logits of
    every sample, the flash_attention launches, wall ms)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import engine as engine_lib
    with recorded_logits(engine_lib, "sample") as logits:
        eng = ServeEngine(cfg, model, batch_size=len(prompts),
                          max_len=prompts.shape[1] + SERVE_MESH_NEW,
                          mesh=mesh)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = eng.generate(prompts, SERVE_MESH_NEW)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = launch_counts().get("flash_attention", 0)
    return outs.tolist(), logits, launches, wall


def logit_gap(logits, ref_logits):
    return max(float((a - b).abs().max()) for a, b in zip(logits, ref_logits))


def serve_mesh_rank(mesh, dev, outdir):
    """Phase 29 (a) on one of the ranks of ``mesh_rank``: each config of
    SERVE_MESH_LAYERS served on the (data 2, model 2) mesh by the
    continuous scheduler, then qwen3 by the lockstep engine, the weights
    drawn straight to the rank's blocks; rank 0 then serves the same
    weights drawn whole on one device and compares.  Rank 0 writes the
    numbers."""
    import torch.distributed as dist
    from repro_torch.bridge import mesh_placer
    from repro_torch.models import init_model
    rank = dist.get_rank()
    res = {}
    for arch in SERVE_MESH_LAYERS:
        cfg = serve_mesh_cfg(arch)
        prompts = serve_mesh_prompts(cfg)
        model = init_model(cfg, seed=0, device=dev,
                           place=mesh_placer(cfg, mesh, mode="serve"))
        sch, outs, logits, launches, wall = serve_recorded(cfg, model,
                                                           prompts, mesh)
        st = sch.stats()
        mine = {"launches": launches, "wall_ms": wall,
                "model_calls": st["prefill_dispatches"] + DECODE_CHUNK
                * st["decode_dispatches"],
                "heads": [int(model.layers[0].mixer[k].to_local().shape[1])
                          for k in ("wq", "wk")],
                "split": dict(sch.kv.cache[0].split),
                "tokens": [o.tolist() for o in outs]}
        per = sch.kv.pool_bytes_by_device()
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        if rank == 0:
            del sch, model
            torch.cuda.empty_cache()
            one = init_model(cfg, seed=0, device=dev)
            sch1, ref, ref_logits, ref_launches, ref_wall = serve_recorded(
                cfg, one, prompts)
            res[arch] = {"ranks": every, "pool_bytes": st["pool_bytes"],
                         "pool_bytes_by_rank": list(per.values()),
                         "one_device_tokens": [o.tolist() for o in ref],
                         "one_device_launches": ref_launches,
                         "one_device_wall_ms": ref_wall,
                         "samples": len(logits),
                         "one_device_samples": len(ref_logits),
                         "logit_gap": logit_gap(logits, ref_logits),
                         "logit_max": max(float(lg.abs().max())
                                          for lg in ref_logits),
                         "top2_margin_min": min(float(
                             (lg.topk(2, dim=-1).values[..., 0]
                              - lg.topk(2, dim=-1).values[..., 1]).min())
                             for lg in ref_logits)}
            del sch1, one, ref_logits
        del logits
        torch.cuda.empty_cache()
        dist.barrier()
    # the lockstep slab engine: each data replica its rows, the slab
    # gathered over "model" a layer, the flash kernel on the rank's heads
    cfg = serve_mesh_cfg("qwen3-1.7b", SERVE_MESH_SLAB_LAYERS)
    prompts = np.random.default_rng(29).integers(
        0, cfg.vocab_size, (SERVE_MESH_SLAB_BATCH, SERVE_MESH_SLAB_PROMPT)
    ).astype(np.int32)
    model = init_model(cfg, seed=0, device=dev,
                       place=mesh_placer(cfg, mesh, mode="serve"))
    outs, logits, launches, wall = slab_recorded(cfg, model, prompts, mesh)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {"tokens": outs, "launches": launches,
                                   "wall_ms": wall})
    del model
    torch.cuda.empty_cache()
    if rank == 0:
        ref, ref_logits, ref_launches, ref_wall = slab_recorded(
            cfg, init_model(cfg, seed=0, device=dev), prompts)
        res["lockstep"] = {"ranks": every, "one_device_tokens": ref,
                           "one_device_launches": ref_launches,
                           "one_device_wall_ms": ref_wall,
                           "samples": len(logits),
                           "one_device_samples": len(ref_logits),
                           "logit_gap": logit_gap(logits, ref_logits)}
        del ref_logits
    del logits
    torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(outdir, "serve_ranks.json"), "w") as f:
            json.dump(res, f)


def serve_mesh(dev, ranks):
    """Phase 29: (a) qwen3-1.7b, deepseek-moe-16b and granite-20b (the
    head_dim fallback) served at full width by the continuous scheduler
    on a (data 2, model 2) mesh of 4 gloo ranks sharing the card, tokens
    equal to the one-device engine's and logits within 1e-5 (granite's
    within 1e-5 of its largest |logit|), each rank's
    pool half the pool, each rank's paged_flash_decode launches exactly
    layers x model calls on its own heads; then qwen3 by the lockstep
    engine, each rank's flash_attention launches exactly layers x
    samples; (b) qwen3 over one NCCL rank on a (1, 1) mesh, logits and
    tokens bitwise the one-device engine's.  ``ranks``: what (a)'s ranks
    wrote.  Returns {arch: the numbers}."""
    import socket
    import torch.distributed as dist
    from repro_torch.bridge import mesh_placer
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import init_model
    card = card_line()
    out = {}

    def same_as_one_device(tag, r, bar=SERVE_MESH_TOL):
        ref = r["one_device_tokens"]
        toks = [rk["tokens"] for rk in r["ranks"]]
        if any(t != ref for t in toks):
            fail(f"phase 29 ({tag}): mesh tokens {toks} differ from the "
                 f"one-device engine's {ref}")
        if r["samples"] != r["one_device_samples"] or r["logit_gap"] > bar:
            fail(f"phase 29 ({tag}): mesh vs one-device logits differ by "
                 f"{r['logit_gap']:.2e} over {r['samples']} / "
                 f"{r['one_device_samples']} samples (bar {bar:.2e})")

    for arch in SERVE_MESH_LAYERS:
        r = ranks[arch]
        cfg = serve_mesh_cfg(arch)
        fallback = cfg.num_kv_heads % MESH_SHAPE[1] != 0
        bar = (SERVE_MESH_FALLBACK_RTOL * max(1.0, r["logit_max"])
               if fallback else SERVE_MESH_TOL)
        same_as_one_device(arch, r, bar)
        half = r["pool_bytes"] // MESH_SHAPE[1]
        if r["pool_bytes_by_rank"] != [half] * len(r["ranks"]):
            fail(f"phase 29 ({arch}): pool bytes a rank "
                 f"{r['pool_bytes_by_rank']}, expected {half} = the "
                 f"{r['pool_bytes']}-byte pool / {MESH_SHAPE[1]}")
        launches = [rk["launches"] for rk in r["ranks"]]
        want = [cfg.num_layers * rk["model_calls"] for rk in r["ranks"]]
        if launches != want or r["one_device_launches"] != want[0]:
            fail(f"phase 29 ({arch}): paged_flash_decode launched "
                 f"{launches} times on the ranks ({r['one_device_launches']}"
                 f" on one device), expected layers x model calls {want}")
        h, hk = r["ranks"][0]["heads"]
        if (h, hk) != serve_mesh_rank_heads(cfg):
            fail(f"phase 29 ({arch}): a rank holds {h} q / {hk} kv heads")
        split = {"k": 2, "v": 2} if fallback else {"k": 1, "v": 1}
        if any(rk["split"] != split for rk in r["ranks"]):
            fail(f"phase 29 ({arch}): the pool is cut on dims "
                 f"{[rk['split'] for rk in r['ranks']]}, expected {split}")
        out[arch] = {"layers": cfg.num_layers, "launches": launches,
                     "model_calls": r["ranks"][0]["model_calls"],
                     "rank_heads": [h, hk], "pool_split": split,
                     "logit_gap": r["logit_gap"], "logit_bar": bar,
                     "logit_max": r["logit_max"],
                     "top2_margin_min": r["top2_margin_min"],
                     "pool_bytes": r["pool_bytes"],
                     "pool_bytes_by_rank": r["pool_bytes_by_rank"],
                     "walls_ms": [rk["wall_ms"] for rk in r["ranks"]],
                     "one_device_wall_ms": r["one_device_wall_ms"],
                     "card": card}
        cut = ("the pool cut on head_dim (1 kv head does not divide model "
               f"{MESH_SHAPE[1]}), the slots' pages gathered before the "
               "kernel" if fallback else "the pool cut on kv heads")
        print(f"phase 29 ({arch}) [{card}]: full width, {cfg.num_layers} "
              f"layers, fp32, {len(SERVE_MESH_LENS)} prompts of "
              f"{SERVE_MESH_LENS} tokens x {SERVE_MESH_NEW} greedy tokens on "
              f"a (data {MESH_SHAPE[0]}, model {MESH_SHAPE[1]}) mesh of 4 "
              f"gloo ranks sharing the card, {cut}: tokens == the "
              f"one-device engine's, logits within {r['logit_gap']:.2e} (bar "
              f"{bar:.2e}{', relative' if fallback else ''}; largest "
              f"|logit| {r['logit_max']:.3f}; smallest top-2 margin "
              f"{r['top2_margin_min']:.2e}); paged_flash_decode launches a "
              f"rank {launches} = {cfg.num_layers} layers x "
              f"{r['ranks'][0]['model_calls']} model calls on {h} q / {hk} "
              f"kv heads a rank; pool bytes a rank "
              f"{r['pool_bytes_by_rank']} of {r['pool_bytes']}; serve walls "
              f"a rank {[round(w) for w in out[arch]['walls_ms']]} ms (gloo "
              f"staged through host memory on one card, not a cross-card "
              f"number), one device {r['one_device_wall_ms']:.0f} ms")

    # (a) the lockstep slab engine
    r = ranks["lockstep"]
    same_as_one_device("lockstep", r)
    launches = [rk["launches"] for rk in r["ranks"]]
    want = SERVE_MESH_SLAB_LAYERS * SERVE_MESH_NEW
    if launches != [want] * len(launches) or r["one_device_launches"] != want:
        fail(f"phase 29 (lockstep): flash_attention launched {launches} times "
             f"on the ranks ({r['one_device_launches']} on one device), "
             f"expected layers x samples {want}")
    out["lockstep"] = {"layers": SERVE_MESH_SLAB_LAYERS, "launches": launches,
                       "logit_gap": r["logit_gap"],
                       "walls_ms": [rk["wall_ms"] for rk in r["ranks"]],
                       "one_device_wall_ms": r["one_device_wall_ms"],
                       "card": card}
    print(f"phase 29 (lockstep) [{card}]: qwen3-1.7b at "
          f"{SERVE_MESH_SLAB_LAYERS} full-width fp32 layers through "
          f"ServeEngine(mesh=), {SERVE_MESH_SLAB_BATCH} prompts of "
          f"{SERVE_MESH_SLAB_PROMPT} tokens x {SERVE_MESH_NEW} greedy tokens, "
          f"{SERVE_MESH_SLAB_BATCH // MESH_SHAPE[0]} rows a data replica, the "
          f"slab gathered over model a layer: tokens == the one-device "
          f"engine's, logits within {r['logit_gap']:.2e}; flash_attention "
          f"launches a rank {launches} = {SERVE_MESH_SLAB_LAYERS} layers x "
          f"{SERVE_MESH_NEW} model calls on "
          f"{serve_mesh_rank_heads(serve_mesh_cfg('qwen3-1.7b', 1))} heads; "
          f"walls a rank {[round(w) for w in out['lockstep']['walls_ms']]} "
          f"ms, one device {r['one_device_wall_ms']:.0f} ms")

    # (b) one NCCL rank on a (1, 1) mesh: bitwise the one-device engine
    arch = "qwen3-1.7b"
    cfg = serve_mesh_cfg(arch, SERVE_MESH_NCCL_LAYERS)
    prompts = serve_mesh_prompts(cfg)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_serve_mesh(1, 1, device_type="cuda")
        _, ref, ref_logits, ref_launches, _ = serve_recorded(
            cfg, init_model(cfg, seed=0, device=dev), prompts)
        _, got, logits, launches, _ = serve_recorded(
            cfg, init_model(cfg, seed=0, device=dev, place=mesh_placer(
                cfg, mesh, mode="serve")), prompts, mesh)
    finally:
        dist.destroy_process_group()
    same = (len(logits) == len(ref_logits)
            and all(torch.equal(a, b) for a, b in zip(logits, ref_logits))
            and all(np.array_equal(a, b) for a, b in zip(got, ref)))
    if not same or launches != ref_launches:
        fail(f"phase 29 (b): one NCCL rank on a (1, 1) mesh: tokens {got} "
             f"vs {ref}, logits bitwise {same}, launches {launches} vs "
             f"{ref_launches}")
    del logits, ref_logits
    torch.cuda.empty_cache()
    out["nccl_1x1"] = {"layers": cfg.num_layers, "launches": launches,
                       "samples": len(ref), "card": card}
    print(f"phase 29 (b) [{card}]: {arch} at {cfg.num_layers} full-width "
          f"fp32 layers over one NCCL rank on a (1, 1) mesh: logits and "
          f"tokens bitwise the one-device engine's; paged_flash_decode "
          f"launches {launches} (one device {ref_launches})")
    return out


# --------------------------------------------------------------------------
# phase 30: the dry run's count of phase 13's step, against phase 13
# --------------------------------------------------------------------------

def dryrun_phase13(train_out):
    """Phase 30: ``launch.dryrun``'s count of phase 13's own step --
    full-width, full-depth qwen3-1.7b, TRAIN_BATCH x TRAIN_SEQ tokens in
    TRAIN_MICRO microbatches, remat, AdamW on fp32 masters -- on the meta
    device over a one-rank mesh of PyTorch's fake process group, in
    this process; its predicted peak held to phase 13's measured one
    within DRYRUN_PEAK_BAND, its FLOPs beside phase 13's 6 N tokens, its
    roofline on ``H100_SXM`` beside phase 13's step wall, and
    ``H100_SXM``'s memory held to the card's within DRYRUN_MEM_TOL."""
    import torch.distributed as dist
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import init_model
    from repro_torch.roofline.analysis import H100_SXM, HW, roofline_terms
    from repro_torch.roofline.cost import count
    from repro_torch.train import TrainConfig
    card = card_line()
    total = torch.cuda.get_device_properties(0).total_memory
    mem_gap = abs(H100_SXM.hbm_bytes - total) / total
    if mem_gap > DRYRUN_MEM_TOL:
        fail(f"phase 30: H100_SXM's memory {H100_SXM.hbm_bytes} B differs "
             f"from the card's {total} B by {mem_gap:.2%} > "
             f"{DRYRUN_MEM_TOL:.0%}")
    cfg = get_config("qwen3-1.7b")
    tc = TrainConfig(optimizer="adamw", lr=TRAIN_LR, microbatches=TRAIN_MICRO,
                     remat=True)
    shape = InputShape("phase13", TRAIN_SEQ, TRAIN_BATCH, "train")
    # one rank holds every block: its count is the one-device count too
    dryrun.fake_world(1)
    try:
        t0 = time.perf_counter()
        fn, args = dryrun.build_step(cfg, tc, shape, make_serve_mesh(
            1, 1, device_type="cpu"))
        _, c = count(fn, *args)
        del fn, args
        count_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    rec = {"peak_bytes": c["peak_bytes"], "flops_global": c["flops"],
           "dot_bytes_global": c["dot_bytes"],
           "collective_bytes": c["collective_bytes"],
           "argument_size_in_bytes": c["argument_bytes"], "count_s": count_s}
    measured = train_out["peak_gib"] * 2**30
    ratio = rec["peak_bytes"] / measured
    n = sum(p.numel() for p in init_model(cfg, device="meta", train=True)
            .parameters() if p.requires_grad)
    useful = 6 * n * TRAIN_BATCH * TRAIN_SEQ / rec["flops_global"]
    terms = roofline_terms(rec, HW(chips=1))
    dominant = max(("t_compute", "t_memory", "t_collective"),
                   key=terms.get)[2:]
    out = {"predicted_peak_gib": rec["peak_bytes"] / 2**30,
           "measured_peak_gib": train_out["peak_gib"], "peak_ratio": ratio,
           "flops": rec["flops_global"], "useful_ratio": useful,
           "t_compute_ms": terms["t_compute"] * 1e3,
           "t_memory_ms": terms["t_memory"] * 1e3, "dominant": dominant,
           "step_ms": train_out["step_ms"], "count_s": rec["count_s"],
           "card_memory_bytes": total, "h100_sxm_bytes": H100_SXM.hbm_bytes,
           "argument_bytes": rec["argument_size_in_bytes"]}
    print(f"phase 30: the dry run's count of phase 13's step (meta device, "
          f"one-rank fake mesh, {rec['count_s']:.1f} s on the host) on "
          f"{card}: predicted peak {out['predicted_peak_gib']:.2f} GiB "
          f"(arguments {rec['argument_size_in_bytes'] / 2**30:.2f} GiB) vs "
          f"phase 13's measured {train_out['peak_gib']:.2f} GiB: ratio "
          f"{ratio:.4f} (band {DRYRUN_PEAK_BAND})")
    print(f"phase 30: counted {rec['flops_global']:.4e} FLOP a step vs 6 N "
          f"tokens = {6 * n * TRAIN_BATCH * TRAIN_SEQ:.4e} (N = {n}): useful "
          f"ratio {useful:.4f}; on {card}")
    print(f"phase 30: roofline on H100_SXM (989 TFLOP/s bf16, 3.35 TB/s): "
          f"t_compute {out['t_compute_ms']:.1f} ms, t_memory "
          f"{out['t_memory_ms']:.1f} ms, dominant {dominant}, vs phase 13's "
          f"step wall {train_out['step_ms']:.1f} ms; H100_SXM memory "
          f"{H100_SXM.hbm_bytes} B vs the card's {total} B ({mem_gap:.2%}); "
          f"on {card}")
    if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
        fail(f"phase 30: predicted peak {out['predicted_peak_gib']:.2f} GiB "
             f"is {ratio:.3f}x phase 13's measured {train_out['peak_gib']:.2f}"
             f" GiB, outside {DRYRUN_PEAK_BAND}")
    return out


# --------------------------------------------------------------------------
# phase 31: kernels/ops.py on the card -- the flash block surface, the
# impl dispatch, --decode-kernel and the examples
# --------------------------------------------------------------------------

# (a)'s shapes at qwen3-1.7b's 16 q / 8 kv heads of 128: name, B, S, T
BLOCK_SHAPES = [
    (f"slab prefill B={LEGACY_BATCH} S=T={LEGACY_PROMPT}", LEGACY_BATCH,
     LEGACY_PROMPT, LEGACY_PROMPT),
    (f"slab decode B={LEGACY_BATCH} S=1 T={LEGACY_PROMPT + NEW_TOKENS}",
     LEGACY_BATCH, 1, LEGACY_PROMPT + NEW_TOKENS),
    (f"train forward B=1 S=T={TRAIN_SEQ}", 1, TRAIN_SEQ, TRAIN_SEQ),
]
# (c): the serve launcher at full width, fp32, cut to this many layers
CLI_LAYERS, CLI_REQUESTS, CLI_NEW = 4, 4, 16


def flash_block_sweep(dev, flush):
    """(a) The flash kernel at every block shape it is built for
    (``block_choices``: the plan, each block_q, each split count),
    set through ``ops.set_flash_blocks`` and read by the launch, in
    fp32 and bf16 at BLOCK_SHAPES: each held against the plain version
    at phase 2's bars and timed as phase 2 times (median of 10 after an
    L2 flush), beside the plan's time, the plain version's, SDPA's and
    the bound.  A shape slower than the plan's is kept and marked."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (block_choices,
                                                     flash_attention,
                                                     flash_attention_ref,
                                                     launch_layout)

    rng = np.random.default_rng(31)
    h, hk, hd = 16, 8, 128
    rows = []
    for name, B, S, T in BLOCK_SHAPES:
        host = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for shape in ((B, S, h, hd), (B, T, hk, hd),
                                               (B, T, hk, hd))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in host)
            want = flash_attention_ref(q, k, v).float()
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            causal = S == T
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            common = {
                "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v),
                                    flush),
                "library_ms": time_ms(sdpa, flush),
                "sdpa_backend": sdpa_backend(qt, kt, vt, None, 0.0, causal,
                                             enable_gqa=True),
                **bound_of(*flash_bound(B, S, T, h, hk, hd, True, 0,
                                        q.element_size()), dtype)}
            plan_ms = None
            for block_q, block_kv in block_choices(dtype, T):
                prev = ops.set_flash_blocks(block_q, block_kv)
                try:
                    layout = launch_layout(dtype, B, S, T, h, hk, block_q,
                                           block_kv)
                    got = flash_attention(q, k, v)
                    torch.cuda.synchronize()
                    err = (got.float() - want).abs().max().item()
                    if not torch.allclose(got.float(), want,
                                          atol=TOL[dtype], rtol=TOL[dtype]):
                        fail(f"phase 31 (a): flash_attention {name} {dtype} "
                             f"blocks ({block_q}, {block_kv}): max |err| "
                             f"{err}")
                    ms = time_ms(lambda: flash_attention(q, k, v), flush)
                finally:
                    ops.set_flash_blocks(*prev)
                plan_ms = ms if block_q is None and block_kv is None \
                    else plan_ms
                row = {"case": name, "dtype": str(dtype)[6:],
                       "block_q": block_q, "block_kv": block_kv,
                       "layout": list(layout), "max_abs_err": err,
                       "tol": TOL[dtype], "ms": ms, "plan_ms": plan_ms,
                       "slower_than_plan": ms > plan_ms, **common}
                rows.append(row)
                slower = "  (slower than the plan)" if ms > plan_ms else ""
                print(f"  phase 31 (a): {name:28s} {row['dtype']:8s} blocks "
                      f"({block_q}, {block_kv}) layout {tuple(layout)}: "
                      f"{ms:.4f} ms, err {err:.2e} (tol {TOL[dtype]:g})"
                      f"{slower}")
            print(f"  phase 31 (a): {name} {str(dtype)[6:]}: plain "
                  f"{common['plain_ms']:.4f} ms, sdpa "
                  f"{common['library_ms']:.4f} ms ({common['sdpa_backend']})"
                  f", bound {common['bound_ms']:.4f} ms "
                  f"({common['bound_by']})")
    return rows


def ops_impls(dev):
    """(b) ``ops.flash_attention`` / ``wkv6`` / ``mamba_scan`` on CUDA
    tensors, fp32, at a slab decode step, an RWKV-6 prefill chunk and a
    Jamba one: "auto" and "cuda" launch the kernel once, "ref" and
    "chunked" launch nothing; every output within phase 2's bars of the
    plain version's."""
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.mamba_scan import mamba_ref
    from repro_torch.kernels.wkv6 import wkv6_chunked

    rng = np.random.default_rng(32)

    def on(*xs):
        return [torch.from_numpy(x).to(dev) for x in xs]

    q, k, v = on(*(rng.standard_normal(s).astype(np.float32) for s in (
        (LEGACY_BATCH, 1, 16, 128), (LEGACY_BATCH, 300, 8, 128),
        (LEGACY_BATCH, 300, 8, 128))))
    wkv = on(*wkv_case(rng, 1, PREFILL_CHUNK, 32, 64, 0))
    x, dt, A, proj, D, h0 = on(*mamba_case(rng, 1, PREFILL_CHUNK, 8192, 16))
    Bm, Cm = proj[..., 256:272], proj[..., 272:288]
    mamba = (x, dt, A, Bm, Cm, D, h0)
    cases = {
        "flash_attention": (lambda impl: ops.flash_attention(
            q, k, v, impl=impl), lambda: flash_attention_ref(q, k, v),
            TOL[torch.float32]),
        "wkv6": (lambda impl: ops.wkv6(*wkv, impl=impl),
                 lambda: wkv6_chunked(*wkv), WKV_ATOL),
        "mamba_scan": (lambda impl: ops.mamba_scan(*mamba, impl=impl),
                       lambda: mamba_ref(*mamba), MAMBA_ATOL),
    }
    out = {}
    for name, (run, plain, tol) in cases.items():
        want = plain()
        want = want[0] if isinstance(want, tuple) else want
        out[name] = {}
        for impl in ("auto", "cuda", "ref", "chunked"):
            reset_launch_counts()
            got = run(impl)
            got = got[0] if isinstance(got, tuple) else got
            torch.cuda.synchronize()
            launches = launch_counts().get(name, 0)
            expect = 1 if impl in ("auto", "cuda") else 0
            err = (got.float() - want.float()).abs().max().item()
            if launches != expect or sum(launch_counts().values()) != expect:
                fail(f"phase 31 (b): ops.{name}(impl={impl!r}) launched "
                     f"{launch_counts()}, expected {expect} {name}")
            if not err <= tol:
                fail(f"phase 31 (b): ops.{name}(impl={impl!r}) differs from "
                     f"the plain version by {err} (tol {tol:g})")
            out[name][impl] = {"launches": launches, "max_abs_err": err}
        print(f"phase 31 (b): ops.{name} on CUDA tensors: launches "
              + ", ".join(f"{i} {r['launches']}" for i, r in
                          out[name].items())
              + "; max |err| vs the plain version "
              + ", ".join(f"{r['max_abs_err']:.1e}" for r in
                          out[name].values()) + f" (tol {tol:g})")
    return out


def serve_decode_kernels(dev):
    """(c) ``launch.serve`` (its ``main``, as ``python -m`` runs it) at
    full-width qwen3-1.7b cut to CLI_LAYERS layers, fp32 with TF32 off,
    CLI_REQUESTS requests x CLI_NEW greedy tokens, with --decode-kernel
    cuda and plain: the tokens bitwise equal, paged launches layers x
    model calls under cuda and 0 under plain, each report line naming
    its kernel."""
    import io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as serve_cli

    argv = ["--arch", "qwen3-1.7b", "--dtype", "float32", "--layers",
            str(CLI_LAYERS), "--batch", str(CLI_REQUESTS), "--requests",
            str(CLI_REQUESTS), "--new-tokens", str(CLI_NEW), "--report"]
    outs, res = {}, {}
    for kernel in ("cuda", "plain"):
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            outs[kernel] = serve_cli.main(argv + ["--decode-kernel", kernel])
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        m = re.search(r"report: decode_kernel=(\w+) prefill (\d+) "
                      r"dispatches .* decode (\d+) dispatches", text)
        if m is None or m.group(1) != kernel:
            fail(f"phase 31 (c): --decode-kernel {kernel}: the report line "
                 f"does not name it: {text[-400:]}")
        calls = int(m.group(2)) + 8 * int(m.group(3))  # launcher's chunk 8
        paged = launch_counts().get("paged_flash_decode", 0)
        want = CLI_LAYERS * calls if kernel == "cuda" else 0
        if paged != want:
            fail(f"phase 31 (c): --decode-kernel {kernel} launched "
                 f"paged_flash_decode {paged} times, expected {want}")
        res[kernel] = {"paged_flash_decode_launches": paged,
                       "model_calls": calls, "wall_s": wall}
    if outs["cuda"] != outs["plain"] or len(outs["cuda"]) != CLI_REQUESTS \
            or any(len(o) != CLI_NEW for o in outs["cuda"]):
        fail(f"phase 31 (c): greedy tokens differ between --decode-kernel "
             f"cuda and plain: {outs}")
    print(f"phase 31 (c): python -m repro_torch.launch.serve --arch "
          f"qwen3-1.7b --dtype float32 --layers {CLI_LAYERS}: "
          f"{CLI_REQUESTS} x {CLI_NEW} greedy tokens bitwise equal under "
          f"--decode-kernel cuda and plain; paged_flash_decode launches "
          f"{res['cuda']['paged_flash_decode_launches']} = {CLI_LAYERS} x "
          f"{res['cuda']['model_calls']} model calls and "
          f"{res['plain']['paged_flash_decode_launches']}; walls "
          f"{res['cuda']['wall_s']:.1f} / {res['plain']['wall_s']:.1f} s")
    return res


def run_examples(dev):
    """(d) The three ported examples on the card at their defaults
    (``main([])``): the quickstart trains and generates, serve_batched
    passes its solo-generation check, long_context_decode prefills
    through the wkv6 kernel."""
    import io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import (long_context_decode, quickstart,
                                    serve_batched)

    res = {}
    for name, mod in (("quickstart", quickstart),
                      ("serve_batched", serve_batched),
                      ("long_context_decode", long_context_decode)):
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main([])
        res[name] = {"wall_s": time.perf_counter() - t0,
                     "launches": dict(launch_counts()),
                     "last_line": buf.getvalue().strip().splitlines()[-1]}
        if name == "quickstart" and not np.isfinite(out["losses"]).all():
            fail(f"phase 31 (d): quickstart losses {out['losses']}")
        print(f"phase 31 (d): {name} at its defaults on the card in "
              f"{res[name]['wall_s']:.1f} s, launches "
              f"{res[name]['launches']}: {res[name]['last_line'][:160]}")
    if not res["long_context_decode"]["launches"].get("wkv6", 0):
        fail("phase 31 (d): long_context_decode launched no wkv6 kernel")
    return res


def ops_phase(dev):
    """Phase 31: (a)-(d) above."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    print(f"phase 31 (a): flash_attention at every block shape it is built "
          f"for, tolerances fp32 {TOL[torch.float32]:g}, bf16 "
          f"{TOL[torch.bfloat16]:g}; device ms per call")
    out = {"blocks": flash_block_sweep(dev, flush)}
    del flush
    out["impls"] = ops_impls(dev)
    out["decode_kernel"] = serve_decode_kernels(dev)
    torch.cuda.empty_cache()
    out["examples"] = run_examples(dev)
    torch.cuda.empty_cache()
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
    stems = ("paged_decode", "paged_decode_mla", "wkv6", "wkv6_bwd",
             "mamba_scan", "mamba_scan_bwd", "flash_attention",
             "flash_attention_bwd")
    build.load_libraries(stems)
    PHASE_S["phase 1"] = time.perf_counter() - t0
    print(f"phase 1: built {len(stems)} kernels in parallel in "
          f"{PHASE_S['phase 1']:.1f} s")
    for stem in stems:
        info = build.build_info[stem]
        ptxas = [ln.strip() for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "smem" in ln
                 or re.search(r"[1-9]\d* bytes spill", ln)]
        print(f"  csrc/{stem}.cu: nvcc {info['seconds']:.1f} s; ptxas: "
              f"{ptxas}")

    # ---- phase 2: kernels vs plain versions -------------------------------
    t_phase = time.perf_counter()
    if args.max_splits is not None:
        gqa_split.MAX_SPLITS = mla_split.MAX_SPLITS = args.max_splits
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    print("phase 2: kernels against their plain versions "
          f"(paged_flash_decode tolerance fp32 {TOL[torch.float32]:g}, bf16 "
          f"{TOL[torch.bfloat16]:g}; times are device ms per call)")
    rows = check_paged_decode(dev, flush)
    jamba_rows = check_paged_decode(dev, flush, h=32, windowed=False,
                                    tag="jamba h=32: ")
    print("  paged_flash_decode at the newcomers' group sizes (granite g 48 "
          "over 1 kv head, qwen2.5-32b g 5, deepseek-coder-33b g 7, "
          "deepseek-moe-16b g 1): tolerances as above")
    group_rows = []
    for h, hk in NEW_GROUPS:
        group_rows += check_paged_decode(
            dev, flush, h=h, hk=hk, windowed=False, tag=f"h={h} hk={hk}: ",
            cases=group_cases(np.random.default_rng(h)))
    print(f"  paged_flash_decode at phase 29's per-rank forms on a (data "
          f"{MESH_SHAPE[0]}, model {MESH_SHAPE[1]}) mesh (qwen3-1.7b 8 q / 4 "
          "kv heads, deepseek-moe-16b 8 / 8, granite-20b 24 q over its one kv "
          "head gathered whole on head_dim), tables of "
          f"{SERVE_MESH_MAX_LEN} tokens: tolerances as above")
    mesh_paged_rows = []
    for arch in SERVE_MESH_LAYERS:
        h, hk = serve_mesh_rank_heads(get_config(arch))
        mesh_paged_rows += check_paged_decode(
            dev, flush, h=h, hk=hk, windowed=False,
            tag=f"mesh rank {arch} h={h} hk={hk}: ",
            cases=serve_mesh_rank_cases(), max_len=SERVE_MESH_MAX_LEN)
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
    from repro_torch.kernels.flash_attention import BWD_TILED_TOL
    print(f"  flash_attention_bwd (csrc/flash_attention_bwd.cu) against its "
          f"tiled plain version (the same algorithm and schedule), max |err| "
          f"/ max |grad| fp32 {BWD_TILED_TOL[torch.float32]:g}, bf16 "
          f"{BWD_TILED_TOL[torch.bfloat16]:g}; the forward's log-sum-exp "
          f"against the plain one, |err| {LSE_TOL:g}")
    bwd_rows = check_flash_bwd_cases(dev)
    print(f"  flash_attention at the training shape: forward tolerance as "
          f"above; the Function's gradients (the backward kernel) against "
          f"autograd of the plain version, max |err| / max |grad| fp32 "
          f"{TRAIN_GRAD_TOL[torch.float32]:g}, bf16 "
          f"{TRAIN_GRAD_TOL[torch.bfloat16]:g} (fp32 re-associates sums "
          "over 4096 rows; bf16 rounds P and dS to bf16 for the products, "
          "and D uses the rounded output)")
    train_rows = check_flash_train(dev, flush)
    print(f"  flash_attention at MLA's widths (q, k 192, v 128; DeepSeek-V3's "
          f"train and prefill branch): tolerances as above")
    flash_mla_rows = check_flash_mla(dev, flush)
    print("  flash_attention at the encoder-decoder's and the VLM's forms "
          "(bidirectional and non-causal cross at (64, 64); llava's prefill "
          "at 2880 + 128 rows) and at granite's lockstep forms (g = 48): "
          "tolerances as above")
    flash_new_rows = check_flash_new_forms(dev, flush)
    print(f"  flash_attention at seamless's training shapes ((64, 64), 16 q "
          f"/ 16 kv heads, B 1, S = T = {TRAIN_SEQ}: the encoder's and the "
          "cross-attention's non-causal form, the decoder's causal "
          "self-attention): tolerances as at qwen3's training shape")
    for causal in (False, True):
        flash_new_rows += check_flash_train(
            dev, flush, f"seamless train B=1 S=T={TRAIN_SEQ} (64, 64) "
            f"h=hk=16 {'causal' if causal else 'non-causal'}", h=16, hk=16,
            hd=64, causal=causal)
    print(f"  flash_attention at phase 28's per-rank training form (qwen3's "
          f"16 q / 8 kv heads over model 2: 8 / 4 heads of 128, B "
          f"{MESH_BATCH // MESH_SHAPE[0]}, S = T = {MESH_SEQ}, causal): "
          "tolerances as at qwen3's training shape")
    mesh_rows = check_flash_train(
        dev, flush, f"mesh rank B={MESH_BATCH // MESH_SHAPE[0]} "
        f"S=T={MESH_SEQ} h=8 hk=4", h=8, hk=4, B=MESH_BATCH // MESH_SHAPE[0],
        S=MESH_SEQ)
    flash_new_rows += mesh_rows
    h, hk = serve_mesh_rank_heads(get_config("qwen3-1.7b"))
    print(f"  flash_attention at phase 29's lockstep per-rank form (qwen3's "
          f"{h} q / {hk} kv heads a rank, the slab gathered over model): "
          "tolerances as above")
    mesh_slab_rows = check_flash_attention(dev, flush, h=h, hk=hk,
                                           full=serve_mesh_slab_cases())
    print(f"  WKV6 and MambaScan gradients (kernel forward, backward "
          f"kernels csrc/wkv6_bwd.cu, csrc/mamba_scan_bwd.cu) against "
          f"autograd of the plain chunked forms: max |err| / max |grad| fp32 "
          f"{TRAIN_GRAD_TOL[torch.float32]:g}, bf16 "
          f"{TRAIN_GRAD_TOL[torch.bfloat16]:g}; the backward kernels against "
          f"the plain backwards on the same cotangents fp32 "
          f"{SCAN_BWD_TOL[torch.float32]:g} (two fp32 evaluations, each within "
          f"~2.3e-6 of a float64 gradient), "
          f"bf16 {SCAN_BWD_TOL[torch.bfloat16]:g} (one bf16 step at the "
          "largest gradient)")
    scan_grad_rows = check_scan_grads(dev, flush)
    del flush
    # the backward kernel's rows at the five training forms (bf16), qwen3's
    # first
    bwd_timed = [r for r in train_rows + flash_mla_rows + flash_new_rows
                 if "bwd_form" in r]
    print("  the flash backward's two kernels apart, at the training forms "
          "(bf16):")
    split_bwd_kernels(dev, bwd_timed)
    PHASE_S["phase 2"] = time.perf_counter() - t_phase
    print(f"phase 2: {PHASE_S['phase 2']:.1f} s")
    if args.kernels_only:
        print(json.dumps({"phase2": {
            "max_splits": gqa_split.MAX_SPLITS,
            "mla_max_splits": mla_split.MAX_SPLITS,
            "paged_flash_decode": rows + jamba_rows + group_rows,
            "wkv6": wkv_rows + scan_grad_rows["wkv6"],
            "mamba_scan": mamba_rows + scan_grad_rows["mamba_scan"],
            "paged_flash_decode_mla": mla_rows,
            "flash_attention": flash_rows + train_rows + flash_mla_rows
            + flash_new_rows, "flash_attention_bwd": bwd_rows}}))
        print(card_line())
        return

    # ---- phase 3: the main path, full width, bf16 -------------------------
    t_phase = time.perf_counter()
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
    del sch
    decode_model = decode_tick_model(cfg, model, prompts)
    PHASE_S["phase 3"] = time.perf_counter() - t_phase
    print(f"phase 3: {PHASE_S['phase 3']:.1f} s")
    prefix_out = run_phase("phase 22", prefix_qwen, dev, cfg, model)
    del model
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

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
    PHASE_S["phase 4"] = time.perf_counter() - t_phase
    print(f"phase 4: {PHASE_S['phase 4']:.1f} s")
    wkv_launches = run_phase("phases 5-6", serve_rwkv, dev, lens)
    scan_launches, jamba_paged_launches = run_phase("phases 7-8", serve_jamba,
                                                dev, lens)
    mla_launches, spec_out = run_phase("phases 9-10, 23 (i)", serve_deepseek,
                                   dev, lens)
    flash_launches = run_phase("phases 11-12", serve_legacy, dev)
    train_launches, train_out = run_phase("phases 13-14", train_qwen, dev)
    paper_out = run_phase("phase 15", paper_dp, dev)
    dp_out, ckpt_out, zero_out = run_phase(
        "phases 16-18", dp_qwen, dev, train_out["losses"], prompts, launches)
    slab_out = run_phase("phase 19", serve_slab_archs, dev)
    arch_train_out, plain_scan_bwd_calls = run_phase("phases 20-21",
                                                     train_archs, dev)
    spec_trained_out = run_phase("phase 23 (trained)", spec_trained, dev)
    dense_out = run_phase("phase 24", serve_dense_more, dev, lens)
    front_out = run_phase("phase 25", serve_frontends, dev)
    front_train_out = run_phase("phase 26", train_frontends, dev)
    bf16_out = run_phase("phase 27", train_bf16_masters, dev)
    mesh_out, serve_mesh_out = run_phase("phases 28-29", mesh_phases, dev)
    dryrun_out = run_phase("phase 30", dryrun_phase13, train_out)
    ops_out = run_phase("phase 31", ops_phase, dev)

    decode_bf16, chunk_bf16, verify_bf16 = (
        next(r for r in rows if r["case"] == case and r["dtype"] == "bfloat16")
        for case in ("decode B=8 S=1, slots 1..max_len tokens",
                     "prefill chunk B=1 S=32", VERIFY_CASE))
    verify_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "splits", "blocks", "max_abs_err")
    entry = {
        "name": "paged_flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:141",
        "launches": launches, "launches_jamba": jamba_paged_launches,
        "launches_from_checkpoint": ckpt_out["paged_flash_decode_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + jamba_rows
                           + group_rows + mesh_paged_rows
                           if r["dtype"] == "bfloat16"),
        "ms": decode_bf16["ms"], "plain_ms": decode_bf16["plain_ms"],
        "bound_ms": decode_bf16["bound_ms"],
        "bound_by": decode_bf16["bound_by"],
        "library_ms": decode_bf16["library_ms"],
        "chunk": {key: chunk_bf16[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "verify": {key: verify_bf16[key] for key in verify_keys},
        "launches_prefix": {k: v["paged_flash_decode_launches"]
                            for k, v in prefix_out.items() if k != "fp32"},
        "launches_decode_kernel": {
            k: v["paged_flash_decode_launches"]
            for k, v in ops_out["decode_kernel"].items()},
        "decode_kernel": ops_out["decode_kernel"],
        "prefix": prefix_out,
        "launches_spec_trained": spec_trained_out["launches"],
        "spec_trained": spec_trained_out,
        "launches_dense_more": {a: r["paged_launches"]
                                for a, r in dense_out.items()},
        "launches_serve_mesh_a_rank": {a: r["launches"]
                                       for a, r in serve_mesh_out.items()
                                       if a != "lockstep"},
        "serve_mesh": serve_mesh_out,
        "serve_mesh_rank_forms": {r["case"]: {key: r[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits",
            "blocks", "max_abs_err")} for r in mesh_paged_rows
            if r["dtype"] == "bfloat16"},
        "dense_more": dense_out,
        "group_sizes": {r["case"]: {key: r[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits",
            "blocks", "max_abs_err")} for r in group_rows
            if r["dtype"] == "bfloat16"},
        "cases": rows + jamba_rows + group_rows + mesh_paged_rows,
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
        "launches_slab": slab_out["rwkv6-1.6b"]["launches"]["wkv6"],
        "launches_train": arch_train_out["rwkv6-1.6b"]["launches"]["wkv6"],
        "launches_long_context_decode": ops_out["examples"][
            "long_context_decode"]["launches"]["wkv6"],
        "ops_impls": ops_out["impls"]["wkv6"],
        "train": scan_grad_rows["wkv6"][-1],
        "cases": wkv_rows + scan_grad_rows["wkv6"],
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
        "launches_slab": slab_out["jamba-v0.1-52b"]["launches"]["mamba_scan"],
        "launches_train": arch_train_out["jamba-v0.1-52b"]["launches"][
            "mamba_scan"],
        "ops_impls": ops_out["impls"]["mamba_scan"],
        "train": scan_grad_rows["mamba_scan"][-1],
        "cases": mamba_rows + scan_grad_rows["mamba_scan"],
    }
    mla_bf16, mla_chunk, mla_verify = (
        next(r for r in mla_rows if r["case"].startswith(case)
             and r["dtype"] == "bfloat16")
        for case in ("decode", "prefill", VERIFY_CASE))
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
        "verify": {key: mla_verify[key] for key in verify_keys},
        "launches_spec": {k: v["paged_flash_decode_mla_launches"]
                          for k, v in spec_out.items()
                          if isinstance(k, int)},
        "spec": spec_out,
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
                           + flash_new_rows + mesh_slab_rows
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
        "mla": {row["case"].split()[1]: {key: row[key] for key in row
                                         if key != "case"}
                for row in flash_mla_rows if row["dtype"] == "bfloat16"},
        "launches_slab_archs": {a: r["launches"]["flash_attention"]
                                for a, r in slab_out.items()},
        "launches_arch_train": {a: r["launches"]["flash_attention"]
                                for a, r in arch_train_out.items()},
        "slab_archs": slab_out, "arch_train": arch_train_out,
        "train": {**{key: train_bf16[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "sdpa_backend", "bwd_ms", "bwd_kernels_ms", "bwd_plain_ms",
            "library_bwd_ms", "library_fwd_bwd_ms", "bwd_bound_ms",
            "bwd_bound_by", "grad_rel_err")},
            "step": train_out},
        "launches_granite_lockstep": dense_out["granite-20b"]["lockstep"][
            "flash_launches"],
        "launches_frontends": {a: r["flash_launches"]
                               for a, r in front_out.items()},
        "launches_frontend_train": {a: r["flash_launches"]
                                    for a, r in front_train_out.items()},
        "frontends": front_out, "frontend_train": front_train_out,
        "launches_bf16_train": bf16_out["llava"]["flash_launches"],
        "launches_mesh_train": {a: r["flash_launches"]
                                for a, r in mesh_out.items()},
        "mesh_train": mesh_out,
        "launches_serve_mesh_lockstep_a_rank": serve_mesh_out["lockstep"][
            "launches"],
        "serve_mesh_rank_forms": {r["case"]: {key: r[key] for key in r
                                              if key != "case"}
                                  for r in mesh_slab_rows
                                  if r["dtype"] == "bfloat16"},
        "mesh_rank_form": {key: mesh_rows[-1][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "sdpa_backend", "max_abs_err", "grad_rel_err")},
        "bf16_train": bf16_out, "phase_3_decode_model": decode_model,
        "ops_impls": ops_out["impls"]["flash_attention"],
        "block_sweep": ops_out["blocks"], "examples": ops_out["examples"],
        "dryrun_phase13": dryrun_out,
        "new_forms": {r["case"]: {key: r[key] for key in r if key != "case"}
                      for r in flash_new_rows if r["dtype"] == "bfloat16"},
        "cases": (flash_rows + train_rows + flash_mla_rows + flash_new_rows
                  + mesh_slab_rows),
    }
    bwd_entry = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "replaces_note": "flash_attention_pallas has no backward: this is "
                         "the gradient of the reference's checkpointed "
                         "chunked_attention loop "
                         "(src/repro/models/attention.py:106), the backward "
                         "of the port's FlashAttention",
        "launches": train_out["bwd_launches"],
        "max_abs_err": max(r["grad_max_abs_err"] for r in bwd_timed),
        "ms": train_bf16["bwd_ms"], "plain_ms": train_bf16["bwd_plain_ms"],
        "bound_ms": train_bf16["bwd_bound_ms"],
        "bound_by": train_bf16["bwd_bound_by"],
        "library_ms": train_bf16["library_bwd_ms"],
        "library_is": "SDPA's backward alone: torch.autograd.grad of a kept "
                      "forward graph",
        "library_fwd_bwd_ms": train_bf16["library_fwd_bwd_ms"],
        "forms": {r["case"]: {key: r[key] for key in (
            "bwd_ms", "bwd_kernels_ms", "bwd_plain_ms", "library_bwd_ms",
            "library_fwd_bwd_ms", "bwd_bound_ms", "bwd_bound_by",
            "grad_rel_err", "grad_max_abs_err")}
            for r in bwd_timed},
        "launches_dp_train": {k: v["bwd_launches"] for k, v in dp_out.items()},
        "launches_arch_train": {a: r["launches"]["flash_attention_bwd"]
                                for a, r in arch_train_out.items()
                                if "flash_attention_bwd" in r["launches"]},
        "launches_frontend_train": {a: r["bwd_launches"]
                                    for a, r in front_train_out.items()},
        "launches_bf16_train": bf16_out["llava"]["bwd_launches"],
        "plain_bwd_calls_phase13": train_out["plain_bwd_calls"],
        "cases": bwd_rows,
    }
    scan_bwd_entries = []
    for kname, arch, replaces, ref in (
            ("wkv6", "rwkv6-1.6b", "src/repro/kernels/rwkv6_scan.py:80",
             "wkv6_chunked (src/repro/kernels/ops.py:91)"),
            ("mamba_scan", "jamba-v0.1-52b",
             "src/repro/kernels/mamba_scan.py:61",
             "mamba_chunked (src/repro/kernels/ops.py:152)")):
        grad_rows = scan_grad_rows[kname]
        timed_row = next(r for r in grad_rows if "bwd_ms" in r)
        scan_bwd_entries.append({
            "name": f"{kname}_bwd", "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}_bwd.cu",
            "replaces": replaces,
            "replaces_note": f"the TPU kernel has no backward: this is the "
                             f"gradient of the reference's checkpointed "
                             f"{ref}, the backward of the port's "
                             f"{'WKV6' if kname == 'wkv6' else 'MambaScan'}",
            "launches": arch_train_out[arch]["launches"][f"{kname}_bwd"],
            "launches_parity": arch_train_out[arch]["parity"][
                "launches"].get(f"{kname}_bwd", 0),
            "plain_bwd_calls_on_cuda": plain_scan_bwd_calls,
            "max_abs_err": max(r["bwd_max_abs_err"] for r in grad_rows
                               if r["dtype"] == "bfloat16"),
            "ms": timed_row["bwd_ms"], "plain_ms": timed_row["bwd_plain_ms"],
            "bound_ms": timed_row["bwd_bound_ms"],
            "bound_by": timed_row["bwd_bound_by"],
            "library_ms": None,
            "step_ms": arch_train_out[arch]["step_ms"],
            "cases": grad_rows,
        })
    print("phase seconds: "
          + json.dumps({k: round(v, 1) for k, v in PHASE_S.items()}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry, wkv_entry, mamba_entry,
                                  mla_entry, flash_entry, bwd_entry,
                                  *scan_bwd_entries]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--zero-rank"]:
        zero_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[2])
    else:
        main()
