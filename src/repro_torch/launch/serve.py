"""Serving launcher for the port: continuous batching (or the lockstep
slab engine, ``--engine legacy``) on the card.

    # full-width qwen3-1.7b in bf16 on the card, random weights from a seed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --batch 8 --requests 16 --prompt-len 128 --new-tokens 64 --report

    # the reduced config in fp32 on the CPU (plain PyTorch kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --device cpu --batch 4 --prompt-len 32 --new-tokens 16

    # the attention-free RWKV-6 stack, reduced, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --reduced --device cpu --batch 2 --prompt-len 40 --new-tokens 8

    # Jamba (Mamba + attention layers, MoE), reduced, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
        --reduced --device cpu --batch 2 --prompt-len 40 --new-tokens 8

    # the lockstep slab engine (whole-prompt prefill, then one decode
    # step per token, every attention call through the flash kernel;
    # any --arch: RWKV-6's and Mamba's prefill through their scans)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --device cpu --engine legacy --batch 2 --prompt-len 40 \\
        --new-tokens 12

    # serve what launch/train.py checkpointed (the reduced config, CPU)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --device cpu --restore /tmp/ck

    # DeepSeek-V3 (MLA, sigmoid-router MoE of 256 experts), full width,
    # cut to its first 4 layers, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --batch 8 --requests 16 --report

    # on a (data 2, model 2) serve mesh of 4 gloo ranks on the CPU
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --device cpu --backend gloo --mesh-shape 2x2 \
        --batch 2 --requests 4 --prompt-len 16 --new-tokens 8

    # full-width qwen3-1.7b on (2, 2): 4 gloo ranks sharing one card
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen3-1.7b \
        --backend gloo --mesh-shape 2x2 --batch 4 --new-tokens 16

    # speculative decode with the MTP head (4-token verify chunks) and
    # the radix prefix cache, streamed through the front door
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --reduced --device cpu --batch 2 \\
        --requests 4 --prompt-len 40 --new-tokens 12 --spec-decode 4 \\
        --prefix-cache --stream --report

Without --reduced the full-width config serves in bf16 (Jamba cut to
one 8-layer super-block, DeepSeek-V3 to its 3 dense layers and first
MoE layer: ``configs.one_card_config``); with it, the smoke config in
fp32.  --dtype sets the compute dtype and --layers N cuts the stack to
its first N layers.  Every decoder-only text architecture serves (granite-20b,
qwen2.5-32b, deepseek-coder-33b and deepseek-moe-16b at full depth);
the VLM and the encoder-decoder are refused, as the reference's
launcher refuses them: they serve through ``apply_model``'s slab
prefill and decode.  The weights are drawn from --seed, or with
--restore read from a checkpoint either package's training wrote (the
sharded store or the legacy npz; --step, default the latest).  Prompts come from
``synthetic_tokens`` seeded by --seed.  The default device is the card;
a machine without one raises unless --device cpu is given.

--mesh-shape DxM serves on a (data D, model M) mesh over the D x M
ranks torchrun started (``launch.mesh.make_serve_mesh``): the weights
drawn (or restored) straight to each rank's blocks by the serve-mode
rules, the paged pool placed by ``rules.pool_spec``, the heads, ffn,
experts and vocabulary split over "model" (``serve.scheduler``).
--backend nccl puts one rank on each card, gloo runs on the CPU or
lets ranks share a card.  Without --reduced under torchrun and without
--mesh-shape, the full config serves on the production mesh (data 16,
model 16; ``make_production_mesh``), which needs 256 ranks.  One
process without --mesh-shape serves on one device.  Rank 0 prints;
every rank returns the outputs.  A caller that has already joined a
process group (a test's ranks) keeps it; otherwise the launcher joins
torchrun's and leaves it at the end.  The engines scope the activation
mesh and the serve topology to their own calls, so nothing is left set
for an in-process caller.

The continuous engine's options: --prefix-cache (shared prompt
prefixes alias already-written KV pages instead of re-prefilling;
attention/MLA stacks), --spec-decode K (K-token verify chunks drafted
by the MTP head: greedy only, an architecture with ``mtp_depth > 0``;
the tokens stay those of K = 0) and --stream (serve through
``FrontDoor``, printing each request's tokens as its decode chunks
sync).  The lockstep engine refuses all three.

--decode-kernel auto|cuda|plain sets the config's ``decode_kernel``: the
paged decode attention of the continuous engine (the reference's
--decode-kernel pallas|xla).  auto is the CUDA kernel on the card and
the plain version on the CPU; cuda is refused on the CPU; plain runs the
plain version over the gathered pages on any device.  --report names
the one that ran.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import (ARCHITECTURES, DECODE_KERNELS, get_config,
                                 one_card_config, smoke_config)
from repro_torch.data import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (BACKENDS, check_production_world,
                                     init_from_env, make_production_mesh,
                                     make_serve_mesh)
from repro_torch.models import check_token_serving, init_model
from repro_torch.models.attention import decode_kernel_for
from repro_torch.serve import (FrontDoor, SamplingConfig, make_engine,
                               make_engine_from_checkpoint)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHITECTURES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "legacy"],
                    help="continuous batching over the paged pool, or the "
                         "lockstep slab engine")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="compute dtype (default: bfloat16 at full width, "
                         "float32 with --reduced)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the stack to its first N layers (depth only; "
                         "widths stay)")
    ap.add_argument("--batch", type=int, default=4,
                    help="serving slots (decode batch width)")
    ap.add_argument("--requests", type=int, default=None,
                    help="total requests to submit (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, prompts and sampling seed")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--decode-kernel", default=None,
                    choices=list(DECODE_KERNELS),
                    help="paged decode attention: auto (the CUDA kernel on "
                         "the card, the plain version on the CPU), cuda "
                         "(the kernel; refused on the CPU) or plain (the "
                         "plain version over the gathered pages).  "
                         "Default: the config's setting (auto)")
    ap.add_argument("--report", action="store_true",
                    help="print per-phase dispatch and host-sync counters "
                         "and the paged decode attention that ran")
    ap.add_argument("--restore", default="",
                    help="serve the params of this checkpoint dir "
                         "(written by launch/train.py of either package) "
                         "instead of random weights")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="continuous engine: speculative decode with "
                         "K-token verify chunks (the carried token + K-1 "
                         "MTP drafts a step); greedy only, needs an arch "
                         "with mtp_depth > 0; tokens stay those of K=0")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="continuous engine: radix prefix cache -- shared "
                         "prompt prefixes alias already-written KV pages "
                         "instead of re-prefilling")
    ap.add_argument("--stream", action="store_true",
                    help="continuous engine: serve through the front "
                         "door, printing each request's tokens as its "
                         "decode chunks sync")
    ap.add_argument("--mesh-shape", default=None, metavar="DxM",
                    help="serve on a (data D, model M) mesh over the D x M "
                         "ranks torchrun started (default: the production "
                         "16x16 mesh for the full config under torchrun, "
                         "else one device)")
    ap.add_argument("--backend", default="nccl", choices=BACKENDS,
                    help="the mesh's process group: nccl (one rank a "
                         "card) or gloo (the CPU, or ranks sharing a card)")
    args = ap.parse_args(argv)
    if not args.requests:
        args.requests = args.batch
    shape = None
    if args.mesh_shape:
        try:
            shape = tuple(int(v) for v in args.mesh_shape.lower().split("x"))
            if len(shape) != 2 or min(shape) < 1:
                raise ValueError
        except ValueError:
            raise SystemExit(f"--mesh-shape {args.mesh_shape!r}: expected "
                             "DxM, e.g. 2x4") from None
    elif not args.reduced and "WORLD_SIZE" in os.environ:
        try:
            check_production_world(False, int(os.environ["WORLD_SIZE"]))
        except RuntimeError as e:
            raise SystemExit(str(e)) from None
        shape = "production"

    if args.engine == "legacy" and (args.prefix_cache or args.stream
                                    or args.spec_decode):
        raise SystemExit("--prefix-cache/--stream/--spec-decode are "
                         "continuous-engine features (the lockstep slab "
                         "has neither a page table to alias, a queue to "
                         "stream from, nor a fused loop to widen)")
    if args.engine == "legacy" and args.requests > args.batch:
        raise SystemExit(
            f"--requests {args.requests} > --batch {args.batch}: the "
            "legacy lockstep engine has no queue (all slots start and "
            "retire together); use the continuous engine or raise "
            "--batch")

    if args.reduced:
        cfg = smoke_config(args.arch).with_overrides(dtype="float32")
    elif shape == "production":
        cfg = get_config(args.arch)
    else:
        cfg = one_card_config(args.arch)
    try:
        check_token_serving(cfg)
    except ValueError as e:
        raise SystemExit(f"serve launcher drives decoder-only archs: {e}")
    if args.decode_kernel:
        cfg = cfg.with_overrides(decode_kernel=args.decode_kernel)
    if args.dtype:
        cfg = cfg.with_overrides(dtype=args.dtype)
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.num_layers:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.num_layers} layers")
        cfg = cfg.with_overrides(num_layers=args.layers)
    sampling = SamplingConfig(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    decode_chunk = 8
    # decode-overshoot slack: one decode chunk; under spec decode each of
    # its steps may write a K-token verify chunk past the budget
    k = args.spec_decode
    slack = decode_chunk * k + k if k else decode_chunk
    max_len = -(-(args.prompt_len + args.new_tokens + slack)
                // args.page_size) * args.page_size
    engine_kw = {}
    if args.engine == "continuous":
        engine_kw = dict(page_size=args.page_size, decode_chunk=decode_chunk,
                         prefix_cache=args.prefix_cache, spec_decode=k)
    mesh, device, own_group = None, resolve_device(args.device), False
    if shape is not None:
        mesh, device, own_group = _join_mesh(args, shape)
    say = print if mesh is None or dist.get_rank() == 0 else (
        lambda *a, **k: None)
    engine_kw.update(engine=args.engine, batch_size=args.batch,
                     max_len=max_len, eos_id=args.eos_id, sampling=sampling,
                     seed=args.seed, device=device, mesh=mesh)
    try:
        return _serve(args, cfg, engine_kw, say)
    finally:
        if own_group:
            dist.destroy_process_group()


def _join_mesh(args, shape):
    """(mesh, this rank's device, whether the group was joined here):
    a caller's process group is kept, else torchrun's is joined."""
    def build(dev_type):
        if shape == "production":
            return make_production_mesh(device_type=dev_type)
        return make_serve_mesh(*shape, device_type=dev_type)

    try:
        if dist.is_initialized():
            device = resolve_device(args.device)
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
            return build(device.type), device, False
        mesh, device = init_from_env(args.backend, args.device, mesh=build)
        return mesh, device, True
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def _serve(args, cfg, engine_kw, say):
    device, mesh = engine_kw["device"], engine_kw["mesh"]
    try:
        kernel = decode_kernel_for(cfg, device)
    except ValueError as e:
        raise SystemExit(f"--decode-kernel: {e}") from None
    k = args.spec_decode
    if args.restore:
        eng = make_engine_from_checkpoint(args.restore, cfg, step=args.step,
                                          **engine_kw)
        say(f"serving checkpoint step {eng.restored_step} from "
            f"{args.restore}")
    else:
        place = None
        if mesh is not None:
            from repro_torch.bridge import mesh_placer
            place = mesh_placer(cfg, mesh, mode="serve")
            say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
                f"over {dist.get_world_size()} ranks ({device.type})")
        eng = make_engine(cfg, init_model(cfg, seed=args.seed, device=device,
                                          place=place), **engine_kw)
    n_req = args.requests
    prompts = synthetic_tokens(np.random.default_rng(args.seed), n_req,
                               args.prompt_len, cfg.vocab_size)
    t0 = time.time()
    if args.engine == "legacy":
        outs = eng.generate(prompts, args.new_tokens).cpu().tolist()
        dt = time.time() - t0
        n_tok = sum(len(o) for o in outs)
        say(f"{n_req} seqs x {args.new_tokens} tokens in {dt:.2f}s "
            f"({n_tok/dt:.1f} tok/s incl. compile)")
        if args.report:
            # the lockstep slab has no phase split: one prefill
            # dispatch, then a blocking round-trip per token
            spt = eng.host_syncs / max(1, n_tok)
            say(f"report: legacy {eng.dispatches} dispatches / "
                f"{eng.host_syncs} host syncs ({spt:.3f} syncs/token)")
        say(outs)
        return outs
    if args.stream:
        fd = FrontDoor(eng)
        handles = [fd.submit(p, args.new_tokens) for p in prompts]
        outs = []
        for i, h in enumerate(handles):
            toks = list(h)           # pumps; tokens arrive as they sync
            say(f"req {i} (ttft {h.ttft * 1e3:.0f}ms): {toks}")
            outs.append(toks)
    else:
        outs = [o.tolist()
                for o in eng.generate(list(prompts), args.new_tokens)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_tok = sum(len(o) for o in outs)
    st = eng.stats()
    extra = (f", prefix hit rate {st['prefix_hit_rate']:.0%}"
             if args.prefix_cache else "")
    if k:
        sd = st["spec_decode"]
        extra += (f", spec k={sd['k']} acceptance {sd['acceptance']:.0%} "
                  f"({sd['tokens_per_step']:.2f} tok/verify)")
    say(f"{n_req} requests x {args.new_tokens} tokens in "
        f"{dt:.2f}s ({n_tok/dt:.1f} tok/s incl. compile, "
        f"{st['syncs_per_token']:.3f} host syncs/token, "
        f"pool {st['pool_pages_in_use']} pages live, "
        f"{st['pool_bytes']} pool bytes, "
        f"{st['state_bytes']} recurrent state bytes{extra})")
    if args.report:
        say(f"report: decode_kernel={kernel} "
            f"prefill {st['prefill_dispatches']} dispatches / "
            f"{st['prefill_host_syncs']} host syncs "
            f"({st['prefill_host_syncs'] / n_req:.2f} "
            f"syncs/request), "
            f"decode {st['decode_dispatches']} dispatches / "
            f"{st['decode_host_syncs']} host syncs "
            f"({st['decode_host_syncs'] / max(1, n_tok):.3f} "
            f"syncs/token)")
    say(outs)
    return outs


if __name__ == "__main__":
    main()
