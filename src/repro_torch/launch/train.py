"""Training launcher for the port: the one-device train step.

    # the reduced config in fp32 on the CPU (plain PyTorch attention)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --steps 3 --batch 4 --seq 64

    # full-width, full-depth qwen3-1.7b on the card: bf16 compute on fp32
    # masters, AdamW, every attention call through the flash kernel
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 10 --batch 2 --seq 4096 --microbatches 2

    # the other architectures: RWKV-6 (its WKV scan kernel forward, a
    # plain backward), Jamba (Mamba scan, attention, MoE) and DeepSeek-V3
    # (MLA, MoE and the MTP head), reduced
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --reduced --device cpu --steps 3 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch jamba-v0.1-52b --reduced --device cpu --steps 3 --batch 4 \\
        --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v3-671b --reduced --device cpu --steps 3 \\
        --batch 4 --seq 64

    # the encoder-decoder (src_embeds frames + tgt_tokens) and the VLM
    # (image rows + tokens): the reference's make_batch forms
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-large-v2 --reduced --device cpu --steps 3 \\
        --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llava-next-mistral-7b --reduced --device cpu --steps 3 \\
        --batch 4 --seq 64

    # the reduced config data-parallel over two ranks (the paper's
    # synchronous allreduce through the Trainer facade), under torchrun
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --backend gloo --dp-strategy bucketed \\
        --steps 3 --batch 4 --seq 64

    # the same over four ranks with the optimizer state, gradients and
    # params sharded (ZeRO-3), the collectives bucket-pipelined
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --device cpu --backend gloo --dp-strategy zero3 \
        --overlap on --bucket-bytes 65536 --steps 3 --batch 4 --seq 64

    # the full config on the production mesh: (data 16, model 16) over
    # 256 ranks, or (pod 2, data 16, model 16) over 512 with --multi-pod,
    # one rank a card (torchrun on every host, e.g. 32 hosts of 8 cards)
    PYTHONPATH=src python -m torch.distributed.run --nnodes 32 \
        --nproc-per-node 8 --rdzv-backend c10d --rdzv-endpoint HOST:PORT \
        -m repro_torch.launch.train --arch qwen3-1.7b --steps 10 \
        --batch 256 --seq 4096

    # checkpoint every 2 steps, hard-kill at step 4, then resume: the
    # rerun restores step 4 and its data cursor and takes steps 4 and 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --steps 6 --batch 4 --seq 64 \\
        --ckpt /tmp/ck --ckpt-every 2 --fault-step 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --steps 2 --batch 4 --seq 64 --ckpt /tmp/ck \\
        --ckpt-every 2

Port of ``repro.launch.train``.  Without --reduced the full config
trains in its compute dtype (bf16) on fp32 masters; with it, the smoke
config in fp32.  The full config under torchrun (or with --multi-pod)
trains on the production mesh (``launch.mesh.make_production_mesh``,
the reference's ``launch/train.py:130-157``): every master and moment
placed by the sharding rules, the batch split over pod x data, the work
over "model" (``train.step.make_train_step(..., mesh=)``); any world but
256 ranks (512 with --multi-pod) exits with the mesh's message.  On one
process without --multi-pod it trains on the one device.  Every architecture trains, DeepSeek-V3 with its
multi-token-prediction head (its CE joins the loss at the train
config's ``mtp_weight``), seamless-m4t-large-v2 on ``src_embeds`` frames
and target tokens, llava-next-mistral-7b on image rows and tokens
(``data.make_batch``).  The weights are drawn from seed 0; the batch of step
i is ``make_batch`` of a generator seeded by (--data-seed, i), so the
data cursor a checkpoint records is ``(data_seed, next_step)``.  Each
step prints its loss; the end prints tokens/s over the steps after the
first and the peak device memory.  The default device is the card; a
machine without one raises unless --device cpu is given.

``--ckpt DIR`` resumes from DIR's latest step when there is one (and
then runs --steps more), and saves every --ckpt-every steps with the
data cursor in ``meta.json``: as in the reference, --reduced runs (and
every --dp-strategy run) through the sharded store, synchronously or
with ``--ckpt-async`` from a background writer, and the full config as
the legacy npz of ``(params, opt_state)``.  ``--fault-step N`` (or
``REPRO_FAULT_STEP``) hard-kills the run at step boundary N with exit
code 113.

``--dp-strategy`` (which, as in the reference, requires --reduced)
trains through ``api.Trainer`` over every rank torchrun starts, with
``--backend`` nccl (one rank a card) or gloo (the CPU, or ranks
sharing one card): rank 0 prints ``describe()``, the losses (averaged
over the ranks) and the time in the collectives.  The strategy is any
registered one, the ZeRO ladder included (``zero1`` / ``zero2`` /
``zero3``, and ``zero1_hier`` / ``zero3_hier`` with --pods > 1);
``--overlap on|serial`` runs its collectives bucket by bucket
(``--bucket-bytes``).  A resume there is elastic: another world size,
strategy or layout restores the newest readable published step.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (checkpoint_meta, latest_step,
                                    restore_train_state, save_checkpoint,
                                    save_sharded_checkpoint, state_tree)
from repro_torch.configs import ARCHITECTURES, get_config, smoke_config
from repro_torch.core import DPConfig, available_strategies, get_strategy
from repro_torch.data import make_batch
from repro_torch.device import resolve_device
from repro_torch.elastic import FaultInjector, FaultPlan
from repro_torch.launch.mesh import BACKENDS, init_from_env
from repro_torch.models import check_train_ported
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def step_batch(cfg, seed, step, batch, seq):
    """The batch of global step ``step`` -- a pure function of ``(seed,
    step)``, so a resumed run regenerates the stream the killed run
    would have seen."""
    return make_batch(cfg, np.random.default_rng([seed, step]), batch, seq)


def data_cursor(seed, next_step):
    """The ``extra=`` payload saved with every checkpoint: enough to
    restart the synthetic stream without replaying or skipping."""
    return {"data_cursor": {"data_seed": int(seed),
                            "next_step": int(next_step)}}


def restore_cursor(ckpt_dir, at, default_seed):
    """Read the saved data cursor (absent in a legacy npz: fall back to
    the CLI seed at the restored step)."""
    try:
        cur = checkpoint_meta(ckpt_dir, at).get("extra", {})["data_cursor"]
        return int(cur["data_seed"]), int(cur["next_step"])
    except (FileNotFoundError, KeyError):
        return default_seed, at


OVERLAP_MODES = {"off": False, "on": True, "serial": "serial"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHITECTURES))
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke variant in fp32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-clip", type=float, default=0.0,
                    help="global-norm clip (0: off)")
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine"])
    ap.add_argument("--no-remat", action="store_true",
                    help="keep every layer's activations instead of "
                         "recomputing them in the backward")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-seed", type=int, default=0,
                    help="seed of the per-step synthetic batch stream")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory: resume from its latest "
                         "step, save every --ckpt-every steps")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint every N steps")
    ap.add_argument("--ckpt-async", action="store_true",
                    help="publish checkpoints from a background writer "
                         "(repro_torch.elastic.AsyncCheckpointer): the "
                         "step loop blocks only for the device->host copy")
    ap.add_argument("--ckpt-keep-last", type=int, default=0,
                    help="retain only the newest N published steps "
                         "(0: keep all)")
    ap.add_argument("--fault-step", type=int, default=-1,
                    help="fault injection: hard-kill (os._exit) the run "
                         "at this step boundary; REPRO_FAULT_STEP "
                         "overrides")
    ap.add_argument("--dp-strategy", default="",
                    choices=["", *available_strategies()],
                    help="reduced mode: train data-parallel over the "
                         "torchrun ranks with this registered strategy")
    ap.add_argument("--sync", default="grads",
                    choices=["grads", "weights", "none"])
    ap.add_argument("--sync-period", type=int, default=1)
    ap.add_argument("--compress", default="none", choices=["none", "bf16"])
    ap.add_argument("--pods", type=int, default=1,
                    help=">1 builds a (pod, data) mesh")
    ap.add_argument("--bucket-bytes", type=int, default=64 * 2 ** 20,
                    help="target bucket size of the bucketed strategy and "
                         "of the overlap scheduler")
    ap.add_argument("--overlap", default="off",
                    choices=sorted(OVERLAP_MODES),
                    help="run the collectives bucket by bucket, the next "
                         "bucket issued before the last one is finished "
                         "(on), or one after another (serial)")
    ap.add_argument("--backend", default="nccl", choices=BACKENDS)
    ap.add_argument("--multi-pod", action="store_true",
                    help="full config: the (pod 2, data 16, model 16) mesh "
                         "over 512 ranks instead of (data 16, model 16)")
    args = ap.parse_args(argv)
    if args.dp_strategy and args.sync != "grads" and \
            get_strategy(args.dp_strategy).sharded:
        ap.error(f"--dp-strategy {args.dp_strategy} shards the optimizer "
                 "state and needs --sync grads")
    if args.dp_strategy and not args.reduced:
        ap.error("--dp-strategy requires --reduced (the full-mesh path "
                 "gets its sharding from the mesh rules, not DPConfig)")
    if args.dp_strategy and (args.grad_clip or args.schedule != "constant"):
        ap.error("--grad-clip and --schedule cosine are options of the "
                 "one-device step; the data-parallel step has neither, as "
                 "in the reference")

    cfg = (smoke_config(args.arch).with_overrides(dtype="float32")
           if args.reduced else get_config(args.arch))
    try:
        check_train_ported(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    tc = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                     microbatches=args.microbatches, remat=not args.no_remat,
                     grad_clip=args.grad_clip, schedule=args.schedule)
    if args.ckpt_async and not args.reduced:
        ap.error("--ckpt-async requires --reduced (the full config saves "
                 "the legacy npz, as in the reference)")
    if args.multi_pod and args.reduced:
        ap.error("--multi-pod is the full config's production mesh; "
                 "--reduced trains data-parallel with --pods")
    if args.dp_strategy:
        return run_dp(args, cfg, tc)
    if not args.reduced and (args.multi_pod or "WORLD_SIZE" in os.environ):
        return run_mesh(args, cfg, tc)
    dev = resolve_device(args.device)
    state = init_train_state(cfg, tc, seed=0, device=dev)
    step, _ = make_train_step(cfg, tc)
    start, data_seed = 0, args.data_seed
    if args.ckpt and latest_step(args.ckpt) is not None:
        # restore_train_state picks the store by what is ON DISK
        state, start = restore_train_state(args.ckpt, state)
        data_seed, start = restore_cursor(args.ckpt, start, data_seed)
        print(f"resumed from step {start}", flush=True)
    injector = _make_injector(args)
    save = _make_saver(args)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_after_first = None
    losses = []
    for i in range(start, start + args.steps):
        state, metrics = step(state, step_batch(cfg, data_seed, i,
                                                args.batch, args.seq))
        losses.append(float(metrics["loss"]))
        print(f"step {i:4d}  loss {losses[-1]:.4f}", flush=True)
        if i == start:
            t_after_first = time.perf_counter()
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save(state, i + 1, extra=data_cursor(data_seed, i + 1))
        if injector is not None:
            injector.after_step(i + 1)
    _finish_saves(save)
    if args.steps > 1:
        wall = time.perf_counter() - t_after_first   # float(loss) synced
        tokens = (args.steps - 1) * args.batch * args.seq
        print(f"{tokens / wall:.1f} tokens/s over steps {start + 1}.."
              f"{start + args.steps - 1} "
              f"({wall:.3f} s, {dev.type})")
    if dev.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
              f"({torch.cuda.get_device_name(dev)})")
    else:
        print("peak device memory: not measured (cpu)")
    return losses


def _make_injector(args):
    """The environment wins (the subprocess tests set it); --fault-step
    is the CLI spelling of the same plan."""
    injector = FaultInjector.from_env()
    if injector is None and args.fault_step >= 0:
        injector = FaultInjector(FaultPlan(args.fault_step))
    return injector


def _make_saver(args):
    """The one-device checkpoint callable ``save(state, step, extra=)``:
    the sharded store for --reduced (synchronous, or the
    AsyncCheckpointer with --ckpt-async), the legacy npz of ``(params,
    opt_state)`` for the full config."""
    keep_last = args.ckpt_keep_last or None
    if not args.reduced:
        def legacy(state, at, *, extra):
            tree = state_tree(state)
            save_checkpoint(args.ckpt, at, (tree["params"],
                                            tree["opt_state"]))
        return legacy
    if not args.ckpt_async:
        def sync(state, at, *, extra):
            save_sharded_checkpoint(args.ckpt, at, state,
                                    keep_last=keep_last, extra=extra)
        return sync
    from repro_torch.elastic import AsyncCheckpointer
    ck = AsyncCheckpointer(args.ckpt, keep_last=keep_last)

    def async_save(state, at, *, extra):
        rec = ck.save(state, at, extra=extra)
        print(f"ckpt async step {at}: blocked {rec['blocking_s']*1e3:.1f}ms "
              f"({rec['bytes']/2**20:.1f} MiB)", flush=True)

    async_save.checkpointer = ck
    return async_save


def _print_ckpt_stats(s, say=print):
    say(f"ckpt stats: published {s['published']}/{s['saves']} "
        f"(dropped {s['dropped']}), blocked {s['total_blocking_s']:.3f}s, "
        f"wrote {s['total_write_s']:.3f}s", flush=True)


def _finish_saves(save):
    ck = getattr(save, "checkpointer", None)
    if ck is not None:
        ck.wait()
        _print_ckpt_stats(ck.stats())
        ck.close()


def run_mesh(args, cfg, tc):
    """The full config on the production mesh over every rank torchrun
    started; rank 0 reports and writes the legacy npz."""
    from repro_torch.launch.mesh import (check_production_world,
                                         make_production_mesh)
    try:
        check_production_world(args.multi_pod,
                               int(os.environ.get("WORLD_SIZE", 1)))
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    mesh, dev = init_from_env(
        args.backend, args.device, mesh=lambda dt: make_production_mesh(
            multi_pod=args.multi_pod, device_type=dt))
    rank0 = dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    state = init_train_state(cfg, tc, mesh=mesh, seed=0, device=dev)
    step, _ = make_train_step(cfg, tc, mesh=mesh)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over "
        f"{dist.get_world_size()} ranks ({args.backend}, {dev.type})",
        flush=True)
    start, data_seed = 0, args.data_seed
    if args.ckpt and latest_step(args.ckpt) is not None:
        state, start = restore_train_state(args.ckpt, state)
        data_seed, start = restore_cursor(args.ckpt, start, data_seed)
        say(f"resumed from step {start}", flush=True)
    injector = _make_injector(args)
    losses = []
    for i in range(start, start + args.steps):
        state, metrics = step(state, step_batch(cfg, data_seed, i,
                                                args.batch, args.seq))
        losses.append(float(metrics["loss"]))
        say(f"step {i:4d}  loss {losses[-1]:.4f}", flush=True)
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            tree = state_tree(state)          # every rank gathers
            if rank0:
                save_checkpoint(args.ckpt, i + 1, (tree["params"],
                                                   tree["opt_state"]))
            dist.barrier()
        if injector is not None:
            injector.after_step(i + 1)
    dist.destroy_process_group()
    return losses


def run_dp(args, cfg, tc):
    """Reduced-mode data-parallel training through the Trainer facade,
    on every rank torchrun started; rank 0 reports."""
    from repro_torch.api import Trainer
    mesh, dev = init_from_env(args.backend, args.device, pods=args.pods)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    dp = DPConfig(sync=args.sync, sync_period=args.sync_period,
                  strategy=args.dp_strategy, compress=args.compress,
                  bucket_bytes=args.bucket_bytes,
                  microbatches=args.microbatches,
                  overlap=OVERLAP_MODES[args.overlap])
    trainer = Trainer.create(cfg, optimizer=tc.optimizer, lr=tc.lr, dp=dp,
                             mesh=mesh, train_cfg=tc, seed=0, device=dev)
    say("trainer:", json.dumps(trainer.describe(), sort_keys=True),
        flush=True)
    start, data_seed = 0, args.data_seed
    if args.ckpt and latest_step(args.ckpt) is not None:
        # elastic resume: any world size or strategy, falling back past
        # torn steps to the newest readable published one
        start, skipped = trainer.restore_elastic(args.ckpt)
        data_seed, start = restore_cursor(args.ckpt, start, data_seed)
        for s, reason in skipped:
            say(f"skipped corrupt step {s}: {reason}", flush=True)
        say(f"resumed from step {start}", flush=True)
    injector = _make_injector(args)
    keep_last = args.ckpt_keep_last or None
    losses = []
    for i in range(start, start + args.steps):
        # every rank draws the batch; only rank 0's is read (and scattered)
        metrics = trainer.step(step_batch(cfg, data_seed, i, args.batch,
                                          args.seq))
        losses.append(float(metrics["loss"]))
        say(f"step {i:4d}  loss {losses[-1]:.4f}", flush=True)
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            cur = data_cursor(data_seed, i + 1)
            if args.ckpt_async:
                rec = trainer.save_async(args.ckpt, keep_last=keep_last,
                                         extra=cur)
                if rec is not None:
                    say(f"ckpt async step {i + 1}: blocked "
                        f"{rec['blocking_s']*1e3:.1f}ms", flush=True)
            else:
                trainer.save(args.ckpt, keep_last=keep_last, extra=cur)
        if injector is not None:
            injector.after_step(i + 1)
    stats = trainer.finish_saves()
    if stats is not None:
        _print_ckpt_stats(stats, say)
    for label, ms in trainer.sync_ms_by_label().items():
        name = "sync" if label == "grad_sync" else label
        say(f"{name}: median {np.median(ms):.3f} ms over {len(ms)} calls "
            f"({dev.type})")
    dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
