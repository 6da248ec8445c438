"""End-to-end training on one device or on N ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir DIR \
        [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \
        ... [--device cpu]

Port of `repro.launch.train`, with its flags, its loop, its prints and its
return value (the list of healthy losses), and `--device` (default cuda:
without a card it raises).  Features exercised: the sharded train step
(loss, gradients, AdamW), the synthetic data pipeline with background
prefetch, async step-atomic checkpointing, NaN rollback, the straggler
monitor and restart (`--resume`).

The run trains on the live world.  When `WORLD_SIZE` is set (torchrun's
variables: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and no
process group is up, `main` joins one (NCCL on cards, gloo with
`--device cpu`; collectives time out after `--collective-timeout`
seconds) and leaves it at the end; a group that is already up is used
as it is.  Each rank's device is cuda:<local rank>, or the CPU.  The mesh
is re-planned from the world at start (`replan_mesh(world,
prefer_model=1)`, as the reference): under a process group the state is
placed on its `DeviceMesh` (`train_step.place_state`) and the mesh
context set; without one (a single process) the state stays whole, as on
one device.  Every rank draws the global batch from the same seed and the
step keeps its own rows, so N ranks see the data one rank sees.  Only
rank 0 prints the step lines; every rank returns the same losses, and
writes its own checkpoint shard.  The default checkpoint directory is
`repro_torch_ckpt` under the temporary directory.  Steps run eagerly (no
`torch.compile`, no CUDA graph).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from ..configs import get_config, get_reduced
from ..device import resolve_device
from ..train import checkpoint as ckpt_mod
from ..train import train_step as ts_mod
from ..train.data import Prefetcher, SyntheticLM
from ..train.meshctx import clear_mesh_context, set_mesh_context
from ..train.optimizer import AdamWConfig
from ..train.resilience import RunGuard, StepMonitor, replan_mesh
from ..train.sharding import batch_specs


def _join_world(device: str, timeout_s: float) -> bool:
    """Join the process group torchrun's variables describe, unless one
    is up or none is described; True when this call joined it."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    backend = "gloo" if device == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _rank_device(device: str):
    if device == "cpu" or not dist.is_initialized():
        return resolve_device(device)
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--abort-after", type=int, default=0,
                    help="simulate a node failure after N steps (no final "
                         "save; restart with --resume)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--collective-timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    joined = _join_world(args.device, args.collective_timeout)
    try:
        return _train(args)
    finally:
        clear_mesh_context()
        if joined:
            dist.destroy_process_group()


def _train(args):
    dev = _rank_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0

    def say(*a, **kw):
        if rank == 0:
            print(*a, **kw)

    # elastic mesh from the live world
    mesh = replan_mesh(world, prefer_model=1,
                       device_type="cpu" if dev.type == "cpu" else "cuda")
    if mesh.mesh is not None:
        set_mesh_context(mesh, batch_specs(mesh))
    say(f"mesh: {mesh.shape} devices={world}")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    step_fn = ts_mod.make_train_step(cfg, opt_cfg,
                                     microbatch=args.microbatch)
    state = ts_mod.init_state(args.seed, cfg, device=dev)
    if mesh.mesh is not None:
        ts_mod.place_state(state, mesh.mesh)

    start_step = 0
    ckpt_dir = Path(args.ckpt_dir)
    if args.resume and ckpt_mod.latest_step(ckpt_dir) is not None:
        state, start_step = ckpt_mod.restore(ckpt_dir, state, host_id=rank)
        say(f"resumed from step {start_step}")

    data = SyntheticLM(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, frontend=cfg.frontend,
        frontend_positions=cfg.frontend_positions, d_model=cfg.d_model,
        encdec=cfg.family == "encdec")

    def stream():
        s = start_step
        while True:
            yield data.batch_at(s)
            s += 1

    it = Prefetcher(stream(), depth=2)
    ckptr = ckpt_mod.Checkpointer(ckpt_dir, host_id=rank)
    guard = RunGuard(ckptr, interval=args.ckpt_every)
    mon = StepMonitor(hard_timeout_s=3600.0)
    losses = []

    for step in range(start_step, args.steps):
        batch = next(it)
        mon.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        t = mon.finish()
        if not guard.check_loss(loss):
            say(f"step {step}: non-finite loss, rolling back")
            # every rank sees the same loss; each waits for its own save,
            # and the barrier for host 0's commit, so all read one step
            ckptr.wait()
            if world > 1:
                dist.barrier()
            state, rb = ckpt_mod.restore(ckpt_dir, state, host_id=rank)
            continue
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"dt {t['step_time_s']*1e3:.0f}ms"
                  + (" [straggler]" if t["straggler_alarm"] else ""),
                  flush=True)
        if guard.should_save(step):
            # state is post-update: the resume point is the NEXT step
            ckptr.save_async(step + 1, state, extra={"loss": loss})
        if args.abort_after and step - start_step + 1 >= args.abort_after:
            ckptr.wait()
            say(f"simulated failure after step {step} — restart with "
                f"--resume")
            return losses
    ckptr.wait()
    ckpt_mod.save(ckpt_dir, args.steps, state, host_id=rank)
    say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"stragglers={mon.stragglers}")
    if args.metrics_out and rank == 0:
        Path(args.metrics_out).write_text(json.dumps(
            {"losses": losses, "first": losses[0], "final": losses[-1]}))
    return losses


if __name__ == "__main__":
    main()
