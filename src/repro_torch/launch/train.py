"""End-to-end training on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir DIR \
        [--device cpu]

Port of `repro.launch.train`, with its flags, its loop, its prints and its
return value (the list of healthy losses), and `--device` (default cuda:
without a card it raises).  Features exercised: the train step (loss,
gradients, AdamW), the synthetic data pipeline with background prefetch,
async step-atomic checkpointing, NaN rollback, the straggler monitor and
restart (`--resume`).  The mesh is re-planned from the live devices at
start (one device here: a (1, 1) mesh, nothing to shard).  The default
checkpoint directory is `repro_torch_ckpt` under the temporary directory.
Steps run eagerly (no `torch.compile`, no CUDA graph).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

from ..configs import get_config, get_reduced
from ..device import resolve_device
from ..train import checkpoint as ckpt_mod
from ..train import train_step as ts_mod
from ..train.data import Prefetcher, SyntheticLM
from ..train.optimizer import AdamWConfig
from ..train.resilience import RunGuard, StepMonitor, replan_mesh


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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)

    # elastic mesh from live devices: this launcher trains on one
    mesh = replan_mesh(1, prefer_model=1)
    print(f"mesh: {mesh.shape} devices=1")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    step_fn = ts_mod.make_train_step(cfg, opt_cfg,
                                     microbatch=args.microbatch)
    state = ts_mod.init_state(args.seed, cfg, device=dev)

    start_step = 0
    ckpt_dir = Path(args.ckpt_dir)
    if args.resume and ckpt_mod.latest_step(ckpt_dir) is not None:
        state, start_step = ckpt_mod.restore(ckpt_dir, state)
        print(f"resumed from step {start_step}")

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
    ckptr = ckpt_mod.Checkpointer(ckpt_dir)
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
            print(f"step {step}: non-finite loss, rolling back")
            state, rb = ckpt_mod.restore(ckpt_dir, state)
            continue
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
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
            print(f"simulated failure after step {step} — restart with "
                  f"--resume")
            return losses
    ckptr.wait()
    ckpt_mod.save(ckpt_dir, args.steps, state)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"stragglers={mon.stragglers}")
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(
            {"losses": losses, "first": losses[0], "final": losses[-1]}))
    return losses


if __name__ == "__main__":
    main()
