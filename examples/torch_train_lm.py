"""End-to-end LM training on the PyTorch/CUDA port with a mid-run failure
and a restart (fault tolerance).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 240]   # card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu    # host

The counterpart of examples/train_lm.py: trains the reduced InternLM2 for
a few hundred steps, simulates a node failure half-way, restarts from the
last committed checkpoint and checks that the loss improved across the
restart.  The checkpoints go to a temporary directory, removed at the end.
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="repro_torch_lm_")
    try:
        common = ["--arch", "internlm2-1.8b", "--reduced",
                  "--steps", str(args.steps), "--batch", str(args.batch),
                  "--seq", str(args.seq), "--ckpt-dir", ckpt,
                  "--ckpt-every", str(max(1, args.steps // 6)),
                  "--log-every", str(max(1, args.steps // 12)),
                  "--device", args.device]
        print("=== phase 1: train until simulated failure at step "
              f"{args.steps // 2} ===")
        losses1 = train_main(common + ["--abort-after", str(args.steps // 2)])
        print("=== phase 2: restart from checkpoint ===")
        losses2 = train_main(common + ["--resume"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"phase1 first/last: {losses1[0]:.3f}/{losses1[-1]:.3f}; "
          f"phase2 last: {losses2[-1]:.3f}")
    if not losses2[-1] < losses1[0]:
        raise RuntimeError("training did not improve across restart")
    print("OK: loss improved across the simulated failure + restart")
    return {"first": losses1[0], "aborted_last": losses1[-1],
            "resumed_last": losses2[-1], "steps": args.steps,
            "resumed_steps": len(losses2)}


if __name__ == "__main__":
    main()
