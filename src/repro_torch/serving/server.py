"""Synthetic-workload generator for the solve service.

    python -m repro_torch.serving.server --requests 200 --tenants 3 --smoke
    python -m repro_torch.serving.server --smoke --device cpu

Port of `repro.serving.server`.  Stands up an in-process `SolveService`
on the card (`--device cuda`, the default; it raises without one) or on
the host (`--device cpu`) and drives the mixed workload the serving tier
is built for — hot repeat solves, cold admissions of new patterns, and
value-only refreshes that route through `update_values` — from several
tenant threads, then prints the full stats snapshot as JSON and exits
non-zero on a wrong answer, a dropped request, or no hot swap.  Every
solved column is checked against the float64 host oracle, so the run is
a correctness gate, not just a liveness probe.  The oracle is solved
once per (pattern, value step) — every request of that pair has the same
right-hand side — and reused, since at full size its Python row loop
would cost more than the serving.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import threading

import numpy as np

from ..solver.levelset import resolve_device
from ..solver.reference import solve_csr_seq
from ..sparse import generators
from .service import SolveService


def step_values(L, step: int):
    """Step k's matrix: same pattern, perturbed values (diagonal scaled,
    not noised, so the triangular systems stay well-conditioned)."""
    rng = np.random.default_rng(1000 + step)
    rows = np.repeat(np.arange(L.n_rows), L.row_nnz())
    d_mask = L.indices == rows
    data = L.data * (1.0 + 0.2 * rng.standard_normal(L.nnz))
    data[d_mask] = L.data[d_mask] * (1.2 + 0.1 * step)
    return L.with_data(data)


def build_matrices(scale: float, patterns: int, seed: int) -> list:
    """A pattern pool: the paper's two analogues plus random fills."""
    pool = [generators.lung2_like(scale=scale),
            generators.torso2_like(scale=scale)]
    n = max(64, int(600 * scale))
    for i in range(max(0, patterns - len(pool))):
        pool.append(generators.random_lower(n, avg_offdiag=3.0,
                                            seed=seed + i))
    return pool[:patterns]


def run_workload(svc: SolveService, matrices: list, *, requests: int,
                 tenants: int, value_steps: int, seed: int,
                 check: bool = True, rel_tol: float = 5e-5) -> dict:
    """Drive a deterministic mixed workload from `tenants` threads.

    Request i: matrix i % len(matrices), value step (i // 7) % value_steps
    (so hot repeats dominate but update_values traffic recurs), tenant
    i % tenants.  Returns {"errors": [...], "checked": n}.
    """
    rng = np.random.default_rng(seed)
    variants = [[m if s == 0 else step_values(m, s) for s in range(value_steps)]
                for m in matrices]
    rhs = [rng.standard_normal(m.n_rows) for m in matrices]
    # request i's oracle depends on (pattern, step) only: solve each once
    refs = [[solve_csr_seq(L, b.astype(np.float64)) for L in row]
            for row, b in zip(variants, rhs)] if check else None
    errors: list = []
    checked = {"n": 0}
    err_lock = threading.Lock()

    def one(i: int) -> None:
        mi = i % len(matrices)
        step = (i // 7) % value_steps
        L = variants[mi][step]
        b = rhs[mi]
        try:
            x = svc.submit(b, L, tenant=f"tenant-{i % tenants}").result(
                timeout=120)
            if check:
                ref = refs[mi][step]
                err = float(np.max(np.abs(np.asarray(x, dtype=np.float64)
                                          - ref)))
                scale = float(np.max(np.abs(ref))) or 1.0
                if err / scale > rel_tol:  # default: float32 device path
                    raise AssertionError(
                        f"request {i}: relative error {err / scale:.2e}")
                with err_lock:
                    checked["n"] += 1
        except Exception as exc:    # noqa: BLE001 - collect, don't die
            with err_lock:
                errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    with concurrent.futures.ThreadPoolExecutor(max_workers=tenants) as pool:
        list(pool.map(one, range(requests)))
    return {"errors": errors, "checked": checked["n"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--patterns", type=int, default=3)
    ap.add_argument("--value-steps", type=int, default=3)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--max-width", type=int, default=8)
    ap.add_argument("--linger-ms", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-check", action="store_true",
                    help="skip the per-request oracle check")
    ap.add_argument("--smoke", action="store_true",
                    help="small fast preset")
    ap.add_argument("--device", default="cuda",
                    help="where the operators run: cuda (the default; "
                         "raises without a card) or cpu")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable tracing and write a Chrome trace-event "
                         "JSON of the whole run to PATH")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the final Prometheus text page to PATH")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = min(args.requests, 120)
        args.scale = min(args.scale, 0.03)

    device = resolve_device(args.device)
    from .. import obs
    tracer = obs.enable() if args.trace_out else None

    matrices = build_matrices(args.scale, args.patterns, args.seed)
    svc = SolveService(max_width=args.max_width,
                       max_linger_s=args.linger_ms * 1e-3,
                       tenant_cap=256, workers=2, cache=False, device=device)
    try:
        result = run_workload(svc, matrices, requests=args.requests,
                              tenants=args.tenants,
                              value_steps=args.value_steps, seed=args.seed,
                              check=not args.no_check)
        svc.wait_warm(timeout=300)
        prom = svc.prometheus_text() if args.prom_out else None
    finally:
        svc.close()             # drains workers: the snapshot below is final
    snap = svc.snapshot()
    if tracer is not None:
        obs.disable()
        obs.export.write_chrome_trace(args.trace_out, tracer)
    if prom is not None:
        with open(args.prom_out, "w") as fh:
            fh.write(prom)

    # each entry's life cycle (state, pick, swaps, re-binds, tune error)
    entries = {k: {f: v for f, v in e.items() if f != "op"}
               for k, e in svc.registry.stats()["entries"].items()}
    report = {"requests": args.requests, "tenants": args.tenants,
              "patterns": len(matrices), "device": str(device),
              "checked": result["checked"],
              "errors": result["errors"], "stats": snap,
              "entries": entries}
    json.dump(report, sys.stdout, indent=2, default=str)
    print()
    dropped = snap["submitted"] - snap["completed"]
    ok = (not result["errors"] and dropped == 0
          and snap["registry"]["hot_swaps"] >= 1)
    if not ok:      # pragma: no cover - failure path
        print(f"FAIL: dropped={dropped} errors={len(result['errors'])} "
              f"hot_swaps={snap['registry']['hot_swaps']}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":      # pragma: no cover
    sys.exit(main())
