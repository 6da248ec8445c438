"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (it puts
`src/` on `sys.path` itself).  Phases, in order; any failure exits
non-zero:

1. The card: name and power limit from nvidia-smi.
2. Build: compile the CUDA kernels from `src/repro_torch/kernels/csrc/`.
3. Kernels against their plain PyTorch versions on the card, on the
   full-scale schedules of the main path: K1 (`sptrsv_groups`) on
   lung2_like(1.0) and torso2_like(1.0) under no_rewriting and
   avgLevelCost (main and T-factor preamble schedules) and on a
   carry-bearing banded(4096, 40) schedule; K2 (`sptrsv_groups_multi`)
   with R in {1, 8, 32}; K3 (`sptrsv_levels`) on the carry schedule.
   Each case prints its error, the kernel's time (CUDA events over 50
   launches after warm-up), the plain version's time (5 runs), the time
   of one `torch.triangular_solve` on the system the schedule solves
   (cuSPARSE; the yardstick, never called by the port) and the
   bytes/operations bound.
4. Main path: `TriangularOperator.from_csr(L, tune=s)` on the card for
   both matrices and both strategies, then `solve(b)` (refined),
   `solve(b, max_refine=0)`, `solve(B)` for B (n, 8),
   `transposed().solve(b)` (refined, unrefined and its
   `device_solve_fn()`, against the float64 oracle of L^T) and
   `device_solve_fn()`, each checked; the
   kernels' launch counts must advance and the plain version's must not.
5. The kernels line and the contract line.

Full results go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# float32 kernel vs float32 plain version: the two sum each row's terms in
# a different order, so they differ by rounding (~1e-7 relative per row,
# damped along the dependency chain of these diagonally dominant systems)
KERNEL_RTOL = 1e-5
# float32 solve vs the float64 host oracle: the JAX suite's own bound
# (tests/test_kernels.py)
ORACLE_RTOL = 5e-4
REFINE_TOL = 1e-10
H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
KERNEL_REPS, PLAIN_REPS, LIB_REPS = 50, 5, 20


def log(*args) -> None:
    print(*args, flush=True)


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> tuple:
    ref64 = ref.double()
    diff = float((x.double() - ref64).abs().max())
    return diff, diff / max(1.0, float(ref64.abs().max()))


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time per call, CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def csr_torch(indptr, indices, data, n: int) -> torch.Tensor:
    return torch.sparse_csr_tensor(
        torch.as_tensor(np.asarray(indptr, dtype=np.int64)),
        torch.as_tensor(np.asarray(indices, dtype=np.int64)),
        torch.as_tensor(np.asarray(data, dtype=np.float32)),
        size=(n, n)).to("cuda")


def lower_with_diag(A, diag):
    """CSR of A (strict lower) + diag(diag), rows sorted."""
    from repro_torch.sparse.csr import from_coo
    rows = np.concatenate([np.repeat(np.arange(A.n_rows), A.row_nnz()),
                           np.arange(A.n_rows)])
    cols = np.concatenate([A.indices, np.arange(A.n_rows)])
    vals = np.concatenate([A.data, diag])
    return from_coo(rows, cols, vals, A.shape)


def library_ms(M, R: int):
    """One cuSPARSE triangular solve of the lower CSR matrix M on (n, R)
    right-hand sides, or None where the card's PyTorch refuses it."""
    if M is None:
        return None
    try:
        A = csr_torch(M.indptr, M.indices, M.data, M.n_rows)
        b = torch.ones((M.n_rows, R), dtype=torch.float32, device="cuda")
        torch.triangular_solve(b, A, upper=False)
        torch.cuda.synchronize()
        return time_ms(lambda: torch.triangular_solve(b, A, upper=False),
                       LIB_REPS)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"    library yardstick unavailable: {type(e).__name__}: {e}")
        return None


def bound(packed, R: int) -> tuple:
    """Least time for the work of one solve, from the data the function
    needs: per finished row its row index and 1/diag; per real dependency
    its index and coefficient; a carry slot only for lanes that read or
    write one; c read once and x written once (n x R float32 each).
    Padding and the packing's offset arrays are left out.  Bytes over the
    HBM rate against the operations (an FMA per dependency, a subtract and
    a multiply per finished row, an add per carry read) over the float32
    rate.  Returns (ms, "bytes" | "operations")."""
    n, nc = packed.n, packed.n_carry
    rows = int((packed.lane_row < n).sum())
    cin = int((packed.lane_cin != nc).sum())
    cout = int((packed.lane_cout < nc).sum())
    deps = packed.num_deps
    nbytes = 8 * rows + 8 * deps + 4 * (cin + cout) + 2 * n * R * 4
    ops = R * (2 * deps + 2 * rows + cin)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    return {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}


def phase_build() -> float:
    from repro_torch.kernels.build import load_library
    t0 = time.perf_counter()
    load_library("sptrsv_level")
    secs = time.perf_counter() - t0
    log(f"build: sptrsv_level.cu in {secs:.3f} s")
    return secs


def build_cases():
    """Full-scale schedules of the main path, plus the carry schedule."""
    from repro_torch.core.portfolio import make_strategy
    from repro_torch.core.transform import transform
    from repro_torch.solver.schedule import (schedule_for_csr,
                                             schedule_for_preamble,
                                             schedule_for_transformed)
    from repro_torch.sparse import generators
    from repro_torch.sparse.levels import build_levels
    cases = []
    for mat in ("lung2_like", "torso2_like"):
        L = getattr(generators, mat)(1.0)
        for strat in ("no_rewriting", "avgLevelCost"):
            ts = transform(L, make_strategy(strat), validate=False)
            cases.append({"name": f"{mat}(1.0)/{strat}",
                          "sched": schedule_for_transformed(ts),
                          "lib": lower_with_diag(ts.A, ts.diag)})
            psched, _, _ = schedule_for_preamble(ts)
            if psched is not None:
                cases.append({"name": f"{mat}(1.0)/{strat}/preamble",
                              "sched": psched, "lib": None})
    B = generators.banded(4096, 40)
    cases.append({"name": "banded(4096,40)/max_deps=4",
                  "sched": schedule_for_csr(B, build_levels(B), max_deps=4),
                  "lib": B})
    return cases


def run_case(kernel: str, case: dict, R: int, rng) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver.levelset import pad_rhs, to_device
    sched = case["sched"]
    ds = to_device(sched, "cuda")
    packed = ds.packed()
    n, nc = sched.n, sched.n_carry
    shape = (n,) if kernel != "sptrsv_groups_multi" else (n, R)
    c_pad = pad_rhs(torch.as_tensor(rng.standard_normal(shape),
                                    dtype=torch.float32,
                                    device="cuda")).contiguous()
    if kernel == "sptrsv_groups":
        call = lambda: K.sptrsv_groups(ds.groups, c_pad, n=n, n_carry=nc,
                                       packed=packed)
    elif kernel == "sptrsv_groups_multi":
        call = lambda: K.sptrsv_groups_multi(ds.groups, c_pad, n=n,
                                             n_carry=nc, packed=packed)
    else:
        check(len(ds.groups) == 1 and len(ds.groups[0]) == 6,
              "K3 takes one carry-bearing group")
        g = ds.groups[0]
        call = lambda: K.sptrsv_levels(*g, g[0], c_pad, n=n, n_carry=nc)
    x = call()
    torch.cuda.synchronize()
    plain = lambda: ref.sptrsv_levels_grouped_ref(ds.groups, c_pad, n, nc)
    xp = plain()
    diff, rel = rel_err(x, xp)
    check(bool(torch.isfinite(x).all()) and rel <= KERNEL_RTOL,
          f"{kernel} on {case['name']} R={R}: relative error {rel:.3e} > "
          f"{KERNEL_RTOL:.0e}")
    ms = time_ms(call, KERNEL_REPS)
    plain_ms = time_ms(plain, PLAIN_REPS, warmup=1)
    bound_ms, bound_by = bound(packed, R)
    lib = library_ms(case["lib"], R)
    row = {"kernel": kernel, "case": case["name"], "R": R,
           "steps": sched.num_steps, "lanes": packed.num_lanes,
           "deps": packed.num_deps, "groups": [
               [g.lanes, g.width] for g in sched.groups],
           "schedule_MB": sched.memory_bytes() / 1e6,
           "packed_MB": packed.nbytes() / 1e6, "max_abs_err": diff,
           "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
           "us_per_step": ms * 1e3 / max(sched.num_steps, 1)}
    log(f"  {kernel:20s} {case['name']:42s} R={R:<3d} steps={row['steps']:5d}"
        f" err={rel:.2e} ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"bound_ms={bound_ms:.5f} ({bound_by}) library_ms={lib}")
    return row


def phase_kernels(rng) -> list:
    cases = build_cases()
    by_name = {c["name"]: c for c in cases}
    rows = [run_case("sptrsv_groups", c, 1, rng) for c in cases]
    for name in ("lung2_like(1.0)/no_rewriting",
                 "torso2_like(1.0)/avgLevelCost",
                 "banded(4096,40)/max_deps=4"):
        for R in (1, 8, 32):
            rows.append(run_case("sptrsv_groups_multi", by_name[name], R,
                                 rng))
    rows.append(run_case("sptrsv_levels",
                         by_name["banded(4096,40)/max_deps=4"], 1, rng))
    return rows


def oracle(M, b: np.ndarray, transpose: bool = False) -> np.ndarray:
    """float64 host oracle: scipy's sparse triangular solve of M x = b, or
    of M^T x = b (an upper sweep) with `transpose`."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular
    A = sp.csr_matrix((np.asarray(M.data, dtype=np.float64), M.indices,
                       M.indptr), shape=M.shape)
    if transpose:
        return spsolve_triangular(A.T.tocsr(), b, lower=False)
    return spsolve_triangular(A, b, lower=True)


def phase_main_path(rng) -> tuple:
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver import TriangularOperator
    from repro_torch.sparse import generators
    rows = []
    mats = {m: getattr(generators, m)(1.0)
            for m in ("lung2_like", "torso2_like")}
    TriangularOperator.clear_memory_cache()
    K.reset_launch_counts()
    for mat, L in mats.items():
        n = L.n_rows
        b = rng.standard_normal(n)
        x_ref = oracle(L, b)
        scale = max(1.0, float(np.abs(x_ref).max()))
        xT_ref = oracle(L, b, transpose=True)
        scaleT = max(1.0, float(np.abs(xT_ref).max()))
        for strat in ("no_rewriting", "avgLevelCost"):
            t0 = time.perf_counter()
            op = TriangularOperator.from_csr(L, tune=strat)
            build_s = time.perf_counter() - t0
            check(op.device.type == "cuda" and op.engine == "cuda",
                  f"operator on {op.device} / {op.engine}")
            t0 = time.perf_counter()
            x = op.solve(b)
            solve_s = time.perf_counter() - t0
            resid, rounds = op.stats.last_residual, op.stats.refine_rounds
            check(resid <= REFINE_TOL, f"refined residual {resid:.3e}")
            x0 = op.solve(b, max_refine=0)
            err0 = float(np.abs(x0 - x_ref).max()) / scale
            check(x0.dtype == np.float32 and err0 <= ORACLE_RTOL,
                  f"max_refine=0 error {err0:.3e}")
            B = rng.standard_normal((n, 8))
            XB = op.solve(B)
            residB = op.stats.last_residual
            check(XB.shape == (n, 8) and residB <= REFINE_TOL,
                  f"batched residual {residB:.3e}")
            opT = op.transposed()
            xT = opT.solve(b)
            residT = opT.stats.last_residual
            check(residT <= REFINE_TOL and np.isfinite(xT).all(),
                  f"transposed residual {residT:.3e}")
            # the reversed schedules' unrefined sweeps against L^T's oracle:
            # refinement would hide a kernel that is slightly wrong there
            bt = torch.as_tensor(b, dtype=torch.float32, device="cuda")
            xT0 = opT.solve(b, max_refine=0)
            xTd = opT.device_solve_fn()(bt)
            torch.cuda.synchronize()
            errT0 = float(np.abs(xT0 - xT_ref).max()) / scaleT
            errTd = float(np.abs(xTd.cpu().numpy() - xT_ref).max()) / scaleT
            check(errT0 <= ORACLE_RTOL and errTd <= ORACLE_RTOL,
                  f"transposed sweep error {errT0:.3e} (max_refine=0), "
                  f"{errTd:.3e} (device_solve_fn)")
            fn = op.device_solve_fn()
            xd = fn(bt)
            torch.cuda.synchronize()
            errd = float(np.abs(xd.cpu().numpy() - x_ref).max()) / scale
            check(xd.shape == (n,) and errd <= ORACLE_RTOL,
                  f"device_solve_fn error {errd:.3e}")
            sweep_ms = time_ms(lambda: fn(bt), 20)
            psched = op._preamble_host()[0]
            row = {"case": f"{mat}(1.0)/{strat}", "n": n, "nnz": L.nnz,
                   "steps": op.schedule.num_steps,
                   "preamble_steps": (psched.num_steps if psched is not None
                                      else 0),
                   "host_build_s": build_s, "solve_refined_s": solve_s,
                   "refine_rounds": rounds,
                   "residual": resid, "residual_batched": residB,
                   "residual_transposed": residT, "err_max_refine0": err0,
                   "err_device_solve_fn": errd,
                   "err_transposed_max_refine0": errT0,
                   "err_transposed_device_solve_fn": errTd,
                   "device_sweep_ms": sweep_ms}
            rows.append(row)
            log(f"  {row['case']:30s} n={n} steps={row['steps']} "
                f"preamble_steps={row['preamble_steps']} "
                f"build_s={build_s:.2f} resid={resid:.2e} "
                f"residB={residB:.2e} residT={residT:.2e} err0={err0:.2e} "
                f"err_dev={errd:.2e} errT0={errT0:.2e} errT_dev={errTd:.2e} "
                f"sweep_ms={sweep_ms:.4f}")
    counts = dict(K.LAUNCHES)
    log(f"  launches on the main path: {counts}")
    check(counts["sptrsv_groups"] > 0 and counts["sptrsv_groups_multi"] > 0,
          f"a kernel of the main path was never launched: {counts}")
    check(counts["plain"] == 0,
          f"the plain version ran on the main path: {counts}")
    return rows, counts


def kernels_line(krows: list, counts: dict) -> dict:
    """One entry per ported kernel, its timings at a main-path shape."""
    from repro_torch.kernels import sptrsv_level as K
    here = "src/repro_torch/kernels/csrc/sptrsv_level.cu"
    spec = [
        ("sptrsv_groups", 1, "lung2_like(1.0)/no_rewriting",
         "src/repro/kernels/sptrsv_level.py:98"),
        ("sptrsv_groups_multi", 8, "lung2_like(1.0)/no_rewriting",
         "src/repro/kernels/sptrsv_level.py:149"),
        ("sptrsv_levels", 1, "banded(4096,40)/max_deps=4",
         "src/repro/kernels/sptrsv_level.py:205"),
    ]
    out = []
    for name, R, case, replaces in spec:
        rep = next(r for r in krows if r["kernel"] == name
                   and r["case"] == case and r["R"] == R)
        out.append({"name": name, "route": "cuda", "source": here,
                    "replaces": replaces, "launches": counts[name],
                    "max_abs_err": max(r["max_abs_err"] for r in krows
                                       if r["kernel"] == name),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"],
                    "bound_by": rep["bound_by"],
                    "library_ms": rep["library_ms"]})
    assert set(K.LAUNCHES) - {"plain"} == {e["name"] for e in out}
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()
    log("== 1. card")
    card = phase_card()
    log("== 2. build")
    build_s = phase_build()
    log("== 3. kernels against their plain versions")
    krows = phase_kernels(rng)
    log("== 4. main path")
    mrows, counts = phase_main_path(rng)
    line = kernels_line(krows, counts)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernels": krows,
         "main_path": mrows, "launches": counts, "kernels_line": line,
         "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    log(card["nvidia_smi"])
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
