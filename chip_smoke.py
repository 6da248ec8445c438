"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--sweep] [--ab DIR ...] [--only sptrsv|spmv]
    python3 chip_smoke.py --sharded-rank RANK STORE OUT   (phase 11's own)

Run from the repository root on a machine with a CUDA card (it puts
`src/` on `sys.path` itself).  Phases, in order; any failure exits
non-zero:

1. The card: name and power limit from nvidia-smi.
2. Build: compile the CUDA kernels from `src/repro_torch/kernels/csrc/`,
   one nvcc per source, all started together.
3. Kernels against their plain PyTorch versions on the card, on the
   full-scale schedules of the main path: K1 (`sptrsv_groups`) on
   lung2_like(1.0) and torso2_like(1.0) under no_rewriting and
   avgLevelCost (main and T-factor preamble schedules), on the backward
   (L^T) IC(0) factors of their SPD systems (lung2's has rows of up to
   2,142 entries, 2,717 schedule steps), on a carry-bearing
   banded(4096, 40) schedule and on an arrow matrix whose row of 20,000
   entries is longer than a tile holds; K1's stamped form
   (`sptrsv_groups_stamped`) on lung2's and torso2's no_rewriting
   schedules; K2 (`sptrsv_groups_multi`) with R in
   {1, 8, 32}; K3 (`sptrsv_levels`) on the carry schedule;
   K4 (`spmv_ell`, which packs the ELL arrays into the kernel's sliced
   form at its first call and keeps it) on spd_from_lower(torso2_like(1.0))
   and poisson2d_spd(512, 512) in float32 and float64, and K4 on
   spd_from_lower(lung2_like(1.0)) packed from its CSR
   (`pack_sliced_csr`, launched with `spmv_sliced`), held against the
   plain version over its ELL arrays (one 2,143-entry row pads them to
   234.8 M slots; built once on the card) and scipy's float64 product.
   Each case prints its error, the kernel's time (CUDA events over 50
   launches after warm-up), the plain version's time (5 runs), the time
   (and, for K4, the profiler's device time) of one cuSPARSE call on the
   same matrix (`torch.triangular_solve` for
   K1-K3, a `sparse_csr_tensor` product for K4; the yardstick, never
   called by the port) and the bytes/operations bound, for K1 the
   schedule's steps before and after the packing re-levels it (which
   must equal the DAG's level count), the widest step, the long lanes,
   µs per step and the packing's host seconds, and for K4 its device
   time with the L2 warm and flushed, the sliced form's slots, fill and
   long rows, the pack's ms, the first call's and a cache hit's.
4. Main path: `TriangularOperator.from_csr(L, tune=s)` on the card for
   both matrices and both strategies, then `solve(b)` (refined),
   `solve(b, max_refine=0)`, `solve(B)` for B (n, 8),
   `transposed().solve(b)` (refined, unrefined and its
   `device_solve_fn()`, against the float64 oracle of L^T) and
   `device_solve_fn()`, each checked; the
   kernels' launch counts must advance and the plain version's must not.
5. Preconditioned Krylov path, at full scale: for lung2's and torso2's
   SPD systems `spd_from_lower(...(1.0), seed=0)`, unpreconditioned `cg`
   and `cg` with `Preconditioner.ic0` under no_rewriting and
   avgLevelCost (float64 iterations, float32 sweeps), each checked
   against scipy's float64 residual, plus a batched (n, 8) `cg`;
   `bicgstab` and `gmres` with `Preconditioner.ilu0` on a nonsymmetric
   torso2 system; `kernels.ops.spmv_ell` against scipy's product.  The
   launch counts of K1, K2 and K4 must advance and the plain versions'
   must not.
6. The strategy-portfolio tuner at full size.  K1's stamped form
   profiles the no_rewriting sweeps of lung2_like(1.0) and
   torso2_like(1.0) (`obs.calibrate.calibrate_on`): its x must equal the
   serving K1's exactly, its stamps must sum to within 10% of the
   launch's event time (which holds unless the kernel's set-up before
   its first stamp takes a tenth of the launch: the stamps are turned
   into time by that event time), the clock its cycles imply must be
   within 10% of the SM clock nvidia-smi reads while the kernel runs,
   and `CostModel.calibrate` fits the card's constants to the two
   profiles.  Then, on both matrices, a portfolio that measures every
   candidate, and `TriangularOperator.from_csr(L)` at tune="auto" in
   model mode and with measure_top_k=3 through a portfolio that takes
   the candidates' transforms from the one before (`ReusedCandidates`:
   the host transforms of lung2's ten candidates take two minutes); each
   candidate prints its predicted us (the committed constants and the
   fresh fit), its measured us, its packed steps, its preamble's steps
   and its launches.  `from_csr(L)` as a user calls it, on torso2, must
   pick as the model mode did.  Last `Preconditioner.ic0(A)` at its
   default tune="auto" on both SPD systems, IC(0)-PCG with its pick (the
   gates of phase 5, and no_rewriting's iteration count) and the staged
   solve's ms beside no_rewriting's and avgLevelCost's on the same
   factors, timed in turns.  K1 and its stamped form must be launched,
   the plain version never.  `from_csr(L)` on torso2 keeps its operator
   in a cache directory of its own for phase 7.
7. The operator's life cycle at full size.  `update_values`: ten steps
   scaling the off-diagonal values by 1 + 0.01 k on lung2's L under
   no_rewriting and avgLevelCost (a preamble) and torso2's under
   no_rewriting, each step's unrefined sweep within 5e-4 of the float64
   oracle and its refined solve within 1e-10, the packed arrays refreshed
   on the card bitwise equal to a fresh pack, no pack unless the
   refresh reported a moved zero set (none under no_rewriting); the
   median step's ms beside a fresh `from_csr(..., cache=False)` build's,
   and a step split into host replay, host repack and device refresh.
   The zero trap: a dependency of lung2's L that is 0 at the build and
   non-zero after the update must re-pack, solve within the gates, and
   differ from what the new values in the old packing give.
   `Preconditioner.refactor` on lung2's SPD system: IC(0)-PCG on the new
   matrix to a true residual <= 1e-7, M^-1 equal to a fresh `ic0`'s, the
   refactor's ms against the fresh `ic0`'s, M^-1's ms before and after.
   The disk tier: a new `python3` process asks for phase 6's torso2
   operator with its cache directory, and must get `cache_source ==
   "disk"`, phase 6's pick, no pack, and solves within the gates.
   `sptrsv` with a float32 CUDA `b` that requires grad, on lung2's L in
   all four sweeps: the forward against the oracle and the gradient
   against the flipped solve within 1e-6, and a second-order gradient
   through `create_graph=True`; forward and backward ms, K1 launches a
   call.  K1 and K2 must be launched, the plain version never.
8. The solve service at full size.  One `OperatorRegistry`
   (`tune_mode="background"`, `cache=False`; the background tune runs
   the default candidates less critical_path's two) behind
   `SolveService(max_width=8, max_linger_s=0.002, workers=2)` serves the
   server's pattern pool at scale 1.0 (lung2_like, torso2_like and one
   random_lower of n 600) with `serving.server.run_workload`'s traffic: 3
   tenants, 240 requests, request i on pattern i % 3 and value step
   (i // 7) % 3, every answer within 5e-4 of the float64 oracle.  A
   stretch while the entries warm (at least one must still be warming
   after it, and some requests must be served untuned), then every tune
   done, then the same traffic on the tuned operators; zero drops, at
   least one hot swap and one value re-bind through `update_values`.
   Queue and solve ms (p50, p99) of each stretch.  Then 240 hot requests
   (a right-hand side each) in bursts through a batched service and a
   width-1 one over the same registry, in turns: the answers must agree
   within 1e-5, requests/s and the ratio are printed.  A burst under
   `obs.enable(annotate_torch=True)` and `torch.profiler`: the Chrome
   trace and the Prometheus page must validate, and the SpTRSV kernels'
   device time over `serving.solve`'s wall time is printed.  K1 and K2
   against their plain version on every served operator; `python -m
   repro_torch.serving.server --smoke` in a new process must exit 0.  K1
   and K2 must be launched, the plain version never.
9. Static verification at full size.  `from_csr(..., health="strict",
   cache=False)` for lung2_like(1.0) and torso2_like(1.0) under
   no_rewriting and avgLevelCost: each certificate (steps, levels,
   critical path, nnz, flops, padded flops) and packed certificate (steps,
   tiles, lanes, long lanes, far pairs, free rows), the verifiers' host
   seconds beside the build's, the packed steps equal to the DAG's level
   count of A', and strict `solve(b)` (refined and max_refine=0) and
   `solve(B)` for B (n, 8) within phase 4's gates; a second strict cached
   build must be a memory hit carrying the same certificate and running
   no verifier.  The four static-defect injectors (`core.faults`:
   reordered step, row finalized twice, out-of-bounds gather, corrupt
   replay plan) under a strict build of lung2 avgLevelCost must each raise
   their typed error and check (step and lane >= 0 for the first three)
   with the pack and launch counts unchanged; what the first two do with
   the checks off is printed (`oob_ell_index` never runs unverified on the
   card).  Ten strict `update_values` steps on lung2's L (no_rewriting)
   must certify each device refresh's rewritten words, their ms printed
   beside the audit's and an unaudited step's; `corrupt_values_payload`
   must raise `ScheduleInvariantError` (`finite` or `dinv`) and leave the
   operator solving its previous values within the gates.
   `ProfilingEngine(get_engine("cuda"))` on lung2 no_rewriting must solve
   within 1e-5 of the serving K1 and the oracle's gate, through K1's
   stamped form, with its profile's steps equal to the packed steps, and
   solve `B` (n, 2) column by column within 1e-5 of the serving K2.  K1,
   its stamped form and K2 must be launched, the plain version never.
10. Runtime resilience at full size, on lung2_like(1.0) and
   torso2_like(1.0), `from_csr(L, tune="no_rewriting", cache=False)`.  On
   a card the host reference serves no solve under any policy: the
   kernel serves it or it raises.  A healthy operator under "on",
   "repair" and "fallback" gives K1's x bitwise the same, with no
   fallback; a batched (n, 8) solve under "repair" is K2's.  Under
   `nan_schedule_payload`, "on" and "fallback" raise
   `NumericalHealthError` after K1's one launch, and "repair" launches K1
   for its round and then raises it with `fallbacks == ("repair",)`.
   Under `wrong_schedule_values` with `HealthPolicy(residual_check=True,
   on_nonfinite="repair")`, a factor of 1.01 is repaired by refinement
   through K1 (`residual:repaired`) and one of 3.0 raises after its
   three rounds (`residual:raised`).  Under `fail_engine_compile("cuda")`
   (the build's compile fails) and `engine_unavailable("cuda")`, with
   the chain of "cuda" set to ("torch",), which the resolution never
   returns for a card, "on", "repair" and "fallback" all raise
   `EngineFallbackError` naming only "cuda", with no launch; after the
   fault the same operator still refuses (the memo) and a fresh one
   serves through K1.  A launch failure patched in for one call fails
   that solve only: the next is K1's.  A staging failure patched in for
   one build fails that build only: a memory hit of the same matrix
   serves through K1.  No operator falls back or compiles the plain
   engine, the plain version never runs, and the host reference serves
   no solve in phases 4-10.  The phase prints its reference-served and
   repaired solves, its K1, K2 and plain launches and its seconds.
11. Sharded solves (`solver/distributed.py`), last, since it holds a
   process group.  First a probe: does gloo take CUDA tensors (a gloo
   world of one doing the sharded solve's collectives on cuda:0)?  It
   prints its answer; if yes, two gloo ranks on cuda:0, each a process of
   its own (`--sharded-rank`), solve lung2_like(1.0) no_rewriting under a
   two-rank mesh, the default one (CUDA on a card, whatever the backend):
   x bitwise equal on both, the unrefined sweep within
   the oracle's gate, the refined within 1e-10 (NCCL refuses two ranks on
   one card, so it is not tried).  Then an NCCL world of one on a
   `HashStore`: `from_csr(L, tune=s, mesh=mesh, cache=False)` for
   lung2_like(1.0) and torso2_like(1.0) under no_rewriting and
   avgLevelCost, each refined within 1e-10 and unrefined within the
   oracle's gate, with no packed or staged form of K1's;
   `count_all_gathers` beside the schedule's steps (families == steps: the
   paper's claim as barrier counts), and the preamble's; ms per sharded
   sweep (CUDA events over `SHARDED_REPS`) beside K1's on the same
   operator (`device_solve_fn(engine="cuda")`, launches not counted);
   the tuner under the mesh (its default cost model, which charges the
   preamble's barriers as the main schedule's) must pick, of the two
   strategies, the one whose sharded sweep measured faster;
   `profile_schedule(mesh=)` on the no_rewriting schedules (the median
   collective us per step) and `CostModel.sharded().calibrate` on the
   two; IC(0)-PCG under one mesh (`Preconditioner.ic0(mesh=)`, the
   sharded `device_matvec`) on spd_from_lower(lung2_like(1.0), seed=0)
   to a true residual <= 1e-7; `core.faults.lose_mesh` on a fresh
   operator, which K1 must serve with one `EngineFallbackWarning` and
   "sharded->cuda".  The plain version never runs, the host reference
   serves no solve; the phase prints its seconds.
12. The kernels line and the contract line.

Operators' disk entries go to a temporary directory that the script
removes at its end.  Full results go to chiprun_out/chip_smoke.json.
With `--sweep` or `--ab`, phases 3-11 give way to studies of the SpTRSV
kernel on lung2's and torso2's L and IC(0) L^T (R = 1, 8) and of K4 on
phase 3's systems, written to chiprun_out/chip_smoke_study.json
(`--only sptrsv` or `--only spmv` keeps one of the two): `--sweep` times
K1/K2 at every consumer count and fits `ROUND_WARPS`, the ratio from
which the wrapper sizes the block, and K4 at every SIGMA x LONG_SLOTS of
`SPMV_SIGMAS` x `SPMV_LONG_SLOTS`; `--ab DIR ...` times the K1/K2 and K4
of other checkouts (another commit, or a variant of this one) beside
this one's, in turns on the same inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
H100_F64_FLOPS = 34e12          # float64 outside the tensor cores
KERNEL_REPS, PLAIN_REPS, LIB_REPS = 50, 5, 20
# K4 against its plain version, relative to scale: the two sum a row's
# products in another order (float32 ~1e-7 per row, float64 ~1e-16)
SPMV_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}
# ops.spmv_ell (float32) against scipy's float64 product
SPMV_ORACLE_RTOL = 1e-4
# Krylov path: the solver's target, and the bound on the true float64
# relative residual ||b - Ax|| / ||b||: ten times the target, for the gap
# between CG's recursive residual and the true one under a float32 M^-1
PCG_TOL, PCG_TRUE_RESID, PCG_MAXITER = 1e-8, 1e-7, 400
ARROW_K = 20000
SOLVE_REPS = 5
DEVICE = "cuda"


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


L2_FLUSH_BYTES = 64 << 20          # more than the H100's 50 MB L2


def device_profile(fn, reps: int = 1, flush: bool = False) -> dict:
    """Device time per call of `fn`, kernel by kernel ({name: ms}), from a
    torch.profiler trace of `reps` calls after one warm-up; empty when the
    trace shows no device time.  With `flush`, a 64 MB buffer is zeroed
    before each call, so that `fn` finds the 50 MB L2 cold (the zeroing
    kernel then appears in the dict under its own name)."""
    from torch.profiler import ProfilerActivity, profile
    buf = (torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if flush
           else None)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if buf is not None:
                buf.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / reps
    return out


def kernel_ms(prof: dict, name: str):
    """ms per call of the kernels whose name holds `name`, or None."""
    ms = sum(v for k, v in prof.items() if name in k)
    return ms if ms > 0 else None


def top_kernels(prof: dict, k: int = 6) -> list:
    """The k kernels with the most device time: [[name, ms], ...]."""
    return [[name[:80], ms] for name, ms in
            sorted(prof.items(), key=lambda kv: -kv[1])[:k]]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def csr_torch(indptr, indices, data, n: int,
              dtype=np.float32) -> torch.Tensor:
    return torch.sparse_csr_tensor(
        torch.as_tensor(np.asarray(indptr, dtype=np.int64)),
        torch.as_tensor(np.asarray(indices, dtype=np.int64)),
        torch.as_tensor(np.asarray(data, dtype=dtype)),
        size=(n, n)).to("cuda")


def lower_with_diag(A, diag):
    """CSR of A (strict lower) + diag(diag), rows sorted."""
    from repro_torch.sparse.csr import from_coo
    rows = np.concatenate([np.repeat(np.arange(A.n_rows), A.row_nnz()),
                           np.arange(A.n_rows)])
    cols = np.concatenate([A.indices, np.arange(A.n_rows)])
    vals = np.concatenate([A.data, diag])
    return from_coo(rows, cols, vals, A.shape)


def dag_levels(M) -> int:
    """Level count of the DAG a float32 schedule of M solves: entries that
    round to 0 in float32 hold no dependency there (lung2's avgLevelCost
    system has 526 values below 1e-45, and 4 levels instead of 7)."""
    from repro_torch.sparse.csr import CSR
    from repro_torch.sparse.levels import build_levels
    keep = np.asarray(M.data, dtype=np.float32) != 0
    rows = np.repeat(np.arange(M.n_rows), M.row_nnz())[keep]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=M.n_rows))])
    return build_levels(CSR(indptr=indptr, indices=M.indices[keep],
                            data=M.data[keep], shape=M.shape)).num_levels


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
    its index and coefficient; c read once and x written once (n x R
    float32 each).  Padding and the tiles' headers and offsets are left
    out.  Bytes over the HBM rate against the operations (an FMA per
    dependency, a subtract and a multiply per finished row) over the
    float32 rate.  Returns (ms, "bytes" | "operations")."""
    n, rows, deps = packed.n, packed.num_lanes, packed.num_deps
    nbytes = 8 * rows + 8 * deps + 2 * n * R * 4
    ops = R * (2 * deps + 2 * rows)
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


KERNEL_SOURCES = ("sptrsv_level", "spmv_ell")


def phase_build() -> float:
    """Build every kernel source in parallel (one nvcc each), then load."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.build import build_library, load_library
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(build_library, KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        load_library(name)
    secs = time.perf_counter() - t0
    log(f"build: {', '.join(f'{k}.cu' for k in KERNEL_SOURCES)} in "
        f"{secs:.3f} s")
    return secs


def build_cases():
    """Full-scale schedules of the main path, plus the carry schedule."""
    from repro_torch.core.portfolio import make_strategy
    from repro_torch.core.transform import transform
    from repro_torch.precond import factorize
    from repro_torch.solver.operator import orient_lower
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
        # IC(0)'s backward sweep: L^T of the SPD system's factor, reversed
        fac = factorize.ic0(generators.spd_from_lower(L, seed=0))
        Lt = orient_lower(fac.L, "lower", True)[0]
        cases.append({"name": f"{mat}(1.0)/ic0/L^T",
                      "sched": schedule_for_csr(Lt, build_levels(Lt)),
                      "lib": Lt})
    B = generators.banded(4096, 40)
    cases.append({"name": "banded(4096,40)/max_deps=4",
                  "sched": schedule_for_csr(B, build_levels(B), max_deps=4),
                  "lib": B})
    W = arrow(ARROW_K)
    cases.append({"name": f"arrow({ARROW_K})",
                  "sched": schedule_for_csr(W, build_levels(W)), "lib": W})
    return cases


def arrow(k: int, seed: int = SEED):
    """Lower-triangular arrow of k + 2 rows: rows 0..k-1 hold only their
    diagonal, row k reads all of them (more deps than a ring stage holds:
    the kernel streams them from device memory), row k + 1 reads row k and
    every 97th of the first k."""
    from repro_torch.sparse.csr import from_coo
    rng = np.random.default_rng(seed)
    tail = np.arange(0, k, 97)
    rows = np.concatenate([np.full(k, k), np.full(tail.size + 1, k + 1)])
    cols = np.concatenate([np.arange(k), tail, [k]])
    vals = rng.uniform(-1, 1, rows.size) / np.sqrt(k)
    n = k + 2
    return from_coo(np.concatenate([rows, np.arange(n)]),
                    np.concatenate([cols, np.arange(n)]),
                    np.concatenate([vals, 1 + rng.random(n)]), (n, n))


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
    elif kernel == "sptrsv_groups_stamped":
        call = lambda: K.sptrsv_groups_stamped(ds.groups, c_pad, n=n,
                                               n_carry=nc, packed=packed).x
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
    levels = (dag_levels(case["lib"]) if case["lib"] is not None else None)
    check(levels is None or packed.num_steps == levels,
          f"{case['name']}: {packed.num_steps} packed steps, the DAG has "
          f"{levels} levels")
    row = {"kernel": kernel, "case": case["name"], "R": R,
           "schedule_steps": sched.num_steps, "steps": packed.num_steps,
           "dag_levels": levels, "widest_step": packed.widest_step,
           "long_lanes": packed.long_lanes, "free_rows": packed.num_free,
           "tiles": packed.num_tiles, "stage_bytes": packed.stage_bytes,
           "stages": packed.num_stages, "pack_s": packed.pack_s,
           "lanes": packed.num_lanes, "deps": packed.num_deps,
           "groups": [[g.lanes, g.width] for g in sched.groups],
           "schedule_MB": sched.memory_bytes() / 1e6,
           "packed_MB": packed.nbytes() / 1e6, "max_abs_err": diff,
           "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
           "us_per_step": ms * 1e3 / max(packed.num_steps, 1)}
    log(f"  {kernel:20s} {case['name']:42s} R={R:<3d} steps="
        f"{sched.num_steps}->{packed.num_steps} widest={packed.widest_step} "
        f"long={packed.long_lanes} free={packed.num_free} "
        f"pack_s={packed.pack_s:.3f} err={rel:.2e} ms={ms:.4f} "
        f"us/step={row['us_per_step']:.3f} plain_ms={plain_ms:.3f} "
        f"bound_ms={bound_ms:.5f} ({bound_by}) library_ms={lib}")
    return row


def spmv_bound(nnz: int, n: int, itemsize: int) -> tuple:
    """Least time for one ELL product, from the data the function needs:
    per real nonzero its int32 index and its value, x read once and y
    written once (padding slots left out), over the HBM rate, against one
    FMA per nonzero over the dtype's rate.  Returns (ms, bound_by)."""
    nbytes = nnz * (4 + itemsize) + 2 * n * itemsize
    flops = H100_F32_FLOPS if itemsize == 4 else H100_F64_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 2 * nnz / flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def spmv_library_ms(A, x: torch.Tensor) -> tuple:
    """One cuSPARSE SpMV of the CSR matrix A by x: (ms by events, device ms
    of its kernels by the profiler), or (None, None) where the card's
    PyTorch refuses it.  The events time the host's call as well, which
    at this size takes longer than the kernels."""
    try:
        M = csr_torch(A.indptr, A.indices, A.data, A.n_rows,
                      dtype=np.float32 if x.dtype == torch.float32
                      else np.float64)
        xc = x[:, None]
        call = lambda: torch.sparse.mm(M, xc)
        call()
        torch.cuda.synchronize()
        prof = device_profile(call, KERNEL_REPS)
        return (time_ms(call, LIB_REPS),
                sum(prof.values()) if prof else None)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"    library yardstick unavailable: {type(e).__name__}: {e}")
        return None, None


def spmv_cases() -> list:
    """K4's cases on ELL arrays: torso2's SPD system (the PCG path's) and a
    2-D Poisson grid."""
    from repro_torch.sparse import generators
    return [("spd_from_lower(torso2_like(1.0))",
             generators.spd_from_lower(generators.torso2_like(1.0), seed=0)),
            ("poisson2d_spd(512,512)", generators.poisson2d_spd(512, 512))]


def host_ms(fn, reps: int = 20) -> float:
    """Median host ms of one call of fn(), synchronized before and after:
    what a caller waits for a lone call."""
    return 1e3 * float(np.median([synced_s(fn)[1] for _ in range(reps)]))


def sliced_row(packed) -> dict:
    """The sliced form's size: slots stored, fill, long rows, constants."""
    return {"sliced_slots": packed.slots, "sliced_fill":
            packed.kept / max(packed.slots, 1), "slices": packed.num_slices,
            "long_rows": packed.num_long, "sigma": packed.sigma,
            "long_slots": packed.long_slots}


def time_spmv(row: dict, A, x, call, plain, itemsize: int) -> dict:
    """Time K4's `call` (events over KERNEL_REPS; device ms warm and with
    the L2 flushed, from the profiler), its plain version, its bound and
    the cuSPARSE yardstick, into `row`, and log it."""
    row["ms"] = time_ms(call, KERNEL_REPS)
    row["kernel_device_ms"] = spmv_device_ms(call)
    row["kernel_device_ms_cold_l2"] = spmv_device_ms(call, flush=True)
    row["plain_ms"] = time_ms(plain, PLAIN_REPS, warmup=1)
    row["bound_ms"], row["bound_by"] = spmv_bound(A.nnz, A.n_rows, itemsize)
    row["library_ms"], row["library_device_ms"] = spmv_library_ms(A, x)
    dev_ms = row["kernel_device_ms"]
    row["bound_share"] = row["bound_ms"] / dev_ms if dev_ms else None
    log(f"  spmv_ell             {row['case']:42s} D={row['D']:<4d} "
        f"slots={row['sliced_slots']} fill={row['sliced_fill']:.3f} "
        f"long={row['long_rows']} err={row['max_rel_err']:.2e} pack_ms="
        f"{row['pack_ms']:.3f} first_ms={row['first_call_ms']:.3f} "
        f"hit_ms={row['hit_ms']:.4f} ms={row['ms']:.4f} device_ms={dev_ms} "
        f"cold_l2_ms={row['kernel_device_ms_cold_l2']} "
        f"plain_ms={row['plain_ms']:.3f} bound_ms={row['bound_ms']:.5f} "
        f"({row['bound_by']}) library_ms={row['library_ms']} "
        f"library_device_ms={row['library_device_ms']}")
    return row


def run_spmv_case(name: str, A, dtype, rng) -> dict:
    """K4 through its wrapper on ELL arrays: the first call packs the
    sliced form (timed alone as well), later calls hit its cache."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import spmv_ell as S
    from repro_torch.solver.levelset import pad_rhs
    idx_np, coef_np, n = ops.ell_pack_csr(A, dtype=dtype)
    idx = torch.as_tensor(idx_np, device=DEVICE)
    coef = torch.as_tensor(coef_np, device=DEVICE)
    x = torch.as_tensor(rng.standard_normal(n), dtype=coef.dtype,
                        device=DEVICE)
    x_pad = pad_rhs(x)
    _, pack_s = synced_s(lambda: S.pack_sliced(idx, coef, n))
    call = lambda: S.spmv_ell(idx, coef, x_pad)
    packs = S.SLICE_PACKS["packs"]
    y, first_s = synced_s(call)
    check(S.SLICE_PACKS["packs"] == packs + 1, "K4's first call did not pack")
    plain = lambda: ref.spmv_ell_ref(idx, coef, x_pad)
    diff, rel = rel_err(y, plain())
    tol = SPMV_RTOL[coef.dtype]
    check(bool(torch.isfinite(y).all()) and rel <= tol,
          f"spmv_ell on {name} {coef.dtype}: relative error {rel:.3e} > "
          f"{tol:.0e}")
    hit_ms = host_ms(call)
    check(S.SLICE_PACKS["packs"] == packs + 1, "K4's cache missed a hit")
    dt = str(coef.dtype).replace("torch.", "")
    row = {"kernel": "spmv_ell", "case": f"{name}/{dt}", "R": 1, "n": n,
           "nnz": A.nnz, "D": int(idx.shape[1]),
           "ell_slots": int(idx.numel()), "fill": A.nnz / idx.numel(),
           **sliced_row(S.sliced_for(idx, coef, n)),
           "max_abs_err": diff, "max_rel_err": rel,
           "pack_ms": 1e3 * pack_s, "first_call_ms": 1e3 * first_s,
           "hit_ms": hit_ms}
    return time_spmv(row, A, x, call, plain, coef.element_size())


def ell_on_card(A, dtypes) -> tuple:
    """A's ELL arrays built on the card from its CSR (no host copy):
    (idx, {dtype: coef}, D)."""
    indptr = np.asarray(A.indptr, dtype=np.int64)
    deg = np.diff(indptr)
    D = max(int(deg.max()), 1)
    n_pad = -(-A.n_rows // 512) * 512
    flat = torch.as_tensor(np.repeat(np.arange(A.n_rows) * D, deg) +
                           (np.arange(indptr[-1]) - np.repeat(indptr[:-1],
                                                              deg)),
                           device=DEVICE)
    idx = torch.full((n_pad * D,), A.n_cols, dtype=torch.int32,
                     device=DEVICE)
    idx[flat] = torch.as_tensor(A.indices, dtype=torch.int32, device=DEVICE)
    coefs = {}
    for dtype in dtypes:
        c = torch.zeros(n_pad * D, dtype=dtype, device=DEVICE)
        c[flat] = torch.as_tensor(A.data, dtype=dtype, device=DEVICE)
        coefs[dtype] = c.view(n_pad, D)
    return idx.view(n_pad, D), coefs, D


def run_spmv_csr_cases(name: str, A, rng) -> list:
    """K4 on A's sliced form packed from its CSR on the host
    (`pack_sliced_csr`) and launched with `spmv_sliced`, in float32 and
    float64: against the plain version over A's ELL arrays, built once on
    the card, and against scipy's float64 product."""
    import scipy.sparse as sp
    from repro_torch.kernels import ref
    from repro_torch.kernels import spmv_ell as S
    from repro_torch.solver.levelset import pad_rhs
    t0 = time.perf_counter()
    idx, coefs, D = ell_on_card(A, (torch.float32, torch.float64))
    torch.cuda.synchronize()
    ell_s = time.perf_counter() - t0
    ell_gb = (idx.numel() * 4 + sum(c.numel() * c.element_size()
                                    for c in coefs.values())) / 1e9
    log(f"  {name}: ELL arrays {tuple(idx.shape)} built on the card in "
        f"{ell_s:.2f} s ({ell_gb:.2f} GB, float32 and float64 values)")
    Asp = sp.csr_matrix((np.asarray(A.data, dtype=np.float64), A.indices,
                         A.indptr), shape=A.shape)
    rows = []
    for dtype, coef in coefs.items():
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        packed, pack_s = synced_s(lambda: S.pack_sliced_csr(
            A, np_dtype).to(DEVICE))
        x64 = rng.standard_normal(A.n_rows)
        x = torch.as_tensor(x64, dtype=dtype, device=DEVICE)
        x_pad = pad_rhs(x)
        call = lambda: S.spmv_sliced(packed, x_pad)
        y, first_s = synced_s(call)
        plain = lambda: ref.spmv_ell_ref(idx, coef, x_pad)
        diff, rel = rel_err(y, plain())
        tol = SPMV_RTOL[dtype]
        check(bool(torch.isfinite(y).all()) and rel <= tol,
              f"spmv_sliced on {name} {dtype}: relative error {rel:.3e} > "
              f"{tol:.0e}")
        y_sp = Asp @ x.double().cpu().numpy()
        oracle = float(np.abs(y[:A.n_rows].double().cpu().numpy() - y_sp)
                       .max()) / max(1.0, float(np.abs(y_sp).max()))
        check(oracle <= SPMV_ORACLE_RTOL, f"spmv_sliced on {name} {dtype}: "
              f"error {oracle:.3e} against scipy's float64 product")
        dt = str(dtype).replace("torch.", "")
        row = {"kernel": "spmv_ell", "case": f"{name}/{dt}", "R": 1,
               "n": A.n_rows, "nnz": A.nnz, "D": D,
               "ell_slots": int(idx.numel()), "fill": A.nnz / idx.numel(),
               "ell_on_card_s": ell_s, "ell_gb": ell_gb,
               **sliced_row(packed), "max_abs_err": diff,
               "max_rel_err": rel, "rel_err_vs_scipy": oracle,
               "pack_ms": 1e3 * pack_s, "first_call_ms": 1e3 * first_s,
               "hit_ms": host_ms(call)}
        rows.append(time_spmv(row, A, x, call, plain, coef.element_size()))
    return rows


def phase_kernels(rng) -> tuple:
    cases = build_cases()
    by_name = {c["name"]: c for c in cases}
    rows = [run_case("sptrsv_groups", c, 1, rng) for c in cases]
    for name in ("lung2_like(1.0)/no_rewriting",
                 "torso2_like(1.0)/no_rewriting"):
        rows.append(run_case("sptrsv_groups_stamped", by_name[name], 1, rng))
    for name in ("lung2_like(1.0)/no_rewriting",
                 "torso2_like(1.0)/avgLevelCost",
                 "banded(4096,40)/max_deps=4"):
        for R in (1, 8, 32):
            rows.append(run_case("sptrsv_groups_multi", by_name[name], R,
                                 rng))
    rows.append(run_case("sptrsv_levels",
                         by_name["banded(4096,40)/max_deps=4"], 1, rng))
    t0 = time.perf_counter()
    for name, A in spmv_cases():
        for dtype in (np.float32, np.float64):
            rows.append(run_spmv_case(name, A, dtype, rng))
    from repro_torch.sparse import generators
    rows += run_spmv_csr_cases(
        "spd_from_lower(lung2_like(1.0))",
        generators.spd_from_lower(generators.lung2_like(1.0), seed=0), rng)
    log(f"  K4's cases took {time.perf_counter() - t0:.1f} s")
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
            pre = op._preamble_staged()
            row = {"case": f"{mat}(1.0)/{strat}", "n": n, "nnz": L.nnz,
                   "schedule_steps": op.schedule.num_steps,
                   "steps": op._staged().packed().num_steps,
                   "preamble_schedule_steps": (psched.num_steps
                                               if psched is not None else 0),
                   "preamble_steps": (pre.packed().num_steps
                                      if pre is not None else 0),
                   "pack_s": op._staged().packed().pack_s + (
                       pre.packed().pack_s if pre is not None else 0.0),
                   "transposed_steps": opT._staged().packed().num_steps,
                   "host_build_s": build_s, "solve_refined_s": solve_s,
                   "refine_rounds": rounds,
                   "residual": resid, "residual_batched": residB,
                   "residual_transposed": residT, "err_max_refine0": err0,
                   "err_device_solve_fn": errd,
                   "err_transposed_max_refine0": errT0,
                   "err_transposed_device_solve_fn": errTd,
                   "device_sweep_ms": sweep_ms}
            rows.append(row)
            log(f"  {row['case']:30s} n={n} steps="
                f"{row['schedule_steps']}->{row['steps']} preamble_steps="
                f"{row['preamble_schedule_steps']}->{row['preamble_steps']} "
                f"L^T steps={row['transposed_steps']} "
                f"build_s={build_s:.2f} pack_s={row['pack_s']:.3f} "
                f"resid={resid:.2e} "
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


def true_residual(A, x: torch.Tensor, b: np.ndarray) -> float:
    """||b - A x||_2 / ||b||_2 per column (the largest), in float64 on the
    host with scipy."""
    import scipy.sparse as sp
    M = sp.csr_matrix((np.asarray(A.data, dtype=np.float64), A.indices,
                       A.indptr), shape=A.shape)
    xs = x.double().cpu().numpy()
    r = b - M @ xs
    return float(np.max(np.linalg.norm(r, axis=0) /
                        np.linalg.norm(b, axis=0)))


def nonsymmetric(A, seed: int = 7):
    """tests/test_iterative.py's recipe on A's pattern: values +
    0.25 U(-1, 1)."""
    from repro_torch.sparse.csr import CSR
    rng = np.random.default_rng(seed)
    return CSR(indptr=A.indptr, indices=A.indices,
               data=A.data + 0.25 * rng.uniform(-1, 1, A.nnz),
               shape=A.shape)


def median_solve_s(solve) -> float:
    """Median host seconds of SOLVE_REPS synchronized solves, after one
    warm-up."""
    solve()
    times = []
    for _ in range(SOLVE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_pcg(rng, scale: float = 1.0) -> tuple:
    """The preconditioned Krylov path on the card (module doc, phase 5).
    Returns (rows, launch counts of this path)."""
    from repro_torch.iterative import bicgstab, cg, device_matvec, gmres
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmv_ell as S
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.precond import Preconditioner, factorize
    from repro_torch.solver import TriangularOperator
    from repro_torch.sparse import generators
    systems = {m: generators.spd_from_lower(getattr(generators, m)(scale),
                                            seed=0)
               for m in ("lung2_like", "torso2_like")}
    TriangularOperator.clear_memory_cache()
    K.reset_launch_counts()
    S.reset_launch_counts()
    rows = []
    for mat, A in systems.items():
        n = A.n_rows
        x_true = rng.standard_normal(n)
        b_np = A.matvec(x_true)
        b = torch.as_tensor(b_np, device=DEVICE)            # float64
        t0 = time.perf_counter()
        base = cg(A, b, tol=PCG_TOL, maxiter=PCG_MAXITER)
        torch.cuda.synchronize()
        base_s = time.perf_counter() - t0
        base_iters = int(base.iterations)
        mv = device_matvec(A)
        matvec_ms = time_ms(lambda: mv(b), KERNEL_REPS)
        t0 = time.perf_counter()
        fac = factorize.ic0(A)
        ic0_s = time.perf_counter() - t0
        B_np = rng.standard_normal((n, 8))
        B = torch.as_tensor(B_np, device=DEVICE)
        for strat in ("no_rewriting", "avgLevelCost"):
            t0 = time.perf_counter()
            P = Preconditioner.from_factors(fac, tune=strat)
            build_s = time.perf_counter() - t0
            check(P.device.type == "cuda" and P.forward.engine == "cuda"
                  and P.backward.engine == "cuda",
                  f"preconditioner on {P.device} / {P.forward.engine}")
            res = cg(A, b, preconditioner=P, tol=PCG_TOL,
                     maxiter=PCG_MAXITER)
            iters = int(res.iterations)
            resid = true_residual(A, res.x, b_np)
            err = float((res.x.cpu() - torch.as_tensor(x_true)).abs().max())
            check(bool(res.converged) and resid <= PCG_TRUE_RESID,
                  f"PCG on {mat}/{strat}: converged={bool(res.converged)} "
                  f"after {iters}, true residual {resid:.3e}")
            check(iters < base_iters, f"PCG on {mat}/{strat}: {iters} "
                  f"iterations, plain CG {base_iters}")
            resB = cg(A, B, preconditioner=P, tol=PCG_TOL,
                      maxiter=PCG_MAXITER)
            residB = true_residual(A, resB.x, B_np)
            check(bool(resB.converged.all()) and residB <= PCG_TRUE_RESID,
                  f"batched PCG on {mat}/{strat}: converged "
                  f"{resB.converged.tolist()}, true residual {residB:.3e}")
            solve_ms = 1e3 * median_solve_s(
                lambda: cg(A, b, preconditioner=P, tol=PCG_TOL,
                           maxiter=PCG_MAXITER))
            # the same solve with the matvec staged once (cg(A, ...) stages
            # the CSR arrays at every call), and the device's busy share
            # of it from a profiler trace
            staged = lambda: cg(mv, b, preconditioner=P, tol=PCG_TOL,
                                maxiter=PCG_MAXITER)
            staged_ms = 1e3 * median_solve_s(staged)
            prof = device_profile(staged)
            busy_ms = sum(prof.values()) if prof else None
            apply = P.device_apply()
            apply_ms = time_ms(lambda: apply(b), 20)
            row = {"case": f"spd_from_lower({mat}({scale}))/ic0/{strat}",
                   "n": n, "nnz": A.nnz, "shift": fac.shift,
                   "plain_cg_iterations": base_iters,
                   "plain_cg_converged": bool(base.converged),
                   "plain_cg_s": base_s, "pcg_iterations": iters,
                   "pcg_true_residual": resid, "pcg_max_err": err,
                   "batched_iterations": resB.iterations.tolist(),
                   "batched_true_residual": residB,
                   "ms_per_solve": solve_ms,
                   "ms_per_solve_staged_matvec": staged_ms,
                   "device_busy_ms_staged": busy_ms,
                   "device_kernels_staged": top_kernels(prof),
                   "ms_per_apply": apply_ms,
                   "ms_per_matvec": matvec_ms, "host_ic0_s": ic0_s,
                   "host_from_factors_s": build_s,
                   "schedule_steps": [P.forward.schedule.num_steps,
                                      P.backward.schedule.num_steps],
                   "steps": [op._staged().packed().num_steps
                             for op in (P.forward, P.backward)],
                   "pack_s": sum(op._staged().packed().pack_s
                                 for op in (P.forward, P.backward))}
            rows.append(row)
            log(f"  {row['case']:48s} cg={base_iters} pcg={iters} "
                f"resid={resid:.2e} batched={row['batched_iterations']} "
                f"ms/solve={solve_ms:.3f} staged={staged_ms:.3f} "
                f"busy_ms={busy_ms} ms/apply={apply_ms:.4f} "
                f"ms/matvec={matvec_ms:.4f} ic0_s={ic0_s:.2f} "
                f"from_factors_s={build_s:.2f} steps={row['schedule_steps']}"
                f"->{row['steps']} pack_s={row['pack_s']:.3f}")
    # ILU(0) on a nonsymmetric torso2 system: bicgstab and gmres
    N = nonsymmetric(systems["torso2_like"])
    x_true = rng.standard_normal(N.n_rows)
    bn_np = N.matvec(x_true)
    bn = torch.as_tensor(bn_np, device=DEVICE)
    t0 = time.perf_counter()
    Pn = Preconditioner.ilu0(N, tune="no_rewriting")
    ilu_s = time.perf_counter() - t0
    for solver, kw in ((bicgstab, {"maxiter": PCG_MAXITER}),
                       (gmres, {"restart": 30, "maxiter": 20})):
        t0 = time.perf_counter()
        res = solver(N, bn, preconditioner=Pn, tol=PCG_TOL, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        resid = true_residual(N, res.x, bn_np)
        check(bool(res.converged),
              f"ILU(0)-{solver.__name__} on nonsymmetric torso2 did not "
              f"converge in {int(res.iterations)} iterations")
        row = {"case": f"nonsymmetric(torso2_like({scale}))/ilu0/"
                       f"no_rewriting/{solver.__name__}",
               "n": N.n_rows, "shift": Pn.factors.shift,
               "iterations": int(res.iterations), "true_residual": resid,
               "solve_s": secs, "host_ilu0_and_build_s": ilu_s}
        rows.append(row)
        log(f"  {row['case']:48s} iterations={row['iterations']} "
            f"true_resid={resid:.2e} solve_s={secs:.3f} "
            f"ilu0+build_s={ilu_s:.2f}")
    # the ELL entry point on the card against scipy's float64 product
    import scipy.sparse as sp
    A = systems["torso2_like"]
    x = rng.standard_normal(A.n_rows)
    y = ops.spmv_ell(A, x)
    y_ref = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape) @ x
    rel = float(np.abs(y - y_ref).max()) / max(1.0, float(np.abs(y_ref).max()))
    check(rel <= SPMV_ORACLE_RTOL, f"ops.spmv_ell error {rel:.3e}")
    rows.append({"case": "ops.spmv_ell(spd_from_lower(torso2_like"
                         f"({scale})))", "rel_err_vs_scipy": rel})
    log(f"  ops.spmv_ell on torso2's system: error {rel:.2e} vs scipy")
    counts = dict(K.LAUNCHES, spmv_ell=S.LAUNCHES["spmv_ell"],
                  plain_spmv_ell=S.LAUNCHES["plain"])
    log(f"  launches on the Krylov path: {counts}")
    check(counts["sptrsv_groups"] > 0 and counts["sptrsv_groups_multi"] > 0
          and counts["spmv_ell"] > 0,
          f"a kernel of the Krylov path was never launched: {counts}")
    check(counts["plain"] == 0 and counts["plain_spmv_ell"] == 0,
          f"a plain version ran on the Krylov path: {counts}")
    return rows, counts


def smi_clocks() -> tuple:
    """(current, max) SM clock in MHz from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cur, top = (float(v) for v in out.split(","))
    return cur, top


def busy_sm_mhz(launch, seconds: float = 2.0) -> float:
    """Median SM clock (MHz) that nvidia-smi reads while `launch()` runs
    back to back on the card."""
    import threading
    reads, stop = [], threading.Event()

    def poll():
        while not stop.wait(0.3):
            reads.append(smi_clocks()[0])

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(100):
                launch()
            torch.cuda.synchronize()
    finally:
        stop.set()
        poller.join()
    check(bool(reads), "nvidia-smi read no SM clock while the kernel ran")
    return float(np.median(reads))


def candidate_rows(report, calibrated) -> list:
    """Per candidate of a PortfolioReport: the committed model's and the
    freshly calibrated model's prediction (us), the measured us where
    measured, the kernel's packed steps and the preamble's, launches."""
    rows = []
    for i, c in enumerate(report.candidates):
        row = {"rank": i, "label": c.label, "error": c.error,
               "predicted_us": c.predicted_us, "measured_us": c.measured_us,
               "measure_note": c.measure_note, "steps": c.steps,
               "preamble_steps": c.preamble_steps, "launches": c.launches,
               "nnz_T": c.nnz_T, "padded_flops": c.padded_flops,
               "memory_bytes": c.memory_bytes}
        if c.error is None:
            shape = {"steps": c.steps, "padded_flops": c.padded_flops,
                     "memory_bytes": c.memory_bytes,
                     "preamble_steps": c.preamble_steps,
                     "launches": c.launches}
            row["predicted_us_calibrated"] = calibrated.predict(
                None, c.metrics, shape)["total_us"]
        rows.append(row)
    return rows


def log_candidates(rows: list) -> None:
    for r in rows:
        if r["error"] is not None:
            log(f"      {r['label']:45s} FAILED {r['error'][:60]}")
            continue
        meas = (f"{r['measured_us']:10.1f}" if r["measured_us"] is not None
                else f"{'-':>10}")
        log(f"      {r['label']:45s} pred_us={r['predicted_us']:10.1f} "
            f"pred_cal_us={r['predicted_us_calibrated']:10.1f} "
            f"meas_us={meas} steps={r['steps']:5d} "
            f"pre_steps={r['preamble_steps']:4d} launches={r['launches']}")


def phase_tuner(rng, cache_dir: str) -> tuple:
    """The strategy-portfolio tuner on the card at full size (module doc,
    phase 6); `from_csr(L)` as a user calls it on torso2 keeps its operator
    in `cache_dir` for phase 7.  Returns (result, launch counts of this
    path)."""
    from repro_torch.core.portfolio import (StrategyPortfolio,
                                            default_candidates,
                                            default_cost_model_for,
                                            strategy_label)
    from repro_torch.iterative import cg, device_matvec
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.obs.calibrate import calibrate_on
    from repro_torch.precond import Preconditioner
    from repro_torch.solver import TriangularOperator
    from repro_torch.solver.levelset import pad_rhs
    from repro_torch.solver.operator import orient_lower
    from repro_torch.sparse import generators
    import dataclasses

    class ReusedCandidates(StrategyPortfolio):
        """A portfolio that takes each candidate's transform and schedule
        from an earlier report of the same matrix; it ranks, measures and
        reports as any portfolio does."""

        def __init__(self, report, **kwargs):
            super().__init__(**kwargs)
            self.built = {c.label: (c.ts, c.sched)
                          for c in report.candidates if c.error is None}

        def _compile(self, L, strat):
            return self.built[strategy_label(strat)]

    TriangularOperator.clear_memory_cache()
    Preconditioner.clear_pair_decisions()
    K.reset_launch_counts()
    res = {"committed_cost_model": dataclasses.asdict(
        default_cost_model_for("cuda"))}

    # 1. K1's stamped profile of both no_rewriting sweeps, and the fit
    t0 = time.perf_counter()
    model, profiles = calibrate_on("cuda", 1.0, reps=3)
    res["calibrate_s"] = time.perf_counter() - t0
    res["calibrated_cost_model"] = dataclasses.asdict(model)
    _, max_mhz = smi_clocks()
    res["profiles"] = {}
    for name, (op, prof) in profiles.items():
        packed = op._staged().packed()
        c = torch.as_tensor(op._ts.preamble(np.ones(op.n)),
                            dtype=torch.float32, device=DEVICE)
        c_pad = pad_rhs(c).contiguous()
        x_stamped = K.sptrsv_groups_stamped(None, c_pad, n=op.n,
                                            n_carry=packed.n_carry,
                                            packed=packed).x
        x_serving = K.sptrsv_groups(None, c_pad, n=op.n,
                                    n_carry=packed.n_carry, packed=packed)
        torch.cuda.synchronize()
        check(torch.equal(x_stamped, x_serving),
              f"{name}: the stamped K1's x differs from the serving K1's "
              f"by {float((x_stamped - x_serving).abs().max()):.3e}")
        share = prof.stamped_ms / prof.event_ms
        check(abs(share - 1.0) <= 0.10,
              f"{name}: the stamps sum to {prof.stamped_ms:.4f} ms, the "
              f"launch's events to {prof.event_ms:.4f} ms")
        # the clock nvidia-smi reads while the serving kernel runs (its
        # launches here compare clocks, not the main path: not counted)
        counted = dict(K.LAUNCHES)
        busy_mhz = busy_sm_mhz(lambda: K.sptrsv_groups(
            None, c_pad, n=op.n, n_carry=packed.n_carry, packed=packed))
        K.LAUNCHES.update(counted)
        check(abs(prof.clock_mhz / busy_mhz - 1.0) <= 0.10,
              f"{name}: the stamps' cycles ran at {prof.clock_mhz:.0f} MHz, "
              f"nvidia-smi read {busy_mhz:.0f} MHz while the kernel ran")
        fit_us = (model.step_overhead_us * prof.num_steps
                  + model.us_per_padded_flop * prof.step_padded_flops.sum()
                  + model.us_per_byte * prof.step_bytes.sum())
        row = {"steps": prof.num_steps, "event_ms": prof.event_ms,
               "stamped_ms": prof.stamped_ms, "stamp_share": share,
               "free_pass_ms": float(prof.step_ms[0]),
               "clock_mhz": prof.clock_mhz, "busy_sm_mhz": busy_mhz,
               "max_sm_mhz": max_mhz,
               "launch_us": prof.launch_us,
               "profile_total_ms": prof.total_ms(),
               "fitted_total_ms": fit_us / 1e3,
               "median_step_us": float(np.median(prof.step_ms[1:])) * 1e3,
               "profile": prof.to_dict()}
        res["profiles"][name] = row
        log(f"  profile {name:12s} steps={prof.num_steps} event_ms="
            f"{prof.event_ms:.4f} stamped_ms={prof.stamped_ms:.4f} "
            f"({share:.3f}) free_pass_ms={row['free_pass_ms']:.4f} "
            f"median_step_us={row['median_step_us']:.3f} clock_mhz="
            f"{prof.clock_mhz:.0f} (nvidia-smi {busy_mhz:.0f} busy, "
            f"{max_mhz:.0f} max) launch_us="
            f"{prof.launch_us:.2f} fitted_total_ms={fit_us / 1e3:.4f} "
            f"x stamped == serving")
    log(f"  calibrated on lung2_like(1.0) and torso2_like(1.0) in "
        f"{res['calibrate_s']:.1f} s: {res['calibrated_cost_model']}")
    log(f"  committed constants: {res['committed_cost_model']}")

    # 2. TriangularOperator.from_csr(L) at its default tune="auto" (model
    # mode): every candidate measured, then from_csr in model mode and
    # with measure_top_k=3 on the measured portfolio's transforms
    mats = {m: getattr(generators, m)(1.0)
            for m in ("lung2_like", "torso2_like")}
    res["operators"] = {}

    def served(op, mat, mode, secs, b) -> dict:
        check(op.report is not None and op.engine == "cuda",
              f"{mat}: from_csr(tune='auto') gave no report or ran on "
              f"{op.engine}")
        op.solve(b)
        check(op.stats.last_residual <= REFINE_TOL,
              f"{mat} {mode}: refined residual {op.stats.last_residual:.3e}")
        fn = op.device_solve_fn()
        bt = torch.as_tensor(b, dtype=torch.float32, device=DEVICE)
        sweep_ms = time_ms(lambda: fn(bt), 20)
        log(f"  from_csr({mat}(1.0)) {mode}: pick {op.strategy} in "
            f"{secs:.1f} s, sweep {sweep_ms:.4f} ms")
        return {"pick": op.strategy, "seconds": secs,
                "tune_ms": op.report.tune_ms, "device_sweep_ms": sweep_ms,
                "candidates": candidate_rows(op.report, model)}

    for mat, L in mats.items():
        b = rng.standard_normal(L.n_rows)
        t0 = time.perf_counter()
        L_eff = orient_lower(L, "lower", False)[0]
        full = StrategyPortfolio(measure_top_k=len(default_candidates()),
                                 device=DEVICE).tune(L_eff)
        secs = time.perf_counter() - t0
        rows = candidate_rows(full, model)
        ok = [r for r in rows if r["error"] is None]
        fastest = min(ok, key=lambda r: r["measured_us"])["label"]
        entry = {"all_measured": {
            "seconds": secs, "candidates": rows, "fastest": fastest,
            "model_pick": min(ok, key=lambda r: r["predicted_us"])["label"],
            "calibrated_pick": min(
                ok, key=lambda r: r["predicted_us_calibrated"])["label"]}}
        log(f"  every candidate of {mat}(1.0) measured in {secs:.1f} s: "
            f"fastest {fastest}; model pick "
            f"{entry['all_measured']['model_pick']}, calibrated model's "
            f"{entry['all_measured']['calibrated_pick']}")
        log_candidates(rows)
        for mode, k in (("model", 0), ("measured_top3", 3)):
            t0 = time.perf_counter()
            op = TriangularOperator.from_csr(L, portfolio=ReusedCandidates(
                full, measure_top_k=k, device=DEVICE))
            entry[mode] = served(op, mat, f"measure_top_k={k}",
                                 time.perf_counter() - t0, b)
            log_candidates(entry[mode]["candidates"])
        res["operators"][mat] = entry
    # the entry point as a user calls it, on torso2 (lung2's ten
    # transforms take two minutes): its pick is the model mode's
    t0 = time.perf_counter()
    op = TriangularOperator.from_csr(mats["torso2_like"], cache_dir=cache_dir)
    entry = res["operators"]["torso2_like"]
    entry["default"] = served(op, "torso2_like", "default",
                              time.perf_counter() - t0,
                              rng.standard_normal(op.n))
    check(op.strategy == entry["model"]["pick"],
          f"torso2_like: from_csr(L) picks {op.strategy}, the model mode "
          f"on the same transforms {entry['model']['pick']}")

    # 3. Preconditioner.ic0(A) at its default tune="auto" (the joint pair
    # tuner), and IC(0)-PCG with its pick against no_rewriting and
    # avgLevelCost on the same factors, timed in turns
    res["pairs"] = {}
    for mat, L in mats.items():
        A = generators.spd_from_lower(L, seed=0)
        n = A.n_rows
        b_np = A.matvec(rng.standard_normal(n))
        b = torch.as_tensor(b_np, device=DEVICE)
        t0 = time.perf_counter()
        P = Preconditioner.ic0(A)
        secs = time.perf_counter() - t0
        check(P.report is not None and P.device.type == "cuda",
              f"{mat}: Preconditioner.ic0(A) gave no pair report or ran on "
              f"{P.device}")
        entry = {"pick": P.strategy, "seconds": secs,
                 "tune_ms": P.report.tune_ms,
                 "combined": P.report.combined}
        precs = {"auto": P}
        for strat in ("no_rewriting", "avgLevelCost"):
            precs[strat] = Preconditioner.from_factors(P.factors, tune=strat)
        mv = device_matvec(A)
        for label, Q in precs.items():
            r = cg(mv, b, preconditioner=Q, tol=PCG_TOL, maxiter=PCG_MAXITER)
            resid = true_residual(A, r.x, b_np)
            check(bool(r.converged) and resid <= PCG_TRUE_RESID,
                  f"IC(0)-PCG on {mat} with {label} ({Q.strategy}): "
                  f"converged={bool(r.converged)} after "
                  f"{int(r.iterations)}, true residual {resid:.3e}")
            entry[label] = {"strategy": Q.strategy,
                            "iterations": int(r.iterations),
                            "true_residual": resid}
        check(entry["auto"]["iterations"] ==
              entry["no_rewriting"]["iterations"],
              f"{mat}: the auto pick takes {entry['auto']['iterations']} "
              f"PCG iterations, no_rewriting "
              f"{entry['no_rewriting']['iterations']}")
        order = list(precs) + list(precs)[::-1]
        staged = {label: [] for label in precs}
        for label in order:
            Q = precs[label]
            staged[label].append(1e3 * median_solve_s(
                lambda: cg(mv, b, preconditioner=Q, tol=PCG_TOL,
                           maxiter=PCG_MAXITER)))
        for label in precs:
            entry[label]["staged_ms"] = staged[label]
        res["pairs"][mat] = entry
        log(f"  Preconditioner.ic0(spd_from_lower({mat}(1.0))): pick "
            f"{P.strategy} in {secs:.1f} s; staged PCG ms (in turns) "
            + ", ".join(f"{k} {v['strategy']} {v['iterations']} it "
                        f"{'/'.join(f'{t:.3f}' for t in v['staged_ms'])}"
                        for k, v in entry.items()
                        if isinstance(v, dict) and "staged_ms" in v))
    counts = dict(K.LAUNCHES)
    log(f"  launches on the tuner's path: {counts}")
    check(counts["sptrsv_groups"] > 0 and counts["sptrsv_groups_stamped"] > 0,
          f"a kernel of the tuner's path was never launched: {counts}")
    check(counts["plain"] == 0,
          f"the plain version ran on the tuner's path: {counts}")
    return res, counts


# -- phase 7: the operator's life cycle ------------------------------------

UPDATE_STEPS = 10
# sptrsv's float32 result of a refined solve against the float64 oracle,
# and its gradient against the flipped solve: float32 rounding of a
# float64-accurate answer
SPTRSV_RTOL = 1e-6


def synced_s(fn) -> tuple:
    """(result, host seconds) of fn(), synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def offdiag_mask(L) -> np.ndarray:
    return np.repeat(np.arange(L.n_rows), L.row_nnz()) != L.indices


def packed_equal(a, b) -> bool:
    """The arrays the kernel reads, bitwise."""
    return all(torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu())
               for k in ("tiles", "tile_ptr", "far", "free_row",
                         "free_dinv"))


def counted(fn):
    """fn() with the kernels' launch counts left as they were: launches
    made to compare with a reference are not the path's."""
    from repro_torch.kernels import sptrsv_level as K
    saved = dict(K.LAUNCHES)
    try:
        return fn()
    finally:
        K.LAUNCHES.update(saved)


def zero_set(op, which: str) -> np.ndarray:
    """Which value slots of the operator's main ("packed") or preamble
    ("preamble_packed") schedule are 0 in float32."""
    from repro_torch.kernels import sptrsv_level as K
    sched = op.schedule if which == "packed" else op._preamble_host()[0]
    if sched is None:
        return np.zeros(0, bool)
    return K.schedule_values(sched).astype(np.float32) == 0


def life_updates(rng, mats) -> list:
    """update_values: UPDATE_STEPS steps scaling the off-diagonal values
    by 1 + 0.01 k on lung2 (no_rewriting, avgLevelCost) and torso2
    (no_rewriting), each step's sweeps checked; the last step's packed
    arrays against a fresh pack; the step's ms against a fresh build and
    split into its host replay, host repack and device refresh."""
    from repro_torch.core.transform import replay_transform
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver import TriangularOperator
    from repro_torch.solver.operator import orient_lower
    from repro_torch.solver.schedule import repack_schedule_values
    rows = []
    for mat, strat in (("lung2_like", "no_rewriting"),
                       ("lung2_like", "avgLevelCost"),
                       ("torso2_like", "no_rewriting")):
        L = mats[mat]
        off = offdiag_mask(L)
        b = rng.standard_normal(L.n_rows)
        B = rng.standard_normal((L.n_rows, 4))
        # cache=False: an update then touches neither cache tier
        op, build_s = synced_s(lambda: TriangularOperator.from_csr(
            L, tune=strat, cache=False))
        packs0, repacks0 = K.PACKS["pack_groups"], K.PACKS["repacks"]
        upd_ms, err0, resid = [], [], []
        # per step and packed schedule, the coefficients that crossed 0 in
        # float32 and whether its packing was made anew (a new value map)
        moved = {"packed": [], "preamble_packed": []}
        for k in range(1, UPDATE_STEPS + 1):
            data = L.data.copy()
            data[off] *= 1 + 0.01 * k
            Lk = L.with_data(data)
            before = {w: (op._payload.get(w), zero_set(op, w))
                      for w in moved}
            _, secs = synced_s(lambda: op.update_values(Lk))
            upd_ms.append(secs * 1e3)
            for w, (packed, zeros) in before.items():
                if packed is not None:
                    moved[w].append([
                        int(np.count_nonzero(zeros != zero_set(op, w))),
                        op._payload[w].values is not packed.values])
            x_ref = oracle(Lk, b)
            scale = max(1.0, float(np.abs(x_ref).max()))
            err0.append(float(np.abs(op.solve(b, max_refine=0) - x_ref)
                              .max()) / scale)
            op.solve(b)
            resid.append(op.stats.last_residual)
            check(err0[-1] <= ORACLE_RTOL and resid[-1] <= REFINE_TOL,
                  f"{mat}/{strat} update {k}: unrefined error "
                  f"{err0[-1]:.3e}, refined residual {resid[-1]:.3e}")
        op.solve(B)
        residB = op.stats.last_residual
        check(residB <= REFINE_TOL, f"{mat}/{strat}: batched residual "
              f"{residB:.3e} after the updates")
        packs = K.PACKS["pack_groups"] - packs0
        repacks = K.PACKS["repacks"] - repacks0
        check(packs == repacks == op.stats.repacks,
              f"{mat}/{strat}: {packs} packs in {UPDATE_STEPS} updates, "
              f"{repacks} of them re-packs for a moved zero set "
              f"(the operator counts {op.stats.repacks})")
        check(strat != "no_rewriting" or packs == 0,
              f"{mat}/{strat}: the updates packed {packs} times")
        check(all(repacked == (crossed > 0) for v in moved.values()
                  for crossed, repacked in v),
              f"{mat}/{strat}: a step re-packed without a zero crossing or "
              f"refreshed across one: {moved}")
        # the refreshed arrays against a fresh pack of the same schedules
        same = packed_equal(op._payload["packed"],
                            K.pack_schedule(op.schedule))
        psched = op._preamble_host()[0]
        if psched is not None:
            same &= packed_equal(op._payload["preamble_packed"],
                                 K.pack_schedule(psched))
        check(same, f"{mat}/{strat}: refreshed packed arrays differ from a "
              "fresh pack")
        # a fresh build of the last values with the same strategy
        _, fresh_s = synced_s(lambda: TriangularOperator.from_csr(
            Lk, tune=strat, cache=False))
        # one more step by its parts: host replay, host repack, device
        # refresh (the operator's own step does the same in that order)
        data = L.data.copy()
        data[off] *= 1.11
        Lk = L.with_data(data)
        L_eff = orient_lower(Lk, "lower", False)[0]
        ts_new, replay_s = synced_s(lambda: replay_transform(L_eff, op._ts))
        sched_new, repack_s = synced_s(lambda: repack_schedule_values(
            op.schedule, ts_new.A.data, ts_new.diag))
        (_, repacked), refresh_s = synced_s(lambda: K.refresh_packed_values(
            op._payload["packed"], sched_new))
        # and the preamble's, which the step repacks and refreshes too
        pre_repacked = None
        if psched is not None:
            pnew = repack_schedule_values(psched, ts_new.T.data,
                                          np.ones(ts_new.T.n_rows))
            pre_repacked = K.refresh_packed_values(
                op._payload["preamble_packed"], pnew)[1]
        row = {"case": f"{mat}(1.0)/{strat}", "n": L.n_rows,
               "build_s": build_s, "fresh_build_s": fresh_s,
               "update_ms": upd_ms,
               "update_ms_median": float(np.median(upd_ms)),
               "replay_ms": replay_s * 1e3, "repack_ms": repack_s * 1e3,
               "refresh_ms": refresh_s * 1e3, "refresh_repacked": repacked,
               "preamble_refresh_repacked": pre_repacked,
               "packs": packs, "repacks": repacks,
               "zero_crossings_and_repacks": moved,
               "err_max_refine0": max(err0), "residual": max(resid),
               "residual_batched": residB, "packed_equal_fresh": same}
        rows.append(row)
        log(f"  update_values {row['case']:28s} median "
            f"{row['update_ms_median']:.1f} ms (fresh build "
            f"{fresh_s * 1e3:.1f} ms; replay {row['replay_ms']:.1f}, repack "
            f"{row['repack_ms']:.1f}, refresh {row['refresh_ms']:.2f}; "
            f"re-packed main {repacked}, preamble {pre_repacked}) "
            f"packs={packs} repacks={repacks} (steps that re-packed / "
            f"saw zeros cross: "
            + ", ".join(f"{w} {sum(r for _, r in v)}/"
                        f"{sum(c > 0 for c, _ in v)}"
                        for w, v in moved.items() if v)
            + f") err0={max(err0):.2e} "
            f"resid={max(resid):.2e} residB={residB:.2e} == fresh pack")
    return rows


def life_zero_trap(mats) -> dict:
    """A dependency of lung2's L that is 0 at the build and non-zero after
    the update: the update must re-pack and solve right, where the new
    values scattered into the old packing give a wrong answer."""
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver import TriangularOperator
    from repro_torch.solver.levelset import pad_rhs
    import dataclasses
    L = mats["lung2_like"]
    n = L.n_rows
    rows = np.repeat(np.arange(n), L.row_nnz())
    b = np.random.default_rng(SEED).standard_normal(n)
    x_ref = oracle(L, b)
    scale = max(1.0, float(np.abs(x_ref).max()))
    # the dependency whose term a_ij x_j weighs most in this solve
    off = np.flatnonzero(rows != L.indices)
    k = int(off[np.argmax(np.abs(L.data[off] * x_ref[L.indices[off]]))])
    zeroed = L.data.copy()
    zeroed[k] = 0.0
    op = TriangularOperator.from_csr(L.with_data(zeroed),
                                     tune="no_rewriting", cache=False)
    old = op._payload["packed"]
    r0, p0 = op.stats.repacks, K.PACKS["pack_groups"]
    op.update_values(L)
    check(op.stats.repacks == r0 + 1 and
          K.PACKS["pack_groups"] == p0 + 1,
          f"zero trap: {op.stats.repacks - r0} re-packs, "
          f"{K.PACKS['pack_groups'] - p0} packs")
    err0 = float(np.abs(op.solve(b, max_refine=0) - x_ref).max()) / scale
    op.solve(b)
    resid = op.stats.last_residual
    # what a refresh alone would serve: the new values in the old packing,
    # which holds no word for the entry that was 0
    vm = old.values
    v = torch.as_tensor(K.schedule_values(op.schedule).astype(np.float32),
                        device=DEVICE)
    tw, ts, _, _, fs = vm.staged(old.tiles.device)
    tiles = old.tiles.clone()
    tiles.view(torch.float32)[tw] = v[ts]
    stale = dataclasses.replace(old, tiles=tiles, free_dinv=v[fs])
    c = torch.as_tensor(op._ts.preamble(b), dtype=torch.float32,
                        device=DEVICE)
    x_stale = counted(lambda: K.sptrsv_groups(
        None, pad_rhs(c).contiguous(), n=n, n_carry=stale.n_carry,
        packed=stale)).cpu().double().numpy()
    err_stale = float(np.abs(x_stale - x_ref).max()) / scale
    check(err0 <= ORACLE_RTOL and resid <= REFINE_TOL,
          f"zero trap: unrefined error {err0:.3e}, residual {resid:.3e}")
    check(err_stale > ORACLE_RTOL,
          f"zero trap: the stale packing's answer is off by only "
          f"{err_stale:.3e}; the entry does not show the trap")
    out = {"entry": k, "row": int(rows[k]), "col": int(L.indices[k]),
           "value": float(L.data[k]), "err_max_refine0": err0,
           "residual": resid, "err_refresh_alone": err_stale,
           "steps_before": old.num_steps,
           "steps_after": op._payload["packed"].num_steps}
    log(f"  zero trap on lung2 L[{out['row']}, {out['col']}] = "
        f"{out['value']:.3f}: re-packed ({out['steps_before']} -> "
        f"{out['steps_after']} steps), err0={err0:.2e} resid={resid:.2e}; "
        f"a refresh alone would be off by {err_stale:.2e}")
    return out


def life_refactor(rng, mats) -> dict:
    """Preconditioner.refactor on lung2's SPD system: IC(0)-PCG on the new
    matrix, the refactor's ms against a fresh ic0, M^-1's ms before and
    after."""
    from repro_torch.iterative import cg, device_matvec
    from repro_torch.precond import Preconditioner
    from repro_torch.sparse import generators
    A = generators.spd_from_lower(mats["lung2_like"], seed=0)
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    key = np.minimum(rows, A.indices) * A.n_cols + np.maximum(rows,
                                                               A.indices)
    scale = 1.0 + 0.1 * np.sin(key * 12.9898)
    scale[A.indices == rows] = 1.2
    A2 = A.with_data(A.data * scale)
    # cache=False: refactor and the fresh build touch neither cache tier
    P = Preconditioner.ic0(A, tune="no_rewriting", cache=False)
    r = torch.as_tensor(rng.standard_normal(A.n_rows), device=DEVICE)
    apply_before = time_ms(lambda: P.device_apply()(r), 20)
    _, refactor_s = synced_s(lambda: P.refactor(A2))
    apply_after = time_ms(lambda: P.device_apply()(r), 20)
    fresh, fresh_s = synced_s(lambda: Preconditioner.ic0(
        A2, tune="no_rewriting", cache=False))
    z, zf = P.device_apply()(r), fresh.device_apply()(r)
    _, diff = rel_err(z, zf)
    check(diff <= KERNEL_RTOL, f"refactor: M^-1 differs from a fresh "
          f"ic0's by {diff:.3e}")
    x_true = rng.standard_normal(A.n_rows)
    b_np = A2.matvec(x_true)
    b = torch.as_tensor(b_np, device=DEVICE)
    res = cg(device_matvec(A2), b, preconditioner=P, tol=PCG_TOL,
             maxiter=PCG_MAXITER)
    resid = true_residual(A2, res.x, b_np)
    check(bool(res.converged) and resid <= PCG_TRUE_RESID,
          f"IC(0)-PCG after refactor: converged={bool(res.converged)} "
          f"after {int(res.iterations)}, true residual {resid:.3e}")
    out = {"case": "spd_from_lower(lung2_like(1.0))/ic0/no_rewriting",
           "refactor_ms": refactor_s * 1e3, "fresh_ic0_ms": fresh_s * 1e3,
           "apply_ms_before": apply_before, "apply_ms_after": apply_after,
           "apply_equal_fresh": bool(torch.equal(z, zf)),
           "apply_rel_diff_fresh": diff, "pcg_iterations": int(
               res.iterations), "pcg_true_residual": resid,
           "repacks": P.forward.stats.repacks + P.backward.stats.repacks}
    log(f"  refactor {out['case']}: {out['refactor_ms']:.1f} ms (fresh ic0 "
        f"{out['fresh_ic0_ms']:.1f} ms), M^-1 {apply_before:.4f} -> "
        f"{apply_after:.4f} ms, equal to fresh {out['apply_equal_fresh']} "
        f"({diff:.1e}); PCG {out['pcg_iterations']} it, true residual "
        f"{resid:.2e}")
    return out


DISK_HIT = """
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, {src!r})
from repro_torch.kernels import sptrsv_level as K
from repro_torch.solver import TriangularOperator
from repro_torch.sparse import generators
L = generators.torso2_like(1.0)
torch.cuda.synchronize()
t0 = time.perf_counter()
op = TriangularOperator.from_csr(L, cache_dir={cache_dir!r})
torch.cuda.synchronize()
secs = time.perf_counter() - t0
b = np.random.default_rng(1).standard_normal(L.n_rows)
np.save({x0_path!r}, op.solve(b, max_refine=0))
op.solve(b)
print(json.dumps({{"cache_source": op.stats.cache_source,
                  "strategy": op.strategy, "seconds": secs,
                  "pack_groups": K.PACKS["pack_groups"],
                  "residual": op.stats.last_residual,
                  "launches": K.LAUNCHES["sptrsv_groups"]}}))
"""


def life_disk(mats, cache_dir: str, tuned: dict) -> dict:
    """A fresh process asks for the operator phase 6 tuned on torso2 with
    the same cache_dir: a disk hit, the same pick, nothing packed."""
    L = mats["torso2_like"]
    x0_path = str(Path(cache_dir) / "x0.npy")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", DISK_HIT.format(
            src=str(ROOT / "src"), cache_dir=cache_dir, x0_path=x0_path)],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"disk-hit process failed:\n{proc.stderr}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    b = np.random.default_rng(1).standard_normal(L.n_rows)
    x_ref = oracle(L, b)
    err0 = float(np.abs(np.load(x0_path) - x_ref).max()) / max(
        1.0, float(np.abs(x_ref).max()))
    check(got["cache_source"] == "disk" and got["pack_groups"] == 0 and
          got["strategy"] == tuned["pick"],
          f"disk hit: {got} (phase 6 picked {tuned['pick']})")
    check(err0 <= ORACLE_RTOL and got["residual"] <= REFINE_TOL,
          f"disk hit: unrefined error {err0:.3e}, residual "
          f"{got['residual']:.3e}")
    out = dict(got, err_max_refine0=err0, process_s=wall,
               tune_s=tuned["seconds"])
    log(f"  disk hit in a new process: torso2 {got['strategy']} from_csr "
        f"{got['seconds']:.2f} s (the tune took {tuned['seconds']:.1f} s; "
        f"process {wall:.1f} s), packs {got['pack_groups']}, "
        f"err0={err0:.2e} resid={got['residual']:.2e}")
    return out


def life_sptrsv(rng, mats) -> list:
    """sptrsv with a float32 CUDA b that requires grad, on lung2's L in all
    four sweeps: the forward against the oracle, the gradient of
    (x * w).sum() against the flipped solve, a second-order gradient
    through create_graph=True; forward and backward ms, K1 launches a
    call."""
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver import sptrsv
    L = mats["lung2_like"]
    n = L.n_rows
    rows = []
    for lower, transpose in ((True, False), (True, True), (False, False),
                             (False, True)):
        A = L if lower else L.transpose()
        kw = {"lower": lower, "transpose": transpose}
        b_np = rng.standard_normal(n)
        w_np = rng.standard_normal(n)
        b = torch.tensor(b_np, dtype=torch.float32, device=DEVICE,
                         requires_grad=True)
        w = torch.as_tensor(w_np, dtype=torch.float32, device=DEVICE)
        x = sptrsv(A, b, **kw)                  # builds both operators
        (g,) = torch.autograd.grad((x * w).sum(), b)
        x_ref = oracle(A, b_np, transpose=transpose) if lower else \
            oracle(L, b_np, transpose=not transpose)
        g_ref = oracle(L, w_np, transpose=not transpose) if lower else \
            oracle(L, w_np, transpose=transpose)
        _, err = rel_err(x.detach().cpu(), torch.as_tensor(x_ref))
        _, gerr = rel_err(g.cpu(), torch.as_tensor(g_ref))
        check(x.device == b.device and x.dtype == torch.float32 and
              err <= SPTRSV_RTOL and gerr <= SPTRSV_RTOL,
              f"sptrsv {kw}: forward error {err:.3e}, gradient error "
              f"{gerr:.3e}")
        # second order: grad of sum(x^2) is 2 A^-T x; its grad of the sum
        # is 2 A^-T A^-1 1
        x2 = sptrsv(A, b, **kw)
        (g2,) = torch.autograd.grad((x2 ** 2).sum(), b, create_graph=True)
        (h,) = torch.autograd.grad(g2.sum(), b)
        h_ref = 2 * sptrsv(A, sptrsv(A, np.ones(n), **kw), lower=lower,
                           transpose=not transpose)
        _, herr = rel_err(h.cpu(), torch.as_tensor(h_ref))
        check(g2.requires_grad and herr <= SPTRSV_RTOL,
              f"sptrsv {kw}: second-order error {herr:.3e}")
        before = K.LAUNCHES["sptrsv_groups"]
        fwd_ms = 1e3 * median_solve_s(lambda: sptrsv(A, b, **kw))
        per_call = (K.LAUNCHES["sptrsv_groups"] - before) / (SOLVE_REPS + 1)
        bwd_ms = 1e3 * median_solve_s(lambda: torch.autograd.grad(
            (sptrsv(A, b, **kw) * w).sum(), b)) - fwd_ms
        row = {"lower": lower, "transpose": transpose, "forward_err": err,
               "grad_err": gerr, "second_order_err": herr,
               "forward_ms": fwd_ms, "backward_ms": bwd_ms,
               "k1_launches_per_forward": per_call}
        rows.append(row)
        log(f"  sptrsv lower={lower!s:5} transpose={transpose!s:5} "
            f"err={err:.1e} grad_err={gerr:.1e} 2nd={herr:.1e} forward "
            f"{fwd_ms:.2f} ms backward {bwd_ms:.2f} ms, K1 launches a "
            f"forward {per_call:.1f}")
    return rows


def phase_lifecycle(rng, cache_dir: str, tuned: dict) -> tuple:
    """The operator's life after its build at full size (module doc, phase
    7).  Returns (result, launch counts of this path)."""
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver import TriangularOperator
    from repro_torch.sparse import generators
    mats = {m: getattr(generators, m)(1.0)
            for m in ("lung2_like", "torso2_like")}
    TriangularOperator.clear_memory_cache()
    K.reset_launch_counts()
    res = {"updates": life_updates(rng, mats),
           "zero_trap": life_zero_trap(mats),
           "refactor": life_refactor(rng, mats),
           "disk": life_disk(mats, cache_dir, tuned),
           "sptrsv": life_sptrsv(rng, mats)}
    counts = dict(K.LAUNCHES)
    log(f"  launches on the life-cycle path: {counts}")
    check(counts["sptrsv_groups"] > 0 and counts["sptrsv_groups_multi"] > 0,
          f"a kernel of the life-cycle path was never launched: {counts}")
    check(counts["plain"] == 0,
          f"the plain version ran on the life-cycle path: {counts}")
    return res, counts


# -- phase 8: the solve service --------------------------------------------

SERVE_REQUESTS, SERVE_TENANTS, SERVE_STEPS = 240, 3, 3
SERVE_WIDTH, SERVE_LINGER_S, SERVE_WORKERS = 8, 0.002, 2
# the traced stretch: a burst of hot requests under torch.profiler
TRACE_REQUESTS = 48


def percentiles(samples: list) -> dict:
    from repro_torch.obs.metrics import nearest_rank_percentile
    return {"p50": nearest_rank_percentile(samples, 50),
            "p99": nearest_rank_percentile(samples, 99),
            "n": len(samples)}


def serve_stretch(svc, mats, seed: int) -> dict:
    """run_workload (the server's traffic: request i on pattern i % 3,
    value step (i // 7) % 3, tenant i % 3), every answer held against the
    float64 oracle at ORACLE_RTOL; the queue and solve ms of this stretch
    alone."""
    from repro_torch.serving.server import run_workload
    q0, s0 = len(svc.stats.queue_ms), len(svc.stats.solve_ms)
    t0 = time.perf_counter()
    out = run_workload(svc, mats, requests=SERVE_REQUESTS,
                       tenants=SERVE_TENANTS, value_steps=SERVE_STEPS,
                       seed=seed, rel_tol=ORACLE_RTOL)
    secs = time.perf_counter() - t0
    check(not out["errors"] and out["checked"] == SERVE_REQUESTS,
          f"served {out['checked']} of {SERVE_REQUESTS} right: "
          f"{out['errors'][:3]}")
    return {"seconds": secs, "checked": out["checked"],
            "queue_ms": percentiles(svc.stats.queue_ms[q0:]),
            "solve_ms": percentiles(svc.stats.solve_ms[s0:])}


def burst(svc, reqs: list) -> tuple:
    """Submit every (matrix, b) of `reqs` at once from SERVE_TENANTS
    threads, then wait for all: (answers, seconds, queue and solve ms,
    mean batch width of this burst)."""
    from concurrent.futures import ThreadPoolExecutor
    q0, s0 = len(svc.stats.queue_ms), len(svc.stats.solve_ms)
    w0 = dict(svc.stats.width_hist)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_TENANTS) as pool:
        futs = list(pool.map(
            lambda ib: svc.submit(ib[1][1], ib[1][0],
                                  tenant=f"tenant-{ib[0] % SERVE_TENANTS}"),
            enumerate(reqs)))
    xs = [f.result(timeout=300) for f in futs]
    secs = time.perf_counter() - t0
    widths = {w: c - w0.get(w, 0) for w, c in svc.stats.width_hist.items()}
    batches = sum(widths.values())
    return xs, {"seconds": secs, "requests_per_s": len(reqs) / secs,
                "batches": batches,
                "mean_width": sum(w * c for w, c in widths.items())
                / max(batches, 1),
                "queue_ms": percentiles(svc.stats.queue_ms[q0:]),
                "solve_ms": percentiles(svc.stats.solve_ms[s0:])}


def admit_hash_ms(M) -> float:
    """Host ms of what every `submit` of M pays before it queues: the
    registry's pattern and value fingerprints (median of 5)."""
    from repro_torch.solver.operator import (matrix_fingerprint,
                                             value_fingerprint)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        matrix_fingerprint(M, include_values=False)
        value_fingerprint(M)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def serve_compare(registry, reqs: list) -> dict:
    """The same hot requests through a batched service and a width-1 one
    over the same warm registry, in turns (batched, width 1, width 1,
    batched): the batched answers must equal the width-1 ones (K2 against
    K1) within KERNEL_RTOL; requests/s is printed, not gated."""
    from repro_torch.serving import SolveService
    runs = {"batched": [], "width1": []}
    answers = {}
    for label in ("batched", "width1", "width1", "batched"):
        width = SERVE_WIDTH if label == "batched" else 1
        with SolveService(max_width=width, max_linger_s=SERVE_LINGER_S,
                          workers=SERVE_WORKERS, tenant_cap=len(reqs),
                          registry=registry) as svc:
            xs, row = burst(svc, reqs)
        runs[label].append(row)
        answers[label] = xs
    err = max(float(np.abs(a.astype(np.float64) - b).max())
              / max(1.0, float(np.abs(b).max()))
              for a, b in zip(answers["batched"], answers["width1"]))
    check(err <= KERNEL_RTOL, f"batched answers differ from width-1 ones "
          f"by {err:.3e} (relative to scale)")
    rate = {k: float(np.median([r["requests_per_s"] for r in v]))
            for k, v in runs.items()}
    return {"runs": runs, "max_rel_diff": err,
            "requests_per_s": rate,
            "speedup": rate["batched"] / rate["width1"]}


def serve_traced(registry, reqs: list) -> dict:
    """A burst with obs.enable(annotate_torch=True) under torch.profiler:
    the tracer's Chrome trace and the service's Prometheus page must
    validate, and the SpTRSV kernels' device time over serving.solve's
    wall time is the device's busy share of a served batch."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.obs.export import (chrome_trace, validate_chrome_trace,
                                        validate_prometheus_text)
    from repro_torch.serving import SolveService
    tracer = obs.enable(annotate_torch=True)
    try:
        with SolveService(max_width=SERVE_WIDTH,
                          max_linger_s=SERVE_LINGER_S,
                          workers=SERVE_WORKERS, tenant_cap=len(reqs),
                          registry=registry) as svc:
            # record the CPU ops (and so the spans' annotations) of every
            # thread: the service solves on its worker threads
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         experimental_config=_ExperimentalConfig(
                             profile_all_threads=True)) as prof:
                burst(svc, reqs)
                torch.cuda.synchronize()
            page = svc.prometheus_text()
    finally:
        obs.disable()
    doc = chrome_trace(tracer)
    problems = validate_chrome_trace(doc) + validate_prometheus_text(page)
    check(not problems, f"trace/metrics export: {problems[:5]}")
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    for need in ("serving.submit", "serving.queue", "serving.batch",
                 "serving.solve", "operator.solve"):
        check(need in names, f"no {need} span in the served trace")
    solve_ms = sum(e["dur"] for e in spans
                   if e["name"] == "serving.solve") / 1e3
    kern_ms = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()
                  if "sptrsv_" in e.key) / 1e3
    check(any(e.key == "serving.solve" for e in prof.key_averages()),
          "no serving.solve annotation in the torch.profiler trace")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "phase8.trace.json").write_text(json.dumps(doc))
    (out / "phase8.prom").write_text(page)
    return {"spans": len(spans), "serving_solve_ms": solve_ms,
            "kernel_ms": kern_ms,
            "kernel_share": kern_ms / solve_ms if solve_ms else None,
            "prometheus_lines": len(page.splitlines()),
            # device time by kernel; the spans' own annotations, which
            # the profiler also reports with device time, left out
            "top_kernels": top_kernels(
                {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3
                 for e in prof.key_averages() if e.key not in names
                 and getattr(e, "self_device_time_total", 0.0) > 0})}


def serve_cli() -> dict:
    """`python -m repro_torch.serving.server --smoke` as a new process on
    the card: exit code 0 and its report."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.server", "--smoke"],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m repro_torch.serving.server "
          f"--smoke exited {proc.returncode}:\n{proc.stderr[-2000:]}")
    rep = json.loads(proc.stdout)
    st, regs = rep["stats"], rep["stats"]["registry"]
    return {"seconds": secs, "device": rep["device"],
            "checked": rep["checked"], "completed": st["completed"],
            "mean_width": st["mean_width"],
            "hot_swaps": regs["hot_swaps"],
            "tuner_failures": regs["tuner_failures"],
            "value_rebinds": regs["value_rebinds"],
            "states": regs["states"], "entries": rep["entries"]}


def serve_kernels(registry, rng) -> dict:
    """K1 and K2 against their plain version on each served entry's live
    operator, at the shapes the service gives them: one column, and a
    batch padded to SERVE_WIDTH (launches not counted)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver.levelset import pad_rhs
    worst = {"sptrsv_groups": 0.0, "sptrsv_groups_multi": 0.0}
    for _, entry in registry.entries():
        ds = entry.op._staged()
        packed = ds.packed()
        n, nc = packed.n, packed.n_carry
        for name, shape in (("sptrsv_groups", (n,)),
                            ("sptrsv_groups_multi", (n, SERVE_WIDTH))):
            c_pad = pad_rhs(torch.as_tensor(
                rng.standard_normal(shape), dtype=torch.float32,
                device=DEVICE)).contiguous()
            kern = getattr(K, name)
            x = counted(lambda: kern(ds.groups, c_pad, n=n, n_carry=nc,
                                     packed=packed))
            xp = ref.sptrsv_levels_grouped_ref(ds.groups, c_pad, n, nc)
            torch.cuda.synchronize()
            diff, rel = rel_err(x, xp)
            check(bool(torch.isfinite(x).all()) and rel <= KERNEL_RTOL,
                  f"{name} on the served {entry.op.strategy} operator "
                  f"(n={n}): relative error {rel:.3e}")
            worst[name] = max(worst[name], diff)
    return worst


def log_serving(res: dict) -> None:
    snap, regs = res["snapshot"], res["snapshot"]["registry"]
    for label in ("warming", "hot"):
        st = res[label]
        log(f"  {label:8s} stretch: {st['checked']} answers within "
            f"{ORACLE_RTOL:.0e} in {st['seconds']:.2f} s; queue ms p50 "
            f"{st['queue_ms']['p50']:.3f} p99 {st['queue_ms']['p99']:.3f}, "
            f"solve ms p50 {st['solve_ms']['p50']:.3f} p99 "
            f"{st['solve_ms']['p99']:.3f}")
    log(f"  states after the warming stretch "
        f"{res['warming']['states_after']}; every tune done "
        f"{res['warm_s']:.1f} s after the first request")
    for k, e in res["entries"].items():
        log(f"    entry {k}: {e['state']} {e['strategy']} tune_ms="
            f"{e['tune_ms']:.0f} untuned_solves={e['untuned_solves']} "
            f"value_rebinds={e['value_rebinds']} {e['tune_error'][:80]}")
    log(f"  service: submitted {snap['submitted']} completed "
        f"{snap['completed']} failed {snap['failed']}; batches "
        f"{snap['batches']} mean width {snap['mean_width']:.3f} "
        f"{snap['width_hist']}; hot swaps {regs['hot_swaps']}, value "
        f"re-binds {regs['value_rebinds']}, tuner failures "
        f"{regs['tuner_failures']}")
    cmp_ = res["compare"]
    for label, runs in cmp_["runs"].items():
        log(f"  {label:8s} hot burst: " + "; ".join(
            f"{r['requests_per_s']:.1f} req/s, mean width "
            f"{r['mean_width']:.2f}, solve ms p50 {r['solve_ms']['p50']:.3f}"
            f" p99 {r['solve_ms']['p99']:.3f}, queue ms p50 "
            f"{r['queue_ms']['p50']:.3f} p99 {r['queue_ms']['p99']:.3f}"
            for r in runs))
    log(f"  batched / width 1: x{cmp_['speedup']:.2f} requests/s; answers "
        f"within {cmp_['max_rel_diff']:.2e}; a submit's fingerprints take "
        + ", ".join(f"{ms:.2f}" for ms in res["admit_hash_ms"])
        + " ms of host per pattern")
    tr = res["traced"]
    log(f"  traced burst: {tr['spans']} spans, serving.solve "
        f"{tr['serving_solve_ms']:.3f} ms, SpTRSV kernels "
        f"{tr['kernel_ms']:.3f} ms (share {tr['kernel_share']:.3f}); "
        f"serving.solve annotated in the profiler's trace; "
        f"Prometheus page {tr['prometheus_lines']} lines; both valid")
    log(f"  kernels against their plain version on the served operators: "
        f"{res['kernels_vs_plain_max_abs_err']}")
    cli = res["cli"]
    log(f"  python -m repro_torch.serving.server --smoke: exit 0 in "
        f"{cli['seconds']:.1f} s on {cli['device']}, {cli['checked']} "
        f"checked, mean width {cli['mean_width']:.3f}, hot swaps "
        f"{cli['hot_swaps']}, value re-binds {cli['value_rebinds']}, "
        f"tuner failures {cli['tuner_failures']}, states {cli['states']}")
    for k, e in cli["entries"].items():
        log(f"    cli entry {k}: {e['state']} {e['strategy']} hot_swaps="
            f"{e['hot_swaps']} value_rebinds={e['value_rebinds']} "
            f"{e['tune_error'][:200]}")
    log(f"  phase 8 took {res['seconds']:.1f} s")


def phase_serving(rng) -> tuple:
    """The solve service on the card at full size (module doc, phase 8).
    Returns (result, launch counts of this path)."""
    from repro_torch.core.portfolio import (StrategyPortfolio,
                                            default_candidates)
    from repro_torch.core.strategies import (CriticalPathRewrite,
                                             strategy_label)
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.serving import OperatorRegistry, SolveService
    from repro_torch.serving.server import build_matrices
    from repro_torch.solver import TriangularOperator
    mats = build_matrices(1.0, 3, SEED)
    TriangularOperator.clear_memory_cache()
    K.reset_launch_counts()
    res = {"matrices": [{"n": L.n_rows, "nnz": L.nnz} for L in mats]}
    # one registry behind every service of this phase (the mixed stretches,
    # the width comparison, the traced burst), closed at its end.  Its
    # background tune runs the default candidates less critical_path's
    # two, whose host transforms of lung2 take most of two minutes
    # (PERF.md §5)
    pool = [c for c in default_candidates()
            if not isinstance(c, CriticalPathRewrite)]
    reg = OperatorRegistry(tune_mode="background", cache=False,
                           device=DEVICE, portfolio=StrategyPortfolio(
                               candidates=pool, device=DEVICE))
    res["tuner_pool"] = [strategy_label(c) for c in pool]
    try:
        with SolveService(max_width=SERVE_WIDTH, max_linger_s=SERVE_LINGER_S,
                          workers=SERVE_WORKERS, tenant_cap=256,
                          registry=reg) as svc:
            t0 = time.perf_counter()
            res["warming"] = serve_stretch(svc, mats, SEED)
            states = dict(reg.stats()["states"])
            res["warming"]["states_after"] = states
            check(states.get("warming", 0) >= 1,
                  f"no entry was still warming after the first stretch: "
                  f"{states}")
            check(reg.wait_warm(timeout=900), "the background tunes did "
                  "not finish within 900 s")
            res["warm_s"] = time.perf_counter() - t0
            res["hot"] = serve_stretch(svc, mats, SEED + 1)
        snap = svc.snapshot()
        dropped = snap["submitted"] - snap["completed"]
        regs = snap["registry"]
        check(dropped == 0 and snap["failed"] == 0 and
              snap["rejected"] == 0, f"dropped {dropped}, failed "
              f"{snap['failed']}, rejected {snap['rejected']}")
        check(regs["hot_swaps"] >= 1, f"no hot swap: {regs}")
        check(regs["value_rebinds"] >= 1, f"no value re-bind: {regs}")
        entries = reg.stats()["entries"]
        check(sum(e["untuned_solves"] for e in entries.values()) > 0,
              "no request was served while its entry was warming")
        res["snapshot"] = snap
        res["entries"] = {
            k: {f: v for f, v in e.items() if f != "op"} | {
                "tune_ms": e["op"].get("tune_ms"),
                "value_updates": e["op"].get("value_updates")}
            for k, e in entries.items()}
        # hot traffic: each entry's bound values, a right-hand side of its
        # own per request
        bound = [e._values[e.bound_fp] for _, e in reg.entries()]
        reqs = [(bound[i % len(bound)],
                 rng.standard_normal(bound[i % len(bound)].n_rows))
                for i in range(SERVE_REQUESTS)]
        res["admit_hash_ms"] = [admit_hash_ms(M) for M in bound]
        res["compare"] = serve_compare(reg, reqs)
        res["traced"] = serve_traced(reg, reqs[:TRACE_REQUESTS])
        counts = dict(K.LAUNCHES)
        res["kernels_vs_plain_max_abs_err"] = serve_kernels(reg, rng)
    finally:
        reg.close()
    res["cli"] = serve_cli()
    log(f"  launches on the serving path: {counts}")
    check(counts["sptrsv_groups"] > 0 and counts["sptrsv_groups_multi"] > 0,
          f"a kernel of the serving path was never launched: {counts}")
    check(counts["plain"] == 0,
          f"the plain version ran on the serving path: {counts}")
    return res, counts


# -- phase 9: static verification ------------------------------------------

STATIC_STRATEGIES = ("no_rewriting", "avgLevelCost")
STATIC_INJECTORS = (("reorder_schedule_step", "ScheduleInvariantError",
                     "race"),
                    ("duplicate_lane_row", "ScheduleInvariantError",
                     "bijection"),
                    ("oob_ell_index", "ScheduleInvariantError",
                     "index-bounds"),
                    ("corrupt_replay_plan", "TransformInvariantError",
                     "replay-bounds"))
# what the JAX package also locates to a step and a lane
LOCATED = ("race", "bijection", "index-bounds")


@contextlib.contextmanager
def verifier_clock():
    """Host seconds the operator spends in `repro_torch.analysis.verify`
    (outermost calls only, so a verifier calling another counts once),
    and the calls by name.  The operator imports its verifiers from the
    module when it calls them, so wrapping the module's functions sees
    every call."""
    from repro_torch.analysis import verify as V
    names = ("verify_operator_payload", "verify_level_schedule",
             "verify_packed_schedule", "verify_packed_values",
             "verify_schedule_values", "audit_transformed_system")
    real = {n: getattr(V, n) for n in names}
    acc = {"s": 0.0, "calls": {}}
    depth = [0]

    def wrap(name):
        def timed(*args, **kwargs):
            acc["calls"][name] = acc["calls"].get(name, 0) + 1
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    acc["s"] += time.perf_counter() - t0
        return timed

    for n in names:
        setattr(V, n, wrap(n))
    try:
        yield acc
    finally:
        for n in names:
            setattr(V, n, real[n])


def static_builds(rng, mats) -> list:
    """Strict builds of lung2 and torso2 under no_rewriting and
    avgLevelCost, their certificates, and strict solves within phase 4's
    gates."""
    from repro_torch.analysis import certificate_dict
    from repro_torch.solver import TriangularOperator
    rows = []
    for mat, L in mats.items():
        n = L.n_rows
        b = rng.standard_normal(n)
        B = rng.standard_normal((n, 8))
        x_ref = oracle(L, b)
        scale = max(1.0, float(np.abs(x_ref).max()))
        for strat in STATIC_STRATEGIES:
            with verifier_clock() as vc:
                op, build_s = synced_s(lambda: TriangularOperator.from_csr(
                    L, tune=strat, cache=False, health="strict"))
            cert = op.certificate
            pcert = op._payload.get("packed_certificate")
            check(cert is not None and pcert is not None,
                  f"{mat}/{strat}: a strict build carries no certificate")
            levels = dag_levels(lower_with_diag(op.transformed.A,
                                                op.transformed.diag))
            check(pcert["packed"].steps == levels ==
                  op._staged().packed().num_steps,
                  f"{mat}/{strat}: packed certificate steps "
                  f"{pcert['packed'].steps}, DAG levels of A' {levels}")
            x = op.solve(b, health="strict")
            resid = op.stats.last_residual
            x0 = op.solve(b, max_refine=0, health="strict")
            err0 = float(np.abs(x0 - x_ref).max()) / scale
            XB = op.solve(B, health="strict")
            residB = op.stats.last_residual
            check(resid <= REFINE_TOL and x0.dtype == np.float32 and
                  err0 <= ORACLE_RTOL and XB.shape == (n, 8) and
                  residB <= REFINE_TOL,
                  f"{mat}/{strat}: strict solves: residual {resid:.3e}, "
                  f"max_refine=0 error {err0:.3e}, batched residual "
                  f"{residB:.3e}")
            row = {"case": f"{mat}(1.0)/{strat}", "n": n,
                   "build_s": build_s, "verify_s": vc["s"],
                   "verify_calls": vc["calls"],
                   "certificate": certificate_dict(cert),
                   "packed_certificate": {
                       w: (dataclasses.asdict(c) if c is not None else None)
                       for w, c in pcert.items()},
                   "dag_levels": levels, "residual": resid,
                   "err_max_refine0": err0, "residual_batched": residB}
            rows.append(row)
            pc = pcert["packed"]
            pre = pcert["preamble_packed"]
            log(f"  strict {row['case']:28s} build {build_s:.2f} s, verify "
                f"{vc['s']:.3f} s ({vc['s'] / build_s:.1%}); certificate "
                f"steps={cert.steps} levels={cert.levels} critical_path="
                f"{cert.critical_path} nnz={cert.nnz} flops={cert.flops} "
                f"padded_flops={cert.padded_flops}; packed steps={pc.steps} "
                f"(DAG {levels}) tiles={pc.tiles} lanes={pc.lanes} long="
                f"{pc.long_lanes} far={pc.far_pairs} free={pc.free_rows}; "
                f"preamble "
                + (f"steps={pre.steps} tiles={pre.tiles}" if pre else "none")
                + f"; resid={resid:.2e} err0={err0:.2e} residB={residB:.2e}")
    # the certificate rides the memory tier: a second strict build is a hit
    # that verifies nothing
    L = mats["lung2_like"]
    TriangularOperator.clear_memory_cache()
    op1 = TriangularOperator.from_csr(L, tune="no_rewriting",
                                      health="strict")
    with verifier_clock() as vc:
        op2 = TriangularOperator.from_csr(L, tune="no_rewriting",
                                          health="strict")
    check(op2.stats.cache_source == "memory" and
          op2.certificate is op1.certificate and vc["calls"] == {},
          f"strict cache hit: {op2.stats.cache_source}, same certificate "
          f"{op2.certificate is op1.certificate}, verifier calls "
          f"{vc['calls']}")
    log("  strict memory hit: same certificate object, 0 verifier calls")
    TriangularOperator.clear_memory_cache()
    return rows


def static_injectors(mats) -> dict:
    """The four static defects under strict from_csr on the card: each a
    typed error before any pack or launch.  Then what reorder and duplicate
    do with the checks off."""
    from repro_torch.core import faults
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver import TriangularOperator
    L = mats["lung2_like"]
    res = {}
    for name, exc, want in STATIC_INJECTORS:
        packs, launches = dict(K.PACKS), dict(K.LAUNCHES)
        got = None
        t0 = time.perf_counter()
        with getattr(faults, name)() as count:
            try:
                TriangularOperator.from_csr(L, tune="avgLevelCost",
                                            cache=False, health="strict")
            except Exception as e:      # noqa: BLE001 - judged below
                got = e
        secs = time.perf_counter() - t0
        unchanged = dict(K.PACKS) == packs and dict(K.LAUNCHES) == launches
        res[name] = {"calls": count["calls"], "seconds": secs,
                     "raised": type(got).__name__, "error": str(got)[:300],
                     "check": getattr(got, "check", None),
                     "step": getattr(got, "step", None),
                     "lane": getattr(got, "lane", None),
                     "packs_and_launches_unchanged": unchanged}
        log(f"  strict + {name}: {type(got).__name__} [{res[name]['check']}]"
            f" step={res[name]['step']} lane={res[name]['lane']} in "
            f"{secs:.2f} s, packs and launches unchanged: {unchanged}")
        check(type(got).__name__ == exc and got.check == want and
              count["calls"] >= 1 and unchanged and
              (want not in LOCATED or (got.step >= 0 and got.lane >= 0)),
              f"{name} under strict: {res[name]}")
    b = np.random.default_rng(SEED).standard_normal(L.n_rows)
    x_ref = oracle(L, b)
    for name in ("reorder_schedule_step", "duplicate_lane_row"):
        with getattr(faults, name)():
            try:
                op = TriangularOperator.from_csr(L, tune="avgLevelCost",
                                                 cache=False, health="off")
                x = op.solve(b, max_refine=0, health="off")
                err = float(np.abs(x - x_ref).max()) / max(
                    1.0, float(np.abs(x_ref).max()))
                out = {"outcome": "answer", "finite": bool(
                    np.isfinite(x).all()), "err_vs_oracle": err}
            except ValueError as e:
                out = {"outcome": "ValueError", "error": str(e)[:300]}
        res[f"{name}_off"] = out
        log(f"  health='off' + {name}: {out}")
    return res


def static_updates(rng, mats) -> dict:
    """Ten strict update_values steps on lung2's L (no_rewriting: device
    refreshes), each step's refreshed words certified; the audit's ms
    beside unaudited steps'; a poisoned re-bind refused with the operator
    left on its values."""
    from repro_torch.analysis import verify as V
    from repro_torch.core import faults
    from repro_torch.core.resilience import ScheduleInvariantError
    from repro_torch.solver import TriangularOperator
    L = mats["lung2_like"]
    off = offdiag_mask(L)
    b = rng.standard_normal(L.n_rows)
    op = TriangularOperator.from_csr(L, tune="no_rewriting", cache=False,
                                     health="strict")

    def values(k):
        data = L.data.copy()
        data[off] *= 1 + 0.01 * k
        return L.with_data(data)

    strict_ms, audit_ms, plain_ms, err0 = [], [], [], []
    for k in range(1, UPDATE_STEPS + 1):
        Lk = values(k)
        with verifier_clock() as vc:
            _, secs = synced_s(lambda: op.update_values(Lk, health="strict"))
        strict_ms.append(secs * 1e3)
        audit_ms.append(vc["s"] * 1e3)
        pc = op._payload.get("packed_certificate")["packed"]
        check(pc.checks == V.PACKED_VALUE_CHECKS and
              vc["calls"].get("verify_packed_values", 0) >= 1,
              f"update {k}: the refreshed words were not certified "
              f"({pc.checks}, {vc['calls']})")
        x_ref = oracle(Lk, b)
        err0.append(float(np.abs(op.solve(b, max_refine=0) - x_ref).max())
                    / max(1.0, float(np.abs(x_ref).max())))
        check(err0[-1] <= ORACLE_RTOL, f"update {k}: error {err0[-1]:.3e}")
    for k in range(UPDATE_STEPS + 1, UPDATE_STEPS + 4):
        Lk = values(k)
        _, secs = synced_s(lambda: op.update_values(Lk))
        plain_ms.append(secs * 1e3)
    # a poisoned re-bind: refused, the operator keeps the last values
    Lk = values(UPDATE_STEPS + 3)
    x_ref = oracle(Lk, b)
    got = None
    with faults.corrupt_values_payload() as count:
        try:
            op.update_values(values(50), health="strict")
        except ScheduleInvariantError as e:
            got = e
    x0 = op.solve(b, max_refine=0)
    err = float(np.abs(x0 - x_ref).max()) / max(1.0,
                                                float(np.abs(x_ref).max()))
    x = op.solve(b)
    check(got is not None and got.check in ("finite", "dinv") and
          count["calls"] >= 1 and err <= ORACLE_RTOL and
          op.stats.last_residual <= REFINE_TOL,
          f"poisoned update: raised {got!r}, then error {err:.3e}, "
          f"residual {op.stats.last_residual:.3e}")
    res = {"strict_ms": strict_ms, "audit_ms": audit_ms,
           "unaudited_ms": plain_ms,
           "strict_ms_median": float(np.median(strict_ms)),
           "audit_ms_median": float(np.median(audit_ms)),
           "unaudited_ms_median": float(np.median(plain_ms)),
           "err_max_refine0": max(err0),
           "poisoned": {"check": got.check, "error": str(got)[:300],
                        "err_after": err}}
    log(f"  strict update_values lung2_like(1.0)/no_rewriting: median "
        f"{res['strict_ms_median']:.1f} ms, of which the audit "
        f"{res['audit_ms_median']:.1f} ms; unaudited step "
        f"{res['unaudited_ms_median']:.1f} ms; err0={max(err0):.2e}; "
        f"poisoned re-bind -> [{got.check}], then err0 {err:.2e}")
    return res


def static_profiling(rng, mats) -> dict:
    """ProfilingEngine over the "cuda" engine on lung2 no_rewriting: K1's
    stamped form serves the solve and leaves its profile."""
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.obs.profile import ProfilingEngine
    from repro_torch.solver import TriangularOperator
    from repro_torch.solver.engines import get_engine
    L = mats["lung2_like"]
    b = rng.standard_normal(L.n_rows)
    op = TriangularOperator.from_csr(L, tune="no_rewriting", cache=False)
    x_serve = op.solve(b, max_refine=0)
    eng = ProfilingEngine(get_engine("cuda"))
    before = K.LAUNCHES["sptrsv_groups_stamped"]
    x = op.solve(b, max_refine=0, engine=eng)
    stamped = K.LAUNCHES["sptrsv_groups_stamped"] - before
    x_ref = oracle(L, b)
    scale = max(1.0, float(np.abs(x_ref).max()))
    diff = float(np.abs(x.astype(np.float64) - x_serve).max()) / scale
    err = float(np.abs(x - x_ref).max()) / scale
    prof = eng.last_profile
    steps = op._staged().packed().num_steps
    # a batched right side goes through the stamped form column by column
    B = rng.standard_normal((L.n_rows, 2))
    XB_serve = op.solve(B, max_refine=0)
    before_b = K.LAUNCHES["sptrsv_groups_stamped"]
    XB = op.solve(B, max_refine=0, engine=eng)
    diff_b = float(np.abs(np.asarray(XB, np.float64) - XB_serve).max()) / \
        max(1.0, float(np.abs(XB_serve).max()))
    res = {"rel_diff_vs_serving": diff, "err_vs_oracle": err,
           "profile_steps": prof.num_steps, "packed_steps": steps,
           "stamped_launches": stamped, "event_ms": prof.event_ms,
           "stamped_ms": prof.stamped_ms, "launch_us": prof.launch_us,
           "batched_rel_diff_vs_serving": diff_b,
           "batched_stamped_launches":
               K.LAUNCHES["sptrsv_groups_stamped"] - before_b}
    log(f"  ProfilingEngine(cuda) lung2_like(1.0)/no_rewriting: diff vs "
        f"serving K1 {diff:.2e}, err {err:.2e}, profile steps "
        f"{prof.num_steps} (packed {steps}), stamped launches {stamped}, "
        f"event {prof.event_ms} ms, stamps {prof.stamped_ms} ms; B (n, 2) "
        f"diff vs serving K2 {diff_b:.2e}, stamped launches "
        f"{res['batched_stamped_launches']}")
    check(diff <= KERNEL_RTOL and err <= ORACLE_RTOL and
          prof.num_steps == steps and stamped > 0 and
          XB.shape == B.shape and diff_b <= KERNEL_RTOL and
          res["batched_stamped_launches"] >= 2,
          f"ProfilingEngine: {res}")
    return res


def phase_static(rng) -> tuple:
    """Static verification on the card at full size (module doc, phase
    9).  Returns (result, launch counts of this path)."""
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver import TriangularOperator
    from repro_torch.sparse import generators
    mats = {m: getattr(generators, m)(1.0)
            for m in ("lung2_like", "torso2_like")}
    TriangularOperator.clear_memory_cache()
    K.reset_launch_counts()
    res = {"builds": static_builds(rng, mats),
           "injectors": static_injectors(mats),
           "updates": static_updates(rng, mats),
           "profiling_engine": static_profiling(rng, mats)}
    counts = dict(K.LAUNCHES)
    log(f"  launches on the static-verification path: {counts}")
    check(counts["sptrsv_groups"] > 0 and counts["sptrsv_groups_multi"] > 0
          and counts["sptrsv_groups_stamped"] > 0,
          f"a kernel of the static-verification path was never launched: "
          f"{counts}")
    check(counts["plain"] == 0,
          f"the plain version ran on the static-verification path: {counts}")
    return res, counts


# -- phase 10: runtime resilience ---------------------------------------------

# wrong_schedule_values factors: 1.01 leaves a residual of ~1e-2 that
# each refinement round through K1 cuts ~100-fold (the iteration's
# spectral radius is |1 - f|), so two or three rounds reach the policy's
# residual_tol of 1e-5; at 3.0 (|1 - f| = 2) refinement diverges and the
# solve raises: on a card there is no host reference to escalate to.
# Picked on the CPU at lung2_like/torso2_like(0.02, 0.1), where 1.01 is
# repaired in two rounds (residual ~2e-6) and 1.05 is not in three.
WRONG_REPAIRED, WRONG_UNREPAIRED = 1.01, 3.0
# phase 11: timed sharded sweeps a case (each takes a fraction of a
# second), and the limit on its two gloo ranks' processes
SHARDED_REPS = 3
SHARDED_RANK_TIMEOUT_S = 420


def count_reference_solves() -> dict:
    """From here on, count every host reference solve an operator serves
    (`TriangularOperator._reference_solve`, the escape hatch of the
    "repair" and "fallback" policies on the CPU, which must never serve
    a card's operator): {"calls": n}."""
    from repro_torch.solver import TriangularOperator
    real = TriangularOperator._reference_solve
    count = {"calls": 0}

    def counted_reference(self, b):
        count["calls"] += 1
        return real(self, b)

    TriangularOperator._reference_solve = counted_reference
    return count


def recorded(fn) -> tuple:
    """(what fn() returned, or the exception it raised; the resilience
    warnings it gave, by class name).  The caller judges both."""
    import collections
    import warnings
    from repro_torch.core.resilience import ResilienceWarning
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            out = fn()
        except Exception as e:      # noqa: BLE001 - judged by the caller
            out = e
    return out, dict(collections.Counter(
        w.category.__name__ for w in rec
        if issubclass(w.category, ResilienceWarning)))


def resilience_matrix(mat: str, L, rng, refs: dict) -> dict:
    """Phase 10's cases on one matrix (module doc)."""
    from repro_torch.core import faults
    from repro_torch.core.resilience import (EngineFallbackError,
                                             HealthPolicy,
                                             NumericalHealthError)
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver import TriangularOperator, set_fallback_chain
    n = L.n_rows
    b = rng.standard_normal(n)
    x_ref = oracle(L, b)
    scale = max(1.0, float(np.abs(x_ref).max()))
    res, ops = {}, []

    def build():
        op = TriangularOperator.from_csr(L, tune="no_rewriting", cache=False)
        ops.append(op)
        return op

    def err(x):
        return float(np.abs(np.asarray(x, np.float64) - x_ref).max()) / scale

    def solve(op, rhs=b, **kw):
        """One recorded solve: (x or exception, warnings, K1 launches, K2
        launches, reference solves) it made."""
        k1, k2 = K.LAUNCHES["sptrsv_groups"], K.LAUNCHES["sptrsv_groups_multi"]
        r0 = refs["calls"]
        out, warned = recorded(lambda: op.solve(rhs, **kw))
        return (out, warned, K.LAUNCHES["sptrsv_groups"] - k1,
                K.LAUNCHES["sptrsv_groups_multi"] - k2, refs["calls"] - r0)

    # a healthy operator: the same K1 answer under every level
    op = build()
    xs = {}
    for level in ("on", "repair", "fallback"):
        x, warned, k1, _, nref = solve(op, max_refine=0, health=level)
        check(isinstance(x, np.ndarray) and k1 == 1 and nref == 0 and
              not warned, f"{mat} healthy/{level}: {x!r:.200} K1 {k1}, "
              f"reference {nref}, warnings {warned}")
        xs[level] = x
    check(all(np.array_equal(xs["on"], x) for x in xs.values()) and
          err(xs["on"]) <= ORACLE_RTOL and op.stats.fallbacks == 0 and
          op.stats.health_events == 0,
          f"{mat} healthy: answers differ across levels or from the oracle "
          f"({err(xs['on']):.3e}), stats {op.stats.to_dict()}")
    B = rng.standard_normal((n, 8))
    XB, warned, k1, k2, nref = solve(op, rhs=B, health="repair")
    check(isinstance(XB, np.ndarray) and k2 >= 1 and nref == 0 and
          op.stats.last_residual <= REFINE_TOL and not warned,
          f"{mat} batched under repair: K2 {k2}, reference {nref}, "
          f"residual {op.stats.last_residual:.3e}")
    res["healthy"] = {"err_max_refine0": err(xs["on"]), "bitwise": True,
                      "batched_k2_launches": k2,
                      "batched_residual": op.stats.last_residual}

    # a poisoned payload: on a card the host reference never serves, so
    # every level raises; "repair" first spends its rounds through K1
    with faults.nan_schedule_payload():
        op_nan = build()
    raised = {}
    for level in ("on", "fallback", "repair"):
        e, warned, k1, _, nref = solve(op_nan, health=level)
        want = ("repair",) if level == "repair" else ()
        check(isinstance(e, NumericalHealthError) and e.stage == "output"
              and tuple(e.fallbacks) == want and nref == 0 and
              k1 == (2 if level == "repair" else 1) and not warned and
              op_nan.stats.last_health_event == "output:raised",
              f"{mat} nan payload/{level}: {e!r:.300} K1 {k1}, reference "
              f"{nref}, warnings {warned}, event "
              f"{op_nan.stats.last_health_event}")
        raised[level] = {"raised": type(e).__name__, "k1_launches": k1,
                         "fallbacks": list(getattr(e, "fallbacks", ()))}
    res["nan_payload"] = raised

    # finitely wrong values under a residual check that repairs: K1's
    # rounds repair the one factor and cannot repair the other, which
    # then raises
    policy = HealthPolicy(residual_check=True, on_nonfinite="repair")
    res["wrong_values"] = {}
    for factor, outcome in ((WRONG_REPAIRED, "residual:repaired"),
                            (WRONG_UNREPAIRED, "residual:raised")):
        with faults.wrong_schedule_values(factor):
            op_w = build()
        x, warned, k1, _, nref = solve(op_w, max_refine=0, health=policy)
        resid = op_w.stats.last_residual
        if outcome == "residual:repaired":
            ok = (isinstance(x, np.ndarray) and
                  resid <= policy.residual_tol and
                  warned == {"HealthRepairWarning": 1})
        else:
            ok = (isinstance(x, NumericalHealthError) and
                  x.stage == "residual" and
                  tuple(x.fallbacks) == ("repair",) and not warned and
                  k1 == 1 + policy.max_repair_rounds)
        check(ok and op_w.stats.last_health_event == outcome and k1 >= 2
              and nref == 0,
              f"{mat} wrong values x{factor}: {x!r:.200} event "
              f"{op_w.stats.last_health_event} (want {outcome}), K1 {k1}, "
              f"reference {nref}, residual {resid:.3e}, warnings {warned}")
        res["wrong_values"][str(factor)] = {
            "event": outcome, "k1_launches": k1,
            "residual": resid if isinstance(x, np.ndarray) else None,
            "reference_solves": nref}

    # a dead chain: compile failure at the build, or an engine that
    # reports itself unavailable; the chain names the plain engine, which
    # the resolution never returns for a card.  Every level raises
    set_fallback_chain("cuda", ("torch",))
    try:
        for fault in ("fail_engine_compile", "engine_unavailable"):
            if fault == "engine_unavailable":
                op_d = build()          # compiled: the solve checks
            with getattr(faults, fault)("cuda"):
                if fault == "fail_engine_compile":
                    op_d = build()      # the build's compile fails
                for level in ("on", "repair", "fallback"):
                    e, warned, k1, _, nref = solve(op_d, health=level)
                    check(isinstance(e, EngineFallbackError) and
                          [a for a, _ in e.attempts] == ["cuda"] and
                          k1 == 0 and nref == 0 and not warned,
                          f"{mat} {fault}/{level}: {e!r:.300} K1 {k1}, "
                          f"reference {nref}, warnings {warned}")
            check(op_d.stats.health_events == 0, f"{mat} {fault}: health "
                  f"events {op_d.stats.health_events}")
            again, _, k1, _, nref = solve(op_d, health="fallback")
            check(isinstance(again, EngineFallbackError) and
                  "previously failed" in str(again) and k1 == 0 and
                  nref == 0, f"{mat} {fault}: after the fault the operator "
                  f"did not refuse the engine: {again!r:.300}")
            fresh = build()
            x, _, k1, _, nref = solve(fresh, max_refine=0)
            check(isinstance(x, np.ndarray) and k1 == 1 and
                  err(x) <= ORACLE_RTOL, f"{mat} {fault}: a fresh operator "
                  f"did not serve through K1 ({x!r:.200}, K1 {k1})")
            res[fault] = {"attempts": [list(a) for a in e.attempts],
                          "fresh_err": err(x)}
    finally:
        set_fallback_chain("cuda", ())

    # a staging failure at the build fails that build only: a memory hit
    # of the same matrix stages anew and serves through K1
    from repro_torch.solver import levelset
    real_stage, staged = levelset.to_device, {"n": 0}

    def stage_once(*args, **kwargs):
        if not staged["n"]:
            staged["n"] += 1
            raise RuntimeError("injected staging failure")
        return real_stage(*args, **kwargs)

    levelset.to_device = stage_once
    try:
        e, _ = recorded(lambda: TriangularOperator.from_csr(
            L, tune="no_rewriting"))
    finally:
        levelset.to_device = real_stage
    op_m = TriangularOperator.from_csr(L, tune="no_rewriting")
    ops.append(op_m)
    x, _, k1, _, nref = solve(op_m, max_refine=0)
    check(isinstance(e, RuntimeError) and "staging" in str(e) and
          staged["n"] == 1 and op_m.stats.cache_source == "memory" and
          not op_m._runtime.get("engine_failures") and
          isinstance(x, np.ndarray) and k1 == 1 and nref == 0 and
          err(x) <= ORACLE_RTOL,
          f"{mat} staging failure at the build: {e!r:.300}; memory hit "
          f"{op_m.stats.cache_source}, K1 {k1}, {x!r:.200}")
    res["staging_failure"] = {"raised": type(e).__name__,
                              "memory_hit_k1": k1}

    # a transient launch failure: that solve raises, the next is K1's
    real, fired = K._launch, {"n": 0}

    def once(packed, c_pad):
        if not fired["n"]:
            fired["n"] += 1
            raise RuntimeError("injected transient launch failure")
        return real(packed, c_pad)

    K._launch = once
    try:
        e, _, _, _, nref = solve(op, max_refine=0)
    finally:
        K._launch = real
    x, _, k1, _, _ = solve(op, max_refine=0)
    check(isinstance(e, EngineFallbackError) and "transient" in str(e) and
          fired["n"] == 1 and nref == 0 and
          not op._runtime.get("engine_failures") and
          isinstance(x, np.ndarray) and k1 == 1 and
          np.array_equal(x, xs["on"]),
          f"{mat} transient launch failure: {e!r:.300}; next solve K1 {k1}")
    res["transient"] = {"raised": type(e).__name__, "next_k1": k1}

    # no operator was ever downgraded, and none compiled the plain engine
    check(all(o.stats.fallbacks == 0 and
              "torch" not in o._runtime["compiled"] for o in ops),
          f"{mat}: an operator fell back or compiled the plain engine")
    res["repaired_solves"] = sum(
        1 for r in res["wrong_values"].values()
        if r["event"] == "residual:repaired")
    res["operators"] = len(ops)
    return res


def phase_resilience(rng, refs: dict) -> tuple:
    """Runtime resilience at full size (module doc, phase 10).  Returns
    (result, launch counts of this path)."""
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.solver import TriangularOperator
    from repro_torch.sparse import generators
    TriangularOperator.clear_memory_cache()
    K.reset_launch_counts()
    r0 = refs["calls"]
    res = {}
    for mat in ("lung2_like", "torso2_like"):
        t0 = time.perf_counter()
        res[mat] = resilience_matrix(mat, getattr(generators, mat)(1.0), rng,
                                     refs)
        res[mat]["seconds"] = time.perf_counter() - t0
        log(f"  {mat}(1.0): {json.dumps(res[mat], default=str)}")
    counts = dict(K.LAUNCHES)
    res["reference_solves"] = refs["calls"] - r0
    res["repaired_solves"] = sum(res[m]["repaired_solves"]
                                 for m in ("lung2_like", "torso2_like"))
    log(f"  reference-served solves {res['reference_solves']}, repaired "
        f"solves {res['repaired_solves']}; launches K1 "
        f"{counts['sptrsv_groups']}, K2 {counts['sptrsv_groups_multi']}, "
        f"plain {counts['plain']}")
    check(counts["sptrsv_groups"] > 0 and counts["sptrsv_groups_multi"] > 0,
          f"a kernel of the resilience path was never launched: {counts}")
    check(counts["plain"] == 0,
          f"the plain version ran on the resilience path: {counts}")
    check(res["reference_solves"] == 0, f"the host reference served "
          f"{res['reference_solves']} solves of a card's operator")
    return res, counts


def study_cases() -> list:
    """(label, schedule) of lung2's and torso2's L and IC(0) L^T at full
    scale: the forward and backward sweeps of the main paths."""
    from repro_torch.precond import factorize
    from repro_torch.solver.operator import orient_lower
    from repro_torch.solver.schedule import schedule_for_csr
    from repro_torch.sparse import generators
    from repro_torch.sparse.levels import build_levels
    out = []
    for mat in ("lung2_like", "torso2_like"):
        L = getattr(generators, mat)(1.0)
        fac = factorize.ic0(generators.spd_from_lower(L, seed=0))
        Lt = orient_lower(fac.L, "lower", True)[0]
        for label, M in ((f"{mat}(1.0)", L), (f"{mat}(1.0)/ic0/L^T", Lt)):
            out.append((label, schedule_for_csr(M, build_levels(M))))
    return out


def study_rhs(sched, R: int, rng) -> torch.Tensor:
    from repro_torch.solver.levelset import pad_rhs
    return pad_rhs(torch.as_tensor(rng.standard_normal((sched.n, R)),
                                   dtype=torch.float32,
                                   device="cuda")).contiguous()


def phase_sweep(rng) -> dict:
    """K1/K2 (R = 1, 8) on the study cases at every consumer count, 32 to
    MAX_CONSUMERS, then the ratio ROUND_WARPS of `consumer_threads` that
    minimizes the summed excess of the chosen count's time over the
    fastest count's, case by case."""
    from repro_torch.kernels import sptrsv_level as K
    rows = []
    for label, sched in study_cases():
        packed = K.pack_schedule(sched).to("cuda")
        for R in (1, 8):
            c_pad = study_rhs(sched, R, rng)
            call = lambda: K.sptrsv_groups_multi(None, c_pad, n=sched.n,
                                                 n_carry=sched.n_carry,
                                                 packed=packed)
            ms = {}
            for threads in range(32, K.MAX_CONSUMERS + 1, 32):
                packed.consumers[R] = threads   # consumer_threads' cache
                ms[threads] = time_ms(call, KERNEL_REPS)
            del packed.consumers[R]
            warps, book, rounds = K.consumer_terms(packed, R)
            best = min(ms, key=ms.get)
            rows.append({"case": label, "R": R, "ms": ms, "best": best,
                         "chosen": K.consumer_threads(packed, R),
                         "book": book.tolist(), "rounds": rounds.tolist()})
            log(f"  sweep {label:28s} R={R}: fastest {best} threads "
                f"{ms[best]:.4f} ms; chosen {rows[-1]['chosen']} "
                f"{ms[rows[-1]['chosen']]:.4f} ms; 32/256/512/992: "
                + "/".join(f"{ms[t]:.4f}" for t in (32, 256, 512, 992)))

    def excess(rho):
        tot = 0.0
        for r in rows:
            w = int(np.argmin(np.asarray(r["book"]) +
                              rho * np.asarray(r["rounds"]))) + 1
            tot += r["ms"][32 * w] / r["ms"][r["best"]] - 1
        return tot

    ratios = np.geomspace(0.1, 1000.0, 801)
    ex = np.array([excess(rho) for rho in ratios])
    fit = ratios[ex <= ex.min() + 1e-12]
    rho = float(np.sqrt(fit[0] * fit[-1]))
    log(f"  ROUND_WARPS: now {K.ROUND_WARPS} (summed excess "
        f"{excess(K.ROUND_WARPS):.4f}); fitted {rho:.3f} (ties "
        f"{fit[0]:.3f}..{fit[-1]:.3f}, excess {excess(rho):.4f})")
    return {"rows": rows, "round_warps_now": K.ROUND_WARPS,
            "excess_now": excess(K.ROUND_WARPS), "round_warps_fit": rho,
            "fit_range": [float(fit[0]), float(fit[-1])],
            "excess_fit": excess(rho)}


def load_other(checkout: Path, name: str, module: str):
    """A kernel module (`sptrsv_level` or `spmv_ell`) of another checkout's
    `repro_torch`, imported under the package name `name` (its kernel
    sources are built into that checkout's own build/kernels)."""
    import importlib
    import importlib.util
    if name not in sys.modules:
        pkg = checkout.resolve() / "src" / "repro_torch"
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.kernels.{module}")


def phase_ab(dirs: list, rng) -> list:
    """K1/K2 (R = 1, 8) of each other checkout in `dirs` beside this
    one's, on the study cases, on one card in one process: each packs the
    schedule its own way; timed in turns (other, this, this, other) and
    held against each other (KERNEL_RTOL, relative to scale)."""
    from repro_torch.kernels import sptrsv_level as K
    others = [(str(d), load_other(Path(d), f"other{i}_repro_torch",
                                  "sptrsv_level"))
              for i, d in enumerate(dirs)]
    rows = []
    for label, sched in study_cases():
        n, nc = sched.n, sched.n_carry
        mine = K.pack_schedule(sched).to("cuda")
        for R in (1, 8):
            c_pad = study_rhs(sched, R, rng)
            this = lambda: K.sptrsv_groups_multi(None, c_pad, n=n,
                                                 n_carry=nc, packed=mine)
            x = this()
            for d, KO in others:
                theirs = KO.pack_schedule(sched).to("cuda")
                other = lambda: KO.sptrsv_groups_multi(
                    None, c_pad, n=n, n_carry=nc, packed=theirs)
                _, rel = rel_err(x, other())
                check(rel <= KERNEL_RTOL, f"{label} R={R}: {d}'s kernel "
                      f"differs by {rel:.3e} relative to scale")
                t = [time_ms(f, KERNEL_REPS)
                     for f in (other, this, this, other)]
                rows.append({"other": d, "case": label, "R": R,
                             "schedule_steps": sched.num_steps,
                             "steps": mine.num_steps,
                             "threads": K.consumer_threads(mine, R),
                             "other_ms": [t[0], t[3]],
                             "this_ms": [t[1], t[2]], "max_rel_diff": rel,
                             "speedup": (t[0] + t[3]) / (t[1] + t[2])})
                log(f"  ab {d:16s} {label:28s} R={R} threads="
                    f"{rows[-1]['threads']} other_ms={t[0]:.4f},{t[3]:.4f}"
                    f" this_ms={t[1]:.4f},{t[2]:.4f} "
                    f"x{rows[-1]['speedup']:.3f} diff={rel:.1e}")
    return rows


def spmv_device_ms(call, flush: bool = False) -> float:
    """K4's device ms per call from the profiler (KERNEL_REPS calls; with
    `flush`, the L2 flushed before each): at these sizes the events time
    the host's launches, not the kernel."""
    return kernel_ms(device_profile(call, KERNEL_REPS, flush=flush),
                     "spmv_ell_kernel")


def phase_ab_spmv(dirs: list, rng) -> list:
    """K4 of each other checkout in `dirs` beside this one's, through each
    one's `spmv_ell` on the same ELL arrays of phase 3's ELL cases, in
    float32 and float64: results held equal (SPMV_RTOL, relative to
    scale), then device ms with the L2 warm and flushed, and events ms,
    timed in turns (other, this, this, other)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmv_ell as S
    from repro_torch.solver.levelset import pad_rhs
    others = [(str(d), load_other(Path(d), f"other{i}_repro_torch",
                                  "spmv_ell"))
              for i, d in enumerate(dirs)]
    rows = []
    for name, A in spmv_cases():
        for dtype in (np.float32, np.float64):
            idx_np, coef_np, n = ops.ell_pack_csr(A, dtype=dtype)
            idx = torch.as_tensor(idx_np, device=DEVICE)
            coef = torch.as_tensor(coef_np, device=DEVICE)
            x_pad = pad_rhs(torch.as_tensor(rng.standard_normal(n),
                                            dtype=coef.dtype, device=DEVICE))
            this = lambda: S.spmv_ell(idx, coef, x_pad)
            y = this()
            for d, SO in others:
                other = lambda: SO.spmv_ell(idx, coef, x_pad)
                _, rel = rel_err(y, other())
                check(rel <= SPMV_RTOL[coef.dtype], f"{name} {dtype}: {d}'s "
                      f"K4 differs by {rel:.3e} relative to scale")
                turns = (other, this, this, other)
                dev = [spmv_device_ms(f) for f in turns]
                cold = [spmv_device_ms(f, flush=True) for f in turns]
                ev = [time_ms(f, KERNEL_REPS) for f in turns]
                case = f"{name}/{np.dtype(dtype).name}"
                ratio = lambda t: (t[0] + t[3]) / (t[1] + t[2])
                rows.append({"other": d, "case": case,
                             "other_device_ms": [dev[0], dev[3]],
                             "this_device_ms": [dev[1], dev[2]],
                             "other_cold_l2_ms": [cold[0], cold[3]],
                             "this_cold_l2_ms": [cold[1], cold[2]],
                             "other_ms": [ev[0], ev[3]],
                             "this_ms": [ev[1], ev[2]], "max_rel_diff": rel,
                             "speedup_device": ratio(dev),
                             "speedup_cold_l2": ratio(cold),
                             "speedup": ratio(ev)})
                log(f"  ab K4 {d:16s} {case:42s} device other="
                    f"{dev[0]:.5f},{dev[3]:.5f} this={dev[1]:.5f},"
                    f"{dev[2]:.5f} x{ratio(dev):.3f}; cold L2 other="
                    f"{cold[0]:.5f},{cold[3]:.5f} this={cold[1]:.5f},"
                    f"{cold[2]:.5f} x{ratio(cold):.3f}; events "
                    f"other={ev[0]:.4f},{ev[3]:.4f} this={ev[1]:.4f},"
                    f"{ev[2]:.4f} x{ratio(ev):.3f} diff={rel:.1e}")
    return rows


SPMV_SIGMAS, SPMV_LONG_SLOTS = (32, 256, 1024), (32, 64)


def phase_sweep_spmv(rng) -> list:
    """K4's sliced form at every SIGMA x LONG_SLOTS of the sweep, packed
    from the CSR and launched with `spmv_sliced`, on phase 3's systems
    (torso2's and lung2's SPD systems, poisson2d 512^2) in float32 and
    float64: slots stored and device ms (profiler), each result held
    against the default constants' within SPMV_RTOL."""
    from repro_torch.kernels import spmv_ell as S
    from repro_torch.solver.levelset import pad_rhs
    from repro_torch.sparse import generators
    systems = spmv_cases() + [(
        "spd_from_lower(lung2_like(1.0))",
        generators.spd_from_lower(generators.lung2_like(1.0), seed=0))]
    rows = []
    for name, A in systems:
        for dtype in (np.float32, np.float64):
            x_pad = pad_rhs(torch.as_tensor(
                rng.standard_normal(A.n_rows), device=DEVICE,
                dtype=torch.float32 if dtype == np.float32 else torch.float64))
            y0 = S.spmv_sliced(S.pack_sliced_csr(A, dtype).to(DEVICE), x_pad)
            for sigma in SPMV_SIGMAS:
                for long_slots in SPMV_LONG_SLOTS:
                    packed = S.pack_sliced_csr(
                        A, dtype, sigma=sigma,
                        long_slots=long_slots).to(DEVICE)
                    call = lambda: S.spmv_sliced(packed, x_pad)
                    _, rel = rel_err(call(), y0)
                    check(rel <= SPMV_RTOL[x_pad.dtype], f"sweep {name} "
                          f"sigma={sigma} long={long_slots}: {rel:.3e}")
                    ms = spmv_device_ms(call)
                    rows.append({"case": f"{name}/{np.dtype(dtype).name}",
                                 **sliced_row(packed), "device_ms": ms})
                    log(f"  sweep K4 {rows[-1]['case']:42s} sigma={sigma:<4d}"
                        f" long_slots={long_slots} slots={packed.slots} "
                        f"long={packed.num_long} device_ms={ms:.5f}")
    return rows


def probe_gloo_cuda() -> dict:
    """Does gloo take CUDA tensors?  A gloo world of one in this process:
    the sharded solve's collectives (all_gather into a tensor, all_reduce,
    an object broadcast) on cuda:0 tensors.  {"ok": bool, "error": str}."""
    import torch.distributed as dist
    from repro_torch.solver.distributed import _gather
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        v = torch.arange(6, dtype=torch.float32, device="cuda")
        g = _gather(v, dist.group.WORLD)
        r = torch.ones(4, device="cuda")
        dist.all_reduce(r)
        box = [{"probe": 1}]
        dist.broadcast_object_list(box, src=0)
        ok = bool(torch.equal(g, v)) and g.device.type == "cuda" and \
            float(r.sum()) == 4.0
        return {"ok": ok, "error": "" if ok else "wrong values"}
    except Exception as e:          # noqa: BLE001 - the probe's answer
        return {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
    finally:
        dist.destroy_process_group()


def sharded_rank(rank: int, store: str, out: str) -> int:
    """One of phase 11's two gloo ranks on cuda:0, in a process of its own:
    lung2_like(1.0) no_rewriting under a two-rank CUDA mesh, its unrefined
    and refined answers saved to `out` (.npz)."""
    import torch.distributed as dist
    from repro_torch.solver import TriangularOperator
    from repro_torch.solver.distributed import default_mesh
    from repro_torch.sparse import generators
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        mesh = default_mesh()       # on a card: CUDA, whatever the backend
        L = generators.lung2_like(1.0)
        b = np.random.default_rng(SEED).standard_normal(L.n_rows)
        op, build_s = synced_s(lambda: TriangularOperator.from_csr(
            L, tune="no_rewriting", mesh=mesh, cache=False))
        x0, sweep_s = synced_s(lambda: op.solve(b, max_refine=0))
        x, solve_s = synced_s(lambda: op.solve(b))
        np.savez(out, x0=x0, x=x, residual=op.stats.last_residual,
                 rounds=op.stats.refine_rounds, build_s=build_s,
                 sweep_s=sweep_s, solve_s=solve_s,
                 device=str(op.device), engine=op.engine)
    finally:
        dist.destroy_process_group()
    return 0


def sharded_two_ranks(tmp: Path) -> dict:
    """Phase 11's two gloo ranks on the one card (processes of their own,
    `--sharded-rank`): x bitwise equal across the ranks, the unrefined
    sweep within the oracle's gate, the refined solve within 1e-10."""
    from repro_torch.sparse import generators
    store = tmp / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank",
         str(r), str(store), str(tmp / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=SHARDED_RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for proc, text in zip(procs, logs):
        check(proc.returncode == 0, f"a gloo rank on the card exited "
              f"{proc.returncode}: {text[-2000:]}")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    L = generators.lung2_like(1.0)
    b = np.random.default_rng(SEED).standard_normal(L.n_rows)
    x_ref = oracle(L, b)
    err0 = float(np.abs(ranks[0]["x0"] - x_ref).max()) / max(
        1.0, float(np.abs(x_ref).max()))
    same = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ("x0", "x"))
    out = {"case": "lung2_like(1.0)/no_rewriting, 2 gloo ranks on cuda:0",
           "device": str(ranks[0]["device"]),
           "engine": str(ranks[0]["engine"]), "bitwise_equal": same,
           "err_max_refine0": err0,
           "residual": float(ranks[0]["residual"]),
           "refine_rounds": int(ranks[0]["rounds"]),
           "build_s": float(ranks[0]["build_s"]),
           "sweep_s": float(ranks[0]["sweep_s"]),
           "solve_s": float(ranks[0]["solve_s"])}
    check(same, "the two gloo ranks' answers differ")
    check(out["device"].startswith("cuda") and out["engine"] == "sharded",
          f"the gloo ranks solved on {out['device']} / {out['engine']}")
    check(err0 <= ORACLE_RTOL and out["residual"] <= REFINE_TOL,
          f"two gloo ranks: error {err0:.3e}, residual "
          f"{out['residual']:.3e}")
    return out


def sharded_case(L, strat: str, mesh, b: np.ndarray) -> tuple:
    """One from_csr(mesh=) operator of phase 11: its checks, its barrier
    count, its sweep's ms beside K1's on the same operator.  Returns (row,
    operator)."""
    from repro_torch.solver import TriangularOperator
    from repro_torch.solver import distributed as D
    x_ref = oracle(L, b)
    scale = max(1.0, float(np.abs(x_ref).max()))
    op, build_s = synced_s(lambda: TriangularOperator.from_csr(
        L, tune=strat, mesh=mesh, cache=False))
    check(op.device.type == "cuda" and op.engine == "sharded",
          f"sharded operator on {op.device} / {op.engine}")
    check("packed" not in op._payload and op._runtime.get("dsched") is None,
          "a sharded operator packed or staged K1's form")
    x, solve_s = synced_s(lambda: op.solve(b))
    resid = op.stats.last_residual
    check(resid <= REFINE_TOL, f"sharded refined residual {resid:.3e}")
    x0 = op.solve(b, max_refine=0)
    err0 = float(np.abs(x0 - x_ref).max()) / scale
    check(err0 <= ORACLE_RTOL, f"sharded max_refine=0 error {err0:.3e}")
    g = D.count_all_gathers(op.schedule, mesh)
    check(g["families"] == g["steps"] == op.schedule.num_steps,
          f"{g} for a schedule of {op.schedule.num_steps} steps")
    pre = op._preamble_host()[0]
    gp = D.count_all_gathers(pre, mesh) if pre is not None else None
    bt = torch.as_tensor(b, dtype=torch.float32, device=op.device)
    fn = op.device_solve_fn()
    sweep_ms = time_ms(lambda: fn(bt), SHARDED_REPS, warmup=1)
    # K1 on the same operator, for comparison only (its launches are not
    # the path's; it packs the tiles the sharded engine never reads)
    k1 = op.device_solve_fn(engine="cuda")
    k1_ms = counted(lambda: time_ms(lambda: k1(bt), 20))
    errk = counted(lambda: float((fn(bt) - k1(bt)).abs().max().item())) \
        / scale
    row = {"case": f"{L.n_rows}/{strat}", "strategy": strat,
           "schedule_steps": op.schedule.num_steps,
           "all_gathers": g, "preamble_all_gathers": gp,
           "host_build_s": build_s, "solve_refined_s": solve_s,
           "refine_rounds": op.stats.refine_rounds, "residual": resid,
           "err_max_refine0": err0, "sharded_vs_k1": errk,
           "sharded_sweep_ms": sweep_ms, "k1_sweep_ms": k1_ms}
    check(errk <= KERNEL_RTOL * 10, f"sharded sweep against K1's: {errk:.3e}")
    return row, op


def phase_sharded(rng, refs: dict) -> tuple:
    """Sharded solves on the card (module doc, phase 11).  Returns (result,
    launch counts of this path)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import AvgLevelCost, NoRewrite, faults
    from repro_torch.core.portfolio import (CostModel, StrategyPortfolio,
                                            default_cost_model_for)
    from repro_torch.iterative import cg, device_matvec
    from repro_torch.kernels import sptrsv_level as K
    from repro_torch.obs.profile import merge_profiles, profile_schedule
    from repro_torch.precond import Preconditioner
    from repro_torch.solver import TriangularOperator, sharded_engine
    from repro_torch.solver import distributed as D
    from repro_torch.sparse import generators
    res = {}
    t0 = time.perf_counter()
    res["gloo_cuda"] = probe_gloo_cuda()
    log(f"  gloo takes CUDA tensors: {res['gloo_cuda']['ok']} "
        f"{res['gloo_cuda']['error']}")
    if res["gloo_cuda"]["ok"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-ranks-") as tmp:
            res["two_ranks"] = sharded_two_ranks(Path(tmp))
        log(f"  {json.dumps(res['two_ranks'])}")
    res["two_ranks_s"] = time.perf_counter() - t0
    TriangularOperator.clear_memory_cache()
    K.reset_launch_counts()
    r0 = refs["calls"]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = D.default_mesh()
        check(mesh.device_type == "cuda", f"an NCCL mesh of {mesh}")
        rows, profiles = [], []
        mats = {m: getattr(generators, m)(1.0)
                for m in ("lung2_like", "torso2_like")}
        for mat, L in mats.items():
            b = rng.standard_normal(L.n_rows)
            for strat in ("no_rewriting", "avgLevelCost"):
                row, op = sharded_case(L, strat, mesh, b)
                row["case"] = f"{mat}(1.0)/{strat}"
                rows.append(row)
                log(f"  {row['case']:30s} steps={row['schedule_steps']} "
                    f"all_gathers={row['all_gathers']} preamble="
                    f"{row['preamble_all_gathers']} resid="
                    f"{row['residual']:.2e} err0={row['err_max_refine0']:.2e}"
                    f" vs_k1={row['sharded_vs_k1']:.2e} sharded_ms="
                    f"{row['sharded_sweep_ms']:.3f} k1_ms="
                    f"{row['k1_sweep_ms']:.4f} build_s="
                    f"{row['host_build_s']:.2f}")
                if strat == "no_rewriting":
                    prof = profile_schedule(op.schedule, b, mesh=mesh,
                                            reps=2, warmup=1)
                    profiles.append(prof)
                    row["collective_us_per_step_median"] = float(
                        np.median(prof.collective_ms)) * 1e3
                    row["step_us_median"] = float(
                        np.median(prof.step_ms)) * 1e3
        res["operators"] = rows
        # the tuner's model under the card's mesh charges the preamble's
        # barriers as the main schedule's: of the two strategies it picks
        # the one whose sharded sweep measured faster above
        eng = sharded_engine(mesh)
        res["tuner"] = {}
        for mat, L in mats.items():
            rep = StrategyPortfolio(
                candidates=[NoRewrite(), AvgLevelCost()], engine=eng,
                device=D.mesh_device(mesh),
                cost_model=default_cost_model_for(eng)).tune(L)
            ms = {r["strategy"]: r["sharded_sweep_ms"] for r in rows
                  if r["case"].startswith(mat)}
            res["tuner"][mat] = {
                "pick": rep.best.label,
                "barriers": {c.label: c.steps + c.preamble_steps
                             for c in rep.candidates},
                "predicted_us": {c.label: c.predicted_us
                                 for c in rep.candidates},
                "measured_ms": ms}
            log(f"  tuner under the mesh, {mat}: "
                f"{json.dumps(res['tuner'][mat])}")
            check(rep.best.label == min(ms, key=ms.get),
                  f"the sharded tuner picked {rep.best.label} on {mat}, "
                  f"the slower sweep: {ms}")
        fit = CostModel.sharded().calibrate(merge_profiles(profiles))
        res["calibrated"] = dataclasses.asdict(fit)
        log(f"  collective us per step (median): "
            f"{[r.get('collective_us_per_step_median') for r in rows]}; "
            f"CostModel.sharded().calibrate: collective "
            f"{fit.collective_latency_us:.3f} us, step "
            f"{fit.step_overhead_us:.3f} us")
        # IC(0)-PCG under one mesh: the sharded matvec and both sweeps
        A = generators.spd_from_lower(mats["lung2_like"], seed=0)
        x_true = rng.standard_normal(A.n_rows)
        b_np = A.matvec(x_true)
        bt = torch.as_tensor(b_np, device="cuda")
        P, build_s = synced_s(lambda: Preconditioner.ic0(
            A, tune="no_rewriting", mesh=mesh, cache=False))
        mv = device_matvec(A, mesh=mesh)
        sol, pcg_s = synced_s(lambda: cg(mv, bt, preconditioner=P,
                                         tol=PCG_TOL, maxiter=PCG_MAXITER))
        resid = true_residual(A, sol.x, b_np)
        res["pcg"] = {"case": "spd_from_lower(lung2_like(1.0))/ic0/"
                              "no_rewriting",
                      "engines": [P.forward.engine, P.backward.engine],
                      "schedule_steps": [P.forward.schedule.num_steps,
                                         P.backward.schedule.num_steps],
                      "iterations": int(sol.iterations),
                      "converged": bool(sol.converged),
                      "true_residual": resid, "solve_s": pcg_s,
                      "host_ic0_and_build_s": build_s}
        log(f"  {json.dumps(res['pcg'])}")
        check(res["pcg"]["engines"] == ["sharded", "sharded"]
              and bool(sol.converged) and resid <= PCG_TRUE_RESID,
              f"sharded PCG: {res['pcg']}")
        # a lost mesh on a card: K1 serves, warned, "sharded->cuda"
        L = mats["lung2_like"]
        b = rng.standard_normal(L.n_rows)
        with faults.lose_mesh():
            op = TriangularOperator.from_csr(L, tune="no_rewriting",
                                             mesh=mesh, cache=False)
            before = K.LAUNCHES["sptrsv_groups"]
            x, warned = recorded(lambda: op.solve(b))
        check(not isinstance(x, Exception), f"lost mesh: {x!r}")
        resid = op.stats.last_residual
        res["lost_mesh"] = {"last_fallback": op.stats.last_fallback,
                            "warnings": warned, "residual": resid,
                            "k1_launches": K.LAUNCHES["sptrsv_groups"]
                            - before}
        log(f"  lost mesh: {json.dumps(res['lost_mesh'])}")
        check(op.stats.last_fallback == "sharded->cuda"
              and warned.get("EngineFallbackWarning") == 1
              and res["lost_mesh"]["k1_launches"] > 0
              and resid <= REFINE_TOL, f"lost mesh: {res['lost_mesh']}")
    finally:
        dist.destroy_process_group()
    counts = dict(K.LAUNCHES)
    res["reference_solves"] = refs["calls"] - r0
    log(f"  launches on the sharded path: {counts}; host reference solves "
        f"{res['reference_solves']}")
    check(counts["plain"] == 0,
          f"the plain version ran on the sharded path: {counts}")
    check(res["reference_solves"] == 0, f"the host reference served "
          f"{res['reference_solves']} solves of a card's operator")
    return res, counts


def kernels_line(krows: list, *path_counts: dict,
                 served_err: dict | None = None) -> dict:
    """One entry per ported kernel, its timings at a main-path shape; its
    launches summed over the main paths (phases 4 to 11)."""
    from repro_torch.kernels import spmv_ell as S
    from repro_torch.kernels import sptrsv_level as K
    here = "src/repro_torch/kernels/csrc/"
    spec = [
        ("sptrsv_groups", "sptrsv_level.cu", "lung2_like(1.0)/no_rewriting",
         1, "src/repro/kernels/sptrsv_level.py:98"),
        ("sptrsv_groups_stamped", "sptrsv_level.cu",
         "lung2_like(1.0)/no_rewriting", 1,
         "src/repro/kernels/sptrsv_level.py:98"),
        ("sptrsv_groups_multi", "sptrsv_level.cu",
         "lung2_like(1.0)/no_rewriting", 8,
         "src/repro/kernels/sptrsv_level.py:149"),
        ("sptrsv_levels", "sptrsv_level.cu", "banded(4096,40)/max_deps=4", 1,
         "src/repro/kernels/sptrsv_level.py:205"),
        ("spmv_ell", "spmv_ell.cu",
         "spd_from_lower(torso2_like(1.0))/float32", 1,
         "src/repro/kernels/spmv_ell.py:32"),
    ]
    out = []
    for name, src, case, R, replaces in spec:
        rep = next(r for r in krows if r["kernel"] == name
                   and r["case"] == case and r["R"] == R)
        out.append({"name": name, "route": "cuda", "source": here + src,
                    "replaces": replaces,
                    "launches": sum(c.get(name, 0) for c in path_counts),
                    "max_abs_err": max([r["max_abs_err"] for r in krows
                                        if r["kernel"] == name]
                                       + [(served_err or {}).get(name, 0.0)]),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"],
                    "bound_by": rep["bound_by"],
                    "library_ms": rep["library_ms"]})
    assert (set(K.LAUNCHES) | set(S.LAUNCHES)) - {"plain"} == \
        {e["name"] for e in out}
    return {"kernels": out}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="only time K1/K2 at every consumer count and fit "
                         "the block size's ratio ROUND_WARPS, and K4 at "
                         "every SIGMA x LONG_SLOTS")
    ap.add_argument("--ab", nargs="+", type=Path, metavar="DIR",
                    help="only time the K1/K2 and K4 of other checkouts "
                         "(e.g. `git archive <commit> | tar -x -C "
                         "build/other`) beside this one's")
    ap.add_argument("--only", choices=("sptrsv", "spmv"),
                    help="with --sweep or --ab: study only K1/K2 "
                         "(sptrsv) or only K4 (spmv)")
    ap.add_argument("--sharded-rank", nargs=3,
                    metavar=("RANK", "STORE", "OUT"),
                    help="run one of phase 11's two gloo ranks (started "
                         "by phase 11 itself)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.sharded_rank:
        rank, store, out = args.sharded_rank
        return sharded_rank(int(rank), store, out)
    # the operators' disk cache goes to a directory of this run's own,
    # removed at its end; phase 6 leaves its tuned torso2 operator in
    # `tuned_dir` for phase 7's new process
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        os.environ["REPRO_TORCH_CACHE_DIR"] = str(Path(tmp) / "cache")
        return run(args, str(Path(tmp) / "tuned"))


def run(args, tuned_dir: str) -> int:
    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()
    log("== 1. card")
    card = phase_card()
    log("== 2. build")
    build_s = phase_build()
    if args.sweep or args.ab:
        study = {"card": card}
        sptrsv, spmv = args.only in (None, "sptrsv"), args.only in (None,
                                                                   "spmv")
        if args.sweep and sptrsv:
            log("== block size sweep")
            study["sweep"] = phase_sweep(rng)
        if args.sweep and spmv:
            log("== K4: SIGMA x LONG_SLOTS sweep")
            study["sweep_spmv"] = phase_sweep_spmv(rng)
        if args.ab and sptrsv:
            log("== A/B against other checkouts")
            study["ab"] = phase_ab(args.ab, rng)
        if args.ab and spmv:
            log("== K4: A/B against other checkouts")
            study["ab_spmv"] = phase_ab_spmv(args.ab, rng)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_study.json").write_text(
            json.dumps(study, indent=1))
        log(card["nvidia_smi"])
        return 0
    log("== 3. kernels against their plain versions")
    krows = phase_kernels(rng)
    refs = count_reference_solves()
    log("== 4. main path")
    mrows, counts = phase_main_path(rng)
    log("== 5. preconditioned Krylov path")
    prows, pcg_counts = phase_pcg(rng)
    log("== 6. the tuner at full size")
    t6 = time.perf_counter()
    tuner, tune_counts = phase_tuner(rng, tuned_dir)
    tuner["seconds"] = time.perf_counter() - t6
    log(f"  phase 6 took {tuner['seconds']:.1f} s")
    log("== 7. the operator's life cycle at full size")
    t7 = time.perf_counter()
    life, life_counts = phase_lifecycle(
        rng, tuned_dir, tuner["operators"]["torso2_like"]["default"])
    life["seconds"] = time.perf_counter() - t7
    log(f"  phase 7 took {life['seconds']:.1f} s")
    log("== 8. the solve service at full size")
    t8 = time.perf_counter()
    serve, serve_counts = phase_serving(rng)
    serve["seconds"] = time.perf_counter() - t8
    log_serving(serve)
    log("== 9. static verification at full size")
    t9 = time.perf_counter()
    static, static_counts = phase_static(rng)
    static["seconds"] = time.perf_counter() - t9
    log(f"  phase 9 took {static['seconds']:.1f} s")
    log(f"  host reference solves in phases 4-9: {refs['calls']}")
    check(refs["calls"] == 0, f"the host reference served {refs['calls']} "
          "solves in phases 4-9")
    log("== 10. runtime resilience at full size")
    t10 = time.perf_counter()
    resil, resil_counts = phase_resilience(rng, refs)
    resil["seconds"] = time.perf_counter() - t10
    log(f"  phase 10 took {resil['seconds']:.1f} s")
    log("== 11. sharded solves")
    t11 = time.perf_counter()
    shard, shard_counts = phase_sharded(rng, refs)
    shard["seconds"] = time.perf_counter() - t11
    log(f"  phase 11 took {shard['seconds']:.1f} s")
    line = kernels_line(krows, counts, pcg_counts, tune_counts, life_counts,
                        serve_counts, static_counts, resil_counts,
                        shard_counts,
                        served_err=serve["kernels_vs_plain_max_abs_err"])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernels": krows,
         "main_path": mrows, "launches": counts, "krylov_path": prows,
         "krylov_launches": pcg_counts, "tuner": tuner,
         "tuner_launches": tune_counts, "life_cycle": life,
         "life_cycle_launches": life_counts, "serving": serve,
         "serving_launches": serve_counts, "static": static,
         "static_launches": static_counts, "resilience": resil,
         "resilience_launches": resil_counts, "sharded": shard,
         "sharded_launches": shard_counts, "kernels_line": line,
         "seconds": time.perf_counter() - t_start}, indent=1, default=str))
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    log(card["nvidia_smi"])
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
