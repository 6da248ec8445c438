"""One world of gloo ranks for tests/test_torch_distributed.py.

    python tests/_torch_sharded_world.py WORLD OUT_DIR [DEVICE]

Spawns WORLD ranks (torch.multiprocessing, start method "spawn") that
join one gloo process group through a file under OUT_DIR, build the
default mesh and run the sharded cases of the reference's multi-device
script on the port: the random_lower(400) schedule, its avgLevelCost
transform, the banded(160, 12) carry schedule, a batched (n, 3)
right-hand side, IC(0)-PCG on poisson2d_spd(12, 12) under one mesh, and
the tuner's measured mode with timings rigged to disagree between the
ranks, ranks whose disk caches disagree, and a sharded lowering that
fails on one rank alone.  Each rank writes `rank{r}.npz` (its answers)
and `rank{r}.json` (its counts and decisions) into OUT_DIR; the test
judges them.  DEVICE
is "cpu" (the default) or "cuda" (gloo carrying CUDA tensors: a mesh of
device type "cuda").  Imports torch and the port only.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def rigged_sweeps(rank: int):
    """Make the tuner time stand-ins for its candidates' sweeps: a stall
    by the candidate's step count, no collective (a real sweep's
    all_gathers would make the ranks wait for one another and time alike).
    Fewer steps are faster on rank 0 and slower on the others, so the
    ranks' own timings pick different candidates."""
    import time
    from repro_torch.solver import operator as O

    def rigged(ts, sched, engine, device, reversed_=False):
        # 4 ms a step: far above the timer's noise
        stall = 4e-3 * (sched.num_steps if rank == 0
                        else 100.0 - sched.num_steps)

        def slow(v):
            time.sleep(stall)
            return v

        return slow

    O.candidate_sweep_fn = rigged


def worker(rank: int, world: int, out: str, device: str) -> None:
    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(Path(out) / "cache")
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    try:
        run(rank, out, device)
    finally:
        dist.destroy_process_group()


def run(rank: int, out: str, device: str) -> None:
    from repro_torch.core import AvgLevelCost, transform
    from repro_torch.iterative import cg, device_matvec
    from repro_torch.precond import Preconditioner
    from repro_torch.solver import (TriangularOperator, schedule_for_csr,
                                    schedule_for_transformed,
                                    sharded_engine)
    from repro_torch.solver.distributed import (agree, count_all_gathers,
                                                default_mesh, solve_sharded)
    from repro_torch.sparse import build_levels, generators

    mesh = default_mesh(device_type=device)
    arrays, res = {}, {"device": str(sharded_engine(mesh).placement())}
    L = generators.random_lower(400, avg_offdiag=2.0, seed=3, max_back=24)
    b = np.random.default_rng(0).standard_normal(400)
    sched = schedule_for_csr(L, build_levels(L), chunk=32, max_deps=4,
                             dtype=np.float32)
    arrays["x"] = solve_sharded(sched, b, mesh)
    ts = transform(L, AvgLevelCost(), validate=False, codegen=False)
    s1 = schedule_for_transformed(ts, chunk=32, max_deps=4)
    arrays["x_transformed"] = solve_sharded(
        s1, ts.preamble(b).astype(np.float32), mesh)
    res["steps0"], res["steps1"] = sched.num_steps, s1.num_steps
    res["gathers0"] = count_all_gathers(sched, mesh)
    res["gathers1"] = count_all_gathers(s1, mesh)
    Lb = generators.banded(160, 12, seed=1)
    sb = schedule_for_csr(Lb, build_levels(Lb), chunk=16, max_deps=4)
    res["n_carry"] = sb.n_carry
    arrays["x_carry"] = solve_sharded(
        sb, np.random.default_rng(1).standard_normal(160), mesh)
    res["gathers_carry"] = count_all_gathers(sb, mesh)
    eng = sharded_engine(mesh)
    fn = eng.compile(sched)
    B = np.random.default_rng(2).standard_normal((400, 3))
    arrays["X"] = fn(B).cpu().numpy()
    res["memoized"] = fn is eng.compile(sched)

    # IC(0)-PCG under ONE mesh: the sharded SpMV and the sharded sweeps
    A = generators.poisson2d_spd(12, 12)
    P = Preconditioner.ic0(A, tune="no_rewriting", mesh=mesh, cache=False)
    res["engines"] = [P.forward.engine, P.backward.engine]
    mv = device_matvec(A, mesh=mesh)
    rhs = np.random.default_rng(3).standard_normal(A.n_rows)
    dev = eng.placement()
    arrays["spmv"] = mv(torch.as_tensor(rhs, device=dev)).cpu().numpy()
    sol = cg(mv, torch.as_tensor(rhs, dtype=torch.float32, device=dev),
             preconditioner=P, tol=1e-5, maxiter=300)
    arrays["pcg_x"] = sol.x.cpu().numpy()
    res["pcg_converged"] = bool(sol.converged)
    res["pcg_iters"] = int(sol.iterations)

    # the tuner's measured mode with timings that disagree between ranks:
    # every rank must take rank 0's pick and build the same schedule
    rigged_sweeps(rank)
    op = TriangularOperator.from_csr(L, tune="auto", chunk=32, max_deps=4,
                                     mesh=mesh, measure_top_k=3,
                                     cache=False)
    measured = [c for c in op.report.candidates if c.measured_us is not None]
    res["tuned"] = op.strategy
    res["tuned_steps"] = op.schedule.num_steps
    res["measured_steps"] = [c.steps for c in measured]
    res["agree"] = agree(rank, mesh)
    arrays["x_tuned"] = op.solve(b)

    # ranks whose caches disagree (a cache directory each, as on several
    # hosts; only rank 0 writes the disk tier): rank 0 hits its disk entry,
    # the others have none, so every rank builds (and tunes) together
    def tuned():
        return TriangularOperator.from_csr(
            L, tune="auto", chunk=32, max_deps=4, mesh=mesh,
            measure_top_k=3, cache_dir=Path(out) / f"cache_rank{rank}")

    tuned()
    TriangularOperator.clear_memory_cache()
    op = tuned()
    res["split_cache_source"] = op.stats.cache_source
    res["split_cache_steps"] = op.schedule.num_steps
    arrays["x_split_cache"] = op.solve(b)

    # the sharded lowering fails on the last rank alone: no rank is left
    # in an all_gather, every rank falls back together
    import contextlib
    import warnings
    from repro_torch.core import faults
    with (faults.lose_mesh() if rank == dist.get_world_size() - 1
          else contextlib.nullcontext()):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            op = TriangularOperator.from_csr(L, tune="no_rewriting",
                                             chunk=32, max_deps=4,
                                             mesh=mesh, cache=False)
            arrays["x_lost_on_one"] = op.solve(b)
    res["lost_on_one_fallback"] = op.stats.last_fallback
    # memoized as a compile failure on every rank: no rank got as far as
    # a sharded call whose all_gathers the others would never join
    res["lost_on_one_compile_failed"] = \
        "sharded" in op._runtime.get("engine_failures", {})
    res["lost_on_one_warnings"] = sorted(
        {type(w.message).__name__ for w in caught
         if "downgraded" in str(w.message)})
    np.savez(Path(out) / f"rank{rank}.npz", **arrays)
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))


def main() -> None:
    world, out = int(sys.argv[1]), sys.argv[2]
    device = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    mp.spawn(worker, args=(world, out, device), nprocs=world, join=True)


if __name__ == "__main__":
    main()
