"""One world of gloo ranks for tests/test_torch_distributed.py.

    python tests/_torch_sharded_world.py WORLD OUT_DIR [DEVICE] [CASES]

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
device type "cuda").  CASES "serve" runs instead a sharded call that
fails on the last rank alone (at its input check, in a step's local
work, in a step's scatter, through the operator) and the solve service
under the mesh: rank 0 serves, the others follow (pump mode against the
single-device batches, a hot swap, a batch failed on the last rank, an
admission, a re-bind and a tune that fail on the last rank alone, auto
mode with submitter threads and background tunes, close); then, in a
process group of its own with a collective timeout of IDLE_TIMEOUT_S, a
service that sits idle for twice that long and then serves.  CASES
"build" runs, in a process group with a collective timeout of
BUILD_TIMEOUT_S (so that ranks left in different collectives fail
instead of hanging), one-rank failures inside a build: a measured tune
whose candidate's sweep fails before its first allocation on the last
rank alone (`faults.fail_measurement`), the same in the
preconditioner's measured pair mode, and a cache hit whose schedule digest fails on the last rank
alone; each followed by a solve.  CASES "after" runs, in the same kind
of process group, a measured tune whose candidate's sweep fails on the
last rank alone after its last sharded call (so no collective of the
sweep can carry the failure; `fail_after_last_sharded_call`), followed
by a solve.  Imports torch and the port only.
"""
import contextlib
import datetime
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

# the collective timeout of the "serve" world's second process group, and
# how long its service idles (twice as long) before it serves
IDLE_TIMEOUT_S = 5.0
# the collective timeout of the "build" world (longer than the idle one:
# its ranks tune, so their host work between collectives takes longer)
BUILD_TIMEOUT_S = 30.0


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


def worker(rank: int, world: int, out: str, device: str,
           cases: str = "solve") -> None:
    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(Path(out) / "cache")
    timeout = {} if cases not in ("build", "after") else {
        "timeout": datetime.timedelta(seconds=BUILD_TIMEOUT_S)}
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world, **timeout)
    try:
        {"serve": serve, "build": build, "after": after}.get(cases, run)(
            rank, out, device)
        # no rank tears its group down while another still talks to it
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if cases == "serve":
        dist.init_process_group(
            "gloo", init_method=f"file://{out}/store_idle", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=IDLE_TIMEOUT_S))
        try:
            idle(rank, out, device)
            dist.barrier()
        finally:
            dist.destroy_process_group()


def once(obj, name: str, exc: Exception, after: bool = False):
    """Make `obj.name` raise `exc` on its first call (after running, with
    `after`: as an out-of-memory at the end of a build would); later calls
    run as before."""
    real, left = getattr(obj, name), [1]

    def patched(*args, **kwargs):
        if left[0] and not after:
            left[0] = 0
            raise exc
        out = real(*args, **kwargs)
        if left[0]:
            left[0] = 0
            raise exc
        return out

    setattr(obj, name, patched)


def failed(call):
    """What `call()` raised: (type, [(rank, reason), ...]) for a
    ShardedCallError, (type, message) for another, None if nothing."""
    from repro_torch.core.resilience import ShardedCallError
    try:
        call()
    except ShardedCallError as e:
        return ["ShardedCallError", e.failures]
    except Exception as e:  # noqa: BLE001 - recorded for the test
        return [type(e).__name__, str(e)]
    return None


def build(rank: int, out: str, device: str) -> None:
    """One-rank failures inside a build, each followed by a solve that
    every rank serves: the tuner's measured mode and the preconditioner's
    measured pair mode with a sweep that fails on the last rank alone,
    and a memory hit whose schedule digest raises on the last rank
    alone."""
    from repro_torch.core import faults
    from repro_torch.precond import Preconditioner
    from repro_torch.solver import TriangularOperator
    from repro_torch.solver import operator as O
    from repro_torch.solver.distributed import default_mesh
    from repro_torch.sparse import generators

    mesh = default_mesh(device_type=device)
    last = dist.get_world_size() - 1
    arrays, res = {}, {}
    L = generators.random_lower(400, avg_offdiag=2.0, seed=3, max_back=24)
    b = np.random.default_rng(0).standard_normal(400)

    def armed():
        return faults.fail_measurement() if rank == last \
            else contextlib.nullcontext()

    def plain(cache=False):
        return TriangularOperator.from_csr(
            L, tune="no_rewriting", chunk=32, max_deps=4, mesh=mesh,
            cache=cache)

    with armed():
        res["tune"] = failed(lambda: TriangularOperator.from_csr(
            L, tune="auto", chunk=32, max_deps=4, mesh=mesh,
            measure_top_k=2, cache=False))
    arrays["x_after_tune"] = plain().solve(b)
    A = generators.poisson2d_spd(8, 8)
    with armed():
        res["pair"] = failed(lambda: Preconditioner.ic0(
            A, tune="auto", mesh=mesh, measure_top_k=2, cache=False))
    P = Preconditioner.ic0(A, tune="no_rewriting", mesh=mesh, cache=False)
    arrays["pair_after"] = P.apply(np.ones(A.n_rows))
    # a memory hit on every rank whose digest raises on the last rank
    res["first_source"] = plain(cache=True).stats.cache_source
    if rank == last:
        once(O, "_schedule_digest", RuntimeError("injected digest failure"))
    op = plain(cache=True)
    res["digest_source"] = op.stats.cache_source
    arrays["x_digest"] = op.solve(b)
    res["hit_source"] = plain(cache=True).stats.cache_source
    np.savez(Path(out) / f"rank{rank}.npz", **arrays)
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))


@contextlib.contextmanager
def fail_after_last_sharded_call(armed: bool):
    """With `armed`, this rank's first composed sweep inside the context
    raises after it returns: after its last sharded call, which every
    rank has made, so only the caller's agreement can carry the failure
    to the other ranks."""
    from repro_torch.solver import operator as O
    real, left = O.compose_sweep_fn, [1]

    def compose(*args, **kwargs):
        fn = real(*args, **kwargs)

        def sweep(v):
            x = fn(v)
            if armed and left[0]:
                left[0] = 0
                raise RuntimeError("injected failure after the sweep's "
                                   "last sharded call")
            return x
        return sweep

    O.compose_sweep_fn = compose
    try:
        yield
    finally:
        O.compose_sweep_fn = real


def after(rank: int, out: str, device: str) -> None:
    """A measured tune whose first candidate sweep fails on the last rank
    alone after the sweep's last sharded call, then a solve that every
    rank serves."""
    from repro_torch.solver import TriangularOperator
    from repro_torch.solver.distributed import default_mesh
    from repro_torch.sparse import generators

    mesh = default_mesh(device_type=device)
    last = dist.get_world_size() - 1
    L = generators.random_lower(400, avg_offdiag=2.0, seed=3, max_back=24)
    b = np.random.default_rng(0).standard_normal(400)
    res = {}
    with fail_after_last_sharded_call(rank == last):
        res["tune"] = failed(lambda: TriangularOperator.from_csr(
            L, tune="auto", chunk=32, max_deps=4, mesh=mesh,
            measure_top_k=2, cache=False))
    x = TriangularOperator.from_csr(
        L, tune="no_rewriting", chunk=32, max_deps=4, mesh=mesh,
        cache=False).solve(b)
    np.savez(Path(out) / f"rank{rank}.npz", x_after_tune=x)
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))


def idle(rank: int, out: str, device: str) -> None:
    """A service whose rank 0 idles for twice the group's collective
    timeout before it serves: the follower waits on the store, in no
    collective, and the request is served."""
    import time
    from repro_torch.serving import SolveService
    from repro_torch.solver.distributed import default_mesh
    from repro_torch.sparse import generators
    svc = SolveService(mesh=default_mesh(device_type=device), max_width=4,
                       max_linger_s=60.0, auto_dispatch=False,
                       tune_mode="off", cache=False)
    A = generators.lung2_like(0.02)
    got = []
    if rank:
        svc.follow(on_batch=lambda key, x: got.append(np.asarray(x)))
    else:
        time.sleep(2 * IDLE_TIMEOUT_S)
        fut = svc.submit(np.random.default_rng(40).standard_normal(A.n_rows),
                         A)
        svc.pump()
        got.append(np.asarray(fut.result(timeout=60)))
        svc.close()
    np.savez(Path(out) / f"idle{rank}.npz", *got)


def pump_requests(gen, step):
    """The pump-mode script of tests/test_torch_serving.py: eleven
    requests over two patterns, a value step and a transposed sweep."""
    A, B = gen.lung2_like(0.02), gen.torso2_like(0.02)
    A1 = step(A, 1)
    reqs = [(A, 0, {}), (B, 1, {}), (A, 2, {}), (A, 3, {}), (A1, 4, {}),
            (A, 5, {}), (A, 6, {}), (A, 7, {}), (A1, 8, {}),
            (A, 9, {"transpose": True}), (B, 10, {})]
    return [(M, np.random.default_rng(seed).standard_normal(M.n_rows), kw)
            for M, seed, kw in reqs]


def serve(rank: int, out: str, device: str) -> None:
    from repro_torch import obs
    from repro_torch.core import faults
    from repro_torch.serving import SolveService
    from repro_torch.serving.server import step_values
    from repro_torch.solver import (TriangularOperator, schedule_for_csr,
                                    sharded_engine)
    from repro_torch.solver.distributed import default_mesh
    from repro_torch.sparse import build_levels, generators

    mesh = default_mesh(device_type=device)
    last = dist.get_world_size() - 1
    arrays, res = {}, {}

    # a sharded call that fails on the last rank alone
    L = generators.random_lower(400, avg_offdiag=2.0, seed=3, max_back=24)
    b = np.random.default_rng(0).standard_normal(400)
    sched = schedule_for_csr(L, build_levels(L), chunk=32, max_deps=4,
                             dtype=np.float32)
    fn = sharded_engine(mesh).compile(sched)
    res["input_check"] = failed(lambda: fn(
        b[:-1] if rank == last else b))
    arrays["x_after_input"] = fn(b).cpu().numpy()
    res["columns"] = failed(lambda: fn(
        np.stack([b, b], 1) if rank == last else b))
    with (faults.fail_sharded_step(step=3) if rank == last
          else contextlib.nullcontext()):
        res["step"] = failed(lambda: fn(b))
    arrays["x_after_step"] = fn(b).cpu().numpy()
    with (faults.fail_sharded_step(step=3, stage="publish") if rank == last
          else contextlib.nullcontext()):
        res["publish"] = failed(lambda: fn(b))
    arrays["x_after_publish"] = fn(b).cpu().numpy()
    res["memoized"] = fn is sharded_engine(mesh).compile(sched)
    op = TriangularOperator.from_csr(L, tune="no_rewriting", chunk=32,
                                     max_deps=4, mesh=mesh, cache=False)
    with (faults.fail_sharded_step(step=2) if rank == last
          else contextlib.nullcontext()):
        res["operator"] = failed(lambda: op.solve(b))
    res["operator_fallback"] = op.stats.last_fallback
    arrays["x_operator_after"] = op.solve(b)

    def served(svc, requests, answers, pump=True, wait=False):
        """Rank 0 submits and pumps `requests`; the others follow."""
        if rank != 0:
            got = []
            svc.follow(on_batch=lambda key, x: got.append(np.asarray(x)))
            return got
        futs = [svc.submit(b_, M, **kw) for M, b_, kw in requests]
        if pump:
            svc.pump()
        out_ = []
        for f in futs:
            try:
                out_.append(np.asarray(f.result(timeout=120)))
            except Exception as e:  # noqa: BLE001 - recorded for the test
                out_.append(None)
                answers.append([type(e).__name__, getattr(e, "failures",
                                                          str(e))])
        return out_

    # pump mode: rank 0's batches, every rank's answers
    kw = dict(max_width=4, max_linger_s=60.0, auto_dispatch=False,
              tune_mode="off", cache=False)
    tr = obs.enable()
    svc = SolveService(mesh=mesh, **kw)
    errors: list = []
    xs = served(svc, pump_requests(generators, step_values), errors)
    svc.close()
    obs.disable()
    res["pump_batches"] = [
        {k: v for k, v in sp.attrs.items() if k not in ("pattern",
                                                        "solve_ms")}
        for sp in tr.spans() if sp.name == "serving.batch"]
    res["pump_errors"] = errors
    res["pump_log"] = list(svc.mesh_log)
    res["pump_snapshot"] = {k: svc.snapshot()[k] for k in (
        "batches", "completed", "width_hist", "mesh")}
    for i, x in enumerate(xs):
        arrays[f"pump_{i}"] = x

    # a background tune's hot swap: a command between two pumps
    A = generators.lung2_like(0.02)
    svc = SolveService(mesh=mesh, max_width=4, max_linger_s=60.0,
                       auto_dispatch=False, tune_mode="background",
                       measure_top_k=0, cache=False)
    wave = [(A, np.random.default_rng(20 + i).standard_normal(A.n_rows),
             {}) for i in range(3)]
    xs = served(svc, wave + wave, errors) if rank else \
        served(svc, wave, errors) + served(svc, wave, errors)
    svc.close()
    res["swap_log"] = list(svc.mesh_log)
    res["swap_registry"] = {k: svc.snapshot()["registry"][k] for k in (
        "hot_swaps", "admissions")}
    res["swap_strategies"] = sorted(
        str(e.op.strategy) for _, e in svc.registry.entries())
    for i, x in enumerate(xs):
        arrays[f"swap_{i}"] = x

    # a batch whose sharded call fails on the last rank: every future
    # carries the agreed error, and the next batch is served
    svc = SolveService(mesh=mesh, max_width=4, max_linger_s=60.0,
                       auto_dispatch=False, tune_mode="off", cache=False)
    errors = []
    with (faults.fail_sharded_step(step=1) if rank == last
          else contextlib.nullcontext()):
        if rank:
            xs = served(svc, [], errors)
        else:
            xs = served(svc, wave, errors) + served(svc, wave[:1], errors)
    svc.close()
    res["fail_errors"] = errors
    res["fail_answers"] = [x is not None for x in xs]
    res["fail_snapshot"] = {k: svc.snapshot()[k] for k in (
        "batches", "batch_errors", "failed", "completed")}
    res["fail_mesh"] = svc.snapshot()["mesh"]

    # an admission, then a re-bind, that fail on the last rank alone: the
    # submit, then the batch's futures, carry the agreed error on rank 0;
    # the admission is undone on every rank, and the next ones serve
    from repro_torch.serving import OperatorRegistry
    from repro_torch.solver import TriangularOperator
    if rank == last:
        once(OperatorRegistry, "_build", MemoryError("build"), after=True)
        once(TriangularOperator, "update_values", MemoryError("re-bind"))
    A1 = step_values(A, 1)
    svc = SolveService(mesh=mesh, max_width=4, max_linger_s=60.0,
                       auto_dispatch=False, tune_mode="off", cache=False)
    errors = []
    if rank:
        xs = served(svc, [], errors)
    else:
        res["admit_failed"] = failed(lambda: svc.submit(wave[0][1], A))
        res["entries_after_admit_failed"] = len(svc.registry.entries())
        rebind = [(A1, b_, {}) for _, b_, _ in wave]
        xs = served(svc, wave[:1], errors) + \
            served(svc, rebind[:2], errors) + served(svc, rebind[2:], errors)
    svc.close()
    res["rebind_errors"] = errors
    res["rebind_answers"] = [x is not None for x in xs]
    res["rebind_log"] = list(svc.mesh_log)
    res["rebind_snapshot"] = {k: svc.snapshot()[k] for k in (
        "batches", "batch_errors", "failed", "completed")}
    res["rebind_entries"] = len(svc.registry.entries())
    for i, x in enumerate(xs):
        if x is not None:
            arrays[f"rebind_{i}"] = x

    # a background tune whose build fails on the last rank alone: no rank
    # swaps, every rank keeps serving its untuned operator
    if rank == last:
        real_build, left = OperatorRegistry._build, [1]

        def tune_fails(self, L, tune, ekey):
            op = real_build(self, L, tune, ekey)
            if tune != self._untuned and left[0]:
                left[0] = 0
                raise MemoryError("tune")
            return op

        OperatorRegistry._build = tune_fails
    errors = []
    svc = SolveService(mesh=mesh, max_width=4, max_linger_s=60.0,
                       auto_dispatch=False, tune_mode="background",
                       measure_top_k=0, cache=False)
    xs = served(svc, wave + wave, errors) if rank else \
        served(svc, wave, errors) + served(svc, wave, errors)
    svc.close()
    res["tune_fail_log"] = list(svc.mesh_log)
    res["tune_fail_registry"] = {k: svc.snapshot()["registry"][k] for k in (
        "hot_swaps", "tuner_failures")}
    res["tune_fail_states"] = [e.state for _, e in svc.registry.entries()]
    for i, x in enumerate(xs):
        arrays[f"tune_fail_{i}"] = x
    res["tune_fail_errors"] = errors

    # auto mode: submitter threads, two patterns (the second arriving
    # after traffic started), background tunes between batches, close()
    # while requests linger
    res["auto"], auto = auto_mode(rank, mesh, generators)
    arrays.update(auto)

    # a registry given with max_entries=1 on every rank: rank 0 evicts by
    # its own LRU order and sends each eviction; a follower's cap is lifted
    reg = OperatorRegistry(mesh=mesh, max_entries=1, tune_mode="off",
                           cache=False)
    svc = SolveService(registry=reg, max_width=4, max_linger_s=60.0,
                       auto_dispatch=False)
    res["evict_max_entries"] = reg.max_entries
    B = generators.torso2_like(0.02)
    if rank:
        served(svc, [], errors)
    else:
        served(svc, wave[:1], errors)
        served(svc, [(B, np.zeros(B.n_rows), {})], errors)
    svc.close()
    res["evict_log"] = list(svc.mesh_log)
    res["evict_entries"] = [k.pattern_fp for k, _ in reg.entries()]
    reg.close()
    res["closed"] = True
    np.savez(Path(out) / f"rank{rank}.npz", **arrays)
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))


def auto_mode(rank: int, mesh, generators) -> tuple:
    """The service in auto mode on a mesh: rank 0 submits from 4 threads,
    12 requests on lung2_like(0.02), then 8 over it and torso2_like(0.02),
    waits for the tunes, and closes with 2 requests still lingering; the
    others follow.  (result, arrays): rank 0's answers per request, a
    follower's per batch."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serving import SolveService
    svc = SolveService(mesh=mesh, max_width=4, max_linger_s=0.05,
                       tenant_cap=None, tune_mode="background",
                       measure_top_k=0, cache=False)
    arrays, res = {}, {}
    if rank:
        got = []
        svc.follow(on_batch=lambda key, x: got.append(np.asarray(x)))
        arrays = {f"auto_batch_{j}": x for j, x in enumerate(got)}
    else:
        A, B = generators.lung2_like(0.02), generators.torso2_like(0.02)
        mats = [A] * 12 + [A, B] * 4 + [A, B]
        reqs = [(M, np.random.default_rng(60 + i).standard_normal(M.n_rows))
                for i, M in enumerate(mats)]
        with ThreadPoolExecutor(4) as pool:
            futs = list(pool.map(lambda r: svc.submit(r[1], r[0]),
                                 reqs[:12]))
            futs += list(pool.map(lambda r: svc.submit(r[1], r[0]),
                                  reqs[12:20]))
        res["warm"] = svc.wait_warm(timeout=120)
        futs += [svc.submit(b_, M) for M, b_ in reqs[20:]]
        res["lingering"] = svc._batcher.pending()
        svc.close()
        xs = [np.asarray(f.result(timeout=120)) for f in futs]
        arrays = {f"auto_{i}": x for i, x in enumerate(xs)}
        snap = svc.snapshot()
        res["snapshot"] = {k: snap[k] for k in ("submitted", "completed",
                                                "failed")}
        res["hot_swaps"] = snap["registry"]["hot_swaps"]
    res["log"] = list(svc.mesh_log)
    return res, arrays


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
    cases = sys.argv[4] if len(sys.argv) > 4 else "solve"
    mp.spawn(worker, args=(world, out, device, cases), nprocs=world,
             join=True)


if __name__ == "__main__":
    main()
