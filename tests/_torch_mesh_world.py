"""One world of gloo ranks for tests/test_torch_lm_mesh*.py.

    python tests/_torch_mesh_world.py WORLD OUT_DIR CASES [PORTS]

Spawns WORLD ranks (torch.multiprocessing, start method "spawn"), each
pinned to one thread.  CASES "train" joins one gloo process group through
a file under OUT_DIR (collectives time out after COLLECTIVE_TIMEOUT_S, so
that ranks left in different collectives fail instead of hanging) and
trains the reduced configs of one architecture of each family for STEPS
steps on the meshes of this world size, through `place_state` and
`make_train_step` (float32, the state drawn from SEED, the batches from
`SyntheticLM`): on 2 ranks the meshes (2, 1) and (1, 2), on 4 ranks
(2, 2) and the (pod 2, data 2, model 1) mesh, and the dense config on the
pod mesh with `compress_pod`; an
`init_<arch>.npz` in OUT_DIR, when there is one, gives the initial
parameters, m and v in place of the seeded draw.  On 4 ranks it also
runs `compressed_psum_tree` on plain gradients that differ on every rank
(seeded by the rank) under the pod mesh.  CASES "launch" runs
`launch.train.main` on the world as torchrun would start it (the
environment's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and the ports
PORTS, one a run): a straight run, a run aborted after ABORT_AFTER steps,
and its `--resume`.  Each rank writes `<case>.rank<r>.npz` (losses, grad
norms, the parameters gathered after the last step) and `rank<r>.json`
(each case's local shard shapes and storage sizes, placements, and the
launch runs' losses) into OUT_DIR; the test judges them.  Imports torch
and the port only (the helpers at the end, which the tests import to
judge the worlds, import the reference inside the functions that use
it).
"""
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

COLLECTIVE_TIMEOUT_S = 120.0
SEED = 0
STEPS = 3
BATCH, SEQ = 4, 32
FAMILIES = ["internlm2-1.8b", "granite-moe-1b-a400m", "mamba2-130m",
            "recurrentgemma-9b", "seamless-m4t-large-v2"]
POD_MESH = (("pod", "data", "model"), (2, 2, 1))
MESHES = {2: [(("data", "model"), (2, 1)), (("data", "model"), (1, 2))],
          4: [(("data", "model"), (2, 2)), POD_MESH]}
LAUNCH_ARCH, LAUNCH_STEPS, ABORT_AFTER, CKPT_EVERY = \
    "internlm2-1.8b", 20, 10, 5


def opt_config():
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig()


def batches(cfg):
    from repro_torch.train.data import SyntheticLM
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                       seed=SEED, frontend=cfg.frontend,
                       frontend_positions=cfg.frontend_positions,
                       d_model=cfg.d_model, encdec=cfg.family == "encdec")
    return [data.batch_at(i) for i in range(STEPS)]


def initial_state(cfg, out: Path, compress: bool):
    """The seeded state, or the one in `init_<arch>.npz`; with residuals
    when `compress`."""
    from repro_torch.train.compression import init_residuals
    from repro_torch.train.train_step import init_state
    state = init_state(SEED, cfg, device="cpu")
    path = out / f"init_{cfg.name}.npz"
    if path.exists():
        with np.load(path) as z, torch.no_grad():
            for n, p in state["params"].named_parameters():
                p.copy_(torch.from_numpy(z[f"params/{n}"]))
            for which in ("m", "v"):
                for n, t in state["opt"][which].items():
                    t.copy_(torch.from_numpy(z[f"{which}/{n}"]))
    if compress:
        state["residuals"] = init_residuals(state["params"])
    return state


def run_steps(cfg, state, compress: bool):
    """STEPS steps of `make_train_step`: (losses, grad norms)."""
    from repro_torch.train.train_step import make_train_step
    step = make_train_step(cfg, opt_config(), compress_pod=compress)
    losses, norms = [], []
    for batch in batches(cfg):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms


def train_case(rank, names, shape, arch, out, compress, res):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_reduced
    from repro_torch.train import meshctx
    from repro_torch.train.sharding import batch_specs
    from repro_torch.train.train_step import place_state
    cfg = get_reduced(arch)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    state = place_state(initial_state(cfg, out, compress), mesh)
    with meshctx.mesh_context(mesh, batch_specs(mesh)):
        losses, norms = run_steps(cfg, state, compress)
    key = case_key(arch, shape, compress)
    local = {}
    arrays = {"losses": np.array(losses), "grad_norms": np.array(norms)}
    for n, p in state["params"].named_parameters():
        lt = p.to_local()
        local[n] = {"shape": list(lt.shape),
                    "storage": lt.untyped_storage().nbytes(),
                    "itemsize": lt.element_size(),
                    "placements": [str(q) for q in p.placements],
                    "m": list(state["opt"]["m"][n].to_local().shape),
                    "v": list(state["opt"]["v"][n].to_local().shape)}
        arrays[f"params/{n}"] = p.full_tensor().detach().numpy()
    assert all(isinstance(p, DTensor)
               for p in state["params"].parameters())
    np.savez(out / f"{key}.rank{rank}.npz", **arrays)
    res[key] = local


def case_key(arch: str, shape, compress: bool = False) -> str:
    return f"{arch}_{'x'.join(map(str, shape))}" + \
        ("_compress" if compress else "")


def compress_case(rank, out, res):
    """`compressed_psum_tree` of plain gradients seeded by the rank under
    the pod mesh, and the same over the default group (every rank)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.train.compression import compressed_psum_tree
    names, shape = POD_MESH
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    g = compress_grads(rank)
    r = {k: torch.zeros_like(t) for k, t in g.items()}
    pod, new_r = compressed_psum_tree(g, r, mesh=mesh)
    world, _ = compressed_psum_tree(g, r)
    np.savez(out / f"compress.rank{rank}.npz",
             **{f"pod/{k}": t.numpy() for k, t in pod.items()},
             **{f"world/{k}": t.numpy() for k, t in world.items()},
             **{f"res/{k}": t.numpy() for k, t in new_r.items()})
    res["pod_group_ranks"] = dist.get_process_group_ranks(
        mesh.get_group("pod"))


def compress_grads(rank: int) -> dict:
    gen = torch.Generator().manual_seed(100 + rank)
    return {"a": torch.randn((5, 7), generator=gen),
            "b": torch.randn((11,), generator=gen) * 3.0}


def launch_runs(rank, world, out, ports, res):
    from repro_torch.launch import train as T
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1")
    common = ["--arch", LAUNCH_ARCH, "--steps", str(LAUNCH_STEPS),
              "--batch", str(BATCH), "--seq", str(SEQ), "--device", "cpu",
              "--ckpt-every", str(CKPT_EVERY), "--log-every", "100",
              "--collective-timeout", str(COLLECTIVE_TIMEOUT_S)]
    runs = [("straight", ["--ckpt-dir", str(out / "ck_straight")]),
            ("aborted", ["--ckpt-dir", str(out / "ck_resume"),
                         "--abort-after", str(ABORT_AFTER)]),
            ("resumed", ["--ckpt-dir", str(out / "ck_resume"),
                         "--resume"])]
    for (name, extra), port in zip(runs, ports):
        os.environ["MASTER_PORT"] = str(port)
        res[name] = T.main(common + extra)
        assert not dist.is_initialized()
    res["shards"] = sorted(p.name for p in
                           (out / "ck_straight" / "step_00000020").iterdir())


def worker(rank: int, world: int, out: str, cases: str, ports: list):
    torch.set_num_threads(1)
    out = Path(out)
    res = {}
    if cases == "launch":
        launch_runs(rank, world, out, ports, res)
    else:
        dist.init_process_group(
            "gloo", init_method=f"file://{out / 'store'}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            for names, shape in MESHES[world]:
                for arch in FAMILIES:
                    train_case(rank, names, shape, arch, out, False, res)
            if world == 4:
                names, shape = POD_MESH
                train_case(rank, names, shape, FAMILIES[0], out, True, res)
                compress_case(rank, out, res)
        finally:
            dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(res))


# --- for the tests that judge the worlds (they import this module) ---

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
COMPRESS_ATOL = 1e-6
WORLD_TIMEOUT_S = 600


def ref_cfg(cfg):
    """The reference's ArchConfig of a port config."""
    import dataclasses
    from repro.models import config as RC
    d = dataclasses.asdict(cfg)
    for key, cls in (("moe", RC.MoEConfig), ("ssm", RC.SSMConfig),
                     ("recurrent", RC.RecurrentConfig)):
        if d[key] is not None:
            d[key] = cls(**d[key])
    return RC.ArchConfig(**d)


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def run_world(world: int, out: Path, cases: str, ports=()) -> list:
    """Run one spawned world; each rank's json.  The launcher and its
    ranks share a session of their own, so a timeout kills them all."""
    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, str(ROOT / "tests" / "_torch_mesh_world.py"),
           str(world), str(out), cases]
    if ports:
        cmd.append(",".join(map(str, ports)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=env, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        raise AssertionError(f"the world of {world} timed out: "
                             f"{err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def one_device(cfg, out: Path, compress: bool):
    """The one-device port run of the world's case: (losses, grad norms,
    {name: parameter})."""
    state = initial_state(cfg, out, compress)
    losses, norms = run_steps(cfg, state, compress)
    return losses, norms, {n: p.detach().numpy() for n, p in
                           state["params"].named_parameters()}


def plan_local_shape(shape, spec, mesh_shape) -> list:
    out = list(shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            out[d] //= mesh_shape[ax]
    return out


def judge(out: Path, ranks: list, key: str, cfg, mesh_shape, want):
    """The world's case `key` against the one-device run `want`: the
    ranks bitwise alike, the losses, grad norms and parameters within
    the tolerances, every rank's local blocks the plan's (and their
    storage no larger)."""
    from repro_torch.train import sharding
    w_losses, w_norms, w_params = want
    arrs = [np.load(out / f"{key}.rank{r}.npz") for r in range(len(ranks))]
    for a in arrs[1:]:
        for k in arrs[0].files:
            assert np.array_equal(a[k], arrs[0][k]), (key, k)
    a = arrs[0]
    for got, ref in zip(a["losses"], w_losses):
        assert rel(float(got), ref) <= LOSS_RTOL, (key, "loss")
    for got, ref in zip(a["grad_norms"], w_norms):
        assert rel(float(got), ref) <= LOSS_RTOL, (key, "grad norm")
    for n, ref in w_params.items():
        err = np.abs(a[f"params/{n}"] - ref).max()
        assert err <= PARAM_RTOL * max(np.abs(ref).max(), 1e-30), (key, n)
    specs = sharding.param_specs({n: p.shape for n, p in w_params.items()},
                                 mesh_shape)
    for res in ranks:
        for n, loc in res[key].items():
            plan = plan_local_shape(w_params[n].shape, specs[n], mesh_shape)
            assert loc["shape"] == loc["m"] == loc["v"] == plan, (key, n)
            assert loc["storage"] == \
                int(np.prod(plan)) * loc["itemsize"], (key, n)


def write_reference_init(cfg, out: Path):
    """The reference's initial train state (PRNGKey(1)) in the port's
    names, for the world to start from; returns it (jax arrays)."""
    import jax
    from repro_torch.models import convert
    from repro.train import init_state as ref_init_state
    rcfg = ref_cfg(cfg)
    rstate = ref_init_state(jax.random.PRNGKey(1), rcfg)
    arrays = {}
    for which, tree in (("params", rstate["params"]),
                        ("m", rstate["opt"]["m"]), ("v", rstate["opt"]["v"])):
        for n, a in convert.named_arrays(
                cfg, jax.tree.map(np.asarray, tree)).items():
            arrays[f"{which}/{n}"] = np.asarray(a, np.float32)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / f"init_{cfg.name}.npz", **arrays)
    return rstate


def reference_steps(cfg, rstate):
    import jax
    import jax.numpy as jnp
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import make_train_step as ref_make_train_step
    from repro_torch.models import convert
    rcfg = ref_cfg(cfg)
    step = jax.jit(ref_make_train_step(rcfg, RefAdamW()))
    losses = []
    for batch in batches(cfg):
        rstate, met = step(rstate, jax.tree.map(jnp.asarray, batch))
        losses.append(float(met["loss"]))
    return losses, convert.named_arrays(
        cfg, jax.tree.map(np.asarray, rstate["params"]))


def main() -> None:
    world, out, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    ports = [int(p) for p in sys.argv[4].split(",")] \
        if len(sys.argv) > 4 else []
    mp.spawn(worker, args=(world, out, cases, ports), nprocs=world,
             join=True)


if __name__ == "__main__":
    main()
