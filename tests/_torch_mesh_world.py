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
launch runs' losses) into OUT_DIR; the test judges them.  CASES "heads"
(4 ranks) trains the HEADS_ARCHS, whose KV-head counts the model axis
does not divide, on the (1, 4) mesh as "train" does.  CASES "serve" (2
ranks) runs `prefill` and SERVE_DECODE `decode_step`s of the FAMILIES on
parameters placed on (1, 2) and on (2, 1), with the prompt placed by
`place_batch`, and writes the logits and the whole cache or state after
each call, gathered (`serve_<arch>_<shape>.rank<r>.npz`).  CASES
"restore" (2 ranks) saves a placed state of FAMILIES[0] after one step
on (2, 1) (its gathered arrays in `saved.npz`), then restores it into a
fresh state placed on (1, 2) (`restored.rank<r>.npz`).  The CASES of
MOE_RESTORE save the reduced MoE after one step on (2, 1) and on (2, 2)
and restore each onto another layout: (2, 1) onto (4, 1), (2, 2) onto
(2, 1).  Imports torch
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
HEADS_ARCHS = ["internlm2-1.8b", "llama3-8b", "qwen2-7b"]
HEADS_MESH = (("data", "model"), (1, 4))
SERVE_PROMPT, SERVE_CACHE, SERVE_DECODE = 12, 16, 3
# the MoE's checkpoint across layouts, three worlds in this order, each a
# list of (saved on, restore onto) or (None, save on) meshes: its router
# (("data", None)) is placed alike on (2, 2) and (2, 1), its blocks at
# other offsets
MOE_ARCH = "granite-moe-1b-a400m"
MOE_RESTORE = {"moe_save2": [(None, (2, 1))],
               "moe4": [((2, 1), (4, 1)), (None, (2, 2))],
               "moe_load2": [((2, 2), (2, 1))]}


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


def serve_inputs(cfg):
    """The prompt (BATCH, SERVE_PROMPT) and its src_embeds or
    prefix_embeds, and SERVE_DECODE decode tokens (BATCH, 1), from SEED."""
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, (BATCH, SERVE_PROMPT))
    extra = {}
    if cfg.family == "encdec":
        extra["src_embeds"] = rng.standard_normal(
            (BATCH, SERVE_PROMPT, cfg.d_model)).astype(np.float32)
    elif cfg.frontend != "none":
        extra["prefix_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (SERVE_DECODE, BATCH, 1))
    return toks, extra, steps


def _gathered(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy().copy()      # a decode writes in place


def _leaves(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def serve_run(cfg, params, place=None) -> dict:
    """`prefill`, then SERVE_DECODE `decode_step`s; {name: array} of the
    logits and every cache leaf after each call (gathered).  `place`
    places a batch dict (`place_batch` on a mesh)."""
    from repro_torch.models import get_model
    model = get_model(cfg)
    toks, extra, steps = serve_inputs(cfg)
    place = place or (lambda b: b)
    b = place({"tokens": torch.from_numpy(toks),
               **{k: torch.from_numpy(v) for k, v in extra.items()}})
    logits, cache = model.prefill(params, b["tokens"], cfg,
                                  cache_len=SERVE_CACHE,
                                  **{k: b[k] for k in extra})
    out = {"prefill/logits": _gathered(logits)}
    out.update({k: _gathered(v) for k, v in _leaves(cache, "prefill")})
    pos = SERVE_PROMPT + (cfg.frontend_positions
                          if "prefix_embeds" in extra else 0)
    for i, tok in enumerate(steps):
        t = place({"t": torch.from_numpy(tok)})["t"]
        logits, cache = model.decode_step(params, t, cache, pos + i, cfg)
        out[f"decode{i}/logits"] = _gathered(logits)
        out.update({k: _gathered(v) for k, v in
                    _leaves(cache, f"decode{i}")})
    return out


def serve_case(rank, names, shape, arch, out):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.train import meshctx
    from repro_torch.train.sharding import batch_specs
    from repro_torch.train.train_step import (init_state, place_batch,
                                              place_state)
    cfg = get_reduced(arch)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    params = place_state(init_state(SEED, cfg, device="cpu"),
                         mesh)["params"]
    with meshctx.mesh_context(mesh, batch_specs(mesh)):
        arrays = serve_run(cfg, params, lambda b: place_batch(b, mesh))
    np.savez(out / f"serve_{case_key(arch, shape)}.rank{rank}.npz",
             **arrays)


def state_arrays(state) -> dict:
    """{key: gathered array} of a train state (parameters, m, v, step)."""
    arrays = {f"params/{n}": _gathered(p)
              for n, p in state["params"].named_parameters()}
    for which in ("m", "v"):
        arrays.update({f"{which}/{n}": _gathered(t)
                       for n, t in state["opt"][which].items()})
    arrays["step"] = state["opt"]["step"].numpy()
    return arrays


def restore_case(rank, out):
    """Save a placed state on (2, 1); restore it onto (1, 2)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import meshctx
    from repro_torch.train.sharding import batch_specs
    from repro_torch.train.train_step import (init_state, make_train_step,
                                              place_state)
    cfg = get_reduced(FAMILIES[0])
    names = ("data", "model")
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=names)
    state = place_state(init_state(SEED, cfg, device="cpu"), mesh)
    with meshctx.mesh_context(mesh, batch_specs(mesh)):
        state, _ = make_train_step(cfg, opt_config())(state,
                                                      batches(cfg)[0])
    ckpt.save(out / "ck", 1, state)
    saved = state_arrays(state)
    if rank == 0:
        np.savez(out / "saved.npz", **saved)
    dist.barrier()                       # the MANIFEST is committed
    other = init_device_mesh("cpu", (1, 2), mesh_dim_names=names)
    fresh = place_state(init_state(SEED + 1, cfg, device="cpu"), other)
    fresh, step = ckpt.restore(out / "ck", fresh)
    assert step == 1
    np.savez(out / f"restored.rank{rank}.npz", **state_arrays(fresh))


def _shape_tag(shape) -> str:
    return "x".join(map(str, shape))


def moe_save(rank, out, shape):
    """One step of the reduced MoE placed on (data, model) = shape, saved
    to `ck_<shape>` (its gathered arrays in `saved_<shape>.npz`)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import meshctx
    from repro_torch.train.sharding import batch_specs
    from repro_torch.train.train_step import (init_state, make_train_step,
                                              place_state)
    cfg = get_reduced(MOE_ARCH)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    state = place_state(init_state(SEED, cfg, device="cpu"), mesh)
    with meshctx.mesh_context(mesh, batch_specs(mesh)):
        state, _ = make_train_step(cfg, opt_config())(state,
                                                      batches(cfg)[0])
    ckpt.save(out / f"ck_{_shape_tag(shape)}", 1, state)
    saved = state_arrays(state)
    if rank == 0:
        np.savez(out / f"saved_{_shape_tag(shape)}.npz", **saved)
    dist.barrier()                       # the MANIFEST is committed


def moe_restore(rank, out, saved_on, shape):
    """Restore `ck_<saved_on>` into a fresh reduced MoE state placed on
    (data, model) = shape (`restored_<saved_on>_<shape>.rank<r>.npz`,
    gathered)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import init_state, place_state
    cfg = get_reduced(MOE_ARCH)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    fresh = place_state(init_state(SEED + 1, cfg, device="cpu"), mesh)
    fresh, step = ckpt.restore(out / f"ck_{_shape_tag(saved_on)}", fresh)
    assert step == 1
    np.savez(out / f"restored_{_shape_tag(saved_on)}_{_shape_tag(shape)}"
                   f".rank{rank}.npz", **state_arrays(fresh))


def worker(rank: int, world: int, out: str, cases: str, ports: list):
    torch.set_num_threads(1)
    out = Path(out)
    res = {}
    if cases == "launch":
        launch_runs(rank, world, out, ports, res)
    else:
        dist.init_process_group(
            "gloo", init_method=f"file://{out / f'store.{cases}'}",
            rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            if cases == "heads":
                for arch in HEADS_ARCHS:
                    train_case(rank, *HEADS_MESH, arch, out, False, res)
            elif cases == "serve":
                for names, shape in MESHES[world]:
                    for arch in FAMILIES:
                        serve_case(rank, names, shape, arch, out)
            elif cases == "restore":
                restore_case(rank, out)
            elif cases in MOE_RESTORE:
                for saved_on, shape in MOE_RESTORE[cases]:
                    if saved_on is None:
                        moe_save(rank, out, shape)
                    else:
                        moe_restore(rank, out, saved_on, shape)
            else:
                for names, shape in MESHES[world]:
                    for arch in FAMILIES:
                        train_case(rank, names, shape, arch, out, False,
                                   res)
            if world == 4 and cases == "train":
                names, shape = POD_MESH
                train_case(rank, names, shape, FAMILIES[0], out, True, res)
                compress_case(rank, out, res)
            # no rank tears its group down while another still talks to it
            dist.barrier()
        finally:
            dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(res))


# --- for the tests that judge the worlds (they import this module) ---

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
SERVE_RTOL = 1e-4
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
