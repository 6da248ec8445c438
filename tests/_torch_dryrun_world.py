"""Child processes of tests/test_torch_dryrun.py.

    python tests/_torch_dryrun_world.py CASE

Prints one JSON object as the last line of its output.  The port's cases
run the dry run's fake process groups (so no pytest worker joins one) and
import torch and the port only; the cases named "ref_*" run the reference
on forced host devices (the caller sets XLA_FLAGS and JAX_PLATFORMS) and
import JAX and the reference only.

  scan        13 steps of tanh(c @ w), (128, 256) @ (256, 256), counted
              unsharded on plain CPU tensors, then on a fake 8-rank mesh
              with c as Shard(0) and w as Shard(1) (`op_analysis.analyze`)
  alltoall    a Shard(0) -> Shard(1) redistribution on a fake 8-rank mesh
  params      each architecture's parameter bytes a rank holds, placed on
              the production meshes (16, 16) and (2, 16, 16) over meta
  internlm2   the reduced internlm2 in bfloat16 on a fake (4, 2) mesh:
              `run_cell` of train_4k, prefill_32k, decode_32k
  every       every reduced architecture on a fake (2, 4) mesh, each
              applicable kind, at the cut shapes SMALL_SHAPES
  nested      the reduced internlm2 in bfloat16 with NESTED_LAYERS layers
              (two groups of its remat_group 4: the two-level remat) on
              the fake (4, 2) mesh: `run_cell` of train_4k with remat on
              and off
  ref_scan, ref_params, ref_internlm2, ref_nested: the reference's
              counterparts
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

STEPS, M, K = 13, 128, 256
REDUCED_MESH = {"data": 4, "model": 2}
EVERY_MESH = {"data": 2, "model": 4}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
NESTED_LAYERS = 8
# (seq_len, global_batch) of each shape for the "every" case: the specs'
# kinds and structures at a size that keeps the case to seconds
SMALL_SHAPES = {"train_4k": (256, 8), "prefill_32k": (1024, 8),
                "decode_32k": (1024, 8), "long_500k": (2048, 8)}


# the reduced config in bfloat16: the reference's decode cells take
# bfloat16 caches (`specs.input_specs`), which its float32 reduced configs
# cannot write (dynamic_update_slice refuses the mixed dtypes)
BF16 = {"param_dtype": "bfloat16", "activation_dtype": "bfloat16"}


# --- the port ---------------------------------------------------------

def _scan_program(c, w):
    import torch
    for _ in range(STEPS):
        c = torch.tanh(c @ w)
    return c.sum()


def _fake(n: int):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh("cpu", (n,), mesh_dim_names=("d",))


def scan():
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.op_analysis import analyze
    c, w = torch.randn(M, K), torch.randn(K, K)
    plain = analyze(_scan_program, c, w)
    mesh = _fake(8)
    cd = distribute_tensor(c, mesh, [Shard(0)], src_data_rank=None)
    wd = distribute_tensor(w, mesh, [Shard(1)], src_data_rank=None)
    sharded = analyze(_scan_program, cd, wd)
    return {"flops": plain["flops"], "expect": 2 * M * K * K * STEPS,
            "sharded_flops": sharded["flops"],
            "coll_counts": sharded["collective_counts"],
            "coll_bytes": sharded["collective_bytes"]}


def alltoall():
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.op_analysis import analyze
    mesh = _fake(8)
    x = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0)],
                          src_data_rank=None)
    res = analyze(lambda t: t.redistribute(mesh, [Shard(1)]), x)
    return {"counts": res["collective_counts"],
            "bytes": res["collective_bytes"],
            "local": list(res["result"].to_local().shape)}


def params():
    import torch.distributed as dist
    from repro_torch.configs import all_arch_ids, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    for pod in (False, True):
        mesh = dryrun._device_mesh(make_production_mesh(multi_pod=pod))
        for arch in all_arch_ids():
            p = dryrun._placed_params(get_config(arch), mesh)
            out[f"{arch}|{int(pod)}"] = dryrun._local_bytes(p)
        dist.destroy_process_group()
    return out


def fields(cfg) -> dict:
    """A config's fields: `run_cell`'s variant that makes it."""
    import dataclasses
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def internlm2():
    from repro_torch.configs import get_reduced
    from repro_torch.launch import dryrun
    variant = {**fields(get_reduced("internlm2-1.8b")), **BF16}
    out = {}
    for shape in SHAPES:
        rec = dryrun.run_cell("internlm2-1.8b", shape, mesh=REDUCED_MESH,
                              variant=variant)
        out[shape] = {"flops": rec["hlo_flops"],
                      "model_flops": rec["roofline"]["model_flops_per_chip"],
                      "counts": rec["collectives"]["counts"]}
    return out


def nested():
    from repro_torch.configs import get_reduced
    from repro_torch.launch import dryrun
    cfg = get_reduced("internlm2-1.8b")
    assert cfg.n_layers % cfg.remat_group != 0 and \
        NESTED_LAYERS // cfg.remat_group == 2
    return {str(remat): dryrun.run_cell(
        "internlm2-1.8b", "train_4k", mesh=REDUCED_MESH,
        variant={**fields(cfg), **BF16, "n_layers": NESTED_LAYERS,
                 "remat": remat})["hlo_flops"] for remat in (True, False)}


def every():
    import math
    from repro_torch.configs import all_arch_ids, get_reduced
    from repro_torch.launch import dryrun, specs
    for name, (seq, batch) in SMALL_SHAPES.items():
        sd = specs.SHAPES[name]
        specs.SHAPES[name] = specs.ShapeDef(name, seq, batch, sd.kind)
    out = {}
    for arch in all_arch_ids():
        for shape in specs.SHAPES:
            rec = dryrun.run_cell(arch, shape, mesh=EVERY_MESH,
                                  variant=fields(get_reduced(arch)))
            if "skip" in rec:
                out[f"{arch}|{shape}"] = "skip"
                continue
            vals = [rec["hlo_flops"], rec["hlo_bytes"], rec["hlo_bytes_min"],
                    rec["memory"]["temp_bytes"]]
            out[f"{arch}|{shape}"] = {
                "kind": rec["kind"],
                "finite_positive": all(math.isfinite(v) and v > 0
                                       for v in vals),
                "collectives": rec["collectives"]["total_count"]}
    return out


# --- the reference ----------------------------------------------------

def ref_scan():
    import jax
    import jax.numpy as jnp
    from repro.launch.hlo_analysis import analyze_hlo

    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=STEPS)
        return y.sum()
    x = jax.ShapeDtypeStruct((M, K), jnp.float32)
    w = jax.ShapeDtypeStruct((K, K), jnp.float32)
    return {"flops": analyze_hlo(jax.jit(f).lower(x, w).compile()
                                 .as_text())["flops"]}


def ref_params():
    import jax
    import numpy as np
    from repro.configs import all_arch_ids, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.models import get_model
    from repro.train.sharding import param_shardings
    out = {}
    for pod in (False, True):
        mesh = make_production_mesh(multi_pod=pod)
        for arch in all_arch_ids():
            cfg = get_config(arch)
            shapes = jax.eval_shape(
                lambda k: get_model(cfg).init_params(k, cfg),
                jax.random.PRNGKey(0))
            shard = param_shardings(shapes, mesh)
            total = 0
            for leaf, sh in zip(jax.tree.leaves(shapes),
                                jax.tree.leaves(shard)):
                total += int(np.prod(sh.shard_shape(leaf.shape))) * \
                    leaf.dtype.itemsize
            out[f"{arch}|{int(pod)}"] = total
    return out


def ref_internlm2():
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_reduced
    from repro.launch.dryrun import run_cell
    cfg = get_reduced("internlm2-1.8b")
    mesh = jax.make_mesh(tuple(REDUCED_MESH.values()), tuple(REDUCED_MESH),
                         axis_types=(AxisType.Auto,) * len(REDUCED_MESH))
    out = {}
    for shape in SHAPES:
        rec = run_cell("internlm2-1.8b", shape, mesh=mesh,
                       variant={**cfg.__dict__, **BF16})
        out[shape] = {"flops": rec["hlo_flops"],
                      "model_flops": rec["roofline"]["model_flops_per_chip"],
                      "counts": rec["collectives"]["counts"]}
    return out


def ref_nested():
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_reduced
    from repro.launch.dryrun import run_cell
    cfg = get_reduced("internlm2-1.8b")
    mesh = jax.make_mesh(tuple(REDUCED_MESH.values()), tuple(REDUCED_MESH),
                         axis_types=(AxisType.Auto,) * len(REDUCED_MESH))
    return {str(remat): run_cell(
        "internlm2-1.8b", "train_4k", mesh=mesh,
        variant={**cfg.__dict__, **BF16, "n_layers": NESTED_LAYERS,
                 "remat": remat})["hlo_flops"] for remat in (True, False)}


CASES = {f.__name__: f for f in (scan, alltoall, params, internlm2, every,
                                 nested, ref_scan, ref_params, ref_internlm2,
                                 ref_nested)}


def main() -> None:
    case = sys.argv[1]
    if not case.startswith("ref_"):
        import torch
        torch.set_num_threads(1)
    print(json.dumps(CASES[case]()))


if __name__ == "__main__":
    main()
