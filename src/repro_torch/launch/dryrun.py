"""The dry run: count every (arch x shape x mesh) cell on a fake DeviceMesh
over meta tensors.

Port of `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's memory and cost analysis.  Here one CPU process
joins a fake process group the size of the plan (`backend="fake"` on a
`FakeStore`: 256 ranks, or 512 for the (2, 16, 16) mesh, as rank 0; it is
torn down and rebuilt when the size changes), makes the production
`DeviceMesh` (`launch.mesh.make_production_mesh`), builds the state on
the meta device (`init_state(..., device="meta")`, nothing allocated)
and places it by the plan (`place_state`), takes the inputs from
`launch.specs.input_specs`, and runs one call of the cell's kind, a
train step, a prefill or a decode step, under the op counter
(`op_analysis.OpCounter`), which counts what rank 0 dispatches on its
local blocks.  Tokens, `src_embeds` and `prefix_embeds` are placed as the
reference's `_batch_shardings` places them (dim 0 over the batch axes
when divisible: `train_step.place_batch`), and a decode's cache by
`_cache_shardings`, the reference's rule (`sharding.cache_spec`).

Where DTensor shards a dimension unevenly, rank 0 holds the larger
block; the plan itself never shards unevenly (an axis that does not
divide a dimension replicates it), so every rank's parameters and cache
blocks are the same size, as the reference's padded, uniform per-device
program is.  The record keeps the reference's keys with their meanings:
`hlo_flops`, `hlo_bytes`, `hlo_bytes_min` and `collectives` are the
counter's per-rank totals (`collectives_raw` is the same: the eager
stream has no loop bodies to count once), `memory` gives the local
bytes of the call's inputs (`argument_bytes`) and outputs
(`output_bytes`), the eager peak of storage made during the call
(`temp_bytes`: not XLA's buffer assignment) and `code_bytes` None; the
reference's `lower_s` and `compile_s` are `place_s` (building and
placing the state and inputs) and `trace_s` (the counted call), and
`compile_s` repeats `trace_s` for `benchmarks/roofline_report.py`.
`main` writes `torch_dryrun_results.json`, never the reference's
`dryrun_results.json`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import all_arch_ids, get_config
from ..models.api import get_model
from ..train import meshctx
from ..train.optimizer import AdamWConfig
from ..train.sharding import axis_sizes, batch_specs, cache_spec, \
    placements_for
from ..train.train_step import (init_state, make_serve_fns, make_train_step,
                                place_batch, place_state)
from .mesh import make_production_mesh
from .op_analysis import COLLECTIVES, OpCounter
from .specs import (SHAPES, ShapeDef, cell_is_applicable, input_specs,
                    skip_reason)

__all__ = ["run_cell", "roofline_terms", "count_train_step", "main",
           "COLLECTIVES", "PEAK_FLOPS", "HBM_BW", "LINK_BW"]

# NVIDIA H100 SXM5 (NVIDIA's data sheet; the card the chip machine names
# "NVIDIA H100 80GB HBM3", power limit 700.00 W): dense bf16 peak, HBM3
PEAK_FLOPS = 989e12          # FLOP/s a card
HBM_BW = 3.35e12             # bytes/s a card
# NVLink 4, one direction: 900 GB/s a card in both directions over its 18
# links (data sheet), so 450 GB/s out of one card over all of its links.
# The reference's LINK_BW (50e9, v5e ICI) is one link's.
LINK_BW = 450e9              # bytes/s a card, one direction

def _fake_world(n: int) -> None:
    """A fake process group of n ranks (this process rank 0), made or
    remade when the size changes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _device_mesh(mesh):
    """A `DeviceMesh` of a plan's shape (a `MeshPlan`, or a dict of axis
    sizes) over a fake group of its size."""
    from torch.distributed.device_mesh import init_device_mesh
    sizes = axis_sizes(mesh)
    n = 1
    for v in sizes.values():
        n *= v
    _fake_world(n)
    return init_device_mesh("cpu", tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def _cache_shardings(cache_shape, mesh):
    """The placements of a KV cache or state tree on `mesh`: the
    reference's `_cache_shardings` (its leaf rule is
    `sharding.cache_spec`, batch over data(+pod), long sequence dims over
    "model")."""
    if isinstance(cache_shape, dict):
        return {k: _cache_shardings(v, mesh) for k, v in cache_shape.items()}
    if isinstance(cache_shape, list):
        return [_cache_shardings(v, mesh) for v in cache_shape]
    return placements_for(cache_spec(cache_shape.shape, mesh), mesh)


def _placed(tree, placements, mesh):
    """Zeros of each leaf of `tree` as DTensors with these placements
    (this rank's block; meta leaves allocate nothing)."""
    if isinstance(tree, dict):
        return {k: _placed(v, placements[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placed(v, p, mesh) for v, p in zip(tree, placements)]
    return meshctx.placed_zeros(tree, mesh, placements)


def _local_bytes(tree) -> int:
    """The bytes this rank holds of a tree's tensors (a module's
    parameters, a DTensor's local block)."""
    from torch.utils._pytree import tree_flatten
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _placed_params(cfg, mesh):
    model = get_model(cfg).init_params(0, cfg, device="meta")
    return place_state({"params": model, "opt": {"m": {}, "v": {}}},
                       mesh)["params"]


def _variant(cfg, variant: dict | None):
    fields = {f.name for f in dataclasses.fields(cfg)}
    kv = {k: v for k, v in (variant or {}).items() if k in fields}
    return dataclasses.replace(cfg, **kv) if kv else cfg


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             mesh=None, variant: dict | None = None) -> dict:
    """Count one cell; returns the roofline record.  `mesh` is a
    `MeshPlan` or a dict of axis sizes (the production plan when None); `variant` replaces fields of the arch's config (a
    reduced config's fields, in the tests), as the reference's does."""
    cfg = _variant(get_config(arch), variant)
    if not cell_is_applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "skip": skip_reason(cfg, shape)}
    mesh = _device_mesh(mesh if mesh is not None else
                        make_production_mesh(multi_pod=multi_pod))
    meshctx.set_mesh_context(mesh, batch_specs(mesh))
    try:
        return _count(cfg, arch, shape, mesh)
    finally:
        meshctx.clear_mesh_context()


def _call(cfg, spec: dict, mesh, opt_cfg: AdamWConfig | None = None):
    """(the call of the spec's kind over meta tensors, the local bytes of
    its inputs): its state or parameters placed on `mesh`, or unplaced
    when `mesh` is None (a train step only)."""
    kind = spec["kind"]
    if kind == "train":
        state = init_state(0, cfg, device="meta")
        batch = spec["batch"]
        if mesh is not None:
            state = place_state(state, mesh)
        step = make_train_step(cfg, opt_cfg or AdamWConfig())
        argument_bytes = _local_bytes(state) + _local_bytes(
            batch if mesh is None else place_batch(batch, mesh))

        def call():
            return step(state, batch)
    elif kind == "prefill":
        params = _placed_params(cfg, mesh)
        extra = {k: spec[k] for k in ("src_embeds", "prefix_embeds")
                 if k in spec}
        batch = place_batch({"tokens": spec["tokens"], **extra}, mesh)
        prefill_fn = make_serve_fns(cfg)[0]
        argument_bytes = _local_bytes(params) + _local_bytes(batch)

        def call():
            return prefill_fn(params, batch["tokens"], spec["cache_len"],
                              **{k: batch[k] for k in extra})
    else:
        params = _placed_params(cfg, mesh)
        cache = _placed(spec["cache"], _cache_shardings(spec["cache"], mesh),
                        mesh)
        token = place_batch({"t": spec["token"]}, mesh)["t"]
        decode_fn = make_serve_fns(cfg)[1]
        argument_bytes = _local_bytes(params) + _local_bytes(cache) + \
            _local_bytes(token)

        def call():
            return decode_fn(params, token, cache, spec["pos"])
    return call, argument_bytes


def _count(cfg, arch, shape, mesh) -> dict:
    spec = input_specs(cfg, shape)
    kind = spec["kind"]
    t0 = time.time()
    call, argument_bytes = _call(cfg, spec, mesh)
    place_s = time.time() - t0
    t0 = time.time()
    counter = OpCounter()
    with counter:
        out = call()
    trace_s = time.time() - t0
    totals = counter.totals()
    n_chips = mesh.size()
    coll = {"total_bytes": totals["collective_bytes"],
            "counts": totals["collective_counts"],
            "total_count": int(sum(totals["collective_counts"].values()))}
    rec = {
        "arch": arch, "shape": shape,
        "mesh": dict(axis_sizes(mesh)), "chips": n_chips, "kind": kind,
        "place_s": round(place_s, 1), "trace_s": round(trace_s, 1),
        "compile_s": round(trace_s, 1),
        "hlo_flops": totals["flops"], "hlo_bytes": totals["bytes"],
        "hlo_bytes_min": totals["bytes_min"],
        "collectives_raw": coll,
        "collectives": coll,
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": counter.temp_bytes,
            "code_bytes": None,
        },
    }
    rec["roofline"] = roofline_terms(rec, cfg, SHAPES[shape])
    return rec


def count_train_step(cfg, global_batch: int, seq_len: int,
                     opt_cfg: AdamWConfig | None = None,
                     record_dots: bool = False) -> dict:
    """The counter's totals (`op_analysis.analyze`'s keys) of one train
    step of `cfg` on one device, unplaced, over meta tensors, at
    (global_batch, seq_len): the ops that the same step dispatches on a
    card, counted without one.  With `record_dots`, "dots" is the
    counter's stream of dot ops (`OpCounter.dots`)."""
    call, _ = _call(cfg, input_specs(cfg, ShapeDef("train", seq_len,
                                                    global_batch, "train")),
                    None, opt_cfg)
    counter = OpCounter(record_dots)
    with counter:
        call()
    out = {**counter.totals(), "temp_bytes": counter.temp_bytes}
    if record_dots:
        out["dots"] = counter.dots
    return out


def roofline_terms(rec: dict, cfg, sd) -> dict:
    """Per-card roofline terms from the per-rank totals (the reference's
    formulas, with the H100's constants)."""
    flops, bts = rec["hlo_flops"], rec["hlo_bytes"]
    cbytes = rec["collectives"]["total_bytes"]
    compute_s = flops / PEAK_FLOPS
    memory_s = bts / HBM_BW
    memory_min_s = rec.get("hlo_bytes_min", bts) / HBM_BW
    collective_s = cbytes / LINK_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    # MODEL_FLOPS: 6*N*D for train (fwd+bwd), 2*N*D for single fwd
    N = cfg.active_params_count()
    D = sd.global_batch * (sd.seq_len if rec["kind"] != "decode" else 1)
    mult = 6 if rec["kind"] == "train" else 2
    model_flops = mult * N * D / rec["chips"]    # per card
    step_s = max(compute_s, memory_s, collective_s)
    step_min_s = max(compute_s, memory_min_s, collective_s)
    dominant_min = max(("compute", compute_s), ("memory", memory_min_s),
                       ("collective", collective_s), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "memory_min_s": memory_min_s,
        "collective_s": collective_s, "dominant": dominant,
        "dominant_min": dominant_min,
        "model_flops_per_chip": model_flops,
        "useful_fraction": model_flops / flops if flops else 0.0,
        # the roofline score: MODEL_FLOPS / (step_time * peak), with the
        # dominant term bounding the step; _min with bytes_min's memory
        "roofline_mfu": (model_flops / (step_s * PEAK_FLOPS)
                         if step_s > 0 else 0.0),
        "roofline_mfu_min": (model_flops / (step_min_s * PEAK_FLOPS)
                             if step_min_s > 0 else 0.0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    archs = all_arch_ids() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    path = outdir / "torch_dryrun_results.json"
    results = []
    try:
        for mp in meshes:
            plan = make_production_mesh(multi_pod=mp)
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}|{shape}|{'2pod' if mp else '1pod'}"
                    t0 = time.time()
                    try:
                        rec = run_cell(arch, shape, mesh=plan)
                        rec["mesh_tag"] = "2pod" if mp else "1pod"
                        if "skip" in rec:
                            print(f"SKIP {tag}: {rec['skip']}", flush=True)
                        else:
                            r = rec["roofline"]
                            print(f"OK   {tag}: trace {rec['trace_s']}s "
                                  f"flops {rec['hlo_flops']:.3e} "
                                  f"dom={r['dominant']} "
                                  f"useful={r['useful_fraction']:.2f}",
                                  flush=True)
                    except Exception as e:  # noqa: BLE001
                        rec = {"arch": arch, "shape": shape,
                               "mesh_tag": "2pod" if mp else "1pod",
                               "error": f"{type(e).__name__}: {e}"}
                        print(f"FAIL {tag}: {rec['error']}", flush=True)
                    rec["cell_s"] = round(time.time() - t0, 1)
                    results.append(rec)
                    path.write_text(json.dumps(results, indent=1,
                                               default=str))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"wrote {path}")
    return results


if __name__ == "__main__":
    main()
