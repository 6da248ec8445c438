"""The port's dry run (`repro_torch.launch.dryrun`) and its op counter
(`repro_torch.launch.op_analysis`), held against the reference's
`analyze_hlo` and `run_cell` on the CPU.

Every fake process group runs in a child process
(`tests/_torch_dryrun_world.py CASE`), so no pytest worker joins one; the
reference runs in a child process too, on forced host devices (8 or 512,
as tests/test_hlo_analysis.py runs it), its meshes with Auto axes: jax
0.9.0's `jax.make_mesh` gives Explicit axes, which the reference's
`with_sharding_constraint` anchors refuse (ROADMAP R9), and `run_cell`
takes the mesh as an argument.

* The scan-matmul program of tests/test_hlo_analysis.py (13 steps of
  tanh((128, 256) @ (256, 256))): the port's count is exactly
  2 * 128 * 256 * 256 * 13, as the reference's `analyze_hlo` gives; on a
  fake 8-rank mesh with x as Shard(0) and w as Shard(1), exactly an
  eighth of it, with an all-gather and collective bytes.
* A Shard(0) -> Shard(1) redistribution counts as one all-to-all (the CPU
  group's all-gather-and-chunk fallback not counted).
* The counter's dot stream (`OpCounter(record_dots=True)`, which
  tools/op_stream.py writes and diffs) sums to its count, marks the
  products of a backward, and `op_stream.diff` names the group of dots
  in which two streams differ.
* Each architecture's parameter bytes a rank holds on the production
  meshes (16, 16) and (2, 16, 16) equal the reference's
  `param_shardings` shard shapes.
* The skipped cells equal the reference's `specs.skip_reason` for all 40
  (arch x shape) pairs.
* The reduced internlm2 in bfloat16 (the reference's decode cells take
  bfloat16 caches) on a (4, 2) mesh: per-rank dot FLOPs within
  FLOPS_RTOL of the reference's `run_cell`, and `model_flops_per_chip`
  equal, for train_4k, prefill_32k and decode_32k.
* The two-level remat recomputes as the reference's does: for the reduced
  internlm2 with 8 layers (two remat groups of 4) on the (4, 2) mesh, the
  train_4k FLOPs with remat over those without are within REMAT_RTOL of
  the reference's ratio (the port's base count, without remat, differs
  from the reference's by more than that, so the ratio is what is held).
* Every reduced architecture on a (2, 4) mesh, where the model axis
  divides no architecture's KV heads but some projections' columns,
  finishes each applicable kind with finite, positive counts (at the cut
  shapes of `_torch_dryrun_world.SMALL_SHAPES`; `main --all` runs the
  specs' shapes).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

import _torch_dryrun_world as D
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.specs import SHAPES

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FLOPS_RTOL = 0.10
REMAT_RTOL = 0.02
TIMEOUT_S = 600


def _child(case: str, devices: int | None = None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(ROOT / "src")
    if devices is not None:
        env.update(JAX_PLATFORMS="cpu", XLA_FLAGS=
                   f"--xla_force_host_platform_device_count={devices}")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_world.py"),
         case], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_scan_matmul_count_is_exact_unsharded_and_per_rank():
    res = _child("scan")
    ref = _child("ref_scan", devices=8)
    assert res["flops"] == res["expect"] == 2 * 128 * 256 * 256 * 13
    assert res["flops"] == ref["flops"]
    assert res["sharded_flops"] == res["expect"] / 8
    assert res["coll_counts"].get("all-gather", 0) >= 1
    assert res["coll_bytes"] > 0


def test_a_shard_to_shard_redistribution_is_one_all_to_all():
    res = _child("alltoall")
    assert res["counts"] == {"all-to-all": 1}
    assert res["local"] == [64, 4]
    assert res["bytes"] == 64 * 4 * 4


def test_the_dot_stream_sums_to_the_count_and_diffs():
    from repro_torch.launch.op_analysis import OpCounter
    sys.path.insert(0, str(ROOT))
    from tools import op_stream
    c = torch.randn(D.M, D.K, requires_grad=True)
    w = torch.randn(D.K, D.K)
    counter = OpCounter(record_dots=True)
    with counter:
        torch.autograd.grad(D._scan_program(c, w), c)
    dots = counter.dots
    assert sum(f for _, _, f, _ in dots) == counter.flops
    fwd = [d for d in dots if not d[3]]
    assert len(fwd) == D.STEPS and len(dots) == 2 * D.STEPS
    assert all(d[:3] == ("mm", [[D.M, D.K], [D.K, D.K]], 2 * D.M * D.K * D.K)
               for d in fwd)
    rec = {"torch": "a", "arch": "scan", "batch": D.M, "seq": D.K,
           "n_layers": D.STEPS, "remat_group": 0,
           "remat": {"flops": counter.flops, "dots": dots},
           "no_remat": {"flops": counter.flops, "dots": dots}}
    fewer = {**rec, "torch": "b",
             "remat": {"flops": counter.flops - fwd[0][2], "dots": dots[1:]}}
    lines = op_stream.diff(rec, fewer)
    changed = [ln for ln in lines if ln.startswith("  ")]
    assert len(changed) == 1 and "forward: A 13, B 12" in changed[0]


def test_parameter_bytes_equal_the_reference_shard_shapes():
    ours = _child("params")
    ref = _child("ref_params", devices=512)
    assert len(ours) == 20 and set(ours) == set(ref)
    for key, n in ref.items():
        assert ours[key] == n, key


def test_skipped_cells_equal_the_reference():
    from repro.configs import get_config as ref_get_config
    from repro.launch.specs import cell_is_applicable, skip_reason
    from repro_torch.launch import specs
    pairs = [(a, s) for a in all_arch_ids() for s in SHAPES]
    assert len(pairs) == 40
    skipped = 0
    for arch, shape in pairs:
        rcfg, cfg = ref_get_config(arch), get_config(arch)
        assert specs.cell_is_applicable(cfg, shape) == \
            cell_is_applicable(rcfg, shape)
        assert specs.skip_reason(cfg, shape) == skip_reason(rcfg, shape)
        if not cell_is_applicable(rcfg, shape):
            skipped += 1
            assert dryrun.run_cell(arch, shape) == {
                "arch": arch, "shape": shape,
                "skip": skip_reason(rcfg, shape)}
    assert skipped == 8


def test_reduced_internlm2_flops_match_the_reference():
    ours = _child("internlm2")
    ref = _child("ref_internlm2", devices=8)
    for shape in D.SHAPES:
        got, want = ours[shape], ref[shape]
        assert abs(got["flops"] - want["flops"]) <= \
            FLOPS_RTOL * want["flops"], shape
        assert got["model_flops"] == want["model_flops"], shape


def test_the_two_level_remat_recomputes_as_the_reference():
    ours = _child("nested")
    ref = _child("ref_nested", devices=8)
    got = ours["True"] / ours["False"]
    want = ref["True"] / ref["False"]
    assert want > 1.3, want             # the remat recomputes the layers
    assert abs(got / want - 1) <= REMAT_RTOL, (got, want)


def test_every_reduced_architecture_on_a_two_by_four_mesh():
    res = _child("every")
    assert len(res) == 40
    for arch in all_arch_ids():
        cfg = get_config(arch)
        for shape in SHAPES:
            rec = res[f"{arch}|{shape}"]
            if shape == "long_500k" and not cfg.sub_quadratic:
                assert rec == "skip"
                continue
            assert rec["kind"] == SHAPES[shape].kind, (arch, shape)
            assert rec["finite_positive"], (arch, shape)
            assert rec["collectives"] > 0, (arch, shape)
