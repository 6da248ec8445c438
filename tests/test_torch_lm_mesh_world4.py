"""LM training on a 4-rank gloo world: the (2, 2) mesh and the (pod 2,
data 2, model 1) mesh, held against the one-device step and the
reference on the CPU (the 2-rank worlds, the plan, the mesh context and
`launch.train` on N ranks are in tests/test_torch_lm_mesh.py).

The world runs in a child process (`tests/_torch_mesh_world.py 4 OUT
train`: file store under `tmp_path`, a collective timeout, results in npz
and json files that the test judges):

* one reduced config of each family, 3 steps on the (2, 2) mesh and on
  the (pod 2, data 2, model 1) mesh (the batch over "pod" and "data"): every
  rank holds only the plan's shards (local shapes, and storage no
  larger); the ranks' losses, grad norms and gathered parameters are
  bitwise equal; against the one-device port step (float32) the losses
  and grad norms are within W.LOSS_RTOL (1e-5) relative and the
  parameters within W.PARAM_RTOL (1e-4) of each tensor's scale (its
  largest magnitude); internlm2, from the reference's initial state, also
  against the reference's jitted train step (the same bounds);
* internlm2 on (pod 2, data 2, model 1) with `compress_pod`, against the
  one-device step with `compress_pod` (its mean over a world of one).
  The dense config alone: int8 rounding is discontinuous, so a gradient
  a float-noise away from a rounding boundary can take the next step of
  the grid on one side only, and Adam turns that into a parameter
  difference of about lr; the dense config has no zero-initialized leaf
  whose scale after 3 steps is that small (the others' conv biases,
  A_log and dt_bias are), so its bounds hold;
* internlm2 (4 query heads, 2 KV heads) and llama3 (8 and 2) on the
  (1, 4) mesh ("heads"), where the model axis divides the k and v
  projections' columns but not their KV heads: the same bounds against
  the one-device step;
* the reduced MoE's placed checkpoint (W.MOE_RESTORE, three worlds):
  saved after one step on (2, 1) and restored onto (4, 1), saved on
  (2, 2) and restored onto (2, 1), where its router and the router's
  Adam moments keep their placements and local shapes but not their
  block offsets: every rank's restored state gathers bitwise to the
  saved one;
* `compressed_psum_tree` under the pod mesh equals numpy's computation of
  the reference's formula over each rank's pod group (the ranks with its
  data coordinate) within W.COMPRESS_ATOL (1e-6), and the default group
  (every rank) averages over all four ranks, which differs.
"""
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import _torch_mesh_world as W
from repro_torch.configs import get_reduced

torch.set_num_threads(1)


def test_four_rank_meshes_equal_one_device_and_the_reference(tmp_path):
    out = tmp_path / "world4"
    dense = get_reduced(W.FAMILIES[0])
    rstate = W.write_reference_init(dense, out)
    ranks = W.run_world(4, out, "train")
    for names, shape in W.MESHES[4]:
        mesh_shape = dict(zip(names, shape))
        for arch in W.FAMILIES:
            cfg = get_reduced(arch)
            key = W.case_key(arch, shape)
            W.judge(out, ranks, key, cfg, mesh_shape,
                   W.one_device(cfg, out, False))
    # the dense config on (2, 2) against the reference's jitted step
    ref_losses, ref_params = W.reference_steps(dense, rstate)
    a = np.load(out / f"{W.FAMILIES[0]}_2x2.rank0.npz")
    for got, ref in zip(a["losses"], ref_losses):
        assert W.rel(float(got), ref) <= W.LOSS_RTOL
    for n, ref in ref_params.items():
        err = np.abs(a[f"params/{n}"] - ref).max()
        assert err <= W.PARAM_RTOL * np.abs(ref).max(), n
    # (pod 2, data 2, model 1) with compress_pod, against the one-device
    # step with compress_pod (its mean over a world of one)
    names, shape = W.POD_MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        want = W.one_device(dense, out, True)
    finally:
        dist.destroy_process_group()
    W.judge(out, ranks, W.case_key(W.FAMILIES[0], shape, True), dense,
            dict(zip(names, shape)), want)
    _judge_compress(out, ranks)


def test_a_model_axis_that_does_not_divide_the_kv_heads(tmp_path):
    out = tmp_path / "heads"
    ranks = W.run_world(4, out, "heads")
    names, shape = W.HEADS_MESH
    for arch in W.HEADS_ARCHS:
        cfg = get_reduced(arch)
        assert cfg.n_kv % shape[1] and (cfg.n_kv * cfg.resolved_head_dim
                                        ) % shape[1] == 0
        W.judge(out, ranks, W.case_key(arch, shape), cfg,
                dict(zip(names, shape)), W.one_device(cfg, out, False))


def test_a_moe_checkpoint_restores_onto_more_and_fewer_ranks(tmp_path):
    out = tmp_path / "moe"
    restored = []
    for case, pairs in W.MOE_RESTORE.items():
        world = 4 if case == "moe4" else 2
        W.run_world(world, out, case)
        restored += [(saved_on, shape, world) for saved_on, shape in pairs
                     if saved_on is not None]
    assert len(restored) == 2
    for saved_on, shape, world in restored:
        saved = np.load(out / f"saved_{W._shape_tag(saved_on)}.npz")
        assert int(saved["step"]) == 1
        for r in range(world):
            got = np.load(out / f"restored_{W._shape_tag(saved_on)}_"
                                f"{W._shape_tag(shape)}.rank{r}.npz")
            assert set(got.files) == set(saved.files)
            for k in saved.files:
                assert np.array_equal(got[k], saved[k]), (saved_on, shape,
                                                          r, k)


def _quantized(g: np.ndarray) -> np.ndarray:
    """The reference's `_quantize` then dequantize, in float32."""
    g = g.astype(np.float32)
    scale = np.float32(max(np.abs(g).max(), 1e-12)) / np.float32(127.0)
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    return q.astype(np.float32) * scale


def _judge_compress(out: Path, ranks: list):
    """Each rank's pod mean is numpy's formula over its pod group (the
    ranks with its data coordinate); the default group's mean is over all
    four ranks, and differs."""
    grads = [{k: t.numpy() for k, t in W.compress_grads(r).items()}
             for r in range(4)]
    for r, res in enumerate(ranks):
        group = [q for q in range(4) if q % 2 == r % 2]
        assert res["pod_group_ranks"] == group
        z = np.load(out / f"compress.rank{r}.npz")
        for k in grads[r]:
            deq = {q: _quantized(grads[q][k]) for q in range(4)}
            pod = sum(deq[q] for q in group) / len(group)
            every = sum(deq.values()) / 4
            assert np.abs(z[f"pod/{k}"] - pod).max() <= W.COMPRESS_ATOL, k
            assert np.abs(z[f"world/{k}"] - every).max() <= W.COMPRESS_ATOL
            assert np.abs(pod - every).max() > 1e-2, k
            assert np.abs(z[f"res/{k}"] - (grads[r][k] - deq[r])).max() \
                <= W.COMPRESS_ATOL, k
