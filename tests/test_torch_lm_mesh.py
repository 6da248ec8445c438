"""LM training on a mesh: the port's sharding plan, mesh context, placed
train step, pod compression, sharded checkpoints and `launch.train` on N
ranks, held against the reference and against the one-device step on the
CPU.

* The plan: for the ten reduced configs and the ten full ones (shapes
  from `jax.eval_shape` of the reference's `init_params`, carried onto the
  port's names by `convert`; nothing full-size is allocated) under the
  mesh shapes (1, 1), (2, 1), (1, 2), (2, 2), (16, 16) and (2, 16, 16),
  the port's spec of every parameter equals the reference's
  `spec_for_path` (its stacked leaves' leading layer entry dropped); the
  reference reads only `mesh.shape`, so both get a stand-in.  The same
  for `batch_specs`.
* `meshctx`: its anchors are the identity without a context, on a (1, 1)
  mesh and on a plain tensor.
* One rank: `place_state` on a world of one (a (1, 1) mesh) trains two
  steps bitwise equal to the unplaced step, in float32 and in bfloat16.
* Gloo worlds of 2 and 4 ranks, in a child process each
  (`tests/_torch_mesh_world.py`, file store under `tmp_path`, a
  collective timeout): one reduced config of each family, 3 steps on the
  meshes (2, 1), (1, 2), (2, 2), and internlm2 on (pod 2, data 2, model
  1) with `compress_pod`.  Every rank holds only the plan's shards (local
  shapes, and storage no larger); the ranks' losses, grad norms and
  gathered parameters are bitwise equal; against the one-device port step
  (float32) the losses and grad norms are within W.LOSS_RTOL relative and
  the parameters within W.PARAM_RTOL of each tensor's scale (its largest
  magnitude); on (2, 2) internlm2 (from the reference's initial state)
  also against the reference's jitted train step.
* `compressed_psum_tree` under the pod mesh equals numpy's computation of
  the reference's formula over each rank's pod group within
  W.COMPRESS_ATOL, and the default group (every rank) differs from it.
* Serving on placed parameters (a 2-rank world, "serve"): for one reduced
  config of each family on (1, 2) and (2, 1), `prefill`'s logits and its
  whole cache or state, and the same after each of three `decode_step`s
  (the cache placed by the dry run's rule), within W.SERVE_RTOL of each
  array's scale of the unplaced calls, the ranks bitwise alike.
* A placed checkpoint restores onto another layout (a 2-rank world,
  "restore"): saved on (2, 1), restored onto (1, 2) on both ranks and
  onto an unplaced state here, bitwise the saved state each time.
* `launch.train.main` on 2 ranks (torchrun's variables): each rank returns
  the one-rank run's losses (W.LOSS_RTOL), and an abort after 10 steps plus
  `--resume` (from the checkpoint after step 5) gives the straight run's
  losses from there, and its final loss (W.LOSS_RTOL).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mesh_world as W
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import convert, get_model
from repro_torch.train import meshctx, sharding
from repro_torch.train.train_step import (batch_shardings, init_state,
                                          make_train_step, place_batch,
                                          place_state, state_shardings)

torch.set_num_threads(1)

ARCHS = ["internvl2-1b", "gemma-7b", "internlm2-1.8b", "llama3-8b",
         "qwen2-7b", "llama4-scout-17b-a16e", "granite-moe-1b-a400m",
         "mamba2-130m", "recurrentgemma-9b", "seamless-m4t-large-v2"]
MESH_SHAPES = [{"data": 1, "model": 1}, {"data": 2, "model": 1},
               {"data": 1, "model": 2}, {"data": 2, "model": 2},
               {"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16}]


class _Mesh:
    """What the reference's plan reads of a mesh: `.shape`."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _ref_specs(cfg, mesh_shape) -> dict:
    """{port name: the reference's spec} of every parameter of `cfg`,
    from the shapes of the reference's params (no arrays)."""
    import jax
    from repro.models import get_model as ref_get_model
    from repro.train.sharding import _path_str, spec_for_path
    rcfg = W.ref_cfg(cfg)
    tree = jax.eval_shape(lambda k: ref_get_model(rcfg).init_params(k, rcfg),
                          jax.random.PRNGKey(0))
    paths = {id(leaf): _path_str(path) for path, leaf in
             jax.tree_util.tree_flatten_with_path(tree)[0]}
    out = {}
    for name, leaf, row in convert._leaves(cfg, tree):
        spec = tuple(spec_for_path(paths[id(leaf)], leaf.shape,
                                   _Mesh(mesh_shape)))
        if row is not None and spec:
            spec = spec[1:]          # the stacked leaf's layer entry
        out[name] = spec
    return out


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equals_the_reference(arch, reduced):
    cfg = get_reduced(arch) if reduced else get_config(arch)
    model = get_model(cfg).init_params(0, cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for mesh_shape in MESH_SHAPES:
        ref = _ref_specs(cfg, mesh_shape)
        assert set(ref) == set(shapes)
        ours = sharding.param_specs(shapes, mesh_shape)
        for name, spec in ours.items():
            assert spec == ref[name], (name, mesh_shape, spec, ref[name])
            assert sharding.spec_for_path(name, shapes[name],
                                          _Mesh(mesh_shape)) == spec
    # the production plan shards something over both axes
    prod = sharding.param_specs(shapes, {"data": 16, "model": 16})
    assert any("data" in s for s in prod.values())


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES,
                         ids=lambda s: "x".join(map(str, s.values())))
def test_batch_specs_equal_the_reference(mesh_shape):
    from repro.train.sharding import batch_specs as ref_batch_specs
    assert sharding.batch_specs(mesh_shape) == \
        tuple(ref_batch_specs(_Mesh(mesh_shape)))
    assert sharding.batch_specs(_Mesh(mesh_shape)) == \
        tuple(ref_batch_specs(_Mesh(mesh_shape)))


def test_rules_are_the_reference_rules():
    from repro.train.sharding import RULES as REF_RULES
    assert sharding.RULES == REF_RULES
    assert sharding.logical_rules() == dict(REF_RULES)


class _Names:
    def __init__(self, *names):
        self.mesh_dim_names = names


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    dm = _Names("data", "model")
    assert sharding.placements_for(("data", "model"), dm) == \
        (Shard(0), Shard(1))
    assert sharding.placements_for(("model", "data"), dm) == \
        (Shard(1), Shard(0))
    assert sharding.placements_for((None, "model"), dm) == \
        (Replicate(), Shard(1))
    assert sharding.placements_for((), dm) == (Replicate(), Replicate())
    pdm = _Names("pod", "data", "model")
    assert sharding.placements_for(("data", "model"), pdm) == \
        (Replicate(), Shard(0), Shard(1))
    assert sharding.placements_for((("pod", "data"), None), pdm) == \
        (Shard(0), Shard(0), Replicate())


def test_production_and_local_mesh_plans():
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    p = make_production_mesh()
    assert p.shape == {"data": 16, "model": 16} and p.mesh is None
    p = make_production_mesh(multi_pod=True)
    assert p.shape == {"pod": 2, "data": 16, "model": 16}
    assert p.mesh is None
    if dist.is_initialized():
        dist.destroy_process_group()
    assert make_local_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_local_mesh(model=2)


@pytest.fixture
def world1():
    """A world of one gloo rank, destroyed after."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        meshctx.clear_mesh_context()
        dist.destroy_process_group()


def _mesh11():
    from repro_torch.launch.mesh import make_local_mesh
    plan = make_local_mesh(device_type="cpu")
    assert plan.shape == {"data": 1, "model": 1}
    return plan.mesh


def test_anchors_are_identities(world1):
    from torch.distributed.tensor import Replicate, distribute_tensor
    x = torch.randn(4, 6, 8)
    meshctx.clear_mesh_context()
    assert meshctx.model_axis_size() == 1
    for f in (meshctx.constrain_batch, meshctx.constrain_tokens,
              meshctx.constrain_group_expert):
        assert f(x) is x
    mesh = _mesh11()
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    with meshctx.mesh_context(mesh, ("data",)):
        assert meshctx.model_axis_size() == 1
        for f in (meshctx.constrain_batch, meshctx.constrain_tokens,
                  meshctx.constrain_group_expert):
            assert f(x) is x            # a plain tensor
            assert f(d) is d            # a (1, 1) mesh
        blk = meshctx.Local(x)
        assert blk.x is x and blk.local(x) is x and blk.wrap(x) is x
    assert meshctx.model_axis_size() == 1


def test_placements_of_a_state_and_a_batch(world1):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    cfg = get_reduced("internlm2-1.8b")
    mesh = _mesh11()
    state = init_state(0, cfg, device="cpu")
    pl = state_shardings(state, mesh)
    assert pl["opt"]["step"] == (Replicate(), Replicate())
    assert pl["params"]["blocks.0.attn.q.w"] == (Shard(0), Shard(1))
    assert pl["opt"]["m"] == pl["params"] == pl["opt"]["v"]
    batch = W.batches(cfg)[0]
    assert batch_shardings(batch, mesh)["tokens"] == (Shard(0), Replicate())
    placed = place_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                         mesh)
    assert all(isinstance(t, DTensor) for t in placed.values())
    assert np.array_equal(placed["tokens"].full_tensor().numpy(),
                          batch["tokens"])
    place_state(state, mesh)
    for n, p in state["params"].named_parameters():
        assert isinstance(p, DTensor) and p.placements == pl["params"][n]
        assert p.requires_grad
        assert isinstance(state["opt"]["m"][n], DTensor)


@pytest.mark.parametrize("arch,dtype", [
    ("internlm2-1.8b", "float32"), ("granite-moe-1b-a400m", "float32"),
    ("internlm2-1.8b", "bfloat16")])
def test_one_rank_placed_steps_are_bitwise_the_unplaced_ones(world1, arch,
                                                             dtype):
    import dataclasses
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=dtype,
                              activation_dtype=dtype)
    mesh = _mesh11()
    ours = place_state(init_state(0, cfg, device="cpu"), mesh)
    plain = init_state(0, cfg, device="cpu")
    step = make_train_step(cfg, W.opt_config())
    with meshctx.mesh_context(mesh, ("data",)):
        got = [step(ours, b)[1] for b in W.batches(cfg)[:2]]
    want = [step(plain, b)[1] for b in W.batches(cfg)[:2]]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(g[k], w[k]), k
    pp = dict(plain["params"].named_parameters())
    for n, p in ours["params"].named_parameters():
        assert torch.equal(p.full_tensor(), pp[n]), n
        assert torch.equal(ours["opt"]["m"][n].full_tensor(),
                           plain["opt"]["m"][n]), n


@pytest.mark.cuda
def test_cuda_one_rank_placed_bf16_steps_are_bitwise_the_unplaced_ones():
    """On the card, an NCCL world of one: the (1, 1) mesh's bf16 steps
    (the loss logits through `_Float32Product` on local blocks) equal
    the unplaced steps bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    cfg = dataclasses.replace(get_reduced("internlm2-1.8b"),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        ours = place_state(init_state(0, cfg, device="cuda"), mesh)
        plain = init_state(0, cfg, device="cuda")
        step = make_train_step(cfg, W.opt_config())
        with meshctx.mesh_context(mesh, ("data",)):
            got = [step(ours, b)[1] for b in W.batches(cfg)[:2]]
        want = [step(plain, b)[1] for b in W.batches(cfg)[:2]]
        for g, w in zip(got, want):
            for k in ("loss", "grad_norm"):
                assert torch.equal(g[k], w[k]), k
        pp = dict(plain["params"].named_parameters())
        for n, p in ours["params"].named_parameters():
            assert torch.equal(p.full_tensor(), pp[n]), n
    finally:
        dist.destroy_process_group()


def test_two_rank_meshes_equal_one_device(tmp_path):
    out = tmp_path / "world2"
    ranks = W.run_world(2, out, "train")
    for names, shape in W.MESHES[2]:
        mesh_shape = dict(zip(names, shape))
        for arch in W.FAMILIES:
            cfg = get_reduced(arch)
            key = W.case_key(arch, shape)
            W.judge(out, ranks, key, cfg, mesh_shape,
                   W.one_device(cfg, out, False))


def test_launch_train_on_two_ranks_trains_aborts_and_resumes(tmp_path,
                                                             monkeypatch,
                                                             capsys):
    from repro_torch.launch import train as T
    out = tmp_path / "launch"
    ranks = W.run_world(2, out, "launch", W.free_ports(3))
    for res in ranks[1:]:
        assert res == ranks[0]
    res = ranks[0]
    assert {"shard_0.npz", "shard_1.npz", "MANIFEST.json"} <= \
        set(res["shards"])
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    one = T.main(["--arch", W.LAUNCH_ARCH, "--steps", str(W.LAUNCH_STEPS),
                  "--batch", str(W.BATCH), "--seq", str(W.SEQ),
                  "--device", "cpu", "--log-every", "100",
                  "--ckpt-dir", str(tmp_path / "one")])
    assert "devices=1" in capsys.readouterr().out
    assert len(res["straight"]) == len(one) == W.LAUNCH_STEPS
    for got, ref in zip(res["straight"], one):
        assert W.rel(got, ref) <= W.LOSS_RTOL
    assert len(res["aborted"]) == W.ABORT_AFTER
    # the restart resumes after the last checkpoint before the abort
    start = (W.ABORT_AFTER - 1) // W.CKPT_EVERY * W.CKPT_EVERY + 1
    assert len(res["resumed"]) == W.LAUNCH_STEPS - start
    for got, ref in zip(res["aborted"], res["straight"]):
        assert W.rel(got, ref) <= W.LOSS_RTOL
    for got, ref in zip(res["resumed"], res["straight"][start:]):
        assert W.rel(got, ref) <= W.LOSS_RTOL
    assert W.rel(res["resumed"][-1], res["straight"][-1]) <= W.LOSS_RTOL


def test_prefill_and_decode_on_placed_parameters(tmp_path):
    from repro_torch.train.train_step import init_state
    out = tmp_path / "serve"
    W.run_world(2, out, "serve")
    for arch in W.FAMILIES:
        cfg = get_reduced(arch)
        want = W.serve_run(cfg, init_state(W.SEED, cfg, device="cpu")
                           ["params"])
        assert any(k.startswith("decode2/") for k in want)
        for _, shape in W.MESHES[2]:
            key = f"serve_{W.case_key(arch, shape)}"
            z = [np.load(out / f"{key}.rank{r}.npz") for r in range(2)]
            assert set(z[0].files) == set(want), key
            for k, ref in want.items():
                assert np.array_equal(z[0][k], z[1][k]), (key, k)
                err = np.abs(z[0][k] - ref).max()
                assert err <= W.SERVE_RTOL * max(np.abs(ref).max(), 1e-30), \
                    (key, k, err)


def test_a_placed_checkpoint_restores_onto_another_layout(tmp_path):
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import init_state
    out = tmp_path / "restore"
    W.run_world(2, out, "restore")
    saved = np.load(out / "saved.npz")
    assert int(saved["step"]) == 1
    for r in range(2):
        got = np.load(out / f"restored.rank{r}.npz")
        assert set(got.files) == set(saved.files)
        for k in saved.files:
            assert np.array_equal(got[k], saved[k]), (r, k)
    cfg = get_reduced(W.FAMILIES[0])
    state, step = ckpt.restore(out / "ck",
                               init_state(W.SEED + 1, cfg, device="cpu"))
    assert step == 1
    got = W.state_arrays(state)
    assert set(got) == set(saved.files)
    for k in saved.files:
        assert np.array_equal(got[k], saved[k]), k
