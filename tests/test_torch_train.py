"""The port's training infrastructure on the CPU: the mirror of
`tests/test_train_infra.py` (the optimizer, the checkpoint round trip and
crash consistency, data determinism, compression, resilience, the
end-to-end loss decrease and the restart equivalence, at the same sizes
and bounds), plus the async save's host snapshot and the bitwise
bfloat16 round trip.  The compression runs in a gloo world of one rank on
a `HashStore`, made and destroyed by the test.  The data pipeline is also
held equal to the reference's for the same (seed, step, host); the
reference is imported inside that test only.
"""
import math
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.train import AdamWConfig, checkpoint as ck
from repro_torch.train.data import Prefetcher, SyntheticLM
from repro_torch.train.optimizer import adamw_update, cosine_lr, \
    init_opt_state
from repro_torch.train.resilience import RunGuard, StepMonitor, replan_mesh

torch.set_num_threads(1)


def test_adamw_quadratic_convergence():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, min_lr_ratio=1.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(cfg, params, grads, opt)
    assert float(params["w"].abs().max()) < 0.1


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(cosine_lr(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5, abs=0.01)
    assert lrs[2] == pytest.approx(1.0, abs=0.01)
    assert lrs[-1] == pytest.approx(0.1, abs=0.01)


def test_grad_clip():
    cfg = AdamWConfig(lr=0.0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    opt = init_opt_state(params)
    _, _, stats = adamw_update(cfg, params,
                               {"w": torch.tensor([3.0, 4.0, 0.0])}, opt)
    assert float(stats["grad_norm"]) == pytest.approx(5.0)


def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"a": torch.arange(6, dtype=torch.float32
                                          ).reshape(2, 3)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    ck.save(tmp_path, 7, state)
    like = {"params": {"a": torch.zeros(2, 3)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    restored, step = ck.restore(tmp_path, like)
    assert step == 7 and int(restored["opt"]["step"]) == 7
    torch.testing.assert_close(restored["params"]["a"], state["params"]["a"],
                               rtol=0, atol=0)


def test_checkpoint_crash_consistency(tmp_path):
    """A checkpoint without MANIFEST.json must be invisible."""
    state = {"w": torch.ones(3)}
    ck.save(tmp_path, 1, state)
    # fake a crashed save at step 2: shard present, no manifest
    d = tmp_path / "step_00000002"
    d.mkdir()
    np.savez(d / "shard_0.npz", w=np.zeros(3, np.float32))
    assert ck.latest_step(tmp_path) == 1
    restored, step = ck.restore(tmp_path, {"w": torch.zeros(3)})
    assert step == 1 and float(restored["w"][0]) == 1.0


def test_checkpointer_async_and_gc(tmp_path):
    c = ck.Checkpointer(tmp_path, keep=2)
    state = {"w": torch.ones(2)}
    for s in (10, 20, 30):
        c.save_async(s, state)
    c.wait()
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == [20, 30]


def test_checkpointer_async_saves_the_state_of_its_call(tmp_path,
                                                        monkeypatch):
    """save_async copies the state before its thread starts: the optimizer
    updates the parameters in place right after, and the file must hold
    the values of the call (on the CPU `.cpu()` is the live tensor).  The
    writer is held until the update is done, so a save that read the live
    tensor would store the updated values."""
    updated = threading.Event()
    write = ck._write

    def held(*args):
        assert updated.wait(10)
        return write(*args)

    monkeypatch.setattr(ck, "_write", held)
    c = ck.Checkpointer(tmp_path)
    state = {"w": torch.ones(1000), "m": {"x": torch.full((3,), 2.0)}}
    c.save_async(5, state)
    with torch.no_grad():
        state["w"].add_(1.0)                 # the next step, in place
        state["m"]["x"].mul_(3.0)
    updated.set()
    c.wait()
    back, step = ck.restore(tmp_path, {"w": torch.zeros(1000),
                                       "m": {"x": torch.zeros(3)}})
    assert step == 5
    assert torch.equal(back["w"], torch.ones(1000))
    assert torch.equal(back["m"]["x"], torch.full((3,), 2.0))


def test_bfloat16_checkpoint_is_bitwise(tmp_path):
    """bfloat16 tensors (numpy has no such dtype) are stored as their raw
    words and come back bitwise, beside float32, int32 and a module's
    parameters."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_reduced("internlm2-1.8b"),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    model = transformer.init_params(3, cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    bf = torch.randn(5, 7, generator=g).to(torch.bfloat16)
    bf[0, :3] = torch.tensor([float("inf"), float("-inf"), -0.0])
    state = {"params": model,
             "opt": {"m": {"a": torch.randn(4, generator=g)},
                     "step": torch.tensor(3, dtype=torch.int32)},
             "extra": [bf]}
    ck.save(tmp_path, 3, state)
    like_model = transformer.init_params(9, cfg, device="cpu")
    like = {"params": like_model,
            "opt": {"m": {"a": torch.zeros(4)},
                    "step": torch.tensor(0, dtype=torch.int32)},
            "extra": [torch.zeros(5, 7, dtype=torch.bfloat16)]}
    back, _ = ck.restore(tmp_path, like)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              back["params"].named_parameters()):
        assert q.dtype == torch.bfloat16
        assert torch.equal(p.view(torch.int16), q.view(torch.int16)), n
    assert torch.equal(back["extra"][0].view(torch.int16),
                       bf.view(torch.int16))
    assert torch.equal(back["opt"]["m"]["a"], state["opt"]["m"]["a"])
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 3


def test_data_determinism_and_prefetch():
    d1 = SyntheticLM(vocab=100, seq_len=16, global_batch=4, seed=9)
    d2 = SyntheticLM(vocab=100, seq_len=16, global_batch=4, seed=9)
    b1, b2 = d1.batch_at(3), d2.batch_at(3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    it = Prefetcher(iter([d1.batch_at(i) for i in range(3)]))
    got = list(it)
    assert len(got) == 3


@pytest.mark.parametrize("kw", [
    dict(vocab=100, seq_len=16, global_batch=4, seed=9),
    dict(vocab=50, seq_len=8, global_batch=8, num_hosts=2, host_id=1,
         seed=1),
    dict(vocab=512, seq_len=12, global_batch=2, seed=3, frontend="vlm",
         frontend_positions=4, d_model=8),
    dict(vocab=512, seq_len=12, global_batch=2, seed=3, d_model=8,
         encdec=True)])
def test_data_equals_the_reference(kw):
    from repro.train.data import SyntheticLM as RefSyntheticLM
    ours, ref = SyntheticLM(**kw), RefSyntheticLM(**kw)
    for step in (0, 7):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_host_sharding_partition():
    full = SyntheticLM(vocab=50, seq_len=8, global_batch=8, seed=1)
    h0 = SyntheticLM(vocab=50, seq_len=8, global_batch=8, num_hosts=2,
                     host_id=0, seed=1)
    assert h0.batch == 4 and full.batch == 8


def test_compression_error_feedback():
    """int8 EF compression: a one-rank all_reduce == near-identity with
    the residual carrying the quantization error."""
    from repro_torch.train.compression import compressed_psum_tree, \
        init_residuals
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        g = {"w": torch.as_tensor(np.random.default_rng(0).standard_normal(
            64), dtype=torch.float32)}
        r = init_residuals(g)
        out, new_r = compressed_psum_tree(g, r)
    finally:
        dist.destroy_process_group()
    # compressed value + residual == original (error feedback identity)
    np.testing.assert_allclose((out["w"] + new_r["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-5, atol=1e-6)
    assert not torch.equal(out["w"], g["w"])     # it did quantize


def test_replan_mesh():
    m = replan_mesh(1, prefer_model=16)
    assert dict(m.shape) == {"data": 1, "model": 1}
    assert m.mesh is None                        # no process group is up


def test_step_monitor_straggler():
    mon = StepMonitor(alpha=1.0, straggler_factor=1.5)
    mon.start(); mon.ema = 0.001
    time.sleep(0.01)
    t = mon.finish()
    assert t["straggler_alarm"]


def test_runguard_nan_rollback(tmp_path):
    g = RunGuard(None, interval=10, max_rollbacks=1)
    assert g.check_loss(1.0)
    assert not g.check_loss(float("nan"))
    with pytest.raises(RuntimeError):
        g.check_loss(float("nan"))


@pytest.mark.slow
def test_end_to_end_training_loss_decreases(tmp_path):
    """Integration: 60 steps on the reduced internlm2; loss must drop."""
    from repro_torch.launch.train import main
    losses = main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "60",
                   "--batch", "4", "--seq", "64", "--ckpt-dir",
                   str(tmp_path / "ck"), "--log-every", "30",
                   "--device", "cpu"])
    assert losses[-1] < losses[0] - 0.3


@pytest.mark.slow
def test_restart_equivalence(tmp_path):
    """Kill-and-restart: resuming from the checkpoint reproduces the same
    final loss as an uninterrupted run (same data stream)."""
    from repro_torch.launch.train import main
    ck1 = str(tmp_path / "a")
    common = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "40",
              "--batch", "4", "--seq", "64", "--device", "cpu"]
    full = main(common + ["--ckpt-dir", ck1, "--ckpt-every", "20",
                          "--log-every", "100"])
    ck2 = str(tmp_path / "b")
    part = main(common + ["--ckpt-dir", ck2, "--ckpt-every", "20",
                          "--log-every", "100", "--abort-after", "25"])
    resumed = main(common + ["--ckpt-dir", ck2, "--resume",
                             "--ckpt-every", "100", "--log-every", "100"])
    assert len(part) == 25 and len(resumed) == 40 - 21
    assert resumed[-1] == pytest.approx(full[-1], rel=1e-3)


def test_serve_generate():
    from repro_torch.launch.serve import main
    out = main(["--arch", "internlm2-1.8b", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert out.shape == (2, 4)


def test_replan_mesh_after_failures():
    """Elastic re-mesh: losing devices still yields a valid (data, model)
    factorization, preferring to keep the TP degree."""
    for n, want in ((16, (4, 4)), (12, (3, 4)), (6, (3, 2)), (5, (5, 1))):
        m = replan_mesh(n, prefer_model=4, devices=list(range(n)))
        assert dict(m.shape) == {"data": want[0], "model": want[1]}, (n, m)
        assert len(m.devices) == n


def test_replan_mesh_builds_a_device_mesh_under_a_process_group():
    """With a world of one up, the plan carries a (1, 1) DeviceMesh named
    ("data", "model")."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        m = replan_mesh(1, prefer_model=1)
        assert m.mesh is not None
        assert m.mesh.mesh_dim_names == ("data", "model")
        assert tuple(m.mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_train_main_without_a_card_raises(monkeypatch):
    """The default `--device cuda` never falls back to the host."""
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--steps", "1"])
