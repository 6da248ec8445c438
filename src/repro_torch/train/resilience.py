"""Fault tolerance: restart-from-checkpoint, the elastic re-plan of the
mesh, straggler and NaN monitoring.

Port of `repro.train.resilience`:
  * every step is covered by a committed checkpoint at most `interval`
    steps old (async, manifest-committed: see checkpoint.py);
  * `replan_mesh` keeps the reference's (data, model) factorization of
    the live devices, preferring to keep the model axis;
  * StepMonitor tracks a step-time EMA; a step slower than
    `straggler_factor` x EMA raises a straggler alarm (logged and
    counted), and a hard timeout aborts;
  * a non-finite loss triggers the rollback to the last checkpoint
    (classic loss-spike recovery).
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch
import torch.distributed as dist

__all__ = ["MeshPlan", "replan_mesh", "StepMonitor", "RunGuard"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A (data, model) factorization of `devices`; `mesh` is the
    `DeviceMesh` over them when a process group of that size was up."""
    data: int
    model: int
    devices: tuple
    mesh: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def replan_mesh(n_devices: int, *, model_axis_max: int = 16,
                prefer_model: int = 16, devices=None) -> MeshPlan:
    """Largest (data, model) mesh from n_devices.

    Keeps the model axis as close to `prefer_model` as divisibility allows
    (TP degree is architecture-bound; data parallelism absorbs the loss of
    nodes).  `devices` defaults to the ranks 0 .. n_devices - 1; the plan
    takes the first data * model of them.  No process group is needed: a
    `DeviceMesh` ("data", "model") is built only when one is up whose
    world is the plan's size."""
    model = min(prefer_model, model_axis_max)
    while model > 1 and n_devices % model != 0:
        model //= 2
    data = n_devices // model
    devs = tuple(devices if devices is not None
                 else range(n_devices))[:data * model]
    mesh = None
    if dist.is_initialized() and dist.get_world_size() == data * model:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(
            "cuda" if torch.cuda.is_available() else "cpu", (data, model),
            mesh_dim_names=("data", "model"))
    return MeshPlan(data, model, devs, mesh)


@dataclasses.dataclass
class StepMonitor:
    """Step-time EMA + straggler detection + throughput accounting."""
    ema: float = 0.0
    alpha: float = 0.1
    straggler_factor: float = 3.0
    hard_timeout_s: float = 3600.0
    stragglers: int = 0
    steps: int = 0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.monotonic()

    def finish(self) -> dict:
        dt = time.monotonic() - self._t0
        self.steps += 1
        alarm = False
        if self.ema > 0 and dt > self.straggler_factor * self.ema:
            self.stragglers += 1
            alarm = True
        if dt > self.hard_timeout_s:
            raise TimeoutError(f"step exceeded hard timeout ({dt:.1f}s)")
        self.ema = dt if self.ema == 0 else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        return {"step_time_s": dt, "step_time_ema_s": self.ema,
                "straggler_alarm": alarm}


class RunGuard:
    """Wraps the train loop body: NaN rollback + checkpoint cadence."""

    def __init__(self, checkpointer, interval: int = 50,
                 max_rollbacks: int = 3):
        self.ckpt = checkpointer
        self.interval = interval
        self.rollbacks = 0
        self.max_rollbacks = max_rollbacks

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0

    def check_loss(self, loss: float) -> bool:
        """True if the step is healthy; False => caller must roll back."""
        if math.isfinite(loss):
            return True
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise RuntimeError("too many NaN rollbacks — aborting run")
        return False
