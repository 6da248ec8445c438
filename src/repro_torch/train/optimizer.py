"""AdamW as the reference writes it: decoupled weight decay, global-norm
clipping, a cosine schedule with linear warmup.

Port of `repro.train.optimizer`, not `torch.optim.AdamW` (which keeps m and
v in the parameter's dtype and decays as p *= 1 - lr * wd): m and v are
float32 whatever the parameter's dtype, and each leaf is updated in
float32, p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), then rounded to
the parameter's dtype.  The clip's global norm is taken over the float32
gradients.  Parameters are a module (its `named_parameters()`) or a dict
{name: tensor}; gradients, m and v are dicts keyed by the same names.  The
update writes the parameters, m and v in place; the step counter is an
int32 tensor, and the schedule's lr and the norm stay on the device.

On a placed state (`train_step.place_state`) the parameters, gradients,
m and v are DTensors placed alike, and the same code runs on them: each
leaf's update is local to its shards, and the clip's norm is the global
one (every leaf's sum of squares stays a partial sum over its shards,
and the one reduction is the square root's); the step, lr and the clip
scale are replicated.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.distributed.tensor.experimental import implicit_replication

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "cosine_lr",
           "named"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named(params) -> dict:
    """{name: tensor} of a module's parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The float32 learning rate at `step` (an int or a tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init_opt_state(params) -> dict:
    """{"m", "v": {name: float32 zeros}, "step": int32 0} on the
    parameters' device."""
    p = named(params)
    dev = next(iter(p.values())).device

    def zeros():
        return {k: torch.zeros_like(t, dtype=torch.float32)
                for k, t in p.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every float32 gradient's squares."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads: dict, opt_state: dict):
    """One AdamW step: returns (params, opt_state, stats), the parameters,
    m and v updated in place, `stats` = {"grad_norm", "lr"} (float32
    tensors).  lr is `cosine_lr` at the new step (the old one + 1)."""
    with implicit_replication():
        return _adamw_update(cfg, params, grads, opt_state)


def _adamw_update(cfg, params, grads, opt_state):
    p = named(params)
    step = opt_state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for name, w in p.items():
        g = grads[name].float() * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        w32 = w.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * w32
        w.copy_(w32 - lr * delta)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
