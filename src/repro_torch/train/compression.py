"""Error-feedback int8 gradient compression for a gradient all-reduce.

Port of `repro.train.compression`: each gradient leaf plus its residual
is quantized to int8 with a per-leaf scale (max |g| / 127), the
dequantized values are summed over the process group
(`torch.distributed.all_reduce`) and divided by its size, and the
quantization error is carried into the next step's gradient (error
feedback keeps the method unbiased over time: the 1-bit Adam / EF-SGD
lineage).  The reference runs it inside shard_map over the 'pod' axis;
here `group` is a process group (the default one when None).
Gradients and residuals are dicts {name: tensor}; residuals are float32.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .optimizer import named

__all__ = ["init_residuals", "compressed_psum_tree"]


def init_residuals(grads) -> dict:
    """Float32 zeros shaped as `grads` (a dict of tensors, or a module's
    parameters)."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in named(grads).items()}


def _quantize(g: torch.Tensor):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_tree(grads: dict, residuals: dict, group=None):
    """The mean of `grads` over `group` with int8 EF compression: returns
    (mean grads in each gradient's dtype, new residuals)."""
    n = dist.get_world_size(group)
    out, new_r = {}, {}
    for k, g in grads.items():
        g32 = g.float() + residuals[k]
        q, scale = _quantize(g32)
        deq = q.float() * scale
        new_r[k] = g32 - deq
        dist.all_reduce(deq, group=group)
        out[k] = (deq / n).to(g.dtype)
    return out, new_r
