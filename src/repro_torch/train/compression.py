"""Error-feedback int8 gradient compression for a gradient all-reduce.

Port of `repro.train.compression`: each gradient leaf plus its residual
is quantized to int8 with a per-leaf scale (max |g| / 127), the
dequantized values are summed over the process group
(`torch.distributed.all_reduce`) and divided by its size, and the
quantization error is carried into the next step's gradient (error
feedback keeps the method unbiased over time: the 1-bit Adam / EF-SGD
lineage).  The reference runs it inside shard_map over the 'pod' axis.
Here the group is the mesh's "pod" axis when there is one (`mesh`, or
the mesh of DTensor gradients), as the reference's `axis_name="pod"`;
without a mesh, the given process group (the default one when None).
DTensor gradients on a mesh without a "pod" axis are one pod: nothing is
reduced, the values are only quantized.  A DTensor leaf is quantized
with the scale of the whole leaf (its largest |g| over every shard, as
the reference's leaf), and its local block is summed over the pod group
(every pod holds the same blocks: the parameters are replicated across
pods).  Gradients and residuals are dicts {name: tensor}; residuals are
float32, placed as their gradients.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .optimizer import named

__all__ = ["init_residuals", "compressed_psum_tree"]


def init_residuals(grads) -> dict:
    """Float32 zeros shaped (and placed) as `grads` (a dict of tensors, or
    a module's parameters)."""
    return {k: torch.zeros_like(g, dtype=torch.float32)
            for k, g in named(grads).items()}


def _quantize(g: torch.Tensor):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _pod_group(grads: dict, group=None, mesh=None):
    """The process group the mean runs over: the "pod" axis of `mesh`
    (or of the gradients' mesh); None for DTensor gradients on a mesh
    without one (a single pod); else `group`, the default one when
    None."""
    if mesh is None:
        g = next(iter(grads.values()), None)
        mesh = g.device_mesh if isinstance(g, DTensor) else None
    if mesh is None:
        return group if group is not None else dist.group.WORLD
    names = mesh.mesh_dim_names or ()
    return mesh.get_group("pod") if "pod" in names else None


def compressed_psum_tree(grads: dict, residuals: dict, group=None,
                         mesh=None):
    """The mean of `grads` over the pod group (`_pod_group`) with int8 EF
    compression: returns (mean grads in each gradient's dtype, new
    residuals)."""
    group = _pod_group(grads, group, mesh)
    n = 1 if group is None else dist.get_world_size(group)
    out, new_r = {}, {}
    for k, g in grads.items():
        g32 = g.float() + residuals[k]
        q, scale = _quantize(g32)
        deq = q.float() * scale
        new_r[k] = g32 - deq
        if isinstance(deq, DTensor):
            local = deq.to_local()
            if group is not None:
                dist.all_reduce(local, group=group)
            deq = DTensor.from_local(local / n, deq.device_mesh,
                                     deq.placements, run_check=False,
                                     shape=deq.shape, stride=deq.stride())
            out[k] = deq.to(g.dtype)
            continue
        dist.all_reduce(deq, group=group)
        out[k] = (deq / n).to(g.dtype)
    return out, new_r
