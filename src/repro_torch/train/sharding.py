"""Sharding rules: parameter-name pattern -> the reference's spec, and
that spec as DTensor placements.

Port of `repro.train.sharding`.  The scheme is the reference's: 2-D
sharding, tensor-parallel dims over "model", FSDP dims over "data"; the
multi-pod "pod" axis carries data parallelism (the batch) only, with the
parameters replicated across pods.  Every rule degrades as the
reference's does: an axis applies only when the mesh axis's size divides
the dimension, else that dimension is replicated (DTensor's uneven
sharding is not used in its place).

A spec is the reference's PartitionSpec as a tuple: one entry a tensor
dimension, a mesh axis name or None.  The port's parameter names are the
reference's paths with the layer put in ("blocks.3.attn.q.w"); a rule
matches the name with "." read as "/".  `models.convert` keeps the
reference's (d_in, d_out) and (E, d, dff) orientations, so every rule
applies to the port's shapes unchanged; the blocks are unstacked, so no
leading layer None is prepended (a rule is still applied right-aligned).
`mesh_shape` is anything whose `.shape` maps axis names to sizes (a
`DeviceMesh`, a `resilience.MeshPlan`) or such a dict itself.
"""
from __future__ import annotations

import re

from torch.distributed.tensor import Replicate, Shard

__all__ = ["RULES", "param_specs", "param_placements", "placements_for",
           "batch_specs", "cache_spec", "logical_rules", "spec_for_path",
           "axis_sizes"]

# (path regex, spec for the UNSTACKED tensor, applied right-aligned)
RULES: list[tuple[str, tuple]] = [
    (r"embed/w$",               ("model", "data")),    # (V, d)
    (r"unembed/w$",             ("data", "model")),    # (d, V)
    (r"attn/[qkv]/w$",          ("data", "model")),    # (d, H*hd)
    (r"attn/o/w$",              ("model", "data")),    # (H*hd, d)
    (r"cross/[qkv]/w$",         ("data", "model")),
    (r"cross/o/w$",             ("model", "data")),
    (r"(mlp|shared)/(gate|up)/w$", ("data", "model")),  # (d, ff)
    (r"(mlp|shared)/down/w$",   ("model", "data")),     # (ff, d)
    (r"moe/router/w$",          ("data", None)),
    (r"moe/(gate_w|up_w)$",     ("model", "data", None)),  # (E, d, f)
    (r"moe/down_w$",            ("model", None, "data")),  # (E, f, d)
    (r"in_proj/w$",             ("data", "model")),
    (r"out_proj/w$",            ("model", "data")),
    (r"(in_x|in_gate)/w$",      ("data", "model")),
    (r"(gate_a|gate_x)/w$",     (None, "model")),
    (r"out/w$",                 ("model", "data")),
    # everything else (norms, biases, convs, lam, A_log, D, dt_bias): replicate
]


def axis_sizes(mesh_shape) -> dict:
    """{axis name: size} of a mesh, a plan or a dict."""
    shape = getattr(mesh_shape, "shape", mesh_shape)
    if isinstance(shape, dict):
        return dict(shape)
    # a DeviceMesh: .shape is a tuple, the names are mesh_dim_names
    return dict(zip(mesh_shape.mesh_dim_names, shape))


def spec_for_path(name: str, shape: tuple, mesh_shape,
                  fsdp_axis: str = "data", tp_axis: str = "model") -> tuple:
    """The reference's spec of the parameter `name` of `shape`: a tuple of
    axis names or None, one entry a dimension (() when no rule matches:
    replicated)."""
    path = name.replace(".", "/")
    sizes = axis_sizes(mesh_shape)
    axis_map = {"data": fsdp_axis, "model": tp_axis}
    for pat, rule in RULES:
        if re.search(pat, path):
            nlead = len(shape) - len(rule)
            entries: list = [None] * nlead
            for dim, ax in zip(shape[nlead:], rule):
                if ax is None:
                    entries.append(None)
                    continue
                ax_name = axis_map[ax]
                if ax_name in sizes and dim % sizes[ax_name] == 0:
                    entries.append(ax_name)
                else:
                    entries.append(None)
            return tuple(entries)
    return ()


def param_specs(params, mesh_shape, fsdp_axis: str = "data",
                tp_axis: str = "model") -> dict:
    """{name: spec} of a module's parameters (or of a dict {name: tensor
    or shape})."""
    items = params.named_parameters() if hasattr(params, "named_parameters") \
        else params.items()
    return {n: spec_for_path(n, tuple(getattr(p, "shape", p)), mesh_shape,
                             fsdp_axis, tp_axis) for n, p in items}


def placements_for(spec, mesh) -> tuple:
    """A spec as one DTensor placement a mesh dimension: `Shard(d)` on
    the mesh dimension whose axis shards tensor dimension d (a tuple
    entry shards d over each of its axes), `Replicate()` on the others."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def param_placements(params, mesh, **kw) -> dict:
    """{name: placements} of a module's parameters on `mesh` (a
    `DeviceMesh`) by the plan."""
    return {n: placements_for(s, mesh)
            for n, s in param_specs(params, mesh, **kw).items()}


def batch_specs(mesh_shape, multi_pod: bool | None = None) -> tuple:
    """The batch dimension's axes: data parallel over ("pod", "data")."""
    if multi_pod is None:
        multi_pod = "pod" in axis_sizes(mesh_shape)
    return ("pod", "data") if multi_pod else ("data",)


def cache_spec(shape, mesh_shape, seq_axis: str = "model") -> tuple:
    """The spec of one KV-cache or state leaf of `shape`: the reference
    dry run's `_cache_shardings` rule (`repro/launch/dryrun.py:105-129`),
    rule for rule.  KV caches (L, B, S, K, hd): the batch over the batch
    axes and the sequence over `seq_axis`, each when divisible; a 4-D
    leaf (B, win, K, hd): dim 0 over the batch axes, dim 1 over
    `seq_axis` when divisible and at least 1024 long; other leaves of two
    or more dims (conv, SSD and LRU states): the batch-like leading dim
    (dim 1 when a 3+-D leaf's dim 0 is at most 64) over the batch
    axes."""
    sizes = axis_sizes(mesh_shape)
    bspec = batch_specs(mesh_shape)
    dsz = 1
    for a in bspec:
        dsz *= sizes[a]
    msz = sizes[seq_axis]
    entries: list = [None] * len(shape)
    if len(shape) == 5:
        if shape[1] % dsz == 0:
            entries[1] = bspec
        if shape[2] % msz == 0:
            entries[2] = seq_axis
    elif len(shape) == 4:
        if shape[0] % dsz == 0:
            entries[0] = bspec
        if shape[1] % msz == 0 and shape[1] >= 1024:
            entries[1] = seq_axis
    elif len(shape) >= 2:
        lead = 1 if len(shape) >= 3 and shape[0] <= 64 else 0
        if shape[lead] % dsz == 0:
            entries[lead] = bspec
    return tuple(entries)


def logical_rules(mesh_shape=None) -> dict:  # documentation helper
    return {pat: rule for pat, rule in RULES}
