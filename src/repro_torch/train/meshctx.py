"""The global mesh context for the models' sharding anchors.

Port of `repro.train.meshctx`.  The reference's anchors are
`with_sharding_constraint`s that pin GSPMD's propagation at block
boundaries; here each `constrain_*` is a `redistribute` of a DTensor to
the reference's placement (the spec's axes as `Shard` on their mesh
dimensions, `Replicate` on the others), with the reference's
divisibility rules.  The anchors do real work under a mesh: a block's
output that DTensor leaves partial (the row-parallel `o` projection, the
vocabulary-parallel embedding) is reduced there, and the batch dimension
is put back on the data-parallel axes.

Each anchor is the identity (the same tensor back) when no context is
set, when the context's mesh has one device (a (1, 1) mesh), and on a
tensor that is not a DTensor.  `set_mesh_context` takes a `DeviceMesh`
or a `resilience.MeshPlan` (its `.mesh`; a plan without one sets no
context).
"""
from __future__ import annotations

import math

from torch.distributed.device_mesh import DeviceMesh
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .sharding import axis_sizes, placements_for

__all__ = ["set_mesh_context", "clear_mesh_context", "constrain_batch",
           "constrain_tokens", "constrain_group_expert", "model_axis_size",
           "mesh_context", "Local"]

_CTX: tuple | None = None


def model_axis_size(model_axis: str = "model") -> int:
    """Size of the model axis in the active context (1 when unset)."""
    if _CTX is None:
        return 1
    mesh, _ = _CTX
    return int(axis_sizes(mesh).get(model_axis, 1))


def set_mesh_context(mesh, batch_axes: tuple[str, ...] = ("data",)):
    global _CTX
    if not isinstance(mesh, DeviceMesh):
        mesh = getattr(mesh, "mesh", None)  # a MeshPlan's DeviceMesh
    _CTX = None if mesh is None else (mesh, tuple(batch_axes))


def clear_mesh_context():
    global _CTX
    _CTX = None


class mesh_context:
    def __init__(self, mesh, batch_axes=("data",)):
        self.mesh, self.axes = mesh, batch_axes

    def __enter__(self):
        set_mesh_context(self.mesh, self.axes)
        return self

    def __exit__(self, *exc):
        clear_mesh_context()


def _live(x):
    """(mesh, batch axes, sizes) when an anchor acts on x, else None."""
    if _CTX is None or not isinstance(x, DTensor) or x.ndim == 0:
        return None
    mesh, baxes = _CTX
    if mesh.size() == 1:
        return None
    return mesh, baxes, axis_sizes(mesh)


def _to(x, mesh, entries):
    """x redistributed to the spec `entries` (an axis, a tuple of axes or
    None a dimension)."""
    placements = placements_for(entries, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def constrain_tokens(x, dim: int = 0, model_axis: str = "model"):
    """Shard a token-group dim over as many mesh axes as divisibility
    allows (data axes + model): the MoE dispatch stage."""
    live = _live(x)
    if live is None:
        return x
    mesh, baxes, sizes = live
    cands = [tuple(baxes) + (model_axis,), tuple(baxes), (model_axis,)]
    for axes in cands:
        if not all(a in sizes for a in axes):
            continue
        sz = math.prod(sizes[a] for a in axes)
        if x.shape[dim] % sz == 0 and x.shape[dim] >= sz:
            entries: list = [None] * x.ndim
            entries[dim] = axes
            return _to(x, mesh, entries)
    return x


def constrain_group_expert(x, g_dim: int = 0, e_dim: int = 1,
                           model_axis: str = "model"):
    """Shard (groups over the data axes, experts over model): the MoE
    expert-compute stage; from `constrain_tokens` it is the MoE's
    all-to-all."""
    live = _live(x)
    if live is None:
        return x
    mesh, baxes, sizes = live
    entries: list = [None] * x.ndim
    bsz = math.prod(sizes[a] for a in baxes)
    if x.shape[g_dim] % bsz == 0 and x.shape[g_dim] >= bsz:
        entries[g_dim] = tuple(baxes)
    if model_axis in sizes and x.shape[e_dim] % sizes[model_axis] == 0:
        entries[e_dim] = model_axis
    return _to(x, mesh, entries)


def constrain_batch(x, batch_dim: int = 0, model_dim: int | None = None,
                    model_axis: str = "model"):
    """Anchor x's batch dim to the data-parallel axes and (optionally) a
    tensor dim to the model axis, both only when divisible."""
    live = _live(x)
    if live is None:
        return x
    mesh, baxes, sizes = live
    sz = math.prod(sizes[a] for a in baxes)
    if x.shape[batch_dim] % sz != 0 or x.shape[batch_dim] < sz:
        return x
    entries: list = [None] * x.ndim
    entries[batch_dim] = tuple(baxes)
    if (model_dim is not None and model_axis in sizes
            and x.shape[model_dim] % sizes[model_axis] == 0):
        entries[model_dim] = model_axis
    return _to(x, mesh, entries)




class Local:
    """The local blocks of a DTensor x for a computation that is local to
    them: the MoE's group-local routing, dispatch and combine (a scatter
    into a fresh tensor, the sort, the cumsum over the queue) and its
    per-(group, expert) products, and the attention's online softmax per
    (batch row, head).  DTensor has no rule for the scatter, and its
    einsum decomposition views a permuted local block whose layout its
    global strides misstate, so these run on plain local tensors.

    x is made sharded over the tensor dimensions `dims` alone (their
    shards kept, any other placement replicated, which moves no bytes
    after an anchor) and `.x` is its local tensor; `local(t)` is another
    DTensor's local tensor in the same layout, and `wrap(t, shape)` makes
    a tensor computed from local blocks a DTensor in that layout (global
    `shape`; by default x's along dim 0 and t's own elsewhere).  For a
    tensor that is not a DTensor all three are the identity."""

    def __init__(self, x, dims=(0,)):
        self.mesh = None
        if not isinstance(x, DTensor):
            self.x = x
            return
        self.mesh = x.device_mesh
        keep = tuple(Shard(d) for d in dims)
        self.placements = tuple(p if p in keep else Replicate()
                                for p in x.placements)
        self.n = x.shape[0]
        self.x = self.local(x)

    def local(self, t):
        if self.mesh is None:
            return t
        if tuple(t.placements) != self.placements:
            t = t.redistribute(self.mesh, self.placements)
        return t.to_local()

    def wrap(self, t, shape=None):
        if self.mesh is None:
            return t
        shape = torch.Size(shape if shape is not None
                           else (self.n,) + tuple(t.shape[1:]))
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t, self.mesh, self.placements,
                                  run_check=False, shape=shape, stride=stride)

    def weight(self, w, align: dict):
        """w's local block for a product with this layout's local block:
        w keeps its shard of dimension j on a mesh dimension that shards
        x's dimension align[j] (the experts), and is gathered over the
        others (the plan's FSDP gather).  The local block's gradient is a
        partial sum over the mesh dimensions that shard x's rows (dim 0)."""
        if self.mesh is None:
            return w
        want = {Shard(i): Shard(j) for j, i in align.items()}
        wp = tuple(want.get(p, Replicate()) for p in self.placements)
        gp = tuple(Partial() if p == Shard(0) else q
                   for p, q in zip(self.placements, wp))
        return w.redistribute(self.mesh, wp).to_local(grad_placements=gp)
