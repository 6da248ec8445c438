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

Serving on a mesh writes its caches and states in place through
`write`, which acts on each rank's local block of a placed cache (cut by
`place_cache`: the reference dry run's cache rule,
`sharding.cache_spec`).

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

from .sharding import axis_sizes, cache_spec, placements_for

__all__ = ["set_mesh_context", "clear_mesh_context", "constrain_batch",
           "constrain_tokens", "constrain_group_expert", "model_axis_size",
           "mesh_context", "Local", "place_cache", "write", "unshard",
           "unshard_grad", "block_start", "placed_zeros"]

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


def _replicated(t, mesh):
    """t itself if a DTensor, else the plain tensor t as a replicated
    DTensor on `mesh` (every rank holds the same t)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def unshard(x, dim: int, n: int):
    """x with its dimension `dim` made whole (replicated) where the mesh
    shards it into blocks that do not divide `n` (the head count that a
    reshape is about to split out of it); else x itself.  The reshard
    that GSPMD inserts before such a reshape: DTensor's view rule keeps a
    shard only on the first dimension of a split and refuses one that it
    does not divide."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    mesh, sh = x.device_mesh, Shard(dim)
    ways = math.prod(mesh.size(md) for md, p in enumerate(x.placements)
                     if p == sh)
    if n % ways == 0:
        return x
    return x.redistribute(mesh, tuple(Replicate() if p == sh else p
                                      for p in x.placements))


class _UnshardGrad(torch.autograd.Function):
    """The identity, whose backward `unshard`s the gradient."""

    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.n = dim, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return unshard(g, ctx.dim, ctx.n), None, None


def unshard_grad(x, dim: int, n: int):
    """x, whose gradient is made whole along `dim` where the mesh shards
    it into blocks that do not divide `n`: for a tensor merged from `n`
    heads, whose gradient the backward splits into them again."""
    if not isinstance(x, DTensor):
        return x
    return _UnshardGrad.apply(x, dim, n)


def placed_zeros(t: torch.Tensor, mesh, pl) -> DTensor:
    """Zeros of t's shape, dtype and device as a DTensor with the
    placements `pl` on `mesh`, each rank allocating only its block (on the
    meta device, nothing)."""
    local = list(t.shape)
    for md, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(md)
    return DTensor.from_local(
        torch.zeros(local, dtype=t.dtype, device=t.device), mesh, pl,
        run_check=False, shape=t.shape, stride=t.stride())


def place_cache(cache, like):
    """A cache or state tree (dicts and lists of tensors) for a forward
    on `like`: the tree itself unless `like` is a DTensor, else zeros of
    its leaves' shapes placed on like's mesh by the reference dry run's
    cache rule (`sharding.cache_spec`)."""
    if not isinstance(like, DTensor):
        return cache
    mesh = like.device_mesh

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, list):
            return [one(v) for v in t]
        return placed_zeros(t, mesh,
                            placements_for(cache_spec(t.shape, mesh), mesh))
    return one(cache)


def block_start(mesh, placements, dim: int, local: int) -> int:
    """The global index of the first entry of this rank's block of tensor
    dimension `dim` (`local` entries) under `placements` (even blocks)."""
    lo = 0
    for md, p in enumerate(placements):
        if p == Shard(dim):
            lo = lo * mesh.size(md) + mesh.get_local_rank(md)
    return lo * local


def ring_slots(start: int, stop: int, ring: int, like) -> torch.Tensor:
    """The ring slots (p % ring) of positions start..stop-1, as the index
    `write` takes: on like's device for a plain `like`, so that writing a
    cache on the card waits on nothing; on the host for a DTensor, whose
    `write` reads the positions to pick each rank's own."""
    dev = "cpu" if isinstance(like, DTensor) else like.device
    return torch.remainder(torch.arange(start, stop, device=dev), ring)


def write(dst, src, layer: int | None = None, dim: int = 0, index=None):
    """In place: `dst[layer]` (or dst) gets src along its dimension `dim`
    at `index` (a slice, or a 1-D integer tensor of positions; None: the
    whole of it).  On plain tensors that is the indexed assignment.  A
    DTensor cache is written on each rank's local block: src is
    redistributed to dst's shards of the dimensions it covers whole
    (replicated on the others), and each rank writes the layer and the
    positions that fall in its block.  A plain src next to a DTensor dst
    counts as replicated."""
    if not isinstance(dst, DTensor):
        d = dst if layer is None else dst[layer]
        if index is None:
            d.copy_(src)
            return
        if isinstance(index, torch.Tensor):
            index = index.to(d.device)
        d[(slice(None),) * dim + (index,)] = src
        return
    mesh, pl = dst.device_mesh, tuple(dst.placements)
    off = 0 if layer is None else 1
    sel = None if index is None else dim + off
    sp = tuple(Shard(p.dim - off) if isinstance(p, Shard) and p.dim != sel
               and not (layer is not None and p.dim == 0) else Replicate()
               for p in pl)
    sl = _replicated(src, mesh).redistribute(mesh, sp).to_local()
    dl = dst.to_local()
    if layer is not None:
        lo = block_start(mesh, pl, 0, dl.shape[0])
        if not lo <= layer < lo + dl.shape[0]:
            return
        dl = dl[layer - lo]
    if index is None:
        dl.copy_(sl)
        return
    if isinstance(index, slice):
        start, stop, _ = index.indices(dst.shape[sel])
        pos = torch.arange(start, stop)
    else:
        pos = index.to("cpu")
    lo = block_start(mesh, pl, sel, dl.shape[dim])
    keep = (pos >= lo) & (pos < lo + dl.shape[dim])
    if not bool(keep.any()):
        return
    if not bool(keep.all()):
        sl = sl.index_select(dim, keep.nonzero()[:, 0].to(sl.device))
    dl[(slice(None),) * dim + ((pos[keep] - lo).to(dl.device),)] = sl


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
        t = _replicated(t, self.mesh)
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

    def start(self, dim: int) -> int:
        """The global index of this rank's first entry of x's dimension
        `dim` (0 without a mesh)."""
        if self.mesh is None:
            return 0
        return block_start(self.mesh, self.placements, dim,
                            self.x.shape[dim])

    def shared(self, t):
        """t's local block with only this layout's shards of dim 0 (the
        rows) kept and whole along the rest: what every rank of the
        layout's other sharded mesh dimensions reads in full.  Its
        gradient is a partial sum over those mesh dimensions."""
        if self.mesh is None:
            return t
        t = _replicated(t, self.mesh)
        rows = tuple(p if p == Shard(0) else Replicate()
                     for p in self.placements)
        gp = tuple(Partial() if p not in (Shard(0), Replicate()) else q
                   for p, q in zip(self.placements, rows))
        return t.redistribute(self.mesh, rows).to_local(grad_placements=gp)

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
