"""Per-rank program totals from the aten op stream.

Port of `repro.launch.hlo_analysis`.  The reference parses the compiled
HLO text of one device's SPMD program and corrects XLA's cost analysis
for loop trip counts; torch has no such program, so the port counts the
ops that one rank dispatches while it runs the call eagerly (`analyze`).
Eager code unrolls every Python loop (layers, attention blocks, loss
chunks, microbatches), so each op is counted as often as it runs and no
trip-count correction exists to make.

The counter is a `TorchDispatchMode` that returns NotImplemented for any
op with a DTensor among its types, so DTensor handles it and the mode
then sees the local aten ops that it runs on this rank's blocks and the
`_c10d_functional` collectives of its redistributions.  Ops on or
making `FakeTensor`s are skipped: they are DTensor's sharding
propagation working on global shapes, not work of the rank.  The same
conventions as the reference:

  * flops: dot ops only (`mm`, `bmm`, `addmm`, `baddbmm`, the
    convolutions; an einsum reaches the mode as these), 2 x multiply-adds;
  * bytes: operands plus result of every op that moves data (views,
    which alias their input, are XLA's bitcasts and are skipped);
  * bytes_min: the same for dots, copies (`_to_copy`, `clone`), `cat`,
    convolutions and collectives only; the in-place `copy_` and
    `index_put_` (XLA's dynamic-update-slice: the slice is read and
    written, not the whole buffer) count 2 x the slice, in both totals;
  * collective_bytes: the result size of each collective (all-gather:
    the gathered tensor; all-reduce: the tensor; reduce-scatter: the
    shard), and collective_counts under the reference's names.

A Shard -> Shard redistribution is one all-to-all on a card; on a CPU
mesh (the fake group of the dry run, gloo) DTensor falls back to an
all-gather and a chunk (`_collective_utils.shard_dim_alltoall`).  While
the counter runs, that function is wrapped: whatever it dispatches is
not counted, and it is counted as the one all-to-all a card issues (its
result's bytes).  `collective_stats` of the reference (the raw HLO
collectives, loop bodies once) has no separate form here: the eager
stream is already per run, so a dry-run record's `collectives_raw` is
its `collectives`.

`OpCounter.temp_bytes` is the peak of storage created during the call
and live at once (each new storage is followed by a `weakref.finalize`
on the tensors that hold it, views included): an eager peak, not XLA's
buffer assignment, which reuses and fuses buffers.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["analyze", "OpCounter", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_DOTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
         _aten.convolution, _aten._convolution}
_COPIES = {_aten._to_copy, _aten.clone, _aten.cat}
_UPDATES = {_aten.copy_: 1, _aten.index_put_: 2, _aten._index_put_impl_: 2}
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.detach, _aten.lift_fresh, _aten.alias}
# functional collective -> the reference's HLO name
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "all_gather_into_tensor_coalesced": "all-gather",
                   "all_reduce": "all-reduce",
                   "all_reduce_coalesced": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "reduce_scatter_tensor_coalesced": "reduce-scatter",
                   "all_to_all_single": "all-to-all",
                   "shard_dim_alltoall": "all-to-all"}


def _tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments
    or results), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, args, kwargs, out) -> int:
    from torch.utils.flop_counter import flop_registry
    return int(flop_registry[func.overloadpacket](*args, **kwargs,
                                                  out_val=out))


class OpCounter(TorchDispatchMode):
    """Totals of the ops this rank dispatches (see the module's
    docstring); `totals()` gives them under `analyze`'s keys."""

    def __init__(self, record_dots: bool = False):
        super().__init__()
        # with record_dots, one (op, operand shapes, flops, in backward)
        # entry per dot op, in order: the stream that tells two runs apart
        self.dots: list | None = [] if record_dots else None
        self.flops = 0
        self.bytes = 0
        self.bytes_min = 0
        self.coll_bytes = 0
        self.coll_counts: dict = {}
        self.temp_bytes = 0
        self._live_bytes = 0
        self._live: dict = {}          # storage key -> [holders, nbytes]
        self._paused = 0

    # -- collectives -------------------------------------------------------
    def _collective(self, kind: str, args, out) -> None:
        nout = sum(_nbytes(t) for t in _tensors(out))
        nin = sum(_nbytes(t) for t in _tensors(args))
        self.coll_bytes += nout
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.bytes += nin + nout
        self.bytes_min += nin + nout

    @contextlib.contextmanager
    def _alltoall_as_one(self):
        """Count DTensor's Shard -> Shard redistribution as one all-to-all
        (its CPU fallback's all-gather and chunk not counted)."""
        from torch.distributed.tensor import _collective_utils, \
            placement_types
        real = _collective_utils.shard_dim_alltoall

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._paused += 1
            try:
                out = real(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._paused -= 1
            self._collective("all-to-all", (input,), out)
            self._track(out, new=True)
            return out
        mods = (_collective_utils, placement_types)
        for m in mods:
            m.shard_dim_alltoall = alltoall
        try:
            yield
        finally:
            for m in mods:
                m.shard_dim_alltoall = real

    # -- live storage --------------------------------------------------------
    def _drop(self, key) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self._live_bytes -= ent[1]
            del self._live[key]

    def _track(self, t: torch.Tensor, new: bool, old=()) -> None:
        """Follow t's storage while t lives: a new one (`new`, and not
        one of the op's inputs' storages `old`) from now, one made during
        the call as one more holder; storage made before is not counted."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        ent = self._live.get(key)
        if ent is None:
            if not new or key in old:
                return                  # storage made before the call
            ent = self._live[key] = [0, st.nbytes()]
            self._live_bytes += ent[1]
            self.temp_bytes = max(self.temp_bytes, self._live_bytes)
        ent[0] += 1
        weakref.finalize(t, self._drop, key)

    # -- the op stream -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins + _tensors(out)):
            return out
        self._count(func, args, kwargs, ins, out)
        return out

    def _count(self, func, args, kwargs, ins, out) -> None:
        packet = func.overloadpacket
        outs = _tensors(out)
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _COLLECTIVE_OPS.get(packet.__name__)
            if kind is not None:
                self._collective(kind, args, out)
                for t in outs:
                    self._track(t, new=True)
            return
        in_keys = set()
        for t in ins:
            try:
                in_keys.add(t.untyped_storage()._cdata)
            except (RuntimeError, NotImplementedError):
                pass
        for t in outs:
            self._track(t, new=not func.is_view, old=in_keys)
        if func.is_view or packet in _NO_TRAFFIC:
            return
        if packet in _UPDATES:
            src = args[_UPDATES[packet]] if len(args) > _UPDATES[packet] \
                else None
            n = 2 * (_nbytes(src) if isinstance(src, torch.Tensor) else 0)
            self.bytes += n
            self.bytes_min += n
            return
        n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += n
        if packet in _DOTS or packet in _COPIES:
            self.bytes_min += n
        if packet in _DOTS:
            f = _dot_flops(func, args, kwargs, out)
            self.flops += f
            if self.dots is not None:
                self.dots.append((packet.__name__,
                                  [list(t.shape) for t in ins], f,
                                  torch._C._current_graph_task_id() != -1))

    def __enter__(self):
        self._patch = self._alltoall_as_one()
        self._patch.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patch.__exit__(*exc)

    def totals(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "bytes_min": float(self.bytes_min),
                "collective_bytes": float(self.coll_bytes),
                "collective_counts": {k: int(v) for k, v in
                                      self.coll_counts.items()}}


def analyze(fn, *args, **kwargs) -> dict:
    """Run fn(*args, **kwargs) under an `OpCounter`; the per-rank totals
    under the keys of the reference's `analyze_hlo` ("flops", "bytes",
    "bytes_min", "collective_bytes", "collective_counts") plus "result"
    (fn's return value) and "temp_bytes" (the eager peak of storage made
    during the call)."""
    counter = OpCounter()
    with counter:
        result = fn(*args, **kwargs)
    return {**counter.totals(), "temp_bytes": counter.temp_bytes,
            "result": result}
