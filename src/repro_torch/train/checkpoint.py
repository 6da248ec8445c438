"""Step-atomic checkpointing with manifest commit + async save.

Port of `repro.train.checkpoint`, with the same layout and contract:

    <dir>/step_000123/shard_<host>.npz     flat param/opt arrays
    <dir>/step_000123/MANIFEST.json        committed LAST (atomic rename)

A checkpoint without MANIFEST.json is incomplete (crashed save) and is
ignored by restore/latest_step.  `Checkpointer.save_async` copies the state
to the host before its thread starts (a clone on the CPU, where `.cpu()`
would return the live tensor that the optimizer updates in place), joins
the previous save before a new one starts, and keeps the last `keep`.

The port's own file format (nothing reads the reference's): a state is
nested dicts, lists, modules (their `named_parameters()`), tensors and
numpy arrays; keys are the reference's "/"-joined paths, a module's
parameter names joined with "/" to its path ("params/blocks.0.attn.q.w").
numpy has no bfloat16, so every tensor is stored as its raw words (a
bfloat16 one as int16) and the shard's `__dtypes__` entry (a JSON string)
names each key's dtype: a restore is bitwise.  `restore` copies into the
tensors of `state_like` in place (a module's parameters too) and returns
new arrays for its numpy leaves.

A placed state (`train_step.place_state`: DTensors on a mesh) is saved
as the reference's sharded layout: each rank writes its own local blocks
to `shard_<rank>.npz` (no tensor is gathered; `host_id` defaults to the
rank), with each DTensor key's global shape, local shape and placements
under `__layout__` (and the block's offset in the global tensor), and
its plain leaves (the step) whole.  Host 0 commits the MANIFEST once
every rank's shard is in the step's directory (it waits for the files, so
no collective runs on the save thread).  `restore` reads the rank's own
shard into the state's local blocks when the state is placed as the
checkpoint was (the same shapes, placements and block offset, read from
the rank's own shard); otherwise (another mesh shape, another world, an
unplaced state) it rebuilds each global tensor from every rank's shard
in the step's directory (each block at its offset) and copies in this
rank's block of it under the state's placements, or all of it, as the
reference's global arrays fill any mesh.  A global shape that differs
raises ValueError.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["save", "restore", "latest_step", "Checkpointer"]

_DTYPES = "__dtypes__"
_LAYOUT = "__layout__"
# how long host 0 waits for the other ranks' shards before it commits
COMMIT_TIMEOUT_S = 600.0
_WORDS = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _items(tree, prefix: str = ""):
    """(key, leaf) of a state, depth first in its order."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _layout(t: DTensor) -> dict:
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return {"shape": list(t.shape), "local": list(t.to_local().shape),
            "placements": [str(p) for p in t.placements],
            "offset": [int(o) for o in offset]}


def _same_layout(saved: dict | None, t: DTensor) -> bool:
    """Whether the saved block is this rank's block of t: the same global
    and local shapes, placements and offset (a checkpoint written before
    offsets were recorded is matched without one)."""
    if saved is None:
        return False
    mine = _layout(t)
    keys = ("shape", "local", "placements") + (
        ("offset",) if "offset" in saved else ())
    return all(saved.get(k) == mine[k] for k in keys)


def _host(leaf):
    """(numpy array, dtype name) of a leaf, copied to the host now (a
    DTensor's local block)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype in _WORDS:
            t = t.view(_WORDS[t.dtype])
        return t.numpy(), name
    a = np.array(leaf)
    return a, a.dtype.name


def _host_arrays(state) -> tuple:
    """({key: host array} of a state, its dtype names under `__dtypes__`
    and its DTensors' layouts under `__layout__`; the number of hosts
    that write a shard: the mesh's ranks for a placed state, else 1)."""
    arrays, dtypes, layout, hosts = {}, {}, {}, 1
    for key, leaf in _items(state):
        if isinstance(leaf, DTensor):
            layout[key] = _layout(leaf)
            hosts = leaf.device_mesh.size()
        arrays[key], dtypes[key] = _host(leaf)
    arrays[_DTYPES] = np.array(json.dumps(dtypes))
    arrays[_LAYOUT] = np.array(json.dumps(layout))
    return arrays, hosts


def _host_id(host_id: int | None) -> int:
    if host_id is not None:
        return host_id
    return dist.get_rank() if dist.is_initialized() else 0


def _wait_for_shards(final: Path, hosts: int) -> None:
    deadline = time.monotonic() + COMMIT_TIMEOUT_S
    while not all((final / f"shard_{h}.npz").exists()
                  for h in range(hosts)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{final}: not every rank's shard arrived "
                               f"within {COMMIT_TIMEOUT_S} s")
        time.sleep(0.01)


def _write(ckpt_dir: Path, step: int, arrays: dict, host_id: int,
           extra: dict | None, hosts: int = 1) -> Path:
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{host_id}"
    tmp.mkdir(parents=True, exist_ok=True)
    final.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / f"shard_{host_id}.npz", **arrays)
    os.replace(tmp / f"shard_{host_id}.npz", final / f"shard_{host_id}.npz")
    shutil.rmtree(tmp, ignore_errors=True)
    # manifest commit (host 0), after every host's shard
    if host_id == 0:
        _wait_for_shards(final, hosts)
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(k for k in arrays
                                   if k not in (_DTYPES, _LAYOUT)),
                    **(extra or {})}
        mtmp = final / ".MANIFEST.tmp"
        mtmp.write_text(json.dumps(manifest))
        os.replace(mtmp, final / "MANIFEST.json")
    return final


def save(ckpt_dir: str | Path, step: int, state, host_id: int | None = None,
         extra: dict | None = None) -> Path:
    arrays, hosts = _host_arrays(state)
    return _write(Path(ckpt_dir), step, arrays, _host_id(host_id), extra,
                  hosts)


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / "MANIFEST.json").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def _loaded(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    want = getattr(torch, dtype)
    return t.view(want) if want in _WORDS else t


def _restore_into(tree, arrays: dict, meta: tuple, prefix: str = ""):
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, p in tree.named_parameters():
                _copy(p, arrays, meta, prefix + name)
        return tree
    if isinstance(tree, dict):
        return {k: _restore_into(v, arrays, meta, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore_into(v, arrays, meta, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    key = prefix[:-1]
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            _copy(tree, arrays, meta, key)
        return tree
    arr = arrays[key]
    _same_shape(key, arr.shape, np.shape(tree))
    return arr


def _same_shape(key: str, stored, want) -> None:
    if tuple(stored) != tuple(want):
        raise ValueError(f"checkpoint entry {key!r} has shape "
                         f"{tuple(stored)}, not {tuple(want)}")


class _Shards:
    """Every rank's shard of a step directory, opened on first use: the
    global tensors of a placed checkpoint, rebuilt block by block."""

    def __init__(self, d: Path):
        self.dir, self.files = d, None

    def whole(self, key: str, dtype: str) -> torch.Tensor:
        if self.files is None:
            self.files = []
            for p in sorted(self.dir.glob("shard_*.npz")):
                z = np.load(p)
                self.files.append((z, json.loads(str(z[_LAYOUT]))))
        out = None
        for z, layout in self.files:
            lay = layout[key]
            if "offset" not in lay:
                raise ValueError(f"checkpoint entry {key!r} has no block "
                                 f"offsets; it restores only onto its "
                                 f"own layout")
            block = _loaded(z[key], dtype)
            if out is None:
                out = torch.empty(lay["shape"], dtype=block.dtype)
            out[tuple(slice(o, o + n) for o, n in
                      zip(lay["offset"], block.shape))] = block
        return out

    def close(self):
        for z, _ in self.files or ():
            z.close()


def _cut(whole: torch.Tensor, t: DTensor) -> torch.Tensor:
    """This rank's block of the global tensor `whole` under t's placements
    (each rank cuts its own: no collective)."""
    return distribute_tensor(whole, t.device_mesh, t.placements,
                             src_data_rank=None).to_local()


def _copy(t: torch.Tensor, arrays: dict, meta: tuple, key: str) -> None:
    dtypes, layout, shards, mine = meta
    saved = layout.get(key)
    if isinstance(t, DTensor) and mine and _same_layout(saved, t):
        src = _loaded(arrays[key], dtypes[key])       # this rank's block
    else:
        src = _loaded(arrays[key], dtypes[key]) if saved is None \
            else shards.whole(key, dtypes[key])
        _same_shape(key, src.shape, t.shape)
        if isinstance(t, DTensor):
            src = _cut(src.to(t.device), t)
    if isinstance(t, DTensor):
        t = t.to_local()
    _same_shape(key, src.shape, t.shape)
    t.copy_(src)


def restore(ckpt_dir: str | Path, state_like, step: int | None = None,
            host_id: int | None = None):
    """Restore into the structure of `state_like` (global shapes must
    match): its tensors are overwritten in place (a DTensor's local block
    from this rank's shard when the state is placed as the checkpoint
    was, else cut from the global tensor rebuilt from every shard).
    Returns (state, step)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    if not (d / "MANIFEST.json").exists():
        raise FileNotFoundError(f"uncommitted checkpoint {d}")
    own = d / f"shard_{_host_id(host_id)}.npz"
    # a rank past the saver's world reads host 0's dtypes and plain leaves,
    # never its blocks: each of its blocks is cut from the rebuilt tensor
    mine = own.exists()
    with np.load(own if mine else d / "shard_0.npz") as z:
        arrays = {k: z[k] for k in z.files}
    dtypes = json.loads(str(arrays.pop(_DTYPES)))
    layout = json.loads(str(arrays.pop(_LAYOUT, np.array("{}"))))
    shards = _Shards(d)
    try:
        return _restore_into(state_like, arrays,
                             (dtypes, layout, shards, mine)), step
    finally:
        shards.close()


class Checkpointer:
    """Async checkpoint manager with retention."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3,
                 host_id: int | None = None):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.host_id = _host_id(host_id)
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, state, extra: dict | None = None):
        self.wait()
        arrays, hosts = _host_arrays(state)  # device->host copy now

        def work():
            _write(self.dir, step, arrays, self.host_id, extra, hosts)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.dir.iterdir()
            if d.name.startswith("step_") and (d / "MANIFEST.json").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
