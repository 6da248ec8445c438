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
from torch import nn

__all__ = ["save", "restore", "latest_step", "Checkpointer"]

_DTYPES = "__dtypes__"
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


def _host(leaf):
    """(numpy array, dtype name) of a leaf, copied to the host now."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype in _WORDS:
            t = t.view(_WORDS[t.dtype])
        return t.numpy(), name
    a = np.array(leaf)
    return a, a.dtype.name


def _host_arrays(state) -> dict:
    """{key: host array} of a state, and its dtype names under
    `__dtypes__`."""
    arrays, dtypes = {}, {}
    for key, leaf in _items(state):
        arrays[key], dtypes[key] = _host(leaf)
    arrays[_DTYPES] = np.array(json.dumps(dtypes))
    return arrays


def _write(ckpt_dir: Path, step: int, arrays: dict, host_id: int,
           extra: dict | None) -> Path:
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{host_id}"
    tmp.mkdir(parents=True, exist_ok=True)
    final.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / f"shard_{host_id}.npz", **arrays)
    os.replace(tmp / f"shard_{host_id}.npz", final / f"shard_{host_id}.npz")
    shutil.rmtree(tmp, ignore_errors=True)
    # manifest commit (host 0)
    if host_id == 0:
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(k for k in arrays if k != _DTYPES),
                    **(extra or {})}
        mtmp = final / ".MANIFEST.tmp"
        mtmp.write_text(json.dumps(manifest))
        os.replace(mtmp, final / "MANIFEST.json")
    return final


def save(ckpt_dir: str | Path, step: int, state, host_id: int = 0,
         extra: dict | None = None) -> Path:
    return _write(Path(ckpt_dir), step, _host_arrays(state), host_id, extra)


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


def _restore_into(tree, arrays: dict, dtypes: dict, prefix: str = ""):
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, p in tree.named_parameters():
                _copy(p, arrays, dtypes, prefix + name)
        return tree
    if isinstance(tree, dict):
        return {k: _restore_into(v, arrays, dtypes, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore_into(v, arrays, dtypes, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    key = prefix[:-1]
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            _copy(tree, arrays, dtypes, key)
        return tree
    arr = arrays[key]
    _same_shape(key, arr.shape, np.shape(tree))
    return arr


def _same_shape(key: str, stored, want) -> None:
    if tuple(stored) != tuple(want):
        raise ValueError(f"checkpoint entry {key!r} has shape "
                         f"{tuple(stored)}, not {tuple(want)}")


def _copy(t: torch.Tensor, arrays: dict, dtypes: dict, key: str) -> None:
    src = _loaded(arrays[key], dtypes[key])
    _same_shape(key, src.shape, t.shape)
    t.copy_(src)


def restore(ckpt_dir: str | Path, state_like, step: int | None = None,
            host_id: int = 0):
    """Restore into the structure of `state_like` (shapes must match):
    its tensors are overwritten in place.  Returns (state, step)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    if not (d / "MANIFEST.json").exists():
        raise FileNotFoundError(f"uncommitted checkpoint {d}")
    with np.load(d / f"shard_{host_id}.npz") as z:
        arrays = {k: z[k] for k in z.files}
    dtypes = json.loads(str(arrays.pop(_DTYPES)))
    return _restore_into(state_like, arrays, dtypes), step


class Checkpointer:
    """Async checkpoint manager with retention."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3,
                 host_id: int = 0):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.host_id = host_id
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, state, extra: dict | None = None):
        self.wait()
        arrays = _host_arrays(state)  # device->host copy now

        def work():
            _write(self.dir, step, arrays, self.host_id, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.dir.iterdir()
            if d.name.startswith("step_") and (d / "MANIFEST.json").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
