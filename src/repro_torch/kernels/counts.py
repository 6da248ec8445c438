"""Launch and pack counts that several threads may add to at once.

The solve service launches kernels from its worker threads, its
dispatcher and its tuner thread together; `d[k] += 1` on a plain dict is a
read, an add and a write, and two threads interleaving them lose a count.
`Counts` is a dict (so `dict(counts)`, `counts[k]` and `counts.update()`
read and write as before) whose increments and resets take one lock.
"""
from __future__ import annotations

import threading

__all__ = ["Counts"]


class Counts(dict):
    """name -> count; `add` and `reset` are atomic across threads."""

    def __init__(self, *names: str):
        super().__init__((name, 0) for name in names)
        self._lock = threading.Lock()

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self[name] += n

    def reset(self) -> None:
        with self._lock:
            for name in self:
                self[name] = 0
