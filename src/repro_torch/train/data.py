"""Synthetic deterministic data pipeline.

Copy of `repro.train.data` (numpy only; the port imports nothing of the
JAX package): the same arrays for the same (seed, step, host), int32
token ids (the train step converts them to int64).

A real deployment would stream tokenized shards; here the pipeline generates
a reproducible synthetic LM stream (mixture of Zipf unigrams + copy motifs so
the loss actually decreases), sharded per host, with background prefetch.
The interface (iterator of batches + host_shard metadata) is what train.py
consumes, so swapping in a real loader touches nothing else.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticLM", "Prefetcher"]


class SyntheticLM:
    """Deterministic synthetic token stream.

    Each document interleaves Zipf-distributed tokens with repeated motifs;
    labels are next-token; mask is all-ones.  Seeded per (step, host) so any
    restart reproduces the exact stream (important for checkpoint/restart
    equivalence tests).
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 host_id: int = 0, num_hosts: int = 1, seed: int = 1234,
                 frontend: str = "none", frontend_positions: int = 0,
                 d_model: int = 0, encdec: bool = False):
        assert global_batch % num_hosts == 0
        self.vocab, self.seq = vocab, seq_len
        self.batch = global_batch // num_hosts
        self.host_id, self.seed = host_id, seed
        self.frontend, self.fpos = frontend, frontend_positions
        self.d_model, self.encdec = d_model, encdec

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + self.host_id)
        B, S = self.batch, self.seq
        # zipf base stream (clipped to vocab)
        toks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        toks = np.minimum(toks, self.vocab - 1)
        # motif copies: each row repeats a short motif at a random offset —
        # learnable structure so training loss visibly drops
        motif_len = min(16, max(2, S // 4))
        motif = rng.integers(2, min(self.vocab, 1000), size=(B, motif_len))
        for rep in range(3):
            off = rng.integers(0, max(1, S - motif_len), size=B)
            rows = np.arange(B)[:, None]
            cols = off[:, None] + np.arange(motif_len)[None, :]
            toks[rows, cols] = motif
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        out = {"tokens": tokens, "labels": labels,
               "mask": np.ones_like(tokens, np.float32)}
        if self.encdec:
            out["src_embeds"] = rng.standard_normal(
                (B, S, self.d_model)).astype(np.float32)
        elif self.frontend != "none":
            out["prefix_embeds"] = rng.standard_normal(
                (B, self.fpos, self.d_model)).astype(np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch queue over any batch iterator."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = iter(it)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
