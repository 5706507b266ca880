"""Deterministic synthetic LM data pipeline: the reference's
``data/pipeline.py``, array for array (NumPy on the host; the train step
moves a batch to its device).

Properties a real pipeline needs and tests rely on:

* **Deterministic resume** — ``batch(step)`` is a pure function of
  ``(seed, step, shard)``, so restarting from a checkpoint at step k replays
  exactly the same stream (the loss trajectory after an injected fault
  matches the fault-free run).
* **Sharded** — each data-parallel rank materializes only its slice of the
  global batch.
* **Prefetch** — a background thread keeps a bounded queue of ready batches
  so host time hides behind device time.

Tokens are drawn from a counter-mode Philox stream (``np.random.Generator``
re-keyed per (seed, step)), with a Zipf-ish skew so losses are non-trivial.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

__all__ = ["SyntheticLMDataset", "PrefetchIterator"]


@dataclass(frozen=True)
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    frontend_prefix: int = 0
    d_model: int = 0  # only needed when frontend_prefix > 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard])
        )
        # zipf-ish marginal over the vocab for a non-flat loss surface
        u = rng.random((self.local_batch, self.seq_len))
        tokens = (
            (self.vocab_size ** u - 1.0) / (self.vocab_size - 1) * self.vocab_size
        ).astype(np.int32) % self.vocab_size
        out = {"tokens": tokens}
        if self.frontend_prefix:
            out["frontend"] = rng.standard_normal(
                (self.local_batch, self.frontend_prefix, self.d_model), np.float32
            ).astype(np.float32) * 0.02
        return out


class PrefetchIterator:
    """Background-thread prefetch over ``dataset.batch(step)``."""

    def __init__(
        self, dataset: SyntheticLMDataset, start_step: int = 0, depth: int = 2
    ):
        self.dataset = dataset
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def __iter__(self) -> Iterator:
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
