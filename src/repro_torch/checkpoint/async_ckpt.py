"""Asynchronous checkpointing: the device-side snapshot on the critical
path, the disk drain in the background.

The paper's period formula wants the *blocking* cost C (the time training
is stalled); durability needs the *drain* to finish.  The checkpointer
therefore tracks two quantities:

    C_block  = time of the synchronous snapshot: encode on the device
               (int8 codecs) and device-to-host copy
    C_full   = C_block + background disk write

A checkpoint becomes *restorable* only once drained; until then the
previous durable checkpoint is the restore point.  (If a fault lands in
the drain window, we lose the in-flight checkpoint — exactly the risk the
paper's D+R+T/2 term already prices, since the restore point is older.)
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .store import CheckpointStore

__all__ = ["AsyncCheckpointer"]


class AsyncCheckpointer:
    def __init__(self, store: CheckpointStore, keep: int = 2):
        self.store = store
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._durable_step: Optional[int] = None
        self._last_metrics: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    @property
    def durable_step(self) -> Optional[int]:
        with self._lock:
            return self._durable_step

    @property
    def metrics(self) -> Dict[str, float]:
        """The last drained save's ``c_block`` and ``c_full`` plus the
        store's ``t_snapshot``, ``t_total``, ``raw_bytes`` and
        ``stored_bytes``."""
        with self._lock:
            return dict(self._last_metrics)

    def wait(self) -> None:
        """Block until the in-flight drain ends; re-raise its error."""
        t = self._thread
        if t is not None:
            t.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, prev_tree=None) -> float:
        """Snapshot synchronously, drain asynchronously.  After the
        drain, all but the newest ``keep`` steps are dropped.

        Returns C_block (seconds the caller was stalled)."""
        self.wait()  # one in-flight checkpoint at a time
        t0 = time.monotonic()
        snap = self.store.snapshot(tree, prev_tree)
        c_block = time.monotonic() - t0

        def drain():
            try:
                t1 = time.monotonic()
                m = self.store.write(step, snap)
                m["c_block"] = c_block
                m["c_full"] = c_block + (time.monotonic() - t1)
                with self._lock:
                    self._durable_step = step
                    self._last_metrics = m
                self.store.gc(keep=self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=drain, daemon=True)
        self._thread.start()
        return c_block
