"""Host-spilled traversal order log.

The device keeps the scoring-order log as a fixed-capacity ring
(rad_tpu.traverse.device.TraversalState.order_log) — 4 B per entry of HBM.
For campaigns whose total scored count exceeds what the ring should hold
(the 2B-molecule regime of docs/SCALING.md, or simply a small
``log_capacity`` chosen to save HBM), the driver drains the ring
incrementally into this host-side log between steps, so the *complete*
insertion order survives while device memory stays O(log_capacity).

Reference parity: the reference's insertion order lives in a Redis LIST
that grows without bound on the Redis host (rad/scored.py insertion-order
LIST; SURVEY.md §0) — this is the device-resident analogue, with an optional
disk spill (raw little-endian int32 appends) for orders too large for host
RAM, readable back as a zero-copy memmap.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

__all__ = ["SpilledOrderLog"]


class SpilledOrderLog:
    """Append-only host order log fed by incremental device-ring drains.

    path=None keeps the order in host RAM (chunk list); a path appends raw
    int32 ids to that file and reads them back via memmap. An existing file
    is *resumed* (appended to) — pair it with the state checkpoint: the
    drain cursor re-syncs to ``len(log)``.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._chunks: List[np.ndarray] = []
        self._n = 0
        if path is not None and os.path.exists(path):
            self._n = os.path.getsize(path) // 4

    def __len__(self) -> int:
        return self._n

    @property
    def seen(self) -> int:
        """Drain cursor: entries [0, seen) of the traversal order are here."""
        return self._n

    def append(self, ids: np.ndarray) -> None:
        ids = np.ascontiguousarray(ids, dtype="<i4")
        if ids.size == 0:
            return
        if self.path is None:
            self._chunks.append(ids)
        else:
            with open(self.path, "ab") as f:
                f.write(ids.tobytes())
        self._n += ids.size

    def truncate(self, n: int) -> None:
        """Discard entries at positions >= ``n``.

        Checkpoint-resume guard (ADVICE r2): a file resumed after a crash
        may hold order written *after* the restored checkpoint's
        ``n_scored`` by the pre-crash run; if the resumed run diverges
        (different batch size, different parameters), those tail entries
        would be stale. Callers truncate to the checkpoint's ``n_scored``
        on load so the log can never lead the restored state."""
        n = max(0, min(int(n), self._n))
        if n == self._n:
            return
        if self.path is None:
            if len(self._chunks) > 1:
                self._chunks = [np.concatenate(self._chunks)]
            if self._chunks:
                self._chunks = [self._chunks[0][:n]]
        else:
            with open(self.path, "r+b") as f:
                f.truncate(n * 4)
        self._n = n

    def drain(self, state) -> int:
        """Pull order-log entries [seen, n_scored) off the device ring.

        Call between steps (the pipelined driver hooks this after every
        integrate). Raises — like ``read_order_log_since`` — if more than
        ring-capacity entries accumulated since the last drain.
        Returns the number of new entries."""
        from rad_tpu.traverse.device import read_order_log_since

        new = read_order_log_since(state, self._n)
        self.append(new)
        return int(new.size)

    def read(self, start: int = 0, n: Optional[int] = None) -> np.ndarray:
        """The traversal order as one int32 array (memmap-backed when
        spilled to disk; no copy until sliced)."""
        if self.path is None:
            if not self._chunks:
                return np.zeros((0,), np.int32)
            if len(self._chunks) > 1:  # consolidate lazily
                self._chunks = [np.concatenate(self._chunks)]
            full = self._chunks[0]
        else:
            if self._n == 0:
                return np.zeros((0,), np.int32)
            full = np.memmap(self.path, dtype="<i4", mode="r",
                             shape=(self._n,))
        stop = self._n if n is None else min(start + n, self._n)
        return np.asarray(full[start:stop])
