"""LocalHNSWService: in-process service over a device/host-resident graph.

The reference isolates its HNSW index in a *child process* with
multiprocessing.Queue IPC (rad/hnsw_service.py:81-452) because the usearch
C++ index lives in one process's heap and blocks the GIL. Neither constraint
exists here: the graph is JAX/numpy arrays (HBM- or host-resident) and
adjacency queries are array gathers, so the device-resident local service is a
thin, lock-free in-process adapter. The request/metrics surface (timeouts,
request counters, ``get_service_info``) is preserved so local and remote
services stay interchangeable.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from rad_tpu.graph.storage import HNSWGraph, host_keys_view
from rad_tpu.service.base import HNSWService
from rad_tpu.store.smiles_store import SmilesStore

__all__ = ["LocalHNSWService"]


class LocalHNSWService(HNSWService):
    def __init__(
        self,
        graph: HNSWGraph,
        smiles_store: Optional[SmilesStore] = None,
        service_name: str = "local",
    ) -> None:
        self.graph = graph
        self.smiles_store = smiles_store
        self.service_name = service_name
        self._started_at = time.time()
        self._shutdown = False
        self._lock = threading.Lock()
        self._request_count = 0
        self._error_count = 0
        self._request_time = 0.0
        # host copies of key map + adjacency for fast scalar access
        self._keys = host_keys_view(graph.keys)

    # ----------------------------------------------------------- internals
    def _check_alive(self) -> None:
        if self._shutdown:
            raise RuntimeError("service has been shut down")

    def _record(self, dt: float, error: bool = False) -> None:
        with self._lock:
            self._request_count += 1
            self._request_time += dt
            if error:
                self._error_count += 1

    def _to_smiles_pairs(self, ids: List[int]) -> List:
        """[id, ...] → flat [id, smiles, ...]; empty SMILES when unknown
        (empty-SMILES contract: reference tests/test_service_layer_smiles.py:150-190)."""
        keys = [int(self._keys[i]) for i in ids]
        if self.smiles_store is not None:
            found = self.smiles_store.get_smiles_batch(keys)
        else:
            found = {}
        out: List = []
        for i, k in zip(ids, keys):
            out.extend((int(i), found.get(k, "")))
        return out

    # ------------------------------------------------------------ contract
    def get_neighbors(self, node_id: int, level: int) -> List:
        self._check_alive()
        t0 = time.perf_counter()
        try:
            flat = self.graph.get_neighbors(int(node_id), int(level))
            ids = flat[0::2]
            result = self._to_smiles_pairs(ids)
            self._record(time.perf_counter() - t0)
            return result
        except Exception:
            self._record(time.perf_counter() - t0, error=True)
            raise

    def get_top_level_nodes(self) -> List:
        self._check_alive()
        t0 = time.perf_counter()
        try:
            flat = self.graph.get_top_level_nodes()
            ids = flat[0::2]
            result = self._to_smiles_pairs(ids)
            self._record(time.perf_counter() - t0)
            return result
        except Exception:
            self._record(time.perf_counter() - t0, error=True)
            raise

    def is_healthy(self) -> bool:
        return not self._shutdown

    def shutdown(self) -> None:
        self._shutdown = True
        if self.smiles_store is not None:
            self.smiles_store.close()

    def get_service_info(self) -> dict:
        with self._lock:
            reqs = self._request_count
            errs = self._error_count
            total_t = self._request_time
        return {
            "service_type": "local",
            "service_name": self.service_name,
            "healthy": self.is_healthy(),
            "uptime_seconds": time.time() - self._started_at,
            "request_count": reqs,
            "error_count": errs,
            "avg_request_ms": 1000.0 * total_t / max(reqs, 1),
            "has_smiles_store": self.smiles_store is not None,
        }

    def get_hnsw_info(self) -> dict:
        self._check_alive()
        return self.graph.info()
