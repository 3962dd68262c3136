"""HNSWIndex: the usearch-style index facade.

Mirrors the ``usearch.index.Index`` surface the reference builds on
(ctor params reference README.md:47-53; ``add`` README.md:58 and
examples/DUDEZ_example.ipynb:192; load-view scripts/start_hnsw_server.py:69;
properties rad/hnsw_service.py:400-412) so reference users can switch with
minimal changes:

    index = HNSWIndex(ndim=1024, dtype='b1', metric='tanimoto',
                      connectivity=8, expansion_add=400)
    index.add(keys, packed_fps)
    dists, keys = index.search(query_fps, k=10)
    index.save("library.rad.npz"); HNSWIndex.load(path, view=True)

Because virtual-screening libraries are static, ``add`` accumulates vectors
and the graph is built once on first query/build() — either on-host
(numpy reference builder) or on-device (batched JAX builder), selected by
``backend``.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence

import numpy as np

from rad_tpu.graph.storage import HNSWGraph, LayerStats

logger = logging.getLogger(__name__)

__all__ = ["HNSWIndex"]


class HNSWIndex:
    def __init__(
        self,
        ndim: int = 1024,
        dtype: str = "b1",
        metric: str = "tanimoto",
        connectivity: int = 16,
        expansion_add: int = 200,
        expansion_search: int = 64,
        backend: str = "auto",
        seed: int = 0,
    ) -> None:
        if dtype != "b1":
            raise ValueError("only packed-bit 'b1' storage is supported "
                             "(parity with the reference's usage)")
        if metric != "tanimoto":
            raise ValueError("only the 'tanimoto' metric is supported")
        self.ndim = ndim
        self.metric = metric
        self.connectivity = connectivity
        self.expansion_add = expansion_add
        self.expansion_search = expansion_search
        self.backend = backend
        self.seed = seed

        self._pending_keys: List[np.ndarray] = []
        self._pending_fps: List[np.ndarray] = []
        self._graph: Optional[HNSWGraph] = None

    # ------------------------------------------------------------------ add
    def add(self, keys, vectors, log: bool | str = False) -> None:
        """Queue packed fingerprints for graph construction.

        ``vectors``: ``[N, ndim/32] uint32`` packed rows, ``[N, ndim]``
        0/1 bits (auto-packed), or ``[N, ndim/8] uint8`` ``np.packbits``
        rows — the layout reference/usearch pipelines already hold
        (reference README.md:58-63). ``keys``: int64 user keys (scalar or
        array).

        Adding after a graph exists (usearch ``Index.add`` semantics,
        reference README.md:58) is supported by *rebuild*: the existing
        rows are folded into the pending set and the graph is reconstructed
        on the next build()/query — O(N) per append batch. For true O(K)
        incremental insertion into a built graph (usearch's actual
        mechanism) use :meth:`insert`.
        """
        if self._graph is not None and not self._pending_fps:
            # graph came from load()/from_graph(): seed the rebuild with its
            # rows so an append never silently drops the loaded library
            self._pending_fps.append(
                np.ascontiguousarray(np.asarray(self._graph.packed)))
            self._pending_keys.append(np.asarray(self._graph.keys))
        from rad_tpu.fp.pack import coerce_packed
        vectors = coerce_packed(vectors, self.ndim)
        keys = np.atleast_1d(np.asarray(keys, dtype=np.int64))
        if keys.shape[0] != vectors.shape[0]:
            raise ValueError("keys and vectors length mismatch")
        self._pending_keys.append(keys)
        self._pending_fps.append(vectors)
        self._graph = None  # graph is stale until rebuilt
        if log:
            logger.info("queued %d vectors (total pending %d)",
                        len(keys), sum(len(k) for k in self._pending_keys))

    def insert(self, keys, vectors, **kwargs) -> None:
        """True incremental insertion into the BUILT graph — O(K) insert
        work instead of ``add``'s O(N+K) rebuild (usearch's own append
        mechanism, reference README.md:58). Builds first if needed.

        Node ids are renumbered (the level-sorted id invariant); user keys
        are stable — re-resolve ids via :meth:`get_node_ids_from_keys`
        (the reference workflow does exactly that,
        examples/DUDEZ_example.ipynb:405-409).
        """
        from rad_tpu.build.incremental import insert_into_graph
        from rad_tpu.fp.pack import coerce_packed

        vectors = coerce_packed(vectors, self.ndim)
        keys = np.atleast_1d(np.asarray(keys, dtype=np.int64))
        g = self.graph  # builds pending rows if necessary
        self._graph = insert_into_graph(
            g, vectors, new_keys=keys,
            expansion_add=self.expansion_add, seed=self.seed, **kwargs)
        # a later add() folds rows back from the graph (no pending copies)
        self._pending_keys = []
        self._pending_fps = []

    # ---------------------------------------------------------------- build
    def build(self, backend: str | None = None, **kwargs) -> HNSWGraph:
        """Construct the graph from all added vectors."""
        if self._graph is not None:
            return self._graph
        if not self._pending_fps:
            raise RuntimeError("no vectors added")
        fps = np.concatenate(self._pending_fps, axis=0)
        keys = np.concatenate(self._pending_keys, axis=0)
        if len(np.unique(keys)) != len(keys):
            raise ValueError("duplicate keys (multi-key indexes unsupported)")
        backend = backend or self.backend
        t0 = time.perf_counter()
        common = dict(keys=keys, connectivity=self.connectivity,
                      expansion_add=self.expansion_add, ndim=self.ndim,
                      seed=self.seed)
        if backend == "auto":
            # The native C++ builder (exact reference semantics, all host
            # cores) when the toolchain allows; else the numpy reference
            # builder. The exact all-pairs builder is faster on a GPU but
            # its graphs search with far lower recall on libraries of
            # analog families (PERF.md), so it stays opt-in
            # (backend="exact"), as does the batched beam builder
            # (backend="device").
            from rad_tpu.native import native_available
            backend = "native" if native_available() else "host"
        if backend == "device":
            from rad_tpu.build.device import build_hnsw_device
            self._graph = build_hnsw_device(fps, **common, **kwargs)
        elif backend == "exact":
            # all-pairs construction on the tensor cores
            # (rad_tpu.build.exact) — the fast accelerator path at
            # <=few-million-node scale
            from rad_tpu.build.exact import build_hnsw_exact
            logger.info(
                "build backend=exact: expansion_add=%d is ignored (exact "
                "per-layer kNN is the infinite-beam limit); pass "
                "backend='native'/'device' for beam-width semantics",
                self.expansion_add)
            self._graph = build_hnsw_exact(fps, **common, **kwargs)
        elif backend == "native":
            from rad_tpu.native import build_hnsw_native
            self._graph = build_hnsw_native(fps, **common, **kwargs)
        elif backend == "host":
            from rad_tpu.build.reference import build_hnsw
            self._graph = build_hnsw(fps, **common)
        else:
            raise ValueError(f"unknown build backend {backend!r}")
        logger.info("built HNSW over %d vectors in %.2fs (backend=%s)",
                    len(keys), time.perf_counter() - t0, backend)
        return self._graph

    @property
    def graph(self) -> HNSWGraph:
        if self._graph is None:
            self.build()
        return self._graph

    # --------------------------------------------------------------- search
    def search(self, queries, k: int = 10, expansion_search: int | None = None,
               exact: bool = False, backend: str | None = None,
               prefix_filter: int | None = None,
               prefix_keep: int | None = None):
        """Batched k-NN by Tanimoto distance → ``(dists [B,k], keys [B,k])``.

        ``exact=True`` runs brute force (ground truth); otherwise the jitted
        device beam search, or the multithreaded C++ host search with
        ``backend="native"`` (usearch ``Index.search`` CPU parity — for
        hosts serving a graph without an accelerator). ``queries`` accepts
        the same three layouts as :meth:`add` (uint32-packed, 0/1 bits,
        ``np.packbits`` uint8 rows).
        """
        from rad_tpu.fp.pack import coerce_packed
        queries = coerce_packed(queries, self.ndim)
        g = self.graph
        ef = expansion_search or self.expansion_search
        if exact:
            import jax.numpy as jnp
            from rad_tpu.fp.tanimoto import (bruteforce_topk,
                                             bruteforce_topk_blocked)
            db = jnp.asarray(np.asarray(g.packed))
            qj = jnp.asarray(queries)
            if len(g) * queries.shape[0] > (1 << 26):
                # block the scan so the [B, N] matrix never materializes
                d, ids = bruteforce_topk_blocked(qj, db, k, block=1 << 14)
            else:
                d, ids = bruteforce_topk(qj, db, k)
            d, ids = np.asarray(d), np.asarray(ids)
        elif backend == "native":
            from rad_tpu.native import search_knn_native
            d, ids = search_knn_native(g, queries, k=k, expansion_search=ef)
        else:
            from rad_tpu.search.knn import search_device
            d, ids = search_device(g, queries, k=k, expansion_search=ef,
                                   prefix_filter=prefix_filter,
                                   prefix_keep=prefix_keep)
            d, ids = np.asarray(d), np.asarray(ids)
        from rad_tpu.graph.storage import host_keys_view
        kv = host_keys_view(g.keys)  # virtual keys index lazily, not O(N)
        keys = np.where(ids >= 0, np.asarray(kv[np.maximum(ids, 0)]), -1)
        return d, keys

    # ---------------------------------------------------- usearch-like API
    def __len__(self) -> int:
        if self._graph is not None:
            return len(self._graph)
        return int(sum(len(k) for k in self._pending_keys))

    @property
    def size(self) -> int:
        return len(self)

    @property
    def max_level(self) -> int:
        return self.graph.max_level

    @property
    def dtype(self) -> str:
        return "b1"

    @property
    def multi(self) -> bool:
        return False

    @property
    def capacity(self) -> int:
        return len(self)

    @property
    def memory_usage(self) -> int:
        return self.graph.memory_usage

    @property
    def levels_stats(self) -> List[LayerStats]:
        return self.graph.levels_stats()

    # fork-added graph introspection (reference rad/hnsw_service.py:219-232)
    def get_neighbors(self, node_id: int, level: int) -> List[int]:
        return self.graph.get_neighbors(node_id, level)

    def get_top_level_nodes(self) -> List[int]:
        return self.graph.get_top_level_nodes()

    def get_node_ids_from_keys(self, keys: Sequence[int]) -> List[int]:
        return self.graph.get_node_ids_from_keys(keys)

    # -------------------------------------------------------------- persist
    def save(self, path: str) -> None:
        self.graph.save(path)

    @classmethod
    def load(cls, path: str, view: bool = True,
             exclude_vectors: bool = False, **kwargs) -> "HNSWIndex":
        """Load a persisted index; ``view=True`` memory-maps (parity with
        usearch ``Index(path=…, view=True)``,
        reference scripts/start_hnsw_server.py:69). ``exclude_vectors`` is
        accepted for signature parity; mmap already loads lazily."""
        graph = HNSWGraph.load(path, mmap=view)
        idx = cls(ndim=graph.ndim, connectivity=graph.connectivity, **kwargs)
        idx._graph = graph
        return idx

    @classmethod
    def from_graph(cls, graph: HNSWGraph, **kwargs) -> "HNSWIndex":
        idx = cls(ndim=graph.ndim, connectivity=graph.connectivity, **kwargs)
        idx._graph = graph
        return idx
