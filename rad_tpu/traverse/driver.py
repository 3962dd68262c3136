"""DeviceTraverser: host driver around the jitted traversal step.

Runs the expand/integrate halves of :mod:`rad_tpu.traverse.device` and
bridges the scoring boundary: candidate node ids → user keys → SMILES
(store lookup) → user ``scoring_fn`` → scores back to the device. A
thread pool parallelizes the per-molecule scoring calls inside a batch
(the analogue of the reference's N scoring workers,
rad/distributed_worker.py:244-333 — docking functions are subprocess- or
IO-bound, so threads are the right host-side unit), and with
``pipeline_depth > 1`` the driver overlaps device expansion of the next
batch with host scoring of the current one (the prefetch-proxy overlap of
rad/coordination_service.py:314-347).
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np

from rad_tpu.graph.storage import HNSWGraph
from rad_tpu.store.smiles_store import SmilesStore
from rad_tpu.traverse import device as dev

logger = logging.getLogger(__name__)

__all__ = ["DeviceTraverser"]


class DeviceTraverser:
    """Device-resident best-first traversal over one HNSW graph."""

    def __init__(
        self,
        graph: HNSWGraph,
        scoring_fn: Callable[[str], float],
        smiles_store: Optional[SmilesStore] = None,
        batch_size: int = 32,
        frontier_capacity: int | None = None,
        log_capacity: int | None = None,
        buffer_capacity: int = 1 << 15,
        head_capacity: int | None | str = "auto",
        n_score_threads: int = 8,
        failed_score: float = float("inf"),
        order_log_spill: bool | str = False,
        packed_adjacency: bool = False,
    ) -> None:
        self.graph = graph
        self.scoring_fn = scoring_fn
        self.smiles_store = smiles_store
        self.batch_size = batch_size
        self.failed_score = failed_score
        self.n_score_threads = n_score_threads

        # bit-packed neighbor table (rad_tpu.graph.adjpack): same
        # traversal bit-for-bit, ~bits/32 of the adjacency HBM. Packing
        # happens host-side inside prepare_device_graph, so the int32
        # table never touches the device — the single-chip option for
        # graphs past the int32 device-memory ceiling.
        self.dg = dev.prepare_device_graph(
            graph, packed_adjacency=packed_adjacency)
        self.state = dev.init_state(self.dg, frontier_capacity, log_capacity,
                                    buffer_capacity, head_capacity)
        # host-spilled order log: the device ring stays O(log_capacity)
        # while the complete insertion order accumulates on the host
        # (in RAM, or appended to a file when a path is given) — the
        # beyond-HBM regime of docs/SCALING.md
        self._spill = None
        if order_log_spill:
            from rad_tpu.traverse.spill import SpilledOrderLog
            self._spill = SpilledOrderLog(
                order_log_spill if isinstance(order_log_spill, str)
                else None)
        # host_keys_view: virtual keys (v2 slim serving graphs) index
        # lazily instead of materializing 8 B/node on construction
        from rad_tpu.graph.storage import host_keys_view
        self._keys = host_keys_view(graph.keys)
        self._primed = False
        self._pool: Optional[ThreadPoolExecutor] = None
        self.stats = {
            "steps": 0,
            "scoring_time": 0.0,
            "device_time": 0.0,
            "scoring_errors": 0,
            "started_at": None,
            "termination_reason": None,
        }

    # ------------------------------------------------------------- scoring
    def _smiles_for_ids(self, ids: np.ndarray) -> List[str]:
        keys = self._keys[ids]
        if self.smiles_store is None:
            return [str(int(k)) for k in keys]
        return self.smiles_store.get_smiles_list(keys.tolist())

    def _score_smiles(self, smiles: List[str]) -> np.ndarray:
        def one(s: str) -> float:
            try:
                return float(self.scoring_fn(s))
            except Exception:
                self.stats["scoring_errors"] += 1
                logger.exception("scoring_fn failed for %r", s)
                return self.failed_score

        if self._pool is not None and len(smiles) > 1:
            out = list(self._pool.map(one, smiles))
        else:
            out = [one(s) for s in smiles]
        return np.asarray(out, dtype=np.float32)

    # ------------------------------------------------------------ lifecycle
    def prime(self) -> int:
        """Score all top-layer nodes and seed the frontier
        (reference rad/traverser.py:128-176). Returns #nodes primed."""
        n_top = self.graph.layer_sizes[self.graph.max_level]
        ids = np.arange(n_top, dtype=np.int32)
        smiles = self._smiles_for_ids(ids)
        self._ensure_pool()
        t0 = time.perf_counter()
        scores = self._score_smiles(smiles)
        self.stats["scoring_time"] += time.perf_counter() - t0
        self.state = dev.prime(self.state, self.dg, ids, scores)
        self._primed = True
        if self._spill is not None:
            self._spill.drain(self.state)
        return n_top

    def _ensure_pool(self):
        if self._pool is None and self.n_score_threads > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_score_threads,
                thread_name_prefix="rad-score")

    def _score_batch(self, to_score: np.ndarray) -> np.ndarray:
        ids = to_score[to_score >= 0]
        new_scores = np.zeros(to_score.shape, np.float32)
        if ids.size:
            smiles = self._smiles_for_ids(ids)
            new_scores[: ids.size] = self._score_smiles(smiles)
        return new_scores

    def traverse(
        self,
        n_to_score: Optional[int] = None,
        timeout: Optional[float] = None,
        pipeline_depth: int = 1,
        checkpoint_path: Optional[str] = None,
        checkpoint_interval: int = 100,
    ) -> dict:
        """Run the best-first sweep until a stop condition
        (reference rad/traverser.py:178-245 semantics: n_to_score reached,
        timeout elapsed, or frontier exhausted).

        ``pipeline_depth > 1`` keeps that many expansion batches in flight:
        the device expands batch k+1 while the host scores batch k — the
        same overlap the reference gets from multiple outstanding work
        items (rad/coordination_service.py:314-347). Equivalent to running
        the reference with ``pipeline_depth`` workers; traversal order may
        interleave but all once-only invariants hold.

        ``checkpoint_path`` enables crash recovery: the state is persisted
        atomically every ``checkpoint_interval`` integrated batches, so a
        killed campaign resumes with :meth:`load_checkpoint` + another
        ``traverse()`` call and loses at most one interval of scoring work
        — the device-engine analogue of the reference's survive-worker-
        loss journaling (rad/coordination_service.py:339-343; its state
        survives in Redis, ours in the checkpoint file).
        """
        if not self._primed:
            raise RuntimeError("prime() must be called before traverse() "
                               "(reference raises the same way)")
        if n_to_score is not None:
            # batched best-first trades sequential decision depth for
            # throughput: if the whole budget fits in a handful of steps,
            # the sweep floods the entry neighborhood before score
            # guidance can steer (measured: batch 64 vs 8 on an 8k
            # library at a 10% budget recovers 6 vs 100 of the top-100).
            depth = n_to_score / max(self.batch_size * self.dg.m0, 1)
            if depth < 8:
                logger.warning(
                    "batch_size=%d gives only ~%.1f best-first rounds for "
                    "n_to_score=%d (each step can score up to batch*M0=%d)"
                    " — enrichment quality needs tens of rounds; consider "
                    "batch_size<=%d", self.batch_size, depth, n_to_score,
                    self.batch_size * self.dg.m0,
                    max(1, n_to_score // (self.dg.m0 * 32)))
        self._ensure_pool()
        from rad_tpu.traverse.pipeline import pipelined_traverse

        def expand(state):
            return dev.expand(state, self.dg, self.batch_size)

        def integrate(state, out, new_scores):
            return dev.integrate(
                state, self.dg,
                out["exp_node"], out["exp_level"], out["exp_score"],
                out["exp_valid"], out["cand"], out["to_score"], new_scores)

        n_since_ckpt = [0]

        def after_integrate(state):
            if self._spill is not None:
                self._spill.drain(state)
            if checkpoint_path is not None:
                n_since_ckpt[0] += 1
                if n_since_ckpt[0] >= checkpoint_interval:
                    n_since_ckpt[0] = 0
                    self._save_state_atomic(state, checkpoint_path)

        self.state, _ = pipelined_traverse(
            self.state, expand, integrate, self._score_batch,
            n_scored_of=lambda st: int(st.n_scored),
            n_to_score=n_to_score, timeout=timeout,
            pipeline_depth=pipeline_depth, stats=self.stats,
            after_integrate=after_integrate)
        if checkpoint_path is not None:
            self._save_state_atomic(self.state, checkpoint_path)
        return dict(self.stats, n_scored=self.n_scored)

    @staticmethod
    def _save_state_atomic(state, path: str) -> None:
        dev.save_state_atomic(state, path)

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, path: str) -> None:
        """Persist traversal state; a new DeviceTraverser over the same
        graph resumes with :meth:`load_checkpoint` (the analogue of
        re-attaching to a Redis namespace, reference rad/traverser.py:66).

        The file lands at exactly ``path`` whatever its suffix
        (np.savez appends .npz to other suffixes — the atomic
        write-then-rename normalizes it) so the save/load pair always
        round-trips."""
        self._save_state_atomic(self.state, path)

    def load_checkpoint(self, path: str) -> None:
        state = dev.load_state(path)   # normalizes a missing .npz suffix
        if state.scored.shape[0] != self.dg.n_nodes:
            raise ValueError("checkpoint is for a different graph size")
        self.state = state
        self._primed = bool(int(state.n_scored) > 0)
        # an attached spill log may hold order the pre-crash run wrote
        # beyond this checkpoint — drop it so the log never leads the
        # restored state (stale entries would desync if the resumed run
        # diverges, e.g. under a different batch_size)
        if self._spill is not None and len(self._spill) > self.n_scored:
            self._spill.truncate(self.n_scored)

    # -------------------------------------------------------------- results
    @property
    def n_scored(self) -> int:
        return int(self.state.n_scored)

    def get_molecules(self, n: int | None = None) -> List[Tuple[int, float, str]]:
        """(node_id, score, smiles) in traversal order (parity with
        rad/scored.py:63-85). With ``order_log_spill`` the complete order
        is served from the host log even past the device ring capacity."""
        if self._spill is not None:
            self._spill.drain(self.state)
            ids = self._spill.read()
        else:
            ids = dev.read_order_log(self.state)
        if n is not None:
            ids = ids[:n]
        scores = dev.gather_scores(self.state, ids)
        smiles = self._smiles_for_ids(ids) if len(ids) else []
        return [(int(i), float(s), sm)
                for i, s, sm in zip(ids, scores, smiles)]

    def get_best_molecules(self, n: int | None = None) -> List[Tuple[int, float, str]]:
        """Best-scoring molecules, ties broken by traversal order.

        Selects the top ``n`` ids by score BEFORE the SMILES lookups — a
        10M-molecule campaign must not run 10M store lookups to return
        100 rows."""
        if self._spill is not None:
            self._spill.drain(self.state)
            ids = np.asarray(self._spill.read())
        else:
            ids = np.asarray(dev.read_order_log(self.state))
        scores = dev.gather_scores(self.state, ids)
        order = np.argsort(scores, kind="stable")
        if n is not None:
            order = order[:n]
        ids, scores = ids[order], scores[order]
        smiles = self._smiles_for_ids(ids) if len(ids) else []
        return [(int(i), float(s), sm)
                for i, s, sm in zip(ids, scores, smiles)]

    def get_stats(self) -> dict:
        return dict(
            self.stats,
            n_scored=self.n_scored,
            frontier_size=dev.frontier_size(self.state),
            frontier_dropped=int(self.state.n_dropped),
            device_steps=int(self.state.n_steps),
        )
