"""RADTraverser: the top-level 5-call lifecycle facade.

Mirrors the reference API exactly (rad/traverser.py:28-383):
``__init__ → prime() → traverse(n_workers, timeout|n_to_score) →
get_molecules()/get_best_molecules() → shutdown()``, with the same
deployment modes (reference rad/traverser.py:31-35, README.md:113-140):

* ``local`` — graph + traversal state device-resident; the accelerator
  jitted engine (rad_tpu.traverse.device) runs the sweep. No Redis, no
  child processes: atomicity is by compiled-program construction.
* ``distributed`` — the host coordination engine with N scoring workers
  (threads here; remote machines via the HTTP coordination endpoints of
  rad_tpu.server). Equivalent of the reference's Redis-backed mode.
* ``remote``/auto — the graph lives behind an HTTP service
  (e.g. a rad.docking.org-style server); scoring stays local. Uses the host
  engine because adjacency is only reachable over the network.

The ``scored_set`` / ``priority_queue`` / ``visited_set`` properties
(reference rad/traverser.py:273-292) expose live state views in every mode.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from rad_tpu.service.base import HNSWService
from rad_tpu.service.local import LocalHNSWService
from rad_tpu.traverse.coordinator import CoordinationService
from rad_tpu.traverse.structures import (
    HostPriorityQueue,
    HostScoredSet,
    HostVisitedSet,
    ScoredSet,
)
from rad_tpu.traverse.workers import WorkerPool

logger = logging.getLogger(__name__)

__all__ = ["RADTraverser"]


class _DeviceScoredView(ScoredSet):
    """Read view over the device engine's scored arrays (ScoredSet parity)."""

    def __init__(self, traverser: "RADTraverser") -> None:
        self._t = traverser

    def getScore(self, node_id: int) -> Optional[float]:
        eng = self._t._device_engine
        node_id = int(node_id)
        if not bool(eng.state.scored[node_id]):
            return None
        return float(eng.state.scores[node_id])

    def insert(self, node_id: int, score: float, smiles: str = "") -> None:
        raise RuntimeError("device scored set is written by the engine; "
                           "use the traverser API")

    def get_molecules(self, n: int | None = None):
        return self._t._device_engine.get_molecules(n)

    def get_best_molecules(self, n: int | None = None):
        return self._t._device_engine.get_best_molecules(n)

    def __iter__(self):
        for nid, score, _ in self.get_molecules():
            yield (nid, score)

    def __len__(self) -> int:
        return self._t._device_engine.n_scored


class _DeviceFrontierView:
    """Read view over the device frontier (PriorityQueue-len parity)."""

    def __init__(self, traverser: "RADTraverser") -> None:
        self._t = traverser

    def __len__(self) -> int:
        from rad_tpu.traverse.device import frontier_size
        return frontier_size(self._t._device_engine.state)

    def peek_score(self) -> Optional[float]:
        import jax.numpy as jnp
        st = self._t._device_engine.state
        c = st.f_score.shape[0]
        live = jnp.arange(c) >= st.f_cursor
        m = float(jnp.minimum(jnp.min(jnp.where(live, st.f_score, jnp.inf)),
                              jnp.min(st.f_buf_score)))
        return None if not np.isfinite(m) else m


class _DeviceVisitedView:
    """Read view over the device enqueued bitmap (VisitedSet-len parity)."""

    def __init__(self, traverser: "RADTraverser") -> None:
        self._t = traverser

    def __len__(self) -> int:
        import jax.numpy as jnp
        return int(jnp.sum(self._t._device_engine.state.enqueued))

    def __contains__(self, key) -> bool:
        node_id, level = key
        eng = self._t._device_engine
        row = int(eng.dg.offsets[int(level)]) + int(node_id)
        return bool(eng.state.enqueued[row])


class RADTraverser:
    """See the module docstring for the lifecycle and deployment modes.

    Frontier-order caveat: device/pod engines default to a two-level
    frontier (``head_capacity='auto'``) once the frontier capacity reaches
    2^18 — measured +24% screening throughput. The scored SET is unchanged
    (pinned by tests/test_two_level_frontier.py), but once head spills
    occur, molecules with EQUAL scores may be popped — and hence appear in
    ``get_molecules()`` order — in a different order than the host engine
    or a single-level run. Pass ``head_capacity=None`` for exact
    equal-score order parity at any capacity.
    """

    def __init__(
        self,
        hnsw_service: Optional[HNSWService] = None,
        scoring_fn: Callable[[str], float] | None = None,
        deployment_mode: str = "local",
        graph=None,
        smiles_store=None,
        namespace: str = "rad",
        engine: str = "auto",
        batch_size: int = 32,
        frontier_capacity: int | None = None,
        log_capacity: int | None = None,
        buffer_capacity: int = 1 << 15,
        n_score_threads: int = 8,
        worker_timeout: float = 60.0,
        heartbeat_interval: float = 10.0,
        n_workers: int | None = None,
        **kwargs,
    ) -> None:
        if scoring_fn is None:
            raise ValueError("scoring_fn is required")
        if deployment_mode == "hybrid":
            # reference rad/traverser.py:56 names a "hybrid" mode (local
            # index + external workers); that is our distributed engine
            deployment_mode = "distributed"
        if deployment_mode not in ("local", "distributed", "remote",
                                   "pod"):
            raise ValueError(f"unknown deployment_mode {deployment_mode!r}")
        self.scoring_fn = scoring_fn
        self.deployment_mode = deployment_mode
        self.namespace = namespace
        # host-engine pool size used when traverse() is not given one
        # (create_distributed_traverser(n_workers=...) lands here)
        self._default_n_workers = int(n_workers) if n_workers else 1
        self._primed = False
        self._shutdown = False
        self._monitor_stats: dict = {}

        # resolve the graph/service wiring
        if hnsw_service is None:
            if graph is None:
                raise ValueError("provide hnsw_service or graph")
            hnsw_service = LocalHNSWService(graph, smiles_store)
        self.hnsw_service = hnsw_service
        if not self.hnsw_service.is_healthy():
            raise RuntimeError("Provided HNSW service is not healthy")

        local_graph = getattr(hnsw_service, "graph", None)
        if engine == "auto":
            if deployment_mode == "pod":
                engine = "pod"
            else:
                engine = ("device" if deployment_mode == "local"
                          and local_graph is not None else "host")
        if engine in ("device", "pod") and local_graph is None:
            raise ValueError(f"{engine} engine requires a local graph")
        self.engine = engine

        self._device_engine = None
        self._coord: Optional[CoordinationService] = None
        self._pool: Optional[WorkerPool] = None

        if engine == "pod":
            # graph sharded over the device mesh, host scoring pipelined
            # through the sharded expand/integrate halves
            from rad_tpu.parallel.pod import PodTraverser
            self._device_engine = PodTraverser(
                local_graph, scoring_fn=scoring_fn,
                smiles_store=getattr(hnsw_service, "smiles_store", None)
                or smiles_store,
                mesh=kwargs.pop("mesh", None),
                n_devices=kwargs.pop("n_devices", None),
                batch_size=batch_size,
                frontier_capacity=frontier_capacity,
                log_capacity=log_capacity,
                buffer_capacity=buffer_capacity,
                n_score_threads=n_score_threads,
                shard_state=kwargs.pop("shard_state", False),
                head_capacity=kwargs.pop("head_capacity", "auto"),
                order_log_spill=kwargs.pop("order_log_spill", False),
                packed_adjacency=kwargs.pop("packed_adjacency", False),
            )
        elif engine == "device":
            from rad_tpu.traverse.driver import DeviceTraverser
            self._device_engine = DeviceTraverser(
                local_graph, scoring_fn,
                smiles_store=getattr(hnsw_service, "smiles_store", None)
                or smiles_store,
                batch_size=batch_size,
                frontier_capacity=frontier_capacity,
                log_capacity=log_capacity,
                buffer_capacity=buffer_capacity,
                n_score_threads=n_score_threads,
                head_capacity=kwargs.pop("head_capacity", "auto"),
                order_log_spill=kwargs.pop("order_log_spill", False),
                packed_adjacency=kwargs.pop("packed_adjacency", False),
            )
        else:
            self._coord = CoordinationService(
                hnsw_service,
                priority_queue=HostPriorityQueue(),
                visited_set=HostVisitedSet(),
                scored_set=HostScoredSet(),
                worker_timeout=worker_timeout,
                heartbeat_interval=heartbeat_interval,
                namespace=namespace,
            )
        # reference-ctor parity shim: rad's RADTraverser takes redis_*
        # (rad/traverser.py:41-84); there is no Redis here — warn, don't
        # fail a drop-in caller (docs/MIGRATION.md)
        for k in ("redis_host", "redis_port", "redis_password"):
            if k in kwargs:
                kwargs.pop(k)
                logger.warning(
                    "%s ignored: rad-tpu has no Redis — traversal state is "
                    "device-resident (see docs/MIGRATION.md)", k)
        if kwargs:
            raise TypeError(
                f"unsupported RADTraverser kwargs for engine "
                f"{engine!r}: {sorted(kwargs)} (engine options like "
                f"head_capacity/packed_adjacency apply to the device/pod "
                f"engines only)")
        logger.info("RADTraverser initialized (mode=%s engine=%s)",
                    deployment_mode, engine)

    # ------------------------------------------------------------ lifecycle
    def prime(self, **kwargs) -> None:
        """Score all top-layer nodes and seed the frontier
        (reference rad/traverser.py:128-176)."""
        self._check_alive()
        if self._primed:
            return
        if self.engine in ("device", "pod"):
            self._device_engine.prime()
        else:
            top = self.hnsw_service.get_top_level_nodes()
            pairs = list(zip(top[0::2], top[1::2]))
            info = self.hnsw_service.get_hnsw_info()
            start_level = max(0, int(info["max_level"]) - 1)
            for nid, smi in pairs:
                score = float(self.scoring_fn(smi))
                self._coord.scored_set.insert(nid, score, smi)
                if not self._coord.visited_set.checkAndInsert(nid,
                                                              start_level):
                    self._coord.priority_queue.insert(nid, start_level, score)
        self._primed = True

    def traverse(
        self,
        n_workers: Optional[int] = None,
        timeout: Optional[float] = None,
        n_to_score: Optional[int] = None,
        poll_interval: float = 0.2,
        **kwargs,
    ) -> dict:
        """Run the sweep until timeout / n_to_score / frontier exhaustion
        (reference rad/traverser.py:178-245)."""
        self._check_alive()
        if not self._primed:
            raise RuntimeError("prime() must be called before traverse()")
        if timeout is None and n_to_score is None:
            raise ValueError("Must provide either timeout or n_to_score")
        start = time.time()
        if self.engine in ("device", "pod"):
            # pass through engine options — pipeline_depth everywhere;
            # checkpoint_path/checkpoint_interval are device-engine-only
            # (the pod engine checkpoints via save_checkpoint()). Validate
            # against the engine's signature so an unsupported or typo'd
            # kwarg fails with a clear error instead of a bare TypeError.
            import inspect
            params = inspect.signature(
                self._device_engine.traverse).parameters
            bad = sorted(k for k in kwargs if k not in params)
            if bad:
                raise ValueError(
                    f"engine '{self.engine}' traverse() does not accept "
                    f"{bad}; supported: "
                    f"{sorted(k for k in params if k != 'self')}")
            stats = self._device_engine.traverse(n_to_score=n_to_score,
                                                 timeout=timeout, **kwargs)
            self._monitor_stats = stats
            return stats
        # host engine: coordination + worker pool, 1 Hz-ish monitor poll
        self._coord.start()
        # each traverse() round evaluates termination fresh: clear the
        # previous round's sticky reason and restart the timeout epoch
        self._coord.reset_termination()
        if n_workers is None:
            n_workers = self._default_n_workers
        self._pool = WorkerPool(self._coord, self.scoring_fn,
                                n_workers=n_workers)
        self._pool.start_all()
        reason = None
        try:
            while True:
                done, reason = self._coord.check_termination(
                    n_to_score=n_to_score, timeout=timeout)
                if done:
                    break
                time.sleep(poll_interval)
        finally:
            self._pool.stop_all()
        stats = {
            "termination_reason": reason,
            "runtime_seconds": time.time() - start,
            "n_scored": len(self._coord.scored_set),
        }
        self._monitor_stats = stats
        return stats

    def shutdown(self, **kwargs) -> None:
        """Teardown ordering mirrors the reference: workers → coordination →
        HNSW service (rad/traverser.py:346-382)."""
        if self._shutdown:
            return
        self._shutdown = True
        if self._pool is not None:
            self._pool.stop_all()
            self._pool = None
        if self._coord is not None:
            self._coord.shutdown()
        if self._device_engine is not None:
            self._device_engine.shutdown()
        try:
            self.hnsw_service.shutdown()
        except Exception:
            logger.exception("hnsw service shutdown failed")

    def _check_alive(self) -> None:
        if self._shutdown:
            raise RuntimeError("traverser has been shut down")

    # ------------------------------------------------------ state properties
    @property
    def scored_set(self):
        if self.engine in ("device", "pod"):
            return _DeviceScoredView(self)
        return self._coord.scored_set

    @property
    def priority_queue(self):
        if self.engine in ("device", "pod"):
            return _DeviceFrontierView(self)
        return self._coord.priority_queue

    @property
    def visited_set(self):
        if self.engine in ("device", "pod"):
            return _DeviceVisitedView(self)
        return self._coord.visited_set

    # --------------------------------------------------------------- results
    def get_molecules(self, n: int | None = None) -> List[Tuple[int, float, str]]:
        return self.scored_set.get_molecules(n)

    def get_best_molecules(self, n: int | None = None) -> List[Tuple[int, float, str]]:
        return self.scored_set.get_best_molecules(n)

    def get_traversal_stats(self) -> dict:
        stats = {
            "deployment_mode": self.deployment_mode,
            "engine": self.engine,
            "namespace": self.namespace,
            "primed": self._primed,
            "n_scored": len(self.scored_set),
            "service": self.hnsw_service.get_service_info(),
        }
        if self.engine in ("device", "pod"):
            stats["device"] = self._device_engine.get_stats()
        else:
            stats["coordination"] = self._coord.get_coordination_stats()
        stats.update(self._monitor_stats)
        return stats
