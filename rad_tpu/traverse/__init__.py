"""Score-prioritized best-first HNSW traversal.

Two interchangeable engines with identical semantics (SURVEY.md §0):

* :mod:`rad_tpu.traverse.device` — the device engine: frontier heap,
  per-level visited bitset, and scored log live in HBM and one jitted step
  performs pop→expand→dedupe→integrate atomically *by construction*
  (replaces the reference's Redis+Lua arbitration, rad/priority_queue.py:22-39
  et al.).
* :mod:`rad_tpu.traverse.coordinator` + worker threads — host engine with the
  reference's coordination architecture (work items, heartbeats, reassignment)
  for deployments where the graph is remote (HTTP) or scoring is distributed
  across machines.
"""

from rad_tpu.traverse.structures import (
    PriorityQueue,
    VisitedSet,
    ScoredSet,
    HostPriorityQueue,
    HostVisitedSet,
    HostScoredSet,
)
from rad_tpu.traverse.coordinator import (
    WorkItem,
    WorkerInfo,
    CoordinationService,
    create_coordination_service,
)
from rad_tpu.traverse.workers import (
    ScoringWorker,
    WorkerPool,
    create_worker_pool,
)
from rad_tpu.traverse.driver import DeviceTraverser

__all__ = [
    "PriorityQueue",
    "VisitedSet",
    "ScoredSet",
    "HostPriorityQueue",
    "HostVisitedSet",
    "HostScoredSet",
    "WorkItem",
    "WorkerInfo",
    "CoordinationService",
    "create_coordination_service",
    "ScoringWorker",
    "WorkerPool",
    "create_worker_pool",
    "DeviceTraverser",
]
