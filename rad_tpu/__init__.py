"""rad_tpu — a virtual-screening framework for the GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of keiserlab/rad
(reference layout documented in SURVEY.md): an HNSW graph over packed binary
molecular fingerprints with a Tanimoto metric, traversed best-first under a
user-supplied SMILES scoring function so only a small, promising fraction of
an ultra-large chemical library is ever scored.

Where the reference pairs a C++ HNSW core (usearch fork,
reference .gitmodules:1-3) with Redis-coordinated Python workers
(reference rad/coordination_service.py), this framework keeps the graph
and all traversal state device-resident as JAX arrays: a popcount/int8
tensor-core Tanimoto kernel over a device-resident packed fingerprint matrix,
padded per-layer
adjacency tables, batched on-device construction and beam search, and a jitted
best-first traversal step whose atomicity comes from being a single compiled
program rather than Redis Lua scripts.

Top-level API (mirrors rad/traverser.py:41-420):

    from rad_tpu import RADTraverser, HNSWIndex
"""

__version__ = "0.3.0"

from rad_tpu.graph.storage import HNSWGraph

__all__ = [
    "HNSWGraph",
    "HNSWIndex",
    "RADTraverser",
    "create_local_traverser",
    "create_distributed_traverser",
    "create_remote_traverser",
    "create_pod_traverser",
    "PodTraverser",
]

_LAZY = {
    "HNSWIndex": ("rad_tpu.api.index", "HNSWIndex"),
    "RADTraverser": ("rad_tpu.api.traverser", "RADTraverser"),
    "create_local_traverser": ("rad_tpu.api.factories", "create_local_traverser"),
    "create_distributed_traverser": (
        "rad_tpu.api.factories", "create_distributed_traverser"),
    "create_remote_traverser": (
        "rad_tpu.api.factories", "create_remote_traverser"),
    "create_pod_traverser": (
        "rad_tpu.api.factories", "create_pod_traverser"),
    "PodTraverser": ("rad_tpu.parallel.pod", "PodTraverser"),
}


def __getattr__(name):
    # Lazy top-level API: keeps `import rad_tpu.fp` light and avoids import
    # cycles while the heavier service/traversal layers load on first use.
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'rad_tpu' has no attribute {name!r}")
