"""HNSW graph construction: host reference builder, on-device batched
builder, and the partition-and-stitch builder for pod-scale libraries."""

from rad_tpu.build.incremental import insert_into_graph
from rad_tpu.build.partition import build_hnsw_partitioned
from rad_tpu.build.reference import build_hnsw


def build_hnsw_exact(*args, **kwargs):
    """Lazy re-export of :func:`rad_tpu.build.exact.build_hnsw_exact`
    (the tensor-core all-pairs builder; ``probes=`` for the subquadratic
    cluster-probed candidate stage at >=1M nodes)."""
    from rad_tpu.build.exact import build_hnsw_exact as _b
    return _b(*args, **kwargs)


__all__ = ["build_hnsw", "build_hnsw_exact", "build_hnsw_partitioned",
           "insert_into_graph"]
