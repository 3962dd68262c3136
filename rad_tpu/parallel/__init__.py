"""Multi-chip scaling: mesh construction + graph-sharded kernels over NVLink."""

from rad_tpu.parallel.mesh import make_mesh
from rad_tpu.parallel.sharded import (
    ShardedGraph,
    shard_graph,
    sharded_bruteforce_topk,
    sharded_fused_step,
    make_sharded_step,
    make_sharded_step_full,
    make_sharded_step_multi,
    TrafficMeter,
    make_sharded_search,
    init_state_sharded,
)
from rad_tpu.parallel.pod import PodTraverser

__all__ = [
    "make_mesh",
    "ShardedGraph",
    "shard_graph",
    "sharded_bruteforce_topk",
    "sharded_fused_step",
    "make_sharded_step",
    "make_sharded_step_full",
    "make_sharded_step_multi",
    "TrafficMeter",
    "make_sharded_search",
    "init_state_sharded",
    "PodTraverser",
]
