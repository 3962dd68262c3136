"""HNSW graph storage model (device-friendly padded adjacency)."""

from rad_tpu.graph.storage import HNSWGraph, LayerStats

__all__ = ["HNSWGraph", "LayerStats"]
