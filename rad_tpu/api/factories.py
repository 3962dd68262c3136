"""Traverser factories (parity with reference rad/traverser.py:387-420)."""

from __future__ import annotations

from typing import Callable

from rad_tpu.api.traverser import RADTraverser

__all__ = [
    "create_local_traverser",
    "create_distributed_traverser",
    "create_remote_traverser",
    "create_pod_traverser",
]


def create_local_traverser(hnsw, scoring_fn: Callable[[str], float],
                           **kwargs) -> RADTraverser:
    """Fully local: device-resident graph + jitted traversal engine.

    ``hnsw`` may be an HNSWIndex, an HNSWGraph, or a local HNSWService.
    """
    from rad_tpu.api.index import HNSWIndex
    from rad_tpu.graph.storage import HNSWGraph
    from rad_tpu.service.base import HNSWService

    if isinstance(hnsw, HNSWIndex):
        return RADTraverser(graph=hnsw.graph, scoring_fn=scoring_fn,
                            deployment_mode="local", **kwargs)
    if isinstance(hnsw, HNSWGraph):
        return RADTraverser(graph=hnsw, scoring_fn=scoring_fn,
                            deployment_mode="local", **kwargs)
    if isinstance(hnsw, HNSWService):
        return RADTraverser(hnsw_service=hnsw, scoring_fn=scoring_fn,
                            deployment_mode="local", **kwargs)
    raise TypeError(f"unsupported hnsw argument {type(hnsw)!r}")


def create_distributed_traverser(hnsw, scoring_fn: Callable[[str], float],
                                 n_workers: int | None = None,
                                 **kwargs) -> RADTraverser:
    """Host coordination engine with a scoring worker pool (the analogue of
    the reference's Redis-backed distributed mode; remote machines attach via
    the HTTP coordination endpoints of rad_tpu.server)."""
    from rad_tpu.api.index import HNSWIndex
    from rad_tpu.graph.storage import HNSWGraph
    from rad_tpu.service.local import LocalHNSWService

    if isinstance(hnsw, HNSWIndex):
        hnsw = LocalHNSWService(hnsw.graph, kwargs.pop("smiles_store", None))
    elif isinstance(hnsw, HNSWGraph):
        hnsw = LocalHNSWService(hnsw, kwargs.pop("smiles_store", None))
    return RADTraverser(hnsw_service=hnsw, scoring_fn=scoring_fn,
                        deployment_mode="distributed",
                        n_workers=n_workers, **kwargs)


def create_remote_traverser(hnsw_service_url: str,
                            scoring_fn: Callable[[str], float],
                            api_key: str | None = None,
                            **kwargs) -> RADTraverser:
    """Traverse a graph served over HTTP (e.g. a rad.docking.org-style
    service); scoring stays local."""
    from rad_tpu.service.registry import create_remote_hnsw_service

    service = create_remote_hnsw_service(hnsw_service_url, api_key=api_key,
                                         register=False)
    return RADTraverser(hnsw_service=service, scoring_fn=scoring_fn,
                        deployment_mode="remote", **kwargs)


def create_pod_traverser(hnsw, scoring_fn: Callable[[str], float],
                         mesh=None, n_devices: int | None = None,
                         **kwargs) -> RADTraverser:
    """Graph sharded across a device mesh, host scoring pipelined through the
    sharded expand/integrate halves (PodTraverser under the RADTraverser
    lifecycle) — the deployment shape for >50M-molecule docking campaigns.
    """
    from rad_tpu.api.index import HNSWIndex
    from rad_tpu.graph.storage import HNSWGraph

    if isinstance(hnsw, HNSWIndex):
        hnsw = hnsw.graph
    if not isinstance(hnsw, HNSWGraph):
        raise TypeError("pod mode shards a local graph; pass an HNSWIndex "
                        f"or HNSWGraph, got {type(hnsw)!r}")
    return RADTraverser(graph=hnsw, scoring_fn=scoring_fn,
                        deployment_mode="pod", mesh=mesh,
                        n_devices=n_devices, **kwargs)
