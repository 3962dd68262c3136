"""Argument checks and review fixes: clear errors at call time, and the
multi-campaign engine's sizes that must keep working."""

import numpy as np
import pytest

import jax.numpy as jnp

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.traverse import device as dev
from rad_tpu.traverse import multi as multi_mod
from rad_tpu.traverse.multi import fused_run_multi_tables, init_multi


@pytest.fixture(scope="module")
def small_dg():
    fps = random_fingerprints(300, n_bits=128, density=0.25, seed=3)
    graph = build_hnsw(fps, connectivity=4, expansion_add=16, seed=0)
    return dev.prepare_device_graph(graph)


@pytest.mark.parametrize("n_campaigns", [1, 2])
def test_init_multi_single_campaign_unrestricted(small_dg, n_campaigns):
    """Frontiers past 2^20 keys are allowed for any campaign count."""
    st = init_multi(small_dg, n_campaigns=n_campaigns,
                    frontier_capacity=(1 << 21), buffer_capacity=1 << 10)
    assert st.f_score.shape == (n_campaigns, 1 << 21)


def test_multi_batch_guard_allows_small_graphs(small_dg):
    """Small batches run on the multi-campaign table engine."""
    states = init_multi(small_dg, n_campaigns=2,
                        frontier_capacity=1 << 11,
                        buffer_capacity=1 << 8)
    n_top = int(small_dg.offsets[small_dg.max_level + 1]
                - small_dg.offsets[small_dg.max_level])
    ids = jnp.arange(n_top, dtype=jnp.int32)
    tables = jnp.asarray(
        np.random.default_rng(0).random((2, small_dg.n_nodes)),
        jnp.float32)
    states = multi_mod.prime_multi(states, small_dg, ids, tables[:, :n_top])
    out = fused_run_multi_tables(states, small_dg, tables,
                                 jnp.int32(20), batch=8)
    assert int(out.n_scored[0]) >= 20


def test_traverser_rejects_unknown_engine_kwargs():
    """ADVICE r2: a typo'd / unsupported engine kwarg raises a clear
    ValueError naming the supported options, not a bare TypeError."""
    from rad_tpu import HNSWIndex, RADTraverser

    fps = random_fingerprints(300, n_bits=128, density=0.25, seed=3)
    idx = HNSWIndex(ndim=128, connectivity=4, expansion_add=16)
    idx.add(np.arange(300), fps)
    idx.build(backend="host")
    tr = RADTraverser(graph=idx.graph,
                      scoring_fn=lambda smi: float(len(smi)))
    try:
        tr.prime()
        with pytest.raises(ValueError, match="does not accept"):
            tr.traverse(n_to_score=10, checkpoint_pth="/tmp/x.npz")
        # the engine still works after the rejected call
        stats = tr.traverse(n_to_score=10)
        assert stats["n_scored"] >= 10
    finally:
        tr.shutdown()


def test_search_device_jit_requires_m0_packed(small_dg):
    """A packed-adjacency search without m0_packed raises a clear error
    instead of a TypeError deep in tracing (review r3s9)."""
    import jax.numpy as jnp

    from rad_tpu.search.knn import search_device_jit

    with pytest.raises(ValueError, match="m0_packed is required"):
        search_device_jit(
            jnp.zeros((8, 4), jnp.uint32), jnp.zeros((8,), jnp.int32),
            jnp.zeros((4, 8), jnp.uint32), jnp.zeros((3,), jnp.int32),
            jnp.zeros((2, 4), jnp.uint32), k=2, ef=4, max_level=0,
            adj_bits=16, adj_group=2)
