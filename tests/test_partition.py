"""Partition-and-stitch builder tests: validity, stitch coverage, recall
parity with the monolithic builder, determinism.

The pod-scale build path (docs/SCALING.md ">= 500M"): independent
per-shard sub-graphs + cross-shard kNN stitch. The reference has no
equivalent (usearch builds monolithically, README.md:58) — these tests pin
the quality contract that makes partitioning safe: stitched recall within a
small margin of a single build.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rad_tpu.build.partition import build_hnsw_partitioned
from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints, tanimoto_matrix
from rad_tpu.search.knn import search_device

N_SHARDS = 4


@pytest.fixture(scope="module")
def fps():
    return random_fingerprints(600, n_bits=256, density=0.2, seed=17)


@pytest.fixture(scope="module")
def part_graph(fps):
    return build_hnsw_partitioned(fps, n_shards=N_SHARDS, connectivity=8,
                                  expansion_add=48, seed=3, builder="host")


def _recall(graph, queries, k=10, ef=128):
    full = np.asarray(tanimoto_matrix(
        jnp.asarray(queries), jnp.asarray(np.asarray(graph.packed))))
    truth = [set(np.argsort(full[i], kind="stable")[:k].tolist())
             for i in range(len(queries))]
    _, ids = search_device(graph, queries, k=k, expansion_search=ef)
    ids = np.asarray(ids)
    return np.mean([len(set(ids[i].tolist()) & truth[i]) / k
                    for i in range(len(queries))])


def test_partitioned_graph_valid(part_graph, fps):
    g = part_graph
    assert len(g) == len(fps)
    levels = np.asarray(g.levels)
    assert (np.diff(levels) <= 0).all()
    for l, table in enumerate(g.neighbors):
        t = np.asarray(table)
        cap = 2 * g.connectivity if l == 0 else g.connectivity
        assert t.shape == (g.layer_sizes[l], cap)
        valid = t[t >= 0]
        assert (valid < g.layer_sizes[l]).all()
        rows, _ = np.nonzero(t == np.arange(t.shape[0])[:, None])
        assert rows.size == 0, "self loops"
        for r in range(0, t.shape[0], 23):
            row = t[r][t[r] >= 0]
            assert len(row) == len(set(row.tolist())), "duplicate edges"


def test_partitioned_identity_model(part_graph, fps):
    """keys are the original row indices; packed rows follow the id
    permutation (usearch id/key identity model, SURVEY.md §0)."""
    g = part_graph
    keys = np.asarray(g.keys)
    assert sorted(keys.tolist()) == list(range(len(fps)))
    np.testing.assert_array_equal(np.asarray(g.packed), fps[keys])


def test_partitioned_stitch_creates_cross_shard_edges(part_graph):
    """Round-robin sharding puts ~(S-1)/S of each node's true neighbors in
    other shards; the stitch must recover a large fraction of them."""
    g = part_graph
    keys = np.asarray(g.keys)
    shard = keys % N_SHARDS
    for l, table in enumerate(g.neighbors):
        t = np.asarray(table)
        valid = t >= 0
        if valid.sum() == 0:
            continue
        cross = (shard[np.maximum(t, 0)] != shard[:t.shape[0], None]) & valid
        frac = cross.sum() / valid.sum()
        assert frac > 0.15, f"layer {l}: cross-shard edge fraction {frac}"


@pytest.mark.slow
def test_partitioned_recall_parity(part_graph, fps):
    queries = random_fingerprints(24, n_bits=256, density=0.2, seed=71)
    mono = build_hnsw(fps, connectivity=8, expansion_add=48, seed=3)
    r_mono = _recall(mono, queries)
    r_part = _recall(part_graph, queries)
    # measured: 0.99 vs 1.00 at this scale
    assert r_part >= r_mono - 0.05, f"mono={r_mono} partitioned={r_part}"
    assert r_part >= 0.9


@pytest.mark.slow
def test_partitioned_deterministic(fps):
    kw = dict(n_shards=3, connectivity=6, expansion_add=24, seed=9,
              builder="host")
    g1 = build_hnsw_partitioned(fps[:200], **kw)
    g2 = build_hnsw_partitioned(fps[:200], **kw)
    np.testing.assert_array_equal(np.asarray(g1.keys), np.asarray(g2.keys))
    for a, b in zip(g1.neighbors, g2.neighbors):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_partitioned_single_shard_is_monolithic(fps):
    g1 = build_hnsw_partitioned(fps[:150], n_shards=1, connectivity=6,
                                expansion_add=24, seed=5, builder="host")
    g2 = build_hnsw(fps[:150], connectivity=6, expansion_add=24, seed=5)
    for a, b in zip(g1.neighbors, g2.neighbors):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_partitioned_topk_merge_mode(fps):
    """heuristic=False (plain distance-top-cap merge) also yields a usable
    graph."""
    g = build_hnsw_partitioned(fps[:300], n_shards=3, connectivity=6,
                               expansion_add=24, seed=5, builder="host",
                               heuristic=False)
    queries = random_fingerprints(12, n_bits=256, density=0.2, seed=73)
    assert _recall(g, queries) >= 0.85


def test_partitioned_tiny_and_clamped_shards():
    fps = random_fingerprints(10, n_bits=64, seed=1)
    g = build_hnsw_partitioned(fps, n_shards=16, connectivity=4,
                               expansion_add=8, builder="host")
    assert len(g) == 10
    assert (np.asarray(g.neighbors[0]) >= 0).any()


@pytest.mark.slow
def test_partitioned_custom_keys(fps):
    keys = (np.arange(200) * 7 + 3).astype(np.int64)
    g = build_hnsw_partitioned(fps[:200], keys=keys, n_shards=2,
                               connectivity=6, expansion_add=24,
                               builder="host")
    assert sorted(np.asarray(g.keys).tolist()) == sorted(keys.tolist())
    # fork API round trip (reference examples/DUDEZ_example.ipynb:405-409)
    ids = g.get_node_ids_from_keys([keys[0], keys[137]])
    got = np.asarray(g.keys)[ids]
    np.testing.assert_array_equal(got, [keys[0], keys[137]])


@pytest.mark.slow
def test_partitioned_exact_builder(fps):
    """builder='exact' (the all-pairs shard builder): valid stitched
    graph at recall parity with the host-built partition."""
    g = build_hnsw_partitioned(fps, n_shards=N_SHARDS, connectivity=8,
                               expansion_add=48, seed=3, builder="exact")
    assert len(g) == 600
    queries = random_fingerprints(24, n_bits=256, density=0.2, seed=71)
    r = _recall(g, queries)
    assert r >= 0.9, r


@pytest.mark.slow
def test_partitioned_exact_probed_builder():
    """builder_kwargs forwards probes= to the exact shard builds: the
    subquadratic cluster-probed candidate stage composes with the stitch
    (the >=10M-per-shard pod recipe) at recall parity with the exact
    partitioned build on clustered data (probing is a manifold method —
    uniform-random data is the distance-concentration regime)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples"))
    from enrichment_example import make_library

    fps = make_library(3000, 128, seed=11)[0]
    kw = dict(n_shards=2, connectivity=8, expansion_add=48, seed=3,
              builder="exact")
    g_ex = build_hnsw_partitioned(fps, **kw)
    # per shard: 1500 rows / csize 128 = 12 clusters; probes=3 passes the
    # >=4*probes engagement gate
    g_pr = build_hnsw_partitioned(
        fps, **kw,
        builder_kwargs=dict(probes=3, probe_csize=128, q_block=128,
                            col_block=128, sel_block=128,
                            probe_min_n=0))
    assert len(g_pr) == 3000
    rng = np.random.default_rng(5)
    queries = fps[rng.choice(fps.shape[0], 24, replace=False)]
    r_ex, r_pr = _recall(g_ex, queries), _recall(g_pr, queries)
    assert r_pr >= r_ex - 0.05, f"probed {r_pr:.3f} vs exact {r_ex:.3f}"
