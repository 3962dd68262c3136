"""Device kNN search tests: parity with the host oracle + recall."""

import numpy as np
import pytest

from rad_tpu.build.reference import build_hnsw, search_hnsw
from rad_tpu.fp import random_fingerprints, tanimoto_matrix
from rad_tpu.search.knn import search_device

import jax.numpy as jnp


@pytest.fixture(scope="module")
def built():
    fps = random_fingerprints(400, n_bits=256, density=0.2, seed=21)
    graph = build_hnsw(fps, connectivity=8, expansion_add=60, seed=3)
    queries = random_fingerprints(16, n_bits=256, density=0.2, seed=77)
    return graph, queries


def test_device_search_self_query(built):
    graph, _ = built
    q = np.asarray(graph.packed)[[7, 100, 399]]
    d, ids = search_device(graph, q, k=1, expansion_search=32)
    d, ids = np.asarray(d), np.asarray(ids)
    assert (d[:, 0] == 0).all()
    assert ids[:, 0].tolist() == [7, 100, 399]


def test_device_search_recall(built):
    graph, queries = built
    d, ids = search_device(graph, queries, k=10, expansion_search=128)
    ids = np.asarray(ids)
    full = np.asarray(tanimoto_matrix(
        jnp.asarray(queries), jnp.asarray(np.asarray(graph.packed))))
    true_ids = np.argsort(full, axis=1, kind="stable")[:, :10]
    recall = np.mean([
        len(set(ids[i].tolist()) & set(true_ids[i].tolist())) / 10
        for i in range(len(queries))
    ])
    assert recall >= 0.85, f"device recall@10 = {recall}"


def test_device_search_results_sorted_and_valid(built):
    graph, queries = built
    d, ids = search_device(graph, queries, k=10, expansion_search=64)
    d, ids = np.asarray(d), np.asarray(ids)
    assert (np.diff(d, axis=1) >= -1e-6).all(), "distances must be ascending"
    assert (ids >= 0).all() and (ids < len(graph)).all()
    # distances are honest: recompute
    packed = np.asarray(graph.packed)
    for i in range(3):
        recomputed = np.asarray(tanimoto_matrix(
            jnp.asarray(queries[i:i+1]), jnp.asarray(packed[ids[i]])))[0]
        np.testing.assert_allclose(d[i], recomputed, atol=1e-6)


def test_device_matches_host_oracle_quality(built):
    """Device beam and host beam find results of equivalent quality."""
    graph, queries = built
    d_dev, _ = search_device(graph, queries, k=5, expansion_search=64)
    d_host, _ = search_hnsw(graph, queries, k=5, expansion_search=64)
    # mean top-5 distance within noise of each other
    assert abs(float(np.mean(np.asarray(d_dev))) -
               float(np.mean(d_host))) < 0.02


@pytest.mark.slow
def test_prefix_filter_recall_and_degenerate_equivalence():
    """Two-stage prefix screen: keep=all is set-equivalent to the baseline
    search (the filter only reorders the candidate wave), and a 128-bit/
    keep-quarter screen stays within a small recall delta of baseline."""
    # clustered analog-series library: the regime the screen is for (on
    # uniform-random bits the prefix estimate is distance-concentration
    # noise and the filter costs recall)
    import os
    import sys
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples"))
    from enrichment_example import make_library
    try:
        from rad_tpu.native import build_hnsw_native as _build
    except Exception:
        _build = build_hnsw
    fps, _, _ = make_library(4000, 1024, seed=11)
    g = _build(fps, connectivity=8, expansion_add=48, seed=2)
    rng = np.random.default_rng(3)
    queries = np.asarray(g.packed)[rng.choice(4000, 24, replace=False)]
    m0 = 2 * 8
    e = 4
    d0, i0 = search_device(g, queries, k=10, expansion_search=48,
                           expand_width=e)
    d0, i0 = np.asarray(d0), np.asarray(i0)
    # degenerate: keep every candidate -> same converged set
    d1, i1 = search_device(g, queries, k=10, expansion_search=48,
                           expand_width=e, prefix_filter=128,
                           prefix_keep=e * m0)
    np.testing.assert_allclose(np.asarray(d1), d0, atol=1e-6)
    # real screen: quarter keep, recall within 0.05 of baseline
    _, i2 = search_device(g, queries, k=10, expansion_search=48,
                          expand_width=e, prefix_filter=128,
                          prefix_keep=(e * m0) // 4)
    i2 = np.asarray(i2)
    overlap = np.mean([
        len(set(i2[q].tolist()) & set(i0[q].tolist())) / 10
        for q in range(queries.shape[0])
    ])
    assert overlap >= 0.9, f"prefix-filtered overlap with baseline {overlap}"


@pytest.mark.slow
def test_search_device_packed_adjacency_identical():
    """search_device(packed_adjacency=True) walks the grouped bit-field
    table and must return exactly the int32 search's results."""
    from rad_tpu.build.reference import build_hnsw
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.search.knn import search_device

    fps = random_fingerprints(700, n_bits=128, density=0.25, seed=21)
    graph = build_hnsw(fps, connectivity=6, expansion_add=48, seed=7)
    queries = random_fingerprints(9, n_bits=128, density=0.25, seed=22)
    d_u, i_u = search_device(graph, queries, k=8, expansion_search=48)
    d_p, i_p = search_device(graph, queries, k=8, expansion_search=48,
                             packed_adjacency=True)
    np.testing.assert_array_equal(np.asarray(i_u), np.asarray(i_p))
    np.testing.assert_allclose(np.asarray(d_u), np.asarray(d_p), atol=0)
    # prefix filter composes with the packed table
    d_u2, i_u2 = search_device(graph, queries, k=8, expansion_search=48,
                               prefix_filter=64)
    d_p2, i_p2 = search_device(graph, queries, k=8, expansion_search=48,
                               prefix_filter=64, packed_adjacency=True)
    np.testing.assert_array_equal(np.asarray(i_u2), np.asarray(i_p2))
    np.testing.assert_allclose(np.asarray(d_u2), np.asarray(d_p2), atol=0)
