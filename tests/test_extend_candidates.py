"""extend_candidates flag (HNSW paper Algorithm 4 candidate extension).

The paper notes that extension only matters for extremely clustered
data. The flag is
kept for parity with the published algorithm; these tests pin that it
produces a valid graph with recall no worse than the default.
"""

import numpy as np

import jax.numpy as jnp

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints, tanimoto_matrix
from rad_tpu.search.knn import search_device
import pytest


def _recall(graph, queries, k=10, ef=96):
    full = np.asarray(tanimoto_matrix(
        jnp.asarray(queries), jnp.asarray(np.asarray(graph.packed))))
    truth = [set(np.argsort(full[i], kind="stable")[:k].tolist())
             for i in range(len(queries))]
    _, ids = search_device(graph, queries, k=k, expansion_search=ef)
    ids = np.asarray(ids)
    return np.mean([len(set(ids[i].tolist()) & truth[i]) / k
                    for i in range(len(queries))])


@pytest.mark.slow
def test_extend_candidates_valid_and_comparable():
    fps = random_fingerprints(500, n_bits=256, density=0.2, seed=11)
    queries = random_fingerprints(16, n_bits=256, density=0.2, seed=12)
    g0 = build_hnsw(fps, connectivity=8, expansion_add=48, seed=3)
    g1 = build_hnsw(fps, connectivity=8, expansion_add=48, seed=3,
                    extend_candidates=True)
    # identical level structure (extension changes edges, not ids)
    np.testing.assert_array_equal(np.asarray(g0.levels),
                                  np.asarray(g1.levels))
    for l, t in enumerate(g1.neighbors):
        t = np.asarray(t)
        valid = t[t >= 0]
        assert (valid < g1.layer_sizes[l]).all()
        rows, _ = np.nonzero(t == np.arange(t.shape[0])[:, None])
        assert rows.size == 0
    r0, r1 = _recall(g0, queries), _recall(g1, queries)
    assert r1 >= r0 - 0.05, f"extend_candidates hurt recall: {r0} -> {r1}"
