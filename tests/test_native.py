"""Native C++ builder tests: compile, validity, recall, kNN parity, speed."""

import numpy as np
import pytest

import jax.numpy as jnp

from rad_tpu.fp import random_fingerprints, tanimoto_matrix
from rad_tpu.native import (
    build_hnsw_native,
    bruteforce_topk_native,
    native_available,
)

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="g++ unavailable")


@pytest.fixture(scope="module")
def fps():
    return random_fingerprints(800, n_bits=256, density=0.2, seed=23)


@pytest.fixture(scope="module")
def native_graph(fps):
    return build_hnsw_native(fps, connectivity=8, expansion_add=64, seed=5)


def test_native_graph_valid(native_graph):
    g = native_graph
    levels = np.asarray(g.levels)
    assert (np.diff(levels) <= 0).all()
    for l, table in enumerate(g.neighbors):
        t = np.asarray(table)
        cap = 2 * g.connectivity if l == 0 else g.connectivity
        assert t.shape == (g.layer_sizes[l], cap)
        valid = t[t >= 0]
        assert (valid < g.layer_sizes[l]).all()
        rows, _ = np.nonzero(t == np.arange(t.shape[0])[:, None])
        assert rows.size == 0
        for r in range(0, t.shape[0], 53):
            row = t[r][t[r] >= 0]
            assert len(row) == len(set(row.tolist())), f"dup in layer {l}"


def test_native_recall(fps, native_graph):
    from rad_tpu.search.knn import search_device
    queries = random_fingerprints(24, n_bits=256, density=0.2, seed=88)
    _, ids = search_device(native_graph, queries, k=10, expansion_search=128)
    ids = np.asarray(ids)
    full = np.asarray(tanimoto_matrix(
        jnp.asarray(queries),
        jnp.asarray(np.asarray(native_graph.packed))))
    true_ids = np.argsort(full, axis=1, kind="stable")[:, :10]
    recall = np.mean([
        len(set(ids[i].tolist()) & set(true_ids[i].tolist())) / 10
        for i in range(24)
    ])
    assert recall >= 0.85, f"native-built recall@10 = {recall}"


def test_native_matches_python_reference_single_thread(fps):
    """Single-threaded native build is deterministic and equals the numpy
    reference builder edge-for-edge (same algorithm, same level sequence)."""
    from rad_tpu.build.reference import build_hnsw
    g_py = build_hnsw(fps[:300], connectivity=6, expansion_add=32, seed=7)
    g_cc = build_hnsw_native(fps[:300], connectivity=6, expansion_add=32,
                             seed=7, n_threads=1)
    assert g_py.layer_sizes == g_cc.layer_sizes
    for a, b in zip(g_py.neighbors, g_cc.neighbors):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_native_bruteforce_matches_jax(fps):
    queries = fps[:5]
    d_cc, i_cc = bruteforce_topk_native(fps, queries, k=7)
    from rad_tpu.fp.tanimoto import bruteforce_topk
    d_j, i_j = bruteforce_topk(jnp.asarray(queries), jnp.asarray(fps), 7)
    np.testing.assert_allclose(d_cc, np.asarray(d_j), atol=1e-5)


def test_native_build_speed(fps):
    """Native build should beat the pure-python reference builder by a wide
    margin (it exists to give usearch-class host builds)."""
    import time
    from rad_tpu.build.reference import build_hnsw
    sub = fps[:400]
    t0 = time.perf_counter()
    build_hnsw_native(sub, connectivity=8, expansion_add=40, seed=1)
    t_cc = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_hnsw(sub, connectivity=8, expansion_add=40, seed=1)
    t_py = time.perf_counter() - t0
    assert t_cc < t_py / 5, f"native {t_cc:.3f}s vs python {t_py:.3f}s"


def test_native_search_exact_at_full_beam(fps, native_graph):
    """With ef = N the layer-0 beam degenerates to an exhaustive sweep of
    the connected component, so the native search must return the true
    top-k (bruteforce oracle) for every query."""
    from rad_tpu.native import search_knn_native
    queries = random_fingerprints(16, n_bits=256, density=0.2, seed=3)
    d_s, i_s = search_knn_native(native_graph, queries, k=10,
                                 expansion_search=len(native_graph))
    d_b, i_b = bruteforce_topk_native(
        np.asarray(native_graph.packed), queries, k=10)
    np.testing.assert_allclose(d_s, d_b, atol=1e-6)
    # distances sorted ascending, ids valid
    assert (np.diff(d_s, axis=1) >= -1e-7).all()
    assert (i_s >= 0).all() and (i_s < len(native_graph)).all()


def test_native_search_recall_and_threads(fps, native_graph):
    """Beam search recall at modest ef on the native graph, and thread-count
    invariance (each query is independent; results must not depend on the
    worker pool size)."""
    from rad_tpu.native import search_knn_native
    queries = random_fingerprints(32, n_bits=256, density=0.2, seed=9)
    d1, i1 = search_knn_native(native_graph, queries, k=10,
                               expansion_search=128, n_threads=1)
    d4, i4 = search_knn_native(native_graph, queries, k=10,
                               expansion_search=128, n_threads=4)
    np.testing.assert_array_equal(i1, i4)
    np.testing.assert_allclose(d1, d4)
    _, i_b = bruteforce_topk_native(
        np.asarray(native_graph.packed), queries, k=10)
    recall = np.mean([
        len(set(i1[q].tolist()) & set(i_b[q].tolist())) / 10
        for q in range(queries.shape[0])
    ])
    assert recall >= 0.85, f"native search recall@10 = {recall}"


def test_index_search_native_backend(fps):
    """HNSWIndex.search(backend='native') returns keys consistent with the
    device search path on the same graph."""
    from rad_tpu.api.index import HNSWIndex
    idx = HNSWIndex(ndim=256, connectivity=8, expansion_add=64)
    keys = np.arange(500, dtype=np.int64) + 1000
    idx.add(keys, fps[:500])
    # one build thread: a multithreaded insert order varies with the
    # machine's load, and can leave a node with no in-edges (any HNSW
    # may), which this search-parity check is not about
    idx.build(backend="native", n_threads=1)
    queries = fps[:4]
    d_n, k_n = idx.search(queries, k=5, expansion_search=500,
                          backend="native")
    d_e, k_e = idx.search(queries, k=5, exact=True)
    np.testing.assert_allclose(d_n, d_e, atol=1e-5)
    assert (k_n >= 1000).all()


def test_native_fingerprints_match_python_fallback():
    """The C++ batch fingerprinter computes the exact Python fallback
    function (shared FNV-1a 64 substring hash, LSB-first packing)."""
    from rad_tpu.fp.pack import _hash_fingerprint_bits, pack_fingerprints
    from rad_tpu.native import smiles_fingerprints_native
    smiles = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "N", "",
              "CCCCCCCCCCCCCCCC", "C[C@H](N)C(=O)O"]
    for n_bits, radius in [(512, 2), (1024, 2), (256, 1)]:
        want = np.stack([
            pack_fingerprints(_hash_fingerprint_bits(s, n_bits, radius))
            for s in smiles])
        got = smiles_fingerprints_native(smiles, n_bits=n_bits,
                                         radius=radius)
        np.testing.assert_array_equal(got, want)


def test_native_fingerprint_batch_dispatch():
    """smiles_fingerprints (the public loader) routes large RDKit-free
    batches through the native path and agrees with the per-molecule API."""
    from rad_tpu.fp.pack import smiles_fingerprint, smiles_fingerprints
    smiles = [f"C{'C' * (i % 17)}O" for i in range(100)]
    batch = smiles_fingerprints(smiles, n_bits=512)
    one = np.stack([smiles_fingerprint(s, n_bits=512) for s in smiles])
    np.testing.assert_array_equal(batch, one)
