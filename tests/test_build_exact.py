"""Exact-kNN (all-pairs) builder: structure, quality, determinism.

The builder replaces the beam search with exact per-layer top-K candidate
lists (the expansion_add -> N limit), so its recall at equal M must meet
the incremental builders' (the usearch-semantics native core is the
parity bar, reference examples/DUDEZ_example.ipynb:183-192 build usage).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rad_tpu.build.exact import build_hnsw_exact
from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.fp.tanimoto import bruteforce_topk
from rad_tpu.search.knn import search_device


@pytest.fixture(scope="module")
def fps():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "examples"))
    from enrichment_example import make_library
    return make_library(2000, 128, seed=7)[0]


@pytest.fixture(scope="module")
def exact_graph(fps):
    return build_hnsw_exact(fps, connectivity=8, seed=3)


def test_structure_valid(exact_graph):
    g = exact_graph
    assert len(g) == 2000
    assert sum(1 for _ in g.neighbors) == g.max_level + 1
    for l, adj in enumerate(g.neighbors):
        a = np.asarray(adj)
        nl = g.layer_sizes[l]
        cap = 16 if l == 0 else 8
        assert a.shape == (nl, cap)
        assert a.max() < nl and a.min() >= -1
        assert not (a == np.arange(nl)[:, None]).any(), "self loop"
        if nl > 1:
            assert (a[:, 0] >= 0).all(), "isolated node"
        for row in a[:50]:
            real = row[row >= 0]
            assert len(set(real.tolist())) == len(real), "duplicate edge"
    # levels non-increasing (level-sorted id scheme)
    lv = np.asarray(g.levels)
    assert (np.diff(lv) <= 0).all()


@pytest.mark.slow
def test_recall_parity_with_host_builder(fps, exact_graph):
    host = build_hnsw(fps, connectivity=8, expansion_add=64, seed=3)
    rng = np.random.default_rng(5)
    q = fps[rng.choice(2000, 128, replace=False)]
    _, true_ids = bruteforce_topk(jnp.asarray(q), jnp.asarray(fps), 10)
    ts = [set(np.asarray(true_ids)[i].tolist()) for i in range(128)]

    def recall(g):
        ids = np.asarray(search_device(g, q, k=10, expansion_search=64)[1])
        keys = np.asarray(g.keys)
        ids = np.where(ids >= 0, keys[np.maximum(ids, 0)], -1)
        return float(np.mean([
            len(set(ids[i].tolist()) & ts[i]) / 10 for i in range(128)]))

    r_exact = recall(exact_graph)
    r_host = recall(host)
    assert r_exact >= r_host - 0.02, (r_exact, r_host)
    assert r_exact >= 0.9


def test_deterministic(fps):
    g1 = build_hnsw_exact(fps[:600], connectivity=6, seed=1)
    g2 = build_hnsw_exact(fps[:600], connectivity=6, seed=1)
    for a, b in zip(g1.neighbors, g2.neighbors):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(g1.keys), np.asarray(g2.keys))


def test_keys_roundtrip(fps):
    keys = np.arange(600, dtype=np.int64) * 7 + 3
    g = build_hnsw_exact(fps[:600], keys=keys, connectivity=6, seed=1)
    assert set(np.asarray(g.keys).tolist()) == set(keys.tolist())
    # key -> id -> fingerprint row consistency
    ids = g.get_node_ids_from_keys(keys[:5])
    packed = np.asarray(g.packed)
    for k, i in zip(keys[:5], ids):
        src = int((k - 3) // 7)
        np.testing.assert_array_equal(packed[int(i)], fps[src])


def test_block_size_validation(fps):
    with pytest.raises(ValueError, match="power of two"):
        build_hnsw_exact(fps[:100], connectivity=4, q_block=3000)


def test_index_backend(fps):
    from rad_tpu.api.index import HNSWIndex
    idx = HNSWIndex(ndim=128, connectivity=6)
    idx.add(np.arange(500), fps[:500])
    g = idx.build(backend="exact")
    assert len(g) == 500
    d, keys = idx.search(fps[:4], k=5)
    assert keys.shape == (4, 5)
    # a node's own fingerprint must come back first (distance 0)
    assert np.allclose(np.asarray(d)[:, 0], 0.0)


@pytest.mark.slow
def test_bucket_reduction_recall_parity(fps):
    """Fused bucket reduction (Pallas interpret): recall within noise of
    the approx_max_k path at the same parameters."""
    base = build_hnsw_exact(fps, connectivity=8, seed=3,
                            q_block=512, col_block=512, sel_block=512,
                            impl="swar", block_bucket=None)
    fused = build_hnsw_exact(fps, connectivity=8, seed=3,
                             q_block=512, col_block=512, sel_block=512,
                             impl="triton", interpret=True,
                             block_bucket=16)
    rng = np.random.default_rng(5)
    q = fps[rng.choice(2000, 96, replace=False)]
    _, true_ids = bruteforce_topk(jnp.asarray(q), jnp.asarray(fps), 10)
    ts = [set(np.asarray(true_ids)[i].tolist()) for i in range(96)]

    def recall(g):
        ids = np.asarray(search_device(g, q, k=10, expansion_search=64)[1])
        keys = np.asarray(g.keys)
        ids = np.where(ids >= 0, keys[np.maximum(ids, 0)], -1)
        return float(np.mean([
            len(set(ids[i].tolist()) & ts[i]) / 10 for i in range(96)]))

    r_base, r_fused = recall(base), recall(fused)
    assert r_fused >= r_base - 0.03, (r_fused, r_base)
    # same level structure regardless of reduction
    assert fused.layer_sizes == base.layer_sizes


def test_int8_pairs_selection_identical(fps):
    """int8-matmul pairwise block = SWAR popcount block, bit-identically
    (0/1 dots are exact in int32) -> identical selections."""
    import jax.numpy as jnp
    from rad_tpu.build.exact import _allpairs_topk, _select_layer
    from rad_tpu.fp.pack import popcount_rows_np
    packed = jnp.asarray(fps[:1024])
    pops = jnp.asarray(popcount_rows_np(fps[:1024]))
    cd, ci = _allpairs_topk(packed, 1024, 32, 512, 512, "swar", None)
    a = _select_layer(packed, pops, cd, ci, 1024, 8, 32, 512,
                      int8_pairs=False)
    b = _select_layer(packed, pops, cd, ci, 1024, 8, 32, 512,
                      int8_pairs=True)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_small_library_builds():
    """Libraries smaller than the candidate depth (default 64) must clamp
    the per-block top-k instead of crashing lax.top_k with
    k > reduction_dim (review r3s9)."""
    from rad_tpu.build.reference import search_hnsw

    fps = random_fingerprints(30, n_bits=64, density=0.3, seed=11)
    g = build_hnsw_exact(fps, connectivity=16)
    assert len(g) == 30
    # searchable end-to-end: exact brute force == graph search at n=30
    q = random_fingerprints(3, n_bits=64, density=0.3, seed=12)
    dists, ids = search_hnsw(g, q, k=5, expansion_search=30)
    assert dists.shape == ids.shape == (3, 5)
    assert (ids >= 0).all()                      # all k reachable at n=30
    assert (np.diff(dists, axis=1) >= 0).all()


def test_int64_keys_preserved():
    """User keys past 2**31 survive the device builders (review r3s9:
    jnp.asarray canonicalizes int64->int32 with x64 off, silently
    wrapping keys; they must stay host int64)."""
    fps = random_fingerprints(300, n_bits=64, density=0.3, seed=13)
    big = np.arange(300, dtype=np.int64) + 3_000_000_000
    g = build_hnsw_exact(fps, connectivity=8, keys=big)
    assert np.asarray(g.keys).dtype == np.int64
    assert set(np.asarray(g.keys).tolist()) == set(big.tolist())
    nid = g.get_node_ids_from_keys([int(big[7])])[0]
    assert int(np.asarray(g.keys)[nid]) == int(big[7])


@pytest.mark.slow
def test_symmetrize_modes_identical(fps):
    """The compile-fallback symmetrizations — two-pass (lexsort-decomposed
    stable sorts) and chunked (column-chunked small sorts + row-wise
    merges, for the 1M-node shape whose whole-edge-list sorts the remote
    compile service cannot compile) — are bit-identical to the fused
    3-key sort, at the stage level (random directed selections, ties and
    mutual pairs included, several chunk widths) and through full
    builds."""
    from rad_tpu.build.exact import _symmetrize, _symmetrize_chunked

    rng = np.random.default_rng(5)
    n_pad, m, n_real = 256, 4, 201
    sel = rng.integers(-1, n_pad, size=(n_pad, m)).astype(np.int32)
    # quantized distances force score ties; mutual pairs arise by chance
    sel_d = (rng.integers(0, 6, size=(n_pad, m)) / 8.0).astype(np.float32)
    a = np.asarray(_symmetrize(jnp.asarray(sel), jnp.asarray(sel_d),
                               n_real, 8, two_pass=False))
    b = np.asarray(_symmetrize(jnp.asarray(sel), jnp.asarray(sel_d),
                               n_real, 8, two_pass=True))
    np.testing.assert_array_equal(a, b)
    for cpc in (1, 2, 3, 4):
        c = np.asarray(_symmetrize_chunked(
            jnp.asarray(sel), jnp.asarray(sel_d), n_real, 8,
            cols_per_chunk=cpc))
        np.testing.assert_array_equal(a, c), cpc

    g3 = build_hnsw_exact(fps, connectivity=8, seed=3, symm_mode="sort")
    for mode in ("two_pass", "chunked"):
        g = build_hnsw_exact(fps, connectivity=8, seed=3, symm_mode=mode)
        for t3, t2 in zip(g3.neighbors, g.neighbors):
            np.testing.assert_array_equal(np.asarray(t3), np.asarray(t2))


def test_allpairs_chunked_identical(fps):
    """The host-chunked all-pairs driver (bounded device programs) is
    bit-identical to the one-program form, including the
    overlapping tail span when q_span does not divide nq."""
    from rad_tpu.build.exact import _allpairs_topk, _allpairs_topk_chunked
    from rad_tpu.fp.pack import popcount_rows_np

    packed = np.zeros((2048, fps.shape[1]), np.uint32)
    packed[:2000] = fps
    dev = jnp.asarray(packed)
    kw = dict(k=16, q_block=256, col_block=512, impl="swar",
              approx_recall=0.99)
    ref_d, ref_i = _allpairs_topk(dev, 2000, **kw)
    # q_span=3 over nq=8 -> starts [0, 3, 5]: exercises the overlap path
    ch_d, ch_i = _allpairs_topk_chunked(dev, 2000, **kw,
                                        pairs_per_dispatch=1.6e6)
    np.testing.assert_array_equal(np.asarray(ref_i), np.asarray(ch_i))
    np.testing.assert_array_equal(np.asarray(ref_d), np.asarray(ch_d))
    # q_span=2 divides nq=8: no overlap path
    ch_d, ch_i = _allpairs_topk_chunked(dev, 2000, **kw,
                                        pairs_per_dispatch=1.1e6)
    np.testing.assert_array_equal(np.asarray(ref_i), np.asarray(ch_i))


def test_build_chunked_dispatch_identical(fps):
    """A full build with a tiny pairs_per_dispatch (layer 0 split across
    several device programs) equals the single-dispatch build."""
    kw = dict(connectivity=8, seed=3, q_block=256, col_block=512,
              sel_block=256)
    g_ref = build_hnsw_exact(fps, **kw)
    g_ch = build_hnsw_exact(fps, **kw, pairs_per_dispatch=1.6e6)
    for a, b in zip(g_ref.neighbors, g_ch.neighbors):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_merge_topk_matches_lax_topk_on_ties():
    """_merge_topk (one stable variadic sort) must be bit-identical to the
    lax.top_k + take_along_axis it replaced — including tie handling:
    top_k prefers the smaller index among equal keys, which the stable
    ascending sort realizes by construction (r3s13; the replacement
    removed a 903 ms id-gather from the 100k bucket stage)."""
    import jax

    from rad_tpu.build.exact import _merge_topk

    rng = np.random.default_rng(7)
    # heavy duplication: quantized distances force many exact ties
    d = np.round(rng.random((64, 192), dtype=np.float32), 2)
    d[rng.random(d.shape) < 0.1] = np.inf
    ids = rng.integers(0, 10_000, d.shape).astype(np.int32)
    k = 64

    sd, si = _merge_topk(jnp.asarray(d), jnp.asarray(ids), k)
    neg, sel = jax.lax.top_k(-jnp.asarray(d), k)
    ref_d = -neg
    ref_i = jnp.take_along_axis(jnp.asarray(ids), sel, axis=1)
    np.testing.assert_array_equal(np.asarray(sd), np.asarray(ref_d))
    np.testing.assert_array_equal(np.asarray(si), np.asarray(ref_i))


@pytest.mark.slow
def test_symmetrize_spanned_identical(fps):
    """The host-dispatched row-span fold (the >=10M-node symmetrization)
    is bit-identical to the fused 3-key sort — several edge budgets,
    including ones forcing overlapping tail spans and column re-folds."""
    from rad_tpu.build.exact import _symmetrize, _symmetrize_spanned

    rng = np.random.default_rng(5)
    n_pad, m, n_real = 256, 4, 201
    sel = rng.integers(-1, n_pad, size=(n_pad, m)).astype(np.int32)
    # distances must be a SYMMETRIC pair function (d(a->b) == d(b->a)) —
    # true of every real selection (both directions recompute the same
    # pair distance); the fold-level same-src dedup relies on it. Keep
    # heavy quantization so rank/dedup ties are exercised.
    src_ids = np.arange(n_pad)[:, None]
    lo = np.minimum(src_ids, np.maximum(sel, 0))
    hi = np.maximum(src_ids, np.maximum(sel, 0))
    sel_d = (((lo * 31 + hi * 7) % 6) / 8.0).astype(np.float32)
    a = np.asarray(_symmetrize(jnp.asarray(sel), jnp.asarray(sel_d),
                               n_real, 8))
    for eps in (1 << 7, 1 << 8, 300, 1 << 9, 1 << 20):
        got = np.asarray(_symmetrize_spanned(
            jnp.asarray(sel), jnp.asarray(sel_d), n_real, 8,
            edges_per_sort=eps))
        np.testing.assert_array_equal(a, got), eps

    g3 = build_hnsw_exact(fps, connectivity=8, seed=3, symm_mode="sort")
    g = build_hnsw_exact(fps, connectivity=8, seed=3, symm_mode="spanned")
    for t3, t2 in zip(g3.neighbors, g.neighbors):
        np.testing.assert_array_equal(np.asarray(t3), np.asarray(t2))


@pytest.mark.slow
def test_select_chunked_identical(fps):
    """The host-chunked selection driver is bit-identical to the
    one-program form, including the overlapping tail span."""
    from rad_tpu.build.exact import (_allpairs_topk, _select_layer,
                                     _select_layer_chunked)
    from rad_tpu.fp.pack import popcount_rows_np

    packed = np.zeros((2048, fps.shape[1]), np.uint32)
    packed[:2000] = fps
    dev = jnp.asarray(packed)
    pops = jnp.asarray(popcount_rows_np(packed))
    cand_d, cand_id = _allpairs_topk(dev, 2000, 16, 256, 512,
                                     impl="swar", approx_recall=None)
    ref_s, ref_d = _select_layer(dev, pops, cand_d, cand_id, 2000, 8, 16,
                                 256)
    for rpd in (512, 768, 1024, 4096):
        s, d = _select_layer_chunked(dev, pops, cand_d, cand_id, 2000, 8,
                                     16, 256, rows_per_dispatch=rpd)
        np.testing.assert_array_equal(np.asarray(ref_s), np.asarray(s))
        np.testing.assert_array_equal(np.asarray(ref_d), np.asarray(d))


def test_symmetrize_bucketed_identical(fps):
    """The destination-sharded bucketed symmetrization (the r5 >=10M
    form) is bit-identical to the fused 3-key sort — across group
    widths, fold budgets, tiny buffers that force overflow subdivision,
    and a full build."""
    from rad_tpu.build.exact import _symmetrize, _symmetrize_bucketed

    rng = np.random.default_rng(5)
    n_pad, m, n_real = 256, 4, 201
    sel = rng.integers(-1, n_pad, size=(n_pad, m)).astype(np.int32)
    src_ids = np.arange(n_pad)[:, None]
    lo = np.minimum(src_ids, np.maximum(sel, 0))
    hi = np.maximum(src_ids, np.maximum(sel, 0))
    sel_d = (((lo * 31 + hi * 7) % 6) / 8.0).astype(np.float32)
    a = np.asarray(_symmetrize(jnp.asarray(sel), jnp.asarray(sel_d),
                               n_real, 8))
    for eps, target in [(1 << 7, None), (1 << 8, 1 << 9), (300, 1200),
                        (1 << 9, 1 << 11), (1 << 20, None),
                        # tiny buffer target: forces overflow subdivision
                        (1 << 7, 1 << 7)]:
        got = np.asarray(_symmetrize_bucketed(
            jnp.asarray(sel), jnp.asarray(sel_d), n_real, 8,
            edges_per_sort=eps, target_buf_edges=target))
        np.testing.assert_array_equal(a, got), (eps, target)

    # pathological in-degree: EVERY node selects node 0, so node 0's
    # group must overflow any near-uniform buffer and subdivide down to
    # single-row groups — still bit-identical
    sel_hub = sel.copy()
    sel_hub[:, 0] = 0
    d_hub = sel_d.copy()
    a_hub = np.asarray(_symmetrize(jnp.asarray(sel_hub),
                                   jnp.asarray(d_hub), n_real, 8))
    got_hub = np.asarray(_symmetrize_bucketed(
        jnp.asarray(sel_hub), jnp.asarray(d_hub), n_real, 8,
        edges_per_sort=1 << 7, target_buf_edges=1 << 7, buf_slack=1.0))
    np.testing.assert_array_equal(a_hub, got_hub)

    g3 = build_hnsw_exact(fps, connectivity=8, seed=3, symm_mode="sort")
    g = build_hnsw_exact(fps, connectivity=8, seed=3,
                         symm_mode="bucketed")
    for t3, t2 in zip(g3.neighbors, g.neighbors):
        np.testing.assert_array_equal(np.asarray(t3), np.asarray(t2))
