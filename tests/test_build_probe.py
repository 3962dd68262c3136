"""Cluster-probed candidate stage (rad_tpu.build.probe + exact probes=).

The subquadratic form of the exact builder's all-pairs stage: balanced
bisection clusters + sampled probe lists, each query block scanning only
its probed clusters. Pinned here: the partition invariants, the
all-probes limit (probed distances == exact distances when every cluster
is scanned), and graph quality on clustered data.
"""

import numpy as np
import pytest

from rad_tpu.build import exact as ex
from rad_tpu.build.exact import build_hnsw_exact
from rad_tpu.build.probe import bisect_clusters, cluster_probes
from rad_tpu.fp.tanimoto import bruteforce_topk


@pytest.fixture(scope="module")
def fps():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "examples"))
    from enrichment_example import make_library
    return make_library(3000, 128, seed=11)[0]


def test_bisect_partition_invariants(fps):
    csize = 256
    perm = bisect_clusters(fps, csize, seed=0)
    n = fps.shape[0]
    c = -(-n // csize)
    assert perm.shape == (c * csize,)
    real = perm[perm >= 0]
    assert real.size == n
    assert np.array_equal(np.sort(real), np.arange(n))
    # pads are the contiguous TAIL of permuted space (their +inf scores
    # sort to every group's end, and the tail always lands in the last
    # subgroup of every split) — the probed driver's q-block skip and
    # the n_real row-count arithmetic both rely on this
    pad_pos = np.flatnonzero(perm < 0)
    assert pad_pos.size == c * csize - n
    if pad_pos.size:
        assert np.array_equal(pad_pos,
                              np.arange(n, c * csize))


def test_bisect_deterministic(fps):
    p1 = bisect_clusters(fps, 256, seed=3)
    p2 = bisect_clusters(fps, 256, seed=3)
    assert np.array_equal(p1, p2)
    p3 = bisect_clusters(fps, 256, seed=4)
    assert not np.array_equal(p1, p3)


def test_bisect_groups_similar_rows(fps):
    """Clusters must be tighter than random grouping on clustered data."""
    rng = np.random.default_rng(0)
    csize = 256
    perm = bisect_clusters(fps, csize, seed=0)

    def mean_intra(p):
        from rad_tpu.fp.pack import popcount_rows_np
        tot, cnt = 0.0, 0
        pops = popcount_rows_np(fps)
        for ci in range(p.size // csize):
            mem = p[ci * csize:(ci + 1) * csize]
            mem = mem[mem >= 0][:32]
            if mem.size < 2:
                continue
            a = fps[mem]
            inter = popcount_rows_np(
                a[:, None, :] & a[None, :, :]).astype(np.float64)
            union = pops[mem][:, None] + pops[mem][None, :] - inter
            d = 1.0 - inter / np.maximum(union, 1)
            iu = np.triu_indices(mem.size, 1)
            tot += d[iu].sum()
            cnt += iu[0].size
        return tot / cnt

    shuffled = np.concatenate(
        [rng.permutation(fps.shape[0]).astype(np.int32),
         np.full(perm.size - fps.shape[0], -1, np.int32)])
    assert mean_intra(perm) < 0.8 * mean_intra(shuffled)


def test_cluster_probes_shape_and_self(fps):
    csize = 256
    perm = bisect_clusters(fps, csize, seed=0)
    c = perm.size // csize
    tab = cluster_probes(fps, perm, csize, probes=4, sample=8, seed=1)
    assert tab.shape == (c, 4)
    for ci in range(c):
        row = tab[ci]
        row = row[row >= 0]
        assert ci in row, "own cluster must always be probed"
        assert np.array_equal(row, np.sort(row)), "ascending scan order"
        assert len(set(row.tolist())) == len(row)


def test_probed_allpairs_all_probes_matches_exact(fps):
    """With probes >= n_clusters every cluster is scanned: the candidate
    DISTANCES must equal the exact driver's exactly (ids may differ only
    on ties — the probed merge breaks ties by permuted position)."""
    import jax.numpy as jnp

    n = 2048
    sub = np.ascontiguousarray(fps[:n])
    packed_l = jnp.asarray(sub)
    k, qb, csz = 32, 256, 256
    c = n // csz
    d_ex, i_ex = ex._allpairs_topk(packed_l, n, k, qb, csz,
                                   impl="swar", approx_recall=None)
    d_pr, i_pr = ex._allpairs_topk_probed(
        packed_l, n, k, qb, csz, impl="swar", approx_recall=None,
        bucket=None, interpret=False, probes=c, probe_sample=8, seed=0,
        pairs_per_dispatch=ex.PAIRS_PER_DISPATCH)
    np.testing.assert_allclose(np.asarray(d_pr), np.asarray(d_ex),
                               rtol=0, atol=0)
    # winners agree wherever the distance is strictly unique in context:
    # at minimum, valid masks agree
    assert np.array_equal(np.asarray(i_pr) >= 0, np.asarray(i_ex) >= 0)


def test_probed_allpairs_candidate_recall(fps):
    """At a realistic probe fraction the candidates must capture nearly
    all true neighbors on clustered data."""
    import jax.numpy as jnp

    n = 2048
    sub = np.ascontiguousarray(fps[:n])
    packed_l = jnp.asarray(sub)
    k, qb, csz = 16, 128, 128              # 16 clusters
    # ground truth (self included at rank 0 → take k+1, drop self)
    d_t, i_t = bruteforce_topk(packed_l, packed_l, k + 1)
    i_t = np.asarray(i_t)

    def cand_recall(p):
        d_pr, i_pr = ex._allpairs_topk_probed(
            packed_l, n, k, qb, csz, impl="swar",
            approx_recall=None, bucket=None, interpret=False, probes=p,
            probe_sample=8, seed=0,
            pairs_per_dispatch=ex.PAIRS_PER_DISPATCH)
        i_pr = np.asarray(i_pr)
        hits = tot = 0
        for q in range(n):
            truth = [j for j in i_t[q] if j != q][:8]
            hits += len(set(truth) & set(i_pr[q].tolist()))
            tot += len(truth)
        return hits / tot

    # this 16-cluster shape is the PESSIMISTIC operating point (cluster
    # size ~= neighborhood size; at production csize=8192 the ratio is
    # ~50x better) — measured ~0.74 at p=4 and ~0.9 at p=8 (this exact
    # seed); pin graceful degradation + the trend
    r4, r8 = cand_recall(4), cand_recall(8)
    assert r4 > 0.65, f"candidate recall p=4 {r4:.3f}"
    assert r8 > 0.85, f"candidate recall p=8 {r8:.3f}"
    assert r8 > r4, "recall must improve with probes"


@pytest.mark.slow
def test_probed_build_quality(fps):
    """Full build with probes= on clustered data: search recall within a
    small delta of the exact build's."""
    from rad_tpu.search.knn import search_device

    exact_g = build_hnsw_exact(fps, connectivity=8, seed=3)
    # p=8 of 24 clusters: measured search recall 0.9625 == the exact
    # build's 0.9625 at this seed (p=6: 0.932, p=4: 0.845)
    probed_g = build_hnsw_exact(fps, connectivity=8, seed=3,
                                probes=8, probe_csize=128,
                                q_block=128, col_block=128,
                                approx_recall=None, probe_min_n=0)
    rng = np.random.default_rng(5)
    q = fps[rng.choice(fps.shape[0], 128, replace=False)]

    def recall(g):
        import jax.numpy as jnp
        d_t, i_t = bruteforce_topk(jnp.asarray(q), g.packed, 10)
        d, i = search_device(g, q, k=10, expansion_search=64)
        i, i_t = np.asarray(i), np.asarray(i_t)
        return np.mean([len(set(i[r].tolist()) & set(i_t[r].tolist()))
                        for r in range(q.shape[0])]) / 10

    r_ex, r_pr = recall(exact_g), recall(probed_g)
    assert r_pr >= r_ex - 0.03, f"probed {r_pr:.3f} vs exact {r_ex:.3f}"


def test_probed_build_deterministic(fps):
    g1 = build_hnsw_exact(fps, connectivity=8, seed=3, probes=6,
                          probe_csize=128, q_block=128, col_block=128,
                          probe_min_n=0)
    g2 = build_hnsw_exact(fps, connectivity=8, seed=3, probes=6,
                          probe_csize=128, q_block=128, col_block=128,
                          probe_min_n=0)
    for a, b in zip(g1.neighbors, g2.neighbors):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_probes_gate_small_layer(fps):
    """A layer with fewer than 4*probes clusters keeps the exact stage —
    the build must be bit-identical to probes=None."""
    g_pr = build_hnsw_exact(fps, connectivity=8, seed=3, probes=64)
    g_ex = build_hnsw_exact(fps, connectivity=8, seed=3)
    for a, b in zip(g_pr.neighbors, g_ex.neighbors):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_cluster_probes_matches_dense_oracle(fps):
    """The chunked min-linkage matrix (bounded device blocks, r3: the
    one-shot [C*sample, C*sample] form ResourceExhausted at 10M) must
    reproduce the dense numpy computation exactly — same sampled reps,
    same min reduction, same probe ordering."""
    from rad_tpu.fp.pack import popcount_rows_np

    csize = 256
    perm = bisect_clusters(fps, csize, seed=2)
    c = perm.size // csize
    probes, sample, seed = 5, 8, 7
    tab = cluster_probes(fps, perm, csize, probes=probes, sample=sample,
                         seed=seed)

    # oracle: identical sampling protocol, dense distance matrix
    rng = np.random.default_rng(seed)
    reps = np.zeros((c, sample, fps.shape[1]), np.uint32)
    for ci in range(c):
        members = perm[ci * csize:(ci + 1) * csize]
        real = members[members >= 0]
        take = rng.choice(real.size, size=sample,
                          replace=real.size < sample)
        reps[ci] = fps[real[take]]
    flat = reps.reshape(c * sample, -1)
    pops = popcount_rows_np(flat).astype(np.float64)
    inter = popcount_rows_np(
        flat[:, None, :] & flat[None, :, :]).astype(np.float64)
    union = pops[:, None] + pops[None, :] - inter
    d = 1.0 - inter / np.maximum(union, 1.0)
    dcc = d.reshape(c, sample, c, sample).min(axis=(1, 3))
    np.fill_diagonal(dcc, -1.0)
    order = np.argsort(dcc, axis=1, kind="stable")[:, :probes]
    expect = np.sort(order, axis=1)
    assert np.array_equal(tab, expect)


def test_qblock_probes_shape_and_self(fps):
    from rad_tpu.build.probe import qblock_probes

    csize, qb = 256, 128
    perm = bisect_clusters(fps, csize, seed=2)
    nq = perm.size // qb
    tab = qblock_probes(fps, perm, csize, qb, probes=5, sample=8, seed=7)
    assert tab.shape == (nq, 5)
    qpc = csize // qb
    for qi in range(nq):
        if np.any(perm[qi * qb:(qi + 1) * qb] >= 0):
            assert qi // qpc in tab[qi].tolist()  # own cluster present
        row = tab[qi]
        live = row[row >= 0]
        assert np.array_equal(live, np.sort(live))  # ascending scan order


def test_qblock_probes_equal_cluster_when_csize_is_qblock(fps):
    """At csize == q_block the two granularities sample the same groups;
    probe lists coincide given the same seed."""
    from rad_tpu.build.probe import qblock_probes

    csize = 256
    perm = bisect_clusters(fps, csize, seed=2)
    a = cluster_probes(fps, perm, csize, probes=4, sample=8, seed=9)
    b = qblock_probes(fps, perm, csize, csize, probes=4, sample=8, seed=9)
    assert np.array_equal(a, b)


def test_qblock_granularity_candidate_recall_not_worse(fps):
    """Per-q-block probe lists must not lose candidate recall vs
    per-cluster lists at equal probes (they are strictly finer)."""
    import jax.numpy as jnp

    n = 2048
    sub = np.ascontiguousarray(fps[:n])
    packed_l = jnp.asarray(sub)
    k, qb, csz = 16, 128, 256              # 8 clusters, 2 qblocks each
    d_t, i_t = bruteforce_topk(packed_l, packed_l, k + 1)
    i_t = np.asarray(i_t)

    def cand_recall(gran, p):
        _, i_pr = ex._allpairs_topk_probed(
            packed_l, n, k, qb, csz, impl="swar",
            approx_recall=None, bucket=None, interpret=False, probes=p,
            probe_sample=8, seed=0,
            pairs_per_dispatch=ex.PAIRS_PER_DISPATCH,
            probe_granularity=gran)
        i_pr = np.asarray(i_pr)
        hits = tot = 0
        for q in range(n):
            truth = [j for j in i_t[q] if j != q][:8]
            hits += len(set(truth) & set(i_pr[q].tolist()))
            tot += len(truth)
        return hits / tot

    r_cl = cand_recall("cluster", 3)
    r_qb = cand_recall("qblock", 3)
    assert r_qb >= r_cl - 0.01, f"qblock {r_qb:.3f} < cluster {r_cl:.3f}"


def test_probe_width_padding_is_bitidentical(fps):
    """probe_width pads the scan with dead (-1) clusters: results must be
    bit-identical to the unpadded run (only compile shape changes)."""
    g1 = build_hnsw_exact(fps, connectivity=8, seed=3, probes=6,
                          probe_csize=128, q_block=128, col_block=128,
                          probe_min_n=0)
    g2 = build_hnsw_exact(fps, connectivity=8, seed=3, probes=6,
                          probe_csize=128, q_block=128, col_block=128,
                          probe_width=12, probe_min_n=0)
    for a, b in zip(g1.neighbors, g2.neighbors):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_stream_select_bit_identical():
    """The streamed scan+select path (candidate tables never
    materialized — the 30M single-chip memory-wall fix) produces the
    exact same graph as scatter-then-select."""
    from rad_tpu.build.exact import build_hnsw_exact
    from rad_tpu.fp import random_fingerprints

    fps = random_fingerprints(3000, n_bits=128, density=0.2, seed=21)
    kw = dict(connectivity=8, seed=11, q_block=128, col_block=128,
              sel_block=128, probes=3, probe_csize=256, probe_min_n=0,
              probe_sample=4)
    g_tab = build_hnsw_exact(fps, stream_select=False, **kw)
    g_str = build_hnsw_exact(fps, stream_select=True, **kw)
    for lt, ls in zip(g_tab.neighbors, g_str.neighbors):
        np.testing.assert_array_equal(np.asarray(lt), np.asarray(ls))
