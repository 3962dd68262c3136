"""Cluster-probed candidate generation for the exact builder.

The exact builder's all-pairs stage is O(N²) distance evaluations — the
right trade at 1e5 nodes (seconds of tensor-core time) but the wall at
1e6+ (10M would be ~1e14 evaluations). This module makes the candidate
stage subquadratic the accelerator's way: instead of pruning with a
sequential beam search (the CPU/usearch answer, latency-bound on a device),
it partitions the library into balanced, physically contiguous clusters
and lets every query block scan only its P most-proximate clusters — each
scan still a full-width distance block, so the machine keeps running at
kernel rate while evaluating an O(N·P·csize) subset.

Two pieces:

* :func:`bisect_clusters` — balanced two-anchor median bisection
  (Annoy-style: score = d(x, a) − d(x, b) for two random members a, b of
  the current group, split at the median). Every split is exact, so the
  final clusters all have exactly ``csize`` members (the last few carry
  the <csize padding). Anchor distances are computed on device (one
  compiled program reused across all levels); the per-level median
  ordering is one host lexsort. Deterministic given (data, seed).
* :func:`cluster_probes` — per-cluster probe lists: sample ``sample``
  members per cluster, evaluate the sampled cross-cluster distance matrix
  on device, and take each cluster's ``probes`` nearest clusters by
  MIN sampled member distance (self always first). Min-linkage is the
  right proximity for candidate recall: a single close pair of members
  means the boundary region between the clusters holds true neighbors.

The probed all-pairs driver itself lives in :mod:`rad_tpu.build.exact`
(``probes=`` on :func:`~rad_tpu.build.exact.build_hnsw_exact`); it scans
clusters in ascending id order so results are deterministic, and maps the
permuted winner positions back to layer ids at the end.

Reference parity note: usearch has no equivalent — its insert-time beam
IS its pruning (reference examples/DUDEZ_example.ipynb:183-192). This is
the accelerator's replacement for that pruning at scales where exact
all-pairs stops being free.
"""

from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from rad_tpu.fp.backend import dist_block
from rad_tpu.fp.pack import popcount

logger = logging.getLogger(__name__)

__all__ = ["bisect_clusters", "cluster_probes", "qblock_probes"]


@jax.jit
def _bisect_scores(rows, anchors_a, anchors_b, group_id):
    """Median-split score per row: d(x, a_g) − d(x, b_g) for the row's
    group anchors. rows [n, W] uint32, anchors [C, W], group_id [n] int32
    (values < C). One compile serves every bisection level (anchor rows
    past the level's live group count are unused zeros)."""
    a = jnp.take(anchors_a, group_id, axis=0)
    b = jnp.take(anchors_b, group_id, axis=0)
    pops = jnp.sum(popcount(rows), axis=-1).astype(jnp.float32)

    def dist(t):
        inter = jnp.sum(popcount(rows & t), axis=-1).astype(jnp.float32)
        t_pop = jnp.sum(popcount(t), axis=-1).astype(jnp.float32)
        union = pops + t_pop - inter
        return 1.0 - inter / jnp.maximum(union, 1.0)

    return dist(a) - dist(b)


@partial(jax.jit, static_argnames=("chunk",))
def _bisect_scores_chunk(rows, anchors_a, anchors_b, group_id, r0,
                         chunk: int):
    """:func:`_bisect_scores` over ``chunk`` rows starting at ``r0``:
    big layers dispatch fixed-shape slices, so one compile serves every
    slice of every level and no single program grows with the layer."""
    sub = jax.lax.dynamic_slice_in_dim(rows, r0, chunk)
    gid = jax.lax.dynamic_slice_in_dim(group_id, r0, chunk)
    return _bisect_scores(sub, anchors_a, anchors_b, gid)


# rows per bisect-score dispatch past which the monolithic program is
# not attempted (a dispatch-size constant: ROADMAP design item 1)
BISECT_CHUNK = 1 << 22


def bisect_clusters(packed: np.ndarray, csize: int, seed: int = 0,
                    dev_rows=None) -> np.ndarray:
    """Partition ``n`` fingerprint rows into ``C = ceil(n / csize)``
    balanced clusters of exactly ``csize`` members each.

    Returns ``perm`` [C * csize] int32: ``perm[p]`` is the original row at
    permuted position ``p``; positions ``p // csize`` index clusters; the
    ``C*csize − n`` pad entries are −1 and always occupy the tail of the
    last cluster(s) (pad scores sort to +inf at every split).

    ``dev_rows``: optional pre-uploaded device array whose first ``n``
    rows are ``packed`` (avoids re-uploading when the caller already holds
    the layer on device — extra rows beyond ``n`` are ignored because pads
    never become anchors and pad scores are overridden on host).
    """
    n, w = packed.shape
    c = max(1, -(-n // csize))
    n_tot = c * csize
    rng = np.random.default_rng(seed)
    if c == 1:
        return np.concatenate(
            [np.arange(n, dtype=np.int32),
             np.full(n_tot - n, -1, np.int32)])
    if dev_rows is None:
        dev_rows = jnp.asarray(packed)
    n_dev = dev_rows.shape[0]

    ord_ = np.concatenate([np.arange(n, dtype=np.int64),
                           np.full(n_tot - n, -1, np.int64)])
    # groups as (start, n_clusters) spans over ord_; every split keeps
    # cluster-aligned boundaries so leaves are exactly csize
    groups = [(0, c)]
    # anchors padded to one FIXED shape across all levels: the scores
    # program compiles once per layer, not once per bisection level
    a_pad = max(1024, 1 << max(c - 1, 1).bit_length())
    while any(t > 1 for _, t in groups):
        live = [(s, t) for s, t in groups if t > 1]
        anchors_a = np.zeros((a_pad, w), np.uint32)
        anchors_b = np.zeros((a_pad, w), np.uint32)
        gid = np.zeros(n_dev, np.int32)
        for gi, (s, t) in enumerate(live):
            members = ord_[s * csize:(s + t) * csize]
            real = members[members >= 0]
            gid[real] = gi
            if real.size >= 2:
                ai, bi = rng.choice(real.size, size=2, replace=False)
                anchors_a[gi] = packed[real[ai]]
                anchors_b[gi] = packed[real[bi]]
            elif real.size == 1:
                anchors_a[gi] = packed[real[0]]
        a_dev = jnp.asarray(anchors_a)
        b_dev = jnp.asarray(anchors_b)
        gid_dev = jnp.asarray(gid)
        if n_dev <= 2 * BISECT_CHUNK:
            scores = np.asarray(_bisect_scores(
                dev_rows, a_dev, b_dev, gid_dev))[:n]
        else:
            parts = np.empty(n_dev, np.float32)
            for r0 in range(0, n_dev, BISECT_CHUNK):
                r0c = min(r0, n_dev - BISECT_CHUNK)  # overlap recomputes
                parts[r0c:r0c + BISECT_CHUNK] = np.asarray(
                    _bisect_scores_chunk(dev_rows, a_dev, b_dev,
                                         gid_dev, jnp.int32(r0c),
                                         chunk=BISECT_CHUNK))
            scores = parts[:n]
        gid_ord = np.empty(n_tot, np.uint64)
        s_ord = np.full(n_tot, np.inf, np.float32)
        for gi, (s, t) in enumerate(groups):
            gid_ord[s * csize:(s + t) * csize] = gi
        valid = ord_ >= 0
        s_ord[valid] = scores[ord_[valid]]
        # one stable single-key sort on a packed (group, score) u64 key —
        # bit-identical to lexsort((pos, score, group)) (the float bits
        # map monotonically to u32; stability supplies the position
        # tie-break; pads (+inf) fall to each group's tail) but ~2.5×
        # faster at 10M rows (measured 1.7 s vs 4.3 s per level)
        sb = s_ord.view(np.uint32)
        sb = np.where(sb & 0x80000000,
                      ~sb, sb | np.uint32(0x80000000)).astype(np.uint64)
        order = np.argsort((gid_ord << np.uint64(32)) | sb, kind="stable")
        ord_ = ord_[order]
        nxt = []
        for s, t in groups:
            if t == 1:
                nxt.append((s, t))
            else:
                tl = t // 2
                nxt.append((s, tl))
                nxt.append((s + tl, t - tl))
        groups = nxt
    return ord_.astype(np.int32)


def cluster_probes(packed: np.ndarray, perm: np.ndarray, csize: int,
                   probes: int, sample: int = 16, seed: int = 0,
                   impl: str = "swar") -> np.ndarray:
    """Per-cluster probe lists over a :func:`bisect_clusters` partition.

    Returns [C, probes] int32: cluster ``c``'s probe targets, ascending
    cluster id (deterministic scan order for the merge), −1-padded. The
    own cluster is always present. Proximity = MIN distance over
    ``sample``×``sample`` sampled member pairs, evaluated on device in one
    distance call (C·sample ≤ a few tens of thousands rows → trivial
    work).
    """
    n, w = packed.shape
    c = perm.size // csize
    probes = min(probes, c)
    rng = np.random.default_rng(seed)
    reps = np.zeros((c, sample, w), np.uint32)
    empty = np.zeros(c, np.bool_)
    for ci in range(c):
        members = perm[ci * csize:(ci + 1) * csize]
        real = members[members >= 0]
        if real.size == 0:
            empty[ci] = True
            continue
        take = rng.choice(real.size, size=sample, replace=real.size < sample)
        reps[ci] = packed[real[take]]
    nr = c * sample
    flat = jnp.asarray(reps.reshape(nr, w))
    # [C, C] min-linkage matrix in bounded query chunks: the one-shot
    # [C*sample, C*sample] form is ~1.5 GB of f32 at C~1200 on a device
    # already holding the layer (measured ResourceExhausted at 10M), and
    # O(C²·sample²) beyond — each fixed-shape chunk is ≤ a few hundred MB
    # and compiles once
    qcb = max(1, min(c, (1 << 26) // max(nr, 1) // sample))
    dcc = np.empty((c, c), np.float32)
    for c0 in range(0, c, qcb):
        c0c = min(c0, c - qcb)  # fixed shape; overlap re-computes, idempotent
        q = jax.lax.dynamic_slice(flat, (c0c * sample, 0),
                                  (qcb * sample, w))
        d = dist_block(q, flat, impl)
        blk = np.array(jnp.min(
            d.reshape(qcb, sample, c, sample), axis=(1, 3)))
        dcc[c0c:c0c + qcb] = blk
    dcc[empty, :] = np.inf
    dcc[:, empty] = np.inf
    np.fill_diagonal(dcc, -1.0)  # self is always the first probe
    return _probe_lists(dcc, probes)


def _probe_lists(dmat: np.ndarray, probes: int) -> np.ndarray:
    """Top-``probes`` ascending-id probe lists from a proximity matrix
    (rows = scanning groups, cols = clusters; inf = never probe)."""
    order = np.argsort(dmat, axis=1, kind="stable")[:, :probes]
    chosen_d = np.take_along_axis(dmat, order, axis=1)
    out = np.where(np.isfinite(chosen_d), order, -1).astype(np.int32)
    # ascending cluster id per row (−1 pads last) → deterministic merges
    key = np.where(out >= 0, out, np.iinfo(np.int32).max)
    out = np.sort(key, axis=1)
    return np.where(out == np.iinfo(np.int32).max, -1, out).astype(np.int32)


def qblock_probes(packed: np.ndarray, perm: np.ndarray, csize: int,
                  q_block: int, probes: int, sample: int = 16,
                  seed: int = 0, impl: str = "swar") -> np.ndarray:
    """Per-QUERY-BLOCK probe lists: the finer-grained form of
    :func:`cluster_probes` (closing the probed-build
    recall gap).

    With per-cluster lists, every query in a cluster scans the same
    ``probes`` clusters, so queries sitting near a cluster boundary lose
    the neighbors that live just across a boundary their cluster's list
    does not cover. Here each ``q_block``-row scan group (the granularity
    the probed driver actually dispatches) picks its own ``probes``
    nearest clusters by MIN distance from ``sample`` of its own members
    to each cluster's sampled members — same scan cost at equal
    ``probes``, strictly finer coverage (at ``csize == q_block`` the two
    coincide). The group's own cluster is always its first probe.

    Returns [NQ, probes] int32, ascending cluster ids, −1-padded, where
    ``NQ = perm.size // q_block``. Extra device cost is one sampled
    [NQ·sample, C·sample] distance sweep — trivial work, chunked to
    bounded blocks like :func:`cluster_probes`.
    """
    n, w = packed.shape
    c = perm.size // csize
    nq = perm.size // q_block
    qpc = csize // q_block
    probes = min(probes, c)
    rng = np.random.default_rng(seed)

    # db side: per-cluster sampled reps (same convention as cluster_probes)
    reps = np.zeros((c, sample, w), np.uint32)
    empty = np.zeros(c, np.bool_)
    for ci in range(c):
        members = perm[ci * csize:(ci + 1) * csize]
        real = members[members >= 0]
        if real.size == 0:
            empty[ci] = True
            continue
        take = rng.choice(real.size, size=sample, replace=real.size < sample)
        reps[ci] = packed[real[take]]
    nr = c * sample
    flat = jnp.asarray(reps.reshape(nr, w))

    # query side: per-q-block sampled reps. At q_block == csize the scan
    # groups ARE the clusters — reuse the same reps so the lists coincide
    # exactly with cluster_probes (pinned by tests/test_build_probe.py)
    if q_block == csize:
        qreps, qempty = reps, empty
    else:
        qreps = np.zeros((nq, sample, w), np.uint32)
        qempty = np.zeros(nq, np.bool_)
        for qi in range(nq):
            members = perm[qi * q_block:(qi + 1) * q_block]
            real = members[members >= 0]
            if real.size == 0:
                qempty[qi] = True
                continue
            take = rng.choice(real.size, size=sample,
                              replace=real.size < sample)
            qreps[qi] = packed[real[take]]
    qflat = jnp.asarray(qreps.reshape(nq * sample, w))

    qcb = max(1, min(nq, (1 << 26) // max(nr, 1) // sample))
    dqc = np.empty((nq, c), np.float32)
    for q0 in range(0, nq, qcb):
        q0c = min(q0, nq - qcb)  # fixed shape; overlap re-computes
        q = jax.lax.dynamic_slice(qflat, (q0c * sample, 0),
                                  (qcb * sample, w))
        d = dist_block(q, flat, impl)
        blk = np.array(jnp.min(
            d.reshape(qcb, sample, c, sample), axis=(1, 3)))
        dqc[q0c:q0c + qcb] = blk
    dqc[qempty, :] = np.inf
    dqc[:, empty] = np.inf
    own = np.arange(nq) // qpc
    live_q = ~qempty & ~empty[own]
    dqc[np.flatnonzero(live_q), own[live_q]] = -1.0  # own cluster first
    return _probe_lists(dqc, probes)
