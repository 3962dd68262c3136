"""Exact-kNN HNSW construction: the tensor cores do the work.

The accelerator's answer to the build-throughput target (BASELINE: >=10x
CPU build per chip). usearch builds incrementally — greedy descent + an
``expansion_add``-wide beam per inserted vector (reference call site
examples/DUDEZ_example.ipynb:183-192) — because on a CPU that is the only
affordable way to find each node's neighbors. On an accelerator the
economics invert: Tanimoto distances are int8 matrix products, so the
EXACT all-pairs top-K for an entire 100k-1M layer costs seconds of
tensor-core time, while the beam's sequential while-loop is latency-bound
(hundreds of lockstep iterations of tiny ops).

So this builder skips the beam entirely:

1. sample all levels up front, order nodes level-descending (the
   rad_tpu.graph.storage id scheme);
2. per layer l (top -> 0): blocked exact top-K among the layer's nodes
   (distance blocks + running top-k merge — never materializes the
   [N_l, N_l] matrix);
3. vectorized neighbor-selection heuristic (Algorithm 4, same routine the
   beam builder uses) over the exact candidate lists;
4. symmetrize: forward + reverse edges sorted by (destination, distance),
   each row keeps its distance-best ``cap`` incident edges — the global
   form of the beam builder's reverse-link merge.

Exactness dominates quality: candidates are the TRUE nearest neighbors,
i.e. the ``expansion_add -> N`` limit of the beam search, so recall at
equal M meets or beats any incremental build (pinned against the native
builder in tests/test_build_exact.py). Cost is O(N^2) distances — the
regime where this wins is exactly the reference's benchmark scale (1e5-1e6
molecules, seconds of device time); past ~4M nodes prefer the batched beam
builder (rad_tpu.build.device) or partition-and-stitch
(rad_tpu.build.partition), whose shards can each use this builder.
"""

from __future__ import annotations

import logging
import math
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from rad_tpu.build.reference import sample_levels
from rad_tpu.fp.backend import bucketmin_keys, dist_block, tanimoto_impl
from rad_tpu.fp.pack import popcount_rows_np
from rad_tpu.fp.tanimoto import decode_bucket_keys
from rad_tpu.graph.storage import HNSWGraph

logger = logging.getLogger(__name__)

__all__ = ["build_hnsw_exact"]

INF = jnp.inf


def _merge_topk(cat_d, cat_i, k: int):
    """Smallest-k (d, id) columns of a candidate block via ONE stable
    variadic sort.

    Bit-identical to ``lax.top_k(-d, k)`` + ``take_along_axis`` on the
    ids — a stable ascending sort realizes exactly top_k's smaller-index
    tie preference — but co-sorts the ids as a sort payload instead of
    letting XLA's top_k lowering sort an iota and GATHER the ids by
    it."""
    sd, si = jax.lax.sort((cat_d, cat_i), num_keys=1, is_stable=True)
    return sd[:, :k], si[:, :k]


def _make_one_qblock(packed, n_real, k: int, q_block: int, col_block: int,
                     impl: str, approx_recall: float | None,
                     bucket: int | None, interpret: bool):
    """The shared per-q-block body of the all-pairs top-k (see
    :func:`_allpairs_topk` for the reduction semantics)."""
    n_pad, w = packed.shape
    nc = n_pad // col_block

    def one_qblock(qi):
        q = jax.lax.dynamic_slice(packed, (qi * q_block, 0), (q_block, w))
        q_ids = qi * q_block + jnp.arange(q_block, dtype=jnp.int32)

        def body(carry, ci):
            best_d, best_i = carry
            db = jax.lax.dynamic_slice(packed, (ci * col_block, 0),
                                       (col_block, w))
            if bucket is not None:
                keys = bucketmin_keys(q, db, bucket, impl, interpret)
                blk_d, local = decode_bucket_keys(keys, bucket)
                blk_i = ci * col_block + local
                bad = (blk_i >= n_real) | (blk_i == q_ids[:, None])
                blk_d = jnp.where(bad, INF, blk_d)
                blk_i = jnp.where(bad, -1, blk_i)
                cat_d = jnp.concatenate([best_d, blk_d], axis=1)
                cat_i = jnp.concatenate([best_i, blk_i], axis=1)
                return _merge_topk(cat_d, cat_i, k), None
            d = dist_block(q, db, impl)
            ids = ci * col_block + jnp.arange(col_block,
                                             dtype=jnp.int32)[None, :]
            bad = (ids >= n_real) | (ids == q_ids[:, None])  # pad + self
            d = jnp.where(bad, INF, d)
            if approx_recall is not None:
                neg_blk, arg_blk = jax.lax.approx_max_k(
                    -d, k, recall_target=approx_recall)
                blk_d = -neg_blk
                blk_i = ci * col_block + arg_blk.astype(jnp.int32)
                blk_i = jnp.where(jnp.isfinite(blk_d), blk_i, -1)
            else:
                blk_d, blk_i = _merge_topk(
                    d, jnp.broadcast_to(ids, d.shape), k)
            # exact merge of per-block winners: [q_block, 2k] only
            cat_d = jnp.concatenate([best_d, blk_d], axis=1)
            cat_i = jnp.concatenate([best_i, blk_i], axis=1)
            return _merge_topk(cat_d, cat_i, k), None

        init = (jnp.full((q_block, k), INF),
                jnp.full((q_block, k), -1, jnp.int32))
        (bd, bi), _ = jax.lax.scan(body, init,
                                   jnp.arange(nc, dtype=jnp.int32))
        return bd, bi

    return one_qblock


@partial(jax.jit,
         static_argnames=("k", "q_block", "col_block", "impl",
                          "approx_recall", "bucket", "interpret"))
def _allpairs_topk(packed, n_real, k: int, q_block: int, col_block: int,
                   impl: str, approx_recall: float | None,
                   bucket: int | None = None, interpret: bool = False):
    """Top-k neighbor ids+dists for every row of ``packed`` against all
    rows (self excluded), blocked in both dimensions.

    packed: [N_pad, W] (rows >= n_real are zero padding). Returns
    (dists [N_pad, k], ids [N_pad, k]) — padded query rows return junk.

    Per-block reduction: ``approx_recall`` (default 0.99 at the caller)
    uses ``lax.approx_max_k``; ``None`` is the fully exact sort-based
    reduction. The cross-block merge of per-block winners stays EXACT (a
    [*, 2k] top_k).

    ``bucket`` (the default at large layers) switches the per-block
    reduction to one winner per ``bucket`` columns
    (:func:`rad_tpu.fp.backend.bucketmin_keys`: on the GPU the
    Pallas-Triton kernel, so the [q_block, col_block] distance block
    never reaches device memory). A query's self-bucket winner is the
    query itself (dist 0), so that bucket's runner-up is lost — the same
    class of approximation as ``approx_max_k``, and the cross-block merge
    of winners is still exact.
    """
    n_pad, w = packed.shape
    nq = n_pad // q_block
    one_qblock = _make_one_qblock(packed, n_real, k, q_block, col_block,
                                  impl, approx_recall, bucket, interpret)
    dists, ids = jax.lax.map(one_qblock,
                             jnp.arange(nq, dtype=jnp.int32))
    return dists.reshape(n_pad, k), ids.reshape(n_pad, k)


@partial(jax.jit,
         static_argnames=("k", "q_block", "col_block", "impl",
                          "approx_recall", "bucket", "interpret", "q_span"))
def _allpairs_topk_span(packed, n_real, q0, k: int, q_block: int,
                        col_block: int, impl: str,
                        approx_recall: float | None,
                        bucket: int | None, interpret: bool, q_span: int):
    """:func:`_allpairs_topk` restricted to ``q_span`` q-blocks starting
    at q-block index ``q0`` (traced). One host-dispatched span = one
    bounded device program — see :func:`_allpairs_topk_chunked`."""
    one_qblock = _make_one_qblock(packed, n_real, k, q_block, col_block,
                                  impl, approx_recall, bucket, interpret)
    dists, ids = jax.lax.map(
        one_qblock, q0 + jnp.arange(q_span, dtype=jnp.int32))
    return dists.reshape(q_span * q_block, k), ids.reshape(
        q_span * q_block, k)


# Dispatch-size constants (ROADMAP design item 1: each stays until an
# H100 build cell shows it can go). The chunked all-pairs driver runs one
# device program per ~PAIRS_PER_DISPATCH distance evaluations; the
# adaptive re-span grows a span toward DISPATCH_TARGET_S per program, and
# only when the projected remaining stage time exceeds
# RESPAN_MIN_REMAINING_S (the grown span is a new program to compile).
PAIRS_PER_DISPATCH = 1.5e11
DISPATCH_TARGET_S = 10.0
RESPAN_MIN_REMAINING_S = 600.0

# stream_select="auto" fuses selection into the probed scan when the
# [n_pad, k] candidate tables would exceed this many bytes of device
# memory (5.1 GB at 10M and 7.7 GB at 30M/M=8; streaming never
# materializes them).
STREAM_SELECT_BYTES = 6 << 30


def _allpairs_topk_chunked(packed, n_real, k: int, q_block: int,
                           col_block: int, impl: str,
                           approx_recall: float | None,
                           bucket: int | None = None,
                           interpret: bool = False,
                           pairs_per_dispatch: float = PAIRS_PER_DISPATCH):
    """All-pairs top-k as a HOST loop of bounded device programs.

    Identical results to :func:`_allpairs_topk` (same per-q-block body,
    q-blocks are independent), but no single device program exceeds
    ~``pairs_per_dispatch`` distance evaluations.

    Falls back to the one-program form when the whole problem fits one
    dispatch, so sub-300k builds keep their existing compiled path.
    """
    n_pad, _ = packed.shape
    nq = n_pad // q_block
    q_span = max(1, int(pairs_per_dispatch // (q_block * n_pad)))
    if q_span >= nq:
        return _allpairs_topk(packed, n_real, k, q_block, col_block,
                              impl, approx_recall, bucket=bucket,
                              interpret=interpret)
    d_parts, i_parts = [], []
    covered = 0   # rows already emitted
    q0 = 0        # next q-block to cover
    n_done = 0    # dispatches at the current span (for the re-span probe)
    while q0 < nq:
        q0c = min(q0, nq - q_span)  # tail span overlaps; slices dedup
        t0 = time.perf_counter()
        bd, bi = _allpairs_topk_span(
            packed, n_real, jnp.int32(q0c), k, q_block, col_block,
            impl, approx_recall, bucket, interpret, q_span)
        np.asarray(bi[-1:, -1:])  # wait, so the timing below is the span's
        dt = time.perf_counter() - t0
        skip = covered - q0c * q_block
        d_parts.append(bd[skip:] if skip else bd)
        i_parts.append(bi[skip:] if skip else bi)
        covered = (q0c + q_span) * q_block
        q0 = q0c + q_span
        n_done += 1
        # adaptive re-span (once): measure dispatch #2 (dispatch #1
        # carries the compile), and if the program is far under budget,
        # grow the span by a POWER OF TWO (quantized so the new shape's
        # compile is cache-stable across runs). One growth only: one
        # extra compile.
        remaining_s = dt * max(0, (nq - q0)) / q_span
        if (n_done == 2 and dt < DISPATCH_TARGET_S / 2 and q0 < nq
                and remaining_s > RESPAN_MIN_REMAINING_S):
            factor = 1 << max(0, int(np.log2(DISPATCH_TARGET_S / dt)))
            new_span = min(q_span * factor, nq - q0)
            if new_span > q_span:
                logger.info(
                    "all-pairs re-span: %.2fs/program at q_span=%d -> "
                    "q_span=%d (one extra compile)", dt, q_span, new_span)
                q_span = new_span
    return (jnp.concatenate(d_parts, axis=0),
            jnp.concatenate(i_parts, axis=0))


def _make_one_qblock_probed(packed_cl, perm_cl, scan_cols, k: int,
                            q_block: int, csize: int, impl: str,
                            approx_recall: float | None, bucket: int | None,
                            interpret: bool):
    """Per-q-block body of the cluster-probed top-k (see
    :func:`_allpairs_topk_probed`). Operates entirely in PERMUTED space:
    ``packed_cl`` is the cluster-contiguous copy of the layer rows,
    ``perm_cl[p]`` the layer id at permuted position ``p`` (−1 pads), and
    candidate ids carried through the merges are permuted positions
    (mapped back by the caller). ``scan_cols`` holds the probe targets
    ascending (−1 pads skipped via masking) — one row per CLUSTER
    (cluster_probes) or one row per Q-BLOCK (qblock_probes), told apart
    by the row count."""
    n_tot, w = packed_cl.shape
    qpc = csize // q_block
    nq = n_tot // q_block
    p = scan_cols.shape[1]
    # per-qblock lists index directly; per-cluster lists by qi // qpc.
    # (nq == n_tot//csize only when csize == q_block, where they agree.)
    sdiv = 1 if scan_cols.shape[0] == nq else qpc

    def one_qblock(qi):
        q = jax.lax.dynamic_slice(packed_cl, (qi * q_block, 0),
                                  (q_block, w))
        q_pos = qi * q_block + jnp.arange(q_block, dtype=jnp.int32)
        cols = jax.lax.dynamic_slice(scan_cols, (qi // sdiv, 0), (1, p))[0]

        def body(carry, ci):
            best_d, best_i = carry
            live = ci >= 0
            cs = jnp.maximum(ci, 0)
            db = jax.lax.dynamic_slice(packed_cl, (cs * csize, 0),
                                       (csize, w))
            blk_perm = jax.lax.dynamic_slice(perm_cl, (cs * csize,),
                                             (csize,))
            if bucket is not None:
                keys = bucketmin_keys(q, db, bucket, impl, interpret)
                blk_d, local = decode_bucket_keys(keys, bucket)
                blk_pos = cs * csize + local
                wperm = blk_perm[local]
                bad = (~live) | (wperm < 0) | (blk_pos == q_pos[:, None])
                blk_d = jnp.where(bad, INF, blk_d)
                blk_i = jnp.where(bad, -1, blk_pos)
            else:
                d = dist_block(q, db, impl)
                pos = cs * csize + jnp.arange(csize,
                                              dtype=jnp.int32)[None, :]
                bad = ((~live) | (blk_perm[None, :] < 0)
                       | (pos == q_pos[:, None]))
                d = jnp.where(bad, INF, d)
                if approx_recall is not None:
                    neg_blk, arg_blk = jax.lax.approx_max_k(
                        -d, k, recall_target=approx_recall)
                    blk_d = -neg_blk
                    blk_i = cs * csize + arg_blk.astype(jnp.int32)
                    blk_i = jnp.where(jnp.isfinite(blk_d), blk_i, -1)
                else:
                    blk_d, blk_i = _merge_topk(
                        d, jnp.broadcast_to(pos, d.shape), k)
            cat_d = jnp.concatenate([best_d, blk_d], axis=1)
            cat_i = jnp.concatenate([best_i, blk_i], axis=1)
            return _merge_topk(cat_d, cat_i, k), None

        init = (jnp.full((q_block, k), INF),
                jnp.full((q_block, k), -1, jnp.int32))
        (bd, bi), _ = jax.lax.scan(body, init, cols)
        return bd, bi

    return one_qblock


@partial(jax.jit,
         static_argnames=("k", "q_block", "csize", "impl",
                          "approx_recall", "bucket", "interpret", "q_span"))
def _probed_topk_span(packed_cl, perm_cl, scan_cols, q0, k: int,
                      q_block: int, csize: int, impl: str,
                      approx_recall: float | None, bucket: int | None,
                      interpret: bool, q_span: int):
    one = _make_one_qblock_probed(packed_cl, perm_cl, scan_cols, k,
                                  q_block, csize, impl,
                                  approx_recall, bucket, interpret)
    d, i = jax.lax.map(one, q0 + jnp.arange(q_span, dtype=jnp.int32))
    return (d.reshape(q_span * q_block, k),
            i.reshape(q_span * q_block, k))


@partial(jax.jit,
         static_argnames=("m", "heuristic_k", "sel_block", "int8_pairs"))
def _select_span_permuted(packed, pops, bd, bpos, perm_cl, q0_rows,
                          m: int, heuristic_k: int, sel_block: int,
                          int8_pairs: bool):
    """Diversity-select one scan span's candidates in PERMUTED row
    order — the middle program of the streamed scan→select→scatter
    triple. Mirrors :func:`_select_layer_span` with two deltas: query
    ids come from the permutation slice, and candidate positions are
    mapped to layer ids by one gather. The three programs chain on
    device with no host round trip."""
    from rad_tpu.build.device import _dist_rows, _select_neighbors

    s_rows, k = bd.shape
    ids_true = jnp.where(bpos >= 0,
                         jnp.take(perm_cl, jnp.maximum(bpos, 0)),
                         jnp.int32(-1))
    perm_span = jax.lax.dynamic_slice(perm_cl, (q0_rows,), (s_rows,))

    nch = s_rows // sel_block

    def one_sel(chunk):
        cd, ci, qi = chunk
        active = qi >= 0  # perm pads; real perm entries are < n_real
        safe_q = jnp.where(active, qi, 0)
        sel = _select_neighbors(packed, pops, safe_q, cd, ci, m,
                                heuristic_k, active, int8_pairs=int8_pairs)
        sel_d = _dist_rows(packed, pops, safe_q, sel,
                           (sel >= 0) & active[:, None])
        return sel, sel_d

    sel, sel_d = jax.lax.map(
        one_sel, (bd.reshape(nch, sel_block, k),
                  ids_true.reshape(nch, sel_block, k),
                  perm_span.reshape(nch, sel_block)))
    return sel.reshape(s_rows, -1), sel_d.reshape(s_rows, -1), perm_span


@partial(jax.jit, donate_argnums=(0, 1))
def _scatter_sel_span(sel_out, sel_d_out, perm_span, sel, sel_d):
    """Scatter a permuted span's selections into layer-row order (the
    streamed pipeline's last, trivial program — pad rows drop)."""
    n_out = sel_out.shape[0]
    rows = jnp.where(perm_span >= 0, perm_span, n_out)
    return (sel_out.at[rows].set(sel, mode="drop"),
            sel_d_out.at[rows].set(sel_d, mode="drop"))


@partial(jax.jit, donate_argnums=(0, 1))
def _probed_scatter_span(out_d, out_i, perm_span, span_d, span_pos,
                         perm_cl):
    """Scatter a permuted-space span's results into layer-id order and
    map the winner positions to layer ids; pad rows (perm −1) drop."""
    n_pad = out_d.shape[0]
    ids_true = jnp.where(span_pos >= 0,
                         jnp.take(perm_cl, jnp.maximum(span_pos, 0)),
                         jnp.int32(-1))
    rows = jnp.where(perm_span >= 0, perm_span, n_pad)
    return (out_d.at[rows].set(span_d, mode="drop"),
            out_i.at[rows].set(ids_true, mode="drop"))


def _allpairs_topk_probed(packed_l, n_real: int, k: int, q_block: int,
                          csize: int, impl: str,
                          approx_recall: float | None, bucket: int | None,
                          interpret: bool, probes: int, probe_sample: int,
                          seed: int, pairs_per_dispatch: float,
                          packed_host: np.ndarray | None = None,
                          mesh=None, mesh_axis: str = "graph",
                          probe_granularity: str = "qblock",
                          probe_width: int | None = None,
                          select_stream: tuple | None = None):
    """Cluster-probed top-k: the subquadratic form of
    :func:`_allpairs_topk_chunked`.

    Partitions the layer into ``C = ceil(n_real / csize)`` balanced
    clusters (:func:`rad_tpu.build.probe.bisect_clusters`), gives each
    cluster a ``probes``-long probe list by sampled min member distance
    (:func:`rad_tpu.build.probe.cluster_probes`), and evaluates each
    query block only against its cluster's probed clusters —
    O(N·probes·csize) distance evaluations instead of O(N²), every block
    still a full-width distance call. Candidates are exact *within the
    probed set*; quality is governed by ``probes``. Same return
    convention as the exact driver:
    ([n_pad, k] dists, [n_pad, k] layer ids), ascending, −1/INF pads.

    ``probe_granularity``: "qblock" (default) computes one probe list per
    dispatched q-block (:func:`rad_tpu.build.probe.qblock_probes` —
    strictly finer coverage at equal scan cost), "cluster" one per
    cluster. ``probe_width`` pads the probe lists to a fixed width with
    −1 (masked, still scanned as dead iterations): lets recall sweeps
    over ``probes`` reuse ONE compile, at the cost of scanning
    ``probe_width`` clusters' worth of kernel time — use only for
    sweeps, never for throughput numbers.

    ``select_stream``: ``(pops, m, heuristic_k, sel_block, int8_pairs)``
    — fuse diversity SELECTION into each scan span and return
    ``(sel [n_pad, m], sel_d [n_pad, m])`` instead of candidate tables
    (:func:`_probed_span_select`): the [n_pad, k] candidate tables are
    never materialized, removing the memory wall that caps single-card
    builds (~15 GB at 30M nodes). Bit-identical to
    scan-then-select (selection is per-row). Single-device path only.
    """
    from rad_tpu.build.probe import (bisect_clusters, cluster_probes,
                                     qblock_probes)

    n_pad, w = packed_l.shape
    if csize % q_block:
        raise ValueError(f"probe csize {csize} must be a multiple of "
                         f"q_block {q_block}")
    if k > csize:
        raise ValueError(f"candidates k={k} exceeds probe csize {csize}")
    if packed_host is None:
        packed_host = np.asarray(packed_l[:n_real])
    perm = bisect_clusters(packed_host, csize, seed=seed,
                           dev_rows=packed_l)
    if probe_granularity == "qblock":
        probe_tab = qblock_probes(packed_host, perm, csize, q_block,
                                  probes, sample=probe_sample,
                                  seed=seed + 1, impl=impl)
    elif probe_granularity == "cluster":
        probe_tab = cluster_probes(packed_host, perm, csize, probes,
                                   sample=probe_sample, seed=seed + 1,
                                   impl=impl)
    else:
        raise ValueError(
            f"unknown probe_granularity {probe_granularity!r}")
    if probe_width is not None and probe_width > probe_tab.shape[1]:
        probe_tab = np.concatenate(
            [probe_tab,
             np.full((probe_tab.shape[0],
                      probe_width - probe_tab.shape[1]), -1, np.int32)],
            axis=1)
    c = perm.size // csize
    n_tot = c * csize
    perm_cl = jnp.asarray(perm)
    ext = jnp.concatenate([packed_l, jnp.zeros((1, w), jnp.uint32)])
    packed_cl = jnp.take(ext, jnp.where(perm_cl < 0, n_pad, perm_cl),
                         axis=0)
    np.asarray(packed_cl[-1:, -1:])  # serialize before freeing ext
    del ext  # [n_pad+1, w]: 1.28 GB dead weight at 10M
    scan_cols = jnp.asarray(probe_tab)
    p = probe_tab.shape[1]
    nq = n_tot // q_block
    # pads occupy the tail of permuted space — skip all-pad q-blocks
    nq_real = (n_real + q_block - 1) // q_block
    out_d = jnp.full((n_pad, k), INF)
    out_i = jnp.full((n_pad, k), -1, jnp.int32)
    if mesh is not None:
        # sharded: every device scans its own span of permuted q-blocks
        # in ONE program; clamped tail blocks re-compute and the scatter
        # dedups them
        from rad_tpu.build.exact_sharded import (probed_topk_sharded,
                                                 replicate)
        packed_cl = replicate(packed_cl, mesh)
        perm_cl = replicate(perm_cl, mesh)
        scan_cols = replicate(scan_cols, mesh)
        bd, bi, pos = probed_topk_sharded(
            packed_cl, perm_cl, scan_cols, k, q_block, csize, impl,
            approx_recall, bucket, interpret, mesh, mesh_axis)
        perm_span = jnp.take(perm_cl, pos)
        return _probed_scatter_span(out_d, out_i, perm_span, bd, bi,
                                    perm_cl)
    q_span = max(1, int(pairs_per_dispatch // (q_block * p * csize)))
    q_span = min(q_span, nq)
    if select_stream is not None:
        import math as _math

        pops_l, m_sel, heuristic_k, sel_block, int8_pairs = select_stream
        sb_eff = _math.gcd(sel_block, q_span * q_block)
        del out_d, out_i
        sel_out = jnp.full((n_pad, m_sel), -1, jnp.int32)
        sel_d_out = jnp.full((n_pad, m_sel), INF)
        for q0 in range(0, nq_real, q_span):
            q0c = min(q0, nq - q_span)  # overlap re-computes; idempotent
            bd, bi = _probed_topk_span(
                packed_cl, perm_cl, scan_cols, jnp.int32(q0c), k,
                q_block, csize, impl, approx_recall, bucket,
                interpret, q_span)
            sel_sp, sel_d_sp, perm_span = _select_span_permuted(
                packed_l, pops_l, bd, bi, perm_cl,
                jnp.int32(q0c * q_block), m_sel, heuristic_k, sb_eff,
                int8_pairs)
            sel_out, sel_d_out = _scatter_sel_span(
                sel_out, sel_d_out, perm_span, sel_sp, sel_d_sp)
            np.asarray(sel_d_out[-1:, -1:])  # bound the dispatch queue
        return sel_out, sel_d_out
    for q0 in range(0, nq_real, q_span):
        q0c = min(q0, nq - q_span)  # overlap re-computes; scatter idempotent
        bd, bi = _probed_topk_span(
            packed_cl, perm_cl, scan_cols, jnp.int32(q0c), k, q_block,
            csize, impl, approx_recall, bucket, interpret, q_span)
        perm_span = jax.lax.dynamic_slice(
            perm_cl, (q0c * q_block,), (q_span * q_block,))
        out_d, out_i = _probed_scatter_span(out_d, out_i, perm_span,
                                            bd, bi, perm_cl)
        np.asarray(out_i[-1:, -1:])  # bound the dispatch queue
    return out_d, out_i


@partial(jax.jit, static_argnames=("m", "heuristic_k", "sel_block",
                                   "int8_pairs"))
def _select_layer(packed, pops, cand_d, cand_id, n_real, m: int,
                  heuristic_k: int, sel_block: int, int8_pairs: bool = False):
    """Vectorized diversity selection + per-selection distances.

    cand_d/cand_id: [N_pad, K] ascending exact candidates. Returns
    (sel_ids [N_pad, m], sel_d [N_pad, m]); padded rows select nothing.
    Chunked over ``sel_block`` rows — the heuristic's pairwise candidate
    block is [B, kh, kh]. ``int8_pairs`` routes that block through a
    batched int8 matmul (exact same values, tensor cores instead of SWAR
    popcount).
    """
    from rad_tpu.build.device import _dist_rows, _select_neighbors

    n_pad, k = cand_d.shape
    nch = n_pad // sel_block

    def one(chunk):
        cd, ci, qi = chunk
        active = qi < n_real
        safe_q = jnp.minimum(qi, n_real - 1)
        sel = _select_neighbors(packed, pops, safe_q, cd, ci, m,
                                heuristic_k, active, int8_pairs=int8_pairs)
        sel_d = _dist_rows(packed, pops, safe_q, sel,
                           (sel >= 0) & active[:, None])
        return sel, sel_d

    q_ids = jnp.arange(n_pad, dtype=jnp.int32)
    sel, sel_d = jax.lax.map(one, (cand_d.reshape(nch, sel_block, k),
                                   cand_id.reshape(nch, sel_block, k),
                                   q_ids.reshape(nch, sel_block)))
    return sel.reshape(n_pad, -1), sel_d.reshape(n_pad, -1)


@partial(jax.jit, static_argnames=("m", "heuristic_k", "sel_block", "span",
                                   "int8_pairs"))
def _select_layer_span(packed, pops, cand_d, cand_id, r0, n_real, m: int,
                       heuristic_k: int, sel_block: int, span: int,
                       int8_pairs: bool = False):
    """:func:`_select_layer` restricted to ``span`` rows starting at
    ``r0`` (traced) — one bounded device program per host dispatch."""
    from rad_tpu.build.device import _dist_rows, _select_neighbors

    n_pad, k = cand_d.shape
    cd_s = jax.lax.dynamic_slice(cand_d, (r0, 0), (span, k))
    ci_s = jax.lax.dynamic_slice(cand_id, (r0, 0), (span, k))
    q_ids = r0 + jnp.arange(span, dtype=jnp.int32)
    nch = span // sel_block

    def one(chunk):
        cd, ci, qi = chunk
        active = qi < n_real
        safe_q = jnp.minimum(qi, n_real - 1)
        sel = _select_neighbors(packed, pops, safe_q, cd, ci, m,
                                heuristic_k, active, int8_pairs=int8_pairs)
        sel_d = _dist_rows(packed, pops, safe_q, sel,
                           (sel >= 0) & active[:, None])
        return sel, sel_d

    sel, sel_d = jax.lax.map(one, (cd_s.reshape(nch, sel_block, k),
                                   ci_s.reshape(nch, sel_block, k),
                                   q_ids.reshape(nch, sel_block)))
    return sel.reshape(span, -1), sel_d.reshape(span, -1)


# Selection rows per host-dispatched device program (a dispatch-size
# constant: ROADMAP design item 1).
SELECT_ROWS_PER_DISPATCH = 1 << 21


def _select_layer_chunked(packed, pops, cand_d, cand_id, n_real, m: int,
                          heuristic_k: int, sel_block: int,
                          int8_pairs: bool = False,
                          rows_per_dispatch: int = SELECT_ROWS_PER_DISPATCH):
    """Diversity selection as a host loop of bounded device programs.
    Identical results to :func:`_select_layer` (rows are independent);
    layers that fit one dispatch keep the existing compiled path."""
    n_pad, k = cand_d.shape
    if n_pad <= rows_per_dispatch:
        return _select_layer(packed, pops, cand_d, cand_id, n_real, m,
                             heuristic_k, sel_block, int8_pairs=int8_pairs)
    span = max(sel_block, (rows_per_dispatch // sel_block) * sel_block)
    starts = list(range(0, n_pad - span + 1, span))
    if starts[-1] + span < n_pad:
        starts.append(n_pad - span)  # tail span overlaps; slices dedup
    s_parts, d_parts = [], []
    covered = 0
    for r0 in starts:
        s, d = _select_layer_span(packed, pops, cand_d, cand_id,
                                  jnp.int32(r0), n_real, m, heuristic_k,
                                  sel_block, span, int8_pairs=int8_pairs)
        np.asarray(s[-1:, -1:])  # bound the dispatch queue
        skip = covered - r0
        s_parts.append(s[skip:] if skip else s)
        d_parts.append(d[skip:] if skip else d)
        covered = r0 + span
    return jnp.concatenate(s_parts), jnp.concatenate(d_parts)


@partial(jax.jit, static_argnames=("cap", "two_pass"))
def _symmetrize(sel, sel_d, n_real, cap: int, two_pass: bool = False):
    """Rows = distance-best ``cap`` incident edges (forward + reverse).

    The global form of the beam builder's reverse-link merge
    (rad_tpu.build.device._apply_reverse_links): every directed selection
    (i -> j, d) contributes edges (i, j) and (j, i); each destination keeps
    its ``cap`` nearest entrants. One sort + one rank-limited scatter —
    no per-row loops.

    ``two_pass`` decomposes the 3-key sort into a (d, src) sort followed
    by a STABLE single-key sort on dst — the classic lexsort
    decomposition, bit-identical output (equal (dst, d, src) triples are
    interchangeable for the downstream dup/rank masks).
    """
    n_pad, m = sel.shape
    # optimization_barrier: src is a pure iota expression — without the
    # barrier XLA may constant-fold the repeat/concatenate chain into a
    # 100s-of-MB literal inside the compile process
    src = jax.lax.optimization_barrier(
        jnp.repeat(jnp.arange(n_pad, dtype=jnp.int32), m))
    dst = sel.reshape(-1)
    d = sel_d.reshape(-1)
    ok = (dst >= 0) & (src < n_real)
    # both directions
    e_dst = jnp.concatenate([jnp.where(ok, dst, n_pad),
                             jnp.where(ok, src, n_pad)])
    e_src = jnp.concatenate([src, jnp.where(ok, dst, n_pad)])
    e_d = jnp.concatenate([jnp.where(ok, d, INF)] * 2)

    if two_pass:
        s_d, s_src, s_dst = jax.lax.sort((e_d, e_src, e_dst), num_keys=2,
                                         is_stable=True)
        sd_key, sdist, ssrc = jax.lax.sort((s_dst, s_d, s_src), num_keys=1,
                                           is_stable=True)
    else:
        sd_key, sdist, ssrc = jax.lax.sort((e_dst, e_d, e_src), num_keys=3)
    # drop duplicate (dst, src) pairs (mutual selections appear twice)
    dup = jnp.concatenate([
        jnp.zeros((1,), jnp.bool_),
        (sd_key[1:] == sd_key[:-1]) & (ssrc[1:] == ssrc[:-1])])
    valid = (sd_key < n_pad) & jnp.isfinite(sdist) & ~dup

    first = jnp.concatenate([
        jnp.ones((1,), jnp.bool_), sd_key[1:] != sd_key[:-1]])
    c = jnp.cumsum(valid.astype(jnp.int32))
    base_at_start = jnp.where(first, c - valid.astype(jnp.int32),
                              jnp.int32(-1))
    base = jax.lax.associative_scan(jnp.maximum, base_at_start)
    rank = c - 1 - base
    keep = valid & (rank < cap)

    rows = jnp.full((n_pad + 1, cap), -1, jnp.int32)
    rows = rows.at[jnp.where(keep, sd_key, n_pad),
                   jnp.where(keep, rank, 0)].set(
        jnp.where(keep, ssrc, -1), mode="drop")
    return rows[:n_pad]


def _merge_rows(run_d, run_s, ch_d, ch_s, cap: int):
    """Fold a chunk's [n_pad, cap] (d, src) contribution into the running
    per-row table: row-wise 2-key sort by (d, src), adjacent same-src
    dedup (a (dst, src) edge's two copies carry the same distance, so
    duplicates sort together), re-sort, truncate to cap."""
    cat_d = jnp.concatenate([run_d, ch_d], axis=1)
    cat_s = jnp.concatenate([run_s, ch_s], axis=1)
    cat_d, cat_s = jax.lax.sort((cat_d, cat_s), dimension=1, num_keys=2)
    dup = jnp.concatenate([
        jnp.zeros((cat_s.shape[0], 1), jnp.bool_),
        (cat_s[:, 1:] == cat_s[:, :-1]) & (cat_s[:, 1:] >= 0)], axis=1)
    cat_d = jnp.where(dup, INF, cat_d)
    cat_s = jnp.where(dup, -1, cat_s)
    cat_d, cat_s = jax.lax.sort((cat_d, cat_s), dimension=1, num_keys=2)
    return cat_d[:, :cap], cat_s[:, :cap]


@partial(jax.jit, static_argnames=("cap", "cols_per_chunk"))
def _symmetrize_chunked(sel, sel_d, n_real, cap: int, cols_per_chunk: int):
    """Per-destination top-cap incident edges WITHOUT a full-edge-list
    sort: this processes ``cols_per_chunk`` selection columns at a time.
    Each chunk is one small 3-key sort + rank-limited scatter (a few
    million rows), folded into a running [n_pad, cap] table by
    :func:`_merge_rows`.

    Bit-identical to the global sort: a chunk's per-destination
    dedup-then-top-``cap`` can only drop entries beaten by >= ``cap``
    distinct entrants of the same destination within the chunk — all of
    which beat it globally too — so truncation is lossless, and every
    intermediate table stays sorted by the global (d, src) rank order.
    """
    n_pad, m = sel.shape
    run_d = jnp.full((n_pad, cap), INF)
    run_s = jnp.full((n_pad, cap), -1, jnp.int32)
    for c0 in range(0, m, cols_per_chunk):
        cc = min(cols_per_chunk, m - c0)
        sub = sel[:, c0:c0 + cc]
        sub_d = sel_d[:, c0:c0 + cc]
        src = jax.lax.optimization_barrier(
            jnp.repeat(jnp.arange(n_pad, dtype=jnp.int32), cc))
        dst = sub.reshape(-1)
        d = sub_d.reshape(-1)
        ok = (dst >= 0) & (src < n_real)
        e_dst = jnp.concatenate([jnp.where(ok, dst, n_pad),
                                 jnp.where(ok, src, n_pad)])
        e_src = jnp.concatenate([src, jnp.where(ok, dst, n_pad)])
        e_d = jnp.concatenate([jnp.where(ok, d, INF)] * 2)
        sd_key, sdist, ssrc = jax.lax.sort((e_dst, e_d, e_src), num_keys=3)
        dup = jnp.concatenate([
            jnp.zeros((1,), jnp.bool_),
            (sd_key[1:] == sd_key[:-1]) & (ssrc[1:] == ssrc[:-1])])
        valid = (sd_key < n_pad) & jnp.isfinite(sdist) & ~dup
        first = jnp.concatenate([
            jnp.ones((1,), jnp.bool_), sd_key[1:] != sd_key[:-1]])
        c = jnp.cumsum(valid.astype(jnp.int32))
        base_at_start = jnp.where(first, c - valid.astype(jnp.int32),
                                  jnp.int32(-1))
        base = jax.lax.associative_scan(jnp.maximum, base_at_start)
        rank = c - 1 - base
        keep = valid & (rank < cap)
        ch_s = jnp.full((n_pad + 1, cap), -1, jnp.int32)
        ch_s = ch_s.at[jnp.where(keep, sd_key, n_pad),
                       jnp.where(keep, rank, 0)].set(
            jnp.where(keep, ssrc, -1), mode="drop")
        ch_d = jnp.full((n_pad + 1, cap), INF)
        ch_d = ch_d.at[jnp.where(keep, sd_key, n_pad),
                       jnp.where(keep, rank, 0)].set(
            jnp.where(keep, sdist, INF), mode="drop")
        run_d, run_s = _merge_rows(run_d, run_s, ch_d[:n_pad], ch_s[:n_pad],
                                   cap)
    return run_s


def _fold_edges(run_d, run_s, sel_sub, sel_d_sub, r0, n_real, cap: int):
    """Traceable core of :func:`_symm_fold_step` — fold one row-span ×
    column-chunk slice of the selections into the running
    per-destination tables. Shared by the host-dispatched spanned form
    and the mesh-sharded form (rad_tpu.build.exact_sharded)."""
    n_pad = run_d.shape[0]
    b, cc = sel_sub.shape
    src = jax.lax.optimization_barrier(
        jnp.repeat(r0 + jnp.arange(b, dtype=jnp.int32), cc))
    dst = sel_sub.reshape(-1)
    d = sel_d_sub.reshape(-1)
    ok = (dst >= 0) & (src < n_real)
    e_dst = jnp.concatenate([jnp.where(ok, dst, n_pad),
                             jnp.where(ok, src, n_pad)])
    e_src = jnp.concatenate([src, jnp.where(ok, dst, n_pad)])
    e_d = jnp.concatenate([jnp.where(ok, d, INF)] * 2)
    sd_key, sdist, ssrc = jax.lax.sort((e_dst, e_d, e_src), num_keys=3)
    dup = jnp.concatenate([
        jnp.zeros((1,), jnp.bool_),
        (sd_key[1:] == sd_key[:-1]) & (ssrc[1:] == ssrc[:-1])])
    valid = (sd_key < n_pad) & jnp.isfinite(sdist) & ~dup
    first = jnp.concatenate([
        jnp.ones((1,), jnp.bool_), sd_key[1:] != sd_key[:-1]])
    c = jnp.cumsum(valid.astype(jnp.int32))
    base_at_start = jnp.where(first, c - valid.astype(jnp.int32),
                              jnp.int32(-1))
    base = jax.lax.associative_scan(jnp.maximum, base_at_start)
    rank = c - 1 - base
    keep = valid & (rank < cap)
    ch_s = jnp.full((n_pad + 1, cap), -1, jnp.int32)
    ch_s = ch_s.at[jnp.where(keep, sd_key, n_pad),
                   jnp.where(keep, rank, 0)].set(
        jnp.where(keep, ssrc, -1), mode="drop")
    ch_d = jnp.full((n_pad + 1, cap), INF)
    ch_d = ch_d.at[jnp.where(keep, sd_key, n_pad),
                   jnp.where(keep, rank, 0)].set(
        jnp.where(keep, sdist, INF), mode="drop")
    return _merge_rows(run_d, run_s, ch_d[:n_pad], ch_s[:n_pad], cap)


@partial(jax.jit, donate_argnums=(0, 1), static_argnames=("cap",))
def _symm_fold_step(run_d, run_s, sel_sub, sel_d_sub, r0, n_real,
                    cap: int):
    """Fold one (row-span × column-chunk) slice of the selections into
    the running per-destination tables — the host-dispatched form of
    :func:`_symmetrize_chunked`'s loop body. Sources are rows
    ``r0..r0+b``; destinations are global. Idempotent under re-folds
    (a re-seen (dst, src, d) entrant sorts adjacent to its copy and is
    dropped by :func:`_merge_rows`' same-src dedup), so overlapping tail
    spans are safe."""
    return _fold_edges(run_d, run_s, sel_sub, sel_d_sub, r0, n_real, cap)


# Edge rows per symmetrization sort (a dispatch-size constant: ROADMAP
# design item 1).
SYMM_EDGES_PER_SORT = 1 << 22


def _symmetrize_spanned(sel, sel_d, n_real, cap: int,
                        edges_per_sort: int = SYMM_EDGES_PER_SORT):
    """Per-destination top-``cap`` incident edges as a HOST loop of
    bounded fold steps — the ≥10M-node form of the symmetrization
    (where even a single selection COLUMN's edge list exceeds the
    per-sort budget, so :func:`_symmetrize_chunked`'s column chunks
    cannot bound the program). Bit-identical to the global sort by the
    same losslessness argument (truncation to ``cap`` within a fold only
    drops globally-beaten entrants; every intermediate table stays in
    global (d, src) rank order)."""
    n_pad, m = sel.shape
    run_d = jnp.full((n_pad, cap), INF)
    run_s = jnp.full((n_pad, cap), -1, jnp.int32)
    cc = max(1, min(m, edges_per_sort // (2 * n_pad)))
    b = max(1, min(n_pad, edges_per_sort // (2 * cc)))
    row_starts = list(range(0, n_pad - b + 1, b))
    if row_starts[-1] + b < n_pad:
        row_starts.append(n_pad - b)  # overlap is idempotent (see step)
    for c0 in range(0, m, cc):
        ccc = min(cc, m - c0)
        c0c = c0 if ccc == cc else m - cc  # overlap re-folds, idempotent
        for r0 in row_starts:
            sub = jax.lax.dynamic_slice(sel, (r0, c0c), (b, cc))
            sub_d = jax.lax.dynamic_slice(sel_d, (r0, c0c), (b, cc))
            run_d, run_s = _symm_fold_step(run_d, run_s, sub, sub_d,
                                           jnp.int32(r0), n_real, cap)
            np.asarray(run_s[-1:, -1:])  # serialize dispatches
    return run_s


# One bucket-append call processes ~this many edge records (mask +
# cumsum-compact + scatter, NO sort) — bounds the call's integer temps
# to a few hundred MB at any layer size.
BUCKET_EDGES_PER_APPEND = 1 << 25


@partial(jax.jit, donate_argnums=(0, 1, 2, 3), static_argnames=("cols",))
def _bucket_append(buf_dst, buf_src, buf_d, off, sel, sel_d, g_lo, g_hi,
                   n_real, col0, cols: int):
    """Append the (both-direction) edges of ``cols`` selection columns
    whose DESTINATION falls in ``[g_lo, g_hi)`` to the group buffer.

    Pure mask + cumsum compaction + unique-index scatter — no sort. The
    append offset lives on device (no per-call readback); records past
    the buffer capacity scatter out of bounds and drop, detected by the
    caller comparing the final offset against capacity (then the group
    is subdivided). ``g_lo``/``g_hi`` are traced, so one compile serves
    every group."""
    n_pad = sel.shape[0]
    sub = jax.lax.dynamic_slice_in_dim(sel, col0, cols, axis=1)
    sub_d = jax.lax.dynamic_slice_in_dim(sel_d, col0, cols, axis=1)
    src = jax.lax.optimization_barrier(
        jnp.repeat(jnp.arange(n_pad, dtype=jnp.int32), cols))
    dst = sub.reshape(-1)
    d = sub_d.reshape(-1)
    # FORWARD direction only: the reverse direction (dst=i, src=sel[i])
    # is exactly row i's own selection list and is seeded sort-free into
    # the group's run table by _seed_reverse — halving both the append
    # traffic and the bounded-sort volume
    ok = (dst >= 0) & (src < n_real)
    e_dst = jnp.where(ok, dst, -1)
    in_g = (e_dst >= g_lo) & (e_dst < g_hi)
    pos = off + jnp.cumsum(in_g.astype(jnp.int32)) - 1
    cap_b = buf_dst.shape[0]
    idx = jnp.where(in_g, pos, cap_b)  # cap_b and beyond: dropped
    buf_dst = buf_dst.at[idx].set(e_dst, mode="drop")
    buf_src = buf_src.at[idx].set(src, mode="drop")
    buf_d = buf_d.at[idx].set(jnp.where(ok, d, INF), mode="drop")
    return buf_dst, buf_src, buf_d, off + jnp.sum(in_g, dtype=jnp.int32)


@partial(jax.jit, static_argnames=("cap", "chunk", "rows_g"))
def _fold_sort_chunk(buf_dst, buf_src, buf_d, base, off, g_lo,
                     cap: int, chunk: int, rows_g: int):
    """Sort + dup-drop + rank-limit + scatter of one buffer chunk into a
    fresh [rows_g, cap] chunk table — the first half of the bucketed
    fold, kept separate from the row-wise merge (ROADMAP design item 1
    lists the split)."""
    bd = jax.lax.dynamic_slice_in_dim(buf_dst, base, chunk)
    bs = jax.lax.dynamic_slice_in_dim(buf_src, base, chunk)
    bdist = jax.lax.dynamic_slice_in_dim(buf_d, base, chunk)
    live = (base + jnp.arange(chunk, dtype=jnp.int32) < off) & (bd >= 0)
    key = jnp.where(live, bd - g_lo, rows_g)
    sdist_in = jnp.where(live, bdist, INF)
    ssrc_in = jnp.where(live, bs, 0)
    sd_key, sdist, ssrc = jax.lax.sort((key, sdist_in, ssrc_in),
                                       num_keys=3)
    dup = jnp.concatenate([
        jnp.zeros((1,), jnp.bool_),
        (sd_key[1:] == sd_key[:-1]) & (ssrc[1:] == ssrc[:-1])])
    valid = (sd_key < rows_g) & jnp.isfinite(sdist) & ~dup
    first = jnp.concatenate([
        jnp.ones((1,), jnp.bool_), sd_key[1:] != sd_key[:-1]])
    c = jnp.cumsum(valid.astype(jnp.int32))
    base_at_start = jnp.where(first, c - valid.astype(jnp.int32),
                              jnp.int32(-1))
    rank_base = jax.lax.associative_scan(jnp.maximum, base_at_start)
    rank = c - 1 - rank_base
    keep = valid & (rank < cap)
    ch_s = jnp.full((rows_g + 1, cap), -1, jnp.int32)
    ch_s = ch_s.at[jnp.where(keep, sd_key, rows_g),
                   jnp.where(keep, rank, 0)].set(
        jnp.where(keep, ssrc, -1), mode="drop")
    ch_d = jnp.full((rows_g + 1, cap), INF)
    ch_d = ch_d.at[jnp.where(keep, sd_key, rows_g),
                   jnp.where(keep, rank, 0)].set(
        jnp.where(keep, sdist, INF), mode="drop")
    return ch_d[:rows_g], ch_s[:rows_g]


@partial(jax.jit, donate_argnums=(0, 1), static_argnames=("cap",))
def _merge_rows_jit(run_d, run_s, ch_d, ch_s, cap: int):
    """:func:`_merge_rows` as its own program (second fold half)."""
    return _merge_rows(run_d, run_s, ch_d, ch_s, cap)


def _fold_bucket_chunk(run_d, run_s, buf_dst, buf_src, buf_d, base, off,
                       g_lo, cap: int, chunk: int):
    """Fold buffer records ``[base, base+chunk)`` (those below ``off``;
    stale slots from a previous group are masked out) into the group's
    running [rows_g, cap] tables — the destination-sharded form of
    :func:`_fold_edges` as TWO chained device programs (see
    :func:`_fold_sort_chunk` for why)."""
    rows_g = run_d.shape[0]
    ch_d, ch_s = _fold_sort_chunk(buf_dst, buf_src, buf_d, base, off,
                                  g_lo, cap=cap, chunk=chunk,
                                  rows_g=rows_g)
    return _merge_rows_jit(run_d, run_s, ch_d, ch_s, cap=cap)


@partial(jax.jit, donate_argnums=(0,))
def _place_group(out_rows, run_s, g_lo):
    return jax.lax.dynamic_update_slice(out_rows, run_s,
                                        (g_lo, jnp.int32(0)))


@partial(jax.jit, static_argnames=("rows_g",))
def _seed_reverse(sel, sel_d, g_lo, n_real, rows_g: int):
    """Group run tables seeded with the REVERSE edges sort-free: the
    reverse contribution of destination row ``i`` is exactly row i's own
    selection list ``(sel_d[i], sel[i])`` — a gather plus one row-wise
    2-key sort (global (d, src) rank order, like every merge output),
    no cross-row edge sort needed."""
    n_pad = sel.shape[0]
    rows = g_lo + jnp.arange(rows_g, dtype=jnp.int32)
    safe = jnp.minimum(rows, n_pad - 1)
    seed_s = jnp.take(sel, safe, axis=0)
    seed_d = jnp.take(sel_d, safe, axis=0)
    # reverse edge (dst=i, src=sel[i,j]) exists iff sel >= 0 AND i is a
    # real row; the source (= the selected id) is < n_real by
    # construction
    live = (seed_s >= 0) & (rows < n_real)[:, None]
    seed_d = jnp.where(live, seed_d, INF)
    seed_s = jnp.where(live, seed_s, -1)
    return jax.lax.sort((seed_d, seed_s), dimension=1, num_keys=2)


def _symmetrize_bucketed(sel, sel_d, n_real, cap: int,
                         edges_per_sort: int = SYMM_EDGES_PER_SORT,
                         target_buf_edges: int | None = None,
                         buf_slack: float = 1.3):
    """Destination-sharded symmetrization — the fast ≥10M-node form.

    :func:`_symmetrize_spanned` pays a FULL-table [n_pad, 2*cap] row-sort
    merge per bounded fold (~76 such merges at 10M). Here destinations are
    partitioned into contiguous row groups; each group's incident edges
    (both directions) are gathered into a device buffer by a sortless
    mask+compact pass over the selection tables, then folded in
    ``edges_per_sort`` chunks into a [rows_g, cap] table — every merge
    row-sorts only ``n_pad / G`` rows, so total merge work drops by ~G×
    while the edge sorts stay bounded. Bit-identical to the global sort by the same argument as the
    spanned form (per-chunk dedup + rank truncation only drops
    globally-beaten entrants; :func:`_merge_rows` keeps global (d, src)
    rank order), plus: destination groups partition the edge set, so
    grouping cannot change any row's entrant multiset.

    A group whose true edge count overflows the buffer (pathological
    in-degree concentration) is recursively subdivided — appends past
    capacity drop via out-of-bounds scatter, the device-side offset
    counts truly, and the host compares it to capacity per group."""
    n_pad, m = sel.shape
    total_edges = n_pad * m  # forward only; reverse edges are seeded
    if target_buf_edges is None:
        target_buf_edges = 8 * edges_per_sort
    n_groups = max(1, -(-total_edges // target_buf_edges))
    rows_g = -(-n_pad // n_groups)
    n_groups = -(-n_pad // rows_g)
    cap_b = _round_up(int(total_edges // n_groups * buf_slack) + 1,
                      edges_per_sort)
    buf_dst = jnp.full((cap_b,), -1, jnp.int32)
    buf_src = jnp.zeros((cap_b,), jnp.int32)
    buf_d = jnp.full((cap_b,), INF)
    # extra rows_g of margin: a subdivided subgroup's placement window
    # [mid, mid + rows_g) may extend past the padded row count, and
    # dynamic_update_slice CLAMPS starts — the margin keeps every window
    # in bounds so no clamp can shift a write backward over real rows
    out_rows = jnp.full((n_pad + (-n_pad) % rows_g + rows_g, cap), -1,
                        jnp.int32)

    ccb = next((c for c in range(m, 0, -1)
                if m % c == 0
                and 2 * n_pad * c <= BUCKET_EDGES_PER_APPEND), 1)

    def do_group(g_lo: int, g_hi: int, depth: int = 0):
        nonlocal buf_dst, buf_src, buf_d, out_rows
        off = jnp.zeros((), jnp.int32)
        for c0 in range(0, m, ccb):
            buf_dst, buf_src, buf_d, off = _bucket_append(
                buf_dst, buf_src, buf_d, off, sel, sel_d,
                jnp.int32(g_lo), jnp.int32(g_hi), n_real,
                jnp.int32(c0), cols=ccb)
        off_h = int(off)  # one readback per group (serializes appends)
        if off_h > cap_b:
            if depth > 32 or g_hi - g_lo <= 1:
                raise RuntimeError(
                    f"symmetrize_bucketed: group [{g_lo},{g_hi}) "
                    f"overflows at minimum width ({off_h} > {cap_b})")
            mid = (g_lo + g_hi) // 2
            logger.info("bucketed symm: group [%d,%d) overflowed "
                        "(%d > %d) — subdividing", g_lo, g_hi, off_h,
                        cap_b)
            do_group(g_lo, mid, depth + 1)
            do_group(mid, g_hi, depth + 1)
            return
        run_d, run_s = _seed_reverse(sel, sel_d, jnp.int32(g_lo), n_real,
                                     rows_g=rows_g)
        for base in range(0, max(off_h, 1), edges_per_sort):
            run_d, run_s = _fold_bucket_chunk(
                run_d, run_s, buf_dst, buf_src, buf_d,
                jnp.int32(base), off, jnp.int32(g_lo), cap=cap,
                chunk=edges_per_sort)
        out_rows = _place_group(out_rows, run_s, jnp.int32(g_lo))

    g_lo = 0
    while g_lo < n_pad:
        g_hi = min(g_lo + rows_g, n_pad)
        do_group(g_lo, g_hi)
        g_lo = g_hi
    np.asarray(out_rows[-1:, -1:])  # serialize before buffers die
    return out_rows[:n_pad]


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def build_hnsw_exact(
    packed: np.ndarray,
    keys: np.ndarray | None = None,
    connectivity: int = 16,
    expansion_add: int | None = None,
    ndim: int | None = None,
    seed: int = 0,
    candidates: int | None = None,
    heuristic_k: int | None = None,
    q_block: int = 4096,
    col_block: int = 1 << 13,
    sel_block: int = 2048,
    impl: str | None = None,
    approx_recall: float | None = 0.99,
    block_bucket: int | None = 64,
    symm_mode: str | None = None,
    pairs_per_dispatch: float = PAIRS_PER_DISPATCH,
    probes: int | None = None,
    probe_csize: int | None = None,
    probe_sample: int = 16,
    probe_granularity: str = "qblock",
    probe_width: int | None = None,
    probe_min_n: int = 2_000_000,
    stream_select: bool | str = "auto",
    interpret: bool = False,
    mesh=None,
    mesh_axis: str = "graph",
) -> HNSWGraph:
    """Build an HNSW graph from exact per-layer top-K neighbor lists.

    Same graph format and parameter semantics as the other builders;
    ``expansion_add`` is accepted for API parity but ignored — exact
    candidates are the infinite-beam limit. ``candidates`` (default
    ``max(heuristic_k, 2*M0)``) is the per-node exact-kNN depth fed to the
    selection heuristic. ``approx_recall`` controls the per-block top-k
    reduction of the small layers (``lax.approx_max_k``; measured graph
    quality at 0.99 matches the exact reduction —
    tests/test_build_exact.py); pass ``None`` for the fully exact
    (sort-based) reduction.

    ``impl`` is the Tanimoto implementation
    (:func:`rad_tpu.fp.backend.tanimoto_impl`): ``None`` takes it from
    the platform of the device the fingerprints are placed on ("triton"
    on a GPU, "swar" on the CPU). ``interpret`` runs the Triton kernel in
    the Pallas interpreter (CPU tests of ``impl="triton"``).

    ``block_bucket`` (layers >= the block size): reduce each distance
    block to one winner per ``block_bucket`` db columns by a packed-key
    integer max (see ``_allpairs_topk``); on the GPU the Pallas-Triton
    kernel does it without writing the distance block to device memory.
    Smaller layers keep the ``approx_recall`` reduction; ``None``
    disables.
    ``symm_mode`` picks the symmetrization form — ``"sort"``
    (one global 3-key sort), ``"two_pass"`` (lexsort-decomposed stable
    sorts), ``"chunked"`` (column-chunked small sorts + row-wise merges;
    no sort exceeds ~4M rows), ``"spanned"`` (host-dispatched
    row-span × column folds — the old ≥10M-node form, where one column's
    edge list alone exceeds the sort budget), ``"bucketed"``
    (destination-sharded folds: each bounded sort merges into a
    [n_pad/G, cap] group table instead of the full table — ~G× less
    merge work than spanned; the r5 default at spanned's scale), or
    ``None`` = auto: ``"bucketed"`` past 2M rows, ``"chunked"`` past
    ~8M edges. All five are bit-identical; the bounded forms keep every
    sort at a few million rows.
    ``pairs_per_dispatch`` bounds the distance evaluations per device
    program in the all-pairs stage (:data:`PAIRS_PER_DISPATCH`); builds
    that fit one dispatch keep the single-program path.

    ``probes`` switches large layers to the SUBQUADRATIC cluster-probed
    candidate stage (:func:`_allpairs_topk_probed`): the layer is
    partitioned into balanced ``probe_csize``-row clusters (default: the
    layer's column block) by two-anchor median bisection, and each query
    block scans only its cluster's ``probes`` most-proximate clusters
    (min distance over ``probe_sample`` sampled members per cluster) —
    O(N·probes·csize) distance evaluations instead of O(N²). Candidates
    are exact within the probed set; ``None`` (default) keeps the fully
    exact candidate stage. Layers too small to profit (fewer than
    4×``probes`` clusters) keep the exact stage automatically, and
    ``probe_min_n`` (default 2M — CHANGED in r4 from 0) additionally
    gates probing to layers of at least that many nodes: upper-layer
    exact stages are seconds of device time and navigate better. A request
    whose every layer is gated back to exact logs a warning; pass
    ``probe_min_n=0`` to force probing on any eligible layer.
    ``probe_granularity`` ("qblock" default / "cluster") sets whether
    each dispatched q-block picks its own probe list or inherits its
    cluster's (qblock is strictly finer coverage at equal cost);
    ``probe_width`` pads probe lists to a fixed width so recall sweeps
    over ``probes`` share one compile (see _allpairs_topk_probed).
    ``stream_select`` ("auto" default) fuses the diversity selection
    into each probed scan span so the [n_pad, k] candidate tables are
    never materialized (bit-identical; removes the ~15 GB memory wall at
    30M nodes) — "auto" streams when the tables would exceed
    :data:`STREAM_SELECT_BYTES`; True/False force.

    ``mesh`` (a 1-D :class:`jax.sharding.Mesh` with axis ``mesh_axis``)
    distributes the build: every big layer's three stages run sharded
    over the mesh (rad_tpu.build.exact_sharded — q-block/row spans per
    device, one ``all_to_all`` in the symmetrization), producing the
    exact same graph edge for edge as the single-device build (pinned
    by tests/test_build_sharded.py). The fingerprint matrix is
    replicated per device; layers below the mesh's padding unit (and
    any forced ``symm_mode``, which the sharded merge supersedes) keep
    the single-device path.
    """
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    ndim = ndim or w * 32
    m = connectivity
    m0 = 2 * m
    if keys is None:
        keys = np.arange(n, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)
    heuristic_k = heuristic_k or max(4 * m, 32)
    candidates = candidates or max(heuristic_k, 2 * m0)
    for name, v in (("q_block", q_block), ("col_block", col_block),
                    ("sel_block", sel_block)):
        if v & (v - 1):
            raise ValueError(f"{name}={v} must be a power of two")

    levels_raw = sample_levels(n, m, seed)
    order = np.lexsort((np.arange(n), -levels_raw))
    packed = packed[order]
    keys = keys[order]
    levels = levels_raw[order]
    max_level = int(levels[0]) if n else 0
    layer_sizes = tuple(int((levels >= l).sum())
                        for l in range(max_level + 1))

    pops_np = popcount_rows_np(packed)

    big = max(q_block, col_block, sel_block)
    if mesh is not None:
        d_mesh = mesh.shape[mesh_axis]
        # sharded layers need their q-blocks and sel-chunks to split
        # evenly over the mesh; folding the unit into `big` reuses the
        # existing padding (reductions already mask rows >= n_real)
        big = max(big, d_mesh * q_block, d_mesh * sel_block)
    if n >= big:
        n_pad0 = _round_up(n, big)
    elif n > 1:
        n_pad0 = 1 << max(n - 1, 1).bit_length()
    else:
        n_pad0 = 1

    # Small-layer shared compile unit, INDEPENDENT of the big-layer column
    # blocking: a wide col_block must not inflate every upper layer's
    # padded shape 16x. Capped at 8192, so default-block builds compile
    # the exact same shapes as before.
    small_unit = min(big, 8192)

    def _pad_for(n_l: int):
        """Padded size + block sizes for an n_l-node layer.

        Every small layer (n_l < ``small_unit``) gets the SAME padded
        shape so all upper layers of every build share a single
        compile unit: the wasted distance block (<= small_unit² evals)
        is far cheaper than a compile per layer shape. Mid layers
        (small_unit <= n_l < big — rare at geometric level sizes) round
        to small_unit multiples with correspondingly capped blocks."""
        if n_l >= big:
            return _round_up(n_l, big), q_block, col_block, sel_block
        if n_l <= small_unit:
            n_pad = min(small_unit, n_pad0)
            return n_pad, n_pad, n_pad, min(sel_block, n_pad)
        n_pad = min(_round_up(n_l, small_unit), n_pad0)
        return (n_pad, min(q_block, n_pad), min(col_block, n_pad),
                min(sel_block, n_pad))

    # ONE host->device upload, zero-padded to the largest (layer-0) padded
    # size; every layer slices a prefix on-device. Upper-layer prefixes
    # carry real rows of non-members past n_l instead of zeros — harmless,
    # all reductions mask by id >= n_real (the bucket path can lose at most
    # the one boundary bucket's winner per layer to such a row).
    packed_pad = np.concatenate(
        [packed, np.zeros((n_pad0 - n, w), np.uint32)])
    pops_pad = np.concatenate(
        [pops_np, np.zeros(n_pad0 - n, pops_np.dtype)])
    if mesh is not None:
        from rad_tpu.build.exact_sharded import replicate
        dev_packed = replicate(packed_pad, mesh)
        dev_pops = replicate(pops_pad, mesh)
    else:
        dev_packed = jnp.asarray(packed_pad)
        dev_pops = jnp.asarray(pops_pad)
    if impl is None:
        impl = tanimoto_impl(next(iter(dev_packed.devices())).platform)

    # the int8 forms run the selection's pairwise block on the tensor cores
    int8_pairs = impl != "swar"
    neighbors = []
    any_probed = False
    for l in range(max_level + 1):
        n_l = layer_sizes[l]
        cap = m0 if l == 0 else m
        if n_l <= 1:
            neighbors.append(jnp.full((n_l, cap), -1, jnp.int32))
            continue
        # k stays CONSTANT across layers (shape stability = compile
        # reuse); layers with fewer than k real neighbors just carry
        # INF/-1 tails, which selection and symmetrization already mask.
        # Clamped to the padded width: top_k/approx_max_k require
        # k <= reduction dim, so a small library (n_pad < candidates)
        # must not ask for more winners than the block holds — the two
        # shared compile units (small-layer, big-layer) each keep one k.
        n_pad, qb, cb, sb = _pad_for(n_l)
        k = min(candidates, n_pad)
        # layer 0 uses the whole upload: slicing would DUPLICATE the
        # matrix on device (1.28 GB at 10M) — reuse the buffer instead
        packed_l = dev_packed if n_pad == n_pad0 else dev_packed[:n_pad]
        pops_l = dev_pops if n_pad == n_pad0 else dev_pops[:n_pad]

        # the bucket reduction needs full-size blocks (and only the big
        # layers have a reduction wall to trim)
        bkt = block_bucket if block_bucket and n_l >= big else None
        csz = probe_csize or cb
        # csz % qb: a small/mid layer's shared compile unit can set a
        # q-block wider than the probe cluster — such layers keep the
        # exact stage (they are far below the subquadratic break-even
        # anyway) instead of raising in the probed driver
        # probe only where the exact stage is actually the wall: at 10M
        # the 625k layer-1 exact all-pairs is seconds of device time, and
        # exact upper layers navigate better (recall)
        use_probe = (probes is not None
                     and n_l >= probe_min_n
                     and -(-n_l // csz) >= 4 * probes
                     and k <= csz
                     and csz % qb == 0)
        if probes is not None and not use_probe:
            logger.info("layer %d (n=%d): probes=%d requested but layer "
                        "stays exact (below probe_min_n=%d, or too few "
                        "clusters, or k>csize)", l, n_l, probes,
                        probe_min_n)
        any_probed = any_probed or use_probe
        sharded_layer = mesh is not None and n_l >= big
        if use_probe:
            logger.info("layer %d: cluster-probed candidates "
                        "(%d clusters of %d, %d probes)",
                        l, -(-n_l // csz), csz, probes)
            stream = (stream_select if isinstance(stream_select, bool)
                      else n_pad * k * 8 > STREAM_SELECT_BYTES)
            stream = stream and not sharded_layer
            probed_kw = dict(
                bucket=bkt, interpret=interpret, probes=probes,
                probe_sample=probe_sample,
                seed=seed * 1_000_003 + 7919 * (l + 1),
                pairs_per_dispatch=pairs_per_dispatch,
                packed_host=packed[:n_l],
                mesh=mesh if sharded_layer else None,
                mesh_axis=mesh_axis,
                probe_granularity=probe_granularity,
                probe_width=probe_width)
            if stream:
                logger.info("layer %d: streamed scan+select (candidate "
                            "tables never materialized)", l)
                sel, sel_d = _allpairs_topk_probed(
                    packed_l, n_l, k, qb, csz, impl, approx_recall,
                    select_stream=(pops_l, min(m, cap), heuristic_k, sb,
                                   int8_pairs),
                    **probed_kw)
                cand_d = cand_id = None
            else:
                cand_d, cand_id = _allpairs_topk_probed(
                    packed_l, n_l, k, qb, csz, impl, approx_recall,
                    **probed_kw)
        elif sharded_layer:
            from rad_tpu.build.exact_sharded import allpairs_topk_sharded
            cand_d, cand_id = allpairs_topk_sharded(
                packed_l, n_l, k, qb, cb, impl, approx_recall,
                bkt, interpret, mesh, mesh_axis)
        else:
            cand_d, cand_id = _allpairs_topk_chunked(
                packed_l, n_l, k, qb, cb, impl, approx_recall,
                bucket=bkt, interpret=interpret,
                pairs_per_dispatch=pairs_per_dispatch)
        if cand_d is None:
            pass  # streamed scan+select produced sel/sel_d already
        elif sharded_layer:
            from rad_tpu.build.exact_sharded import select_layer_sharded
            sel, sel_d = select_layer_sharded(
                packed_l, pops_l, cand_d, cand_id, n_l, min(m, cap),
                heuristic_k, sb, mesh, mesh_axis, int8_pairs=int8_pairs)
        else:
            sel, sel_d = _select_layer_chunked(packed_l, pops_l, cand_d,
                                               cand_id, n_l, min(m, cap),
                                               heuristic_k, sb,
                                               int8_pairs=int8_pairs)
        # candidates are dead past selection — at 10M they are 5.1 GB
        # ([n_pad, 64] f32 + i32) that must not overlap the
        # symmetrization's own ~5 GB working set
        np.asarray(sel[-1:, -1:])  # frees lag dispatches
        del cand_d, cand_id
        if sharded_layer:
            from rad_tpu.build.exact_sharded import symmetrize_sharded
            neighbors.append(symmetrize_sharded(
                sel, sel_d, n_l, cap, mesh, mesh_axis)[:n_l])
            continue
        n_edges = 2 * n_pad * min(m, cap)
        if symm_mode is not None:
            mode = symm_mode
        elif 2 * n_pad > SYMM_EDGES_PER_SORT:
            # one column already exceeds the sort budget; bucketed
            # shards the merges by destination (~G× less merge work
            # than spanned at equal bounded-sort sizes)
            mode = "bucketed"
        elif n_edges >= 1 << 23:
            mode = "chunked"
        else:
            mode = "sort"
        if mode == "bucketed":
            rows = _symmetrize_bucketed(sel, sel_d, n_l, cap)
        elif mode == "spanned":
            rows = _symmetrize_spanned(sel, sel_d, n_l, cap)
        elif mode == "chunked":
            # chunk so no per-chunk sort exceeds ~4M rows
            cpc = max(1, (1 << 22) // (2 * n_pad))
            rows = _symmetrize_chunked(sel, sel_d, n_l, cap,
                                       cols_per_chunk=cpc)
        elif mode in ("sort", "two_pass"):
            rows = _symmetrize(sel, sel_d, n_l, cap,
                               two_pass=(mode == "two_pass"))
        else:
            raise ValueError(f"unknown symm_mode {mode!r}")
        neighbors.append(rows[:n_l])
        # big layers: the selection tables (3.8 GB at 30M) must not stay
        # bound through the NEXT layer's candidate stage
        np.asarray(neighbors[-1][-1:, -1:])
        del sel, sel_d, rows

    if probes is not None and not any_probed:
        # the probed build was requested but every layer was gated back
        # to the exact stage (probe_min_n default floor) — never silent:
        # the caller should know they got an exact build
        logger.warning(
            "probes=%d requested but NO layer used the probed candidate "
            "stage (all below probe_min_n=%d or too small) — this is a "
            "fully exact build; pass probe_min_n=0 to force probing",
            probes, probe_min_n)

    return HNSWGraph(
        packed=dev_packed[:n],
        popcounts=dev_pops[:n],
        # keys stay HOST int64: jnp.asarray canonicalizes to int32 with
        # x64 off (the repo default), silently wrapping >2^31 user keys
        keys=keys,
        levels=jnp.asarray(levels),
        neighbors=tuple(neighbors),
        ndim=ndim,
        connectivity=m,
    )
