"""Partition-and-stitch HNSW construction for beyond-single-builder scales.

The >=500M-molecule build path called for by docs/SCALING.md: split the
library into S shards (round-robin, so every shard is a uniform 1/S sample),
build an independent sub-graph per shard (embarrassingly parallel — on a pod
each chip runs its shard through the device builder; on hosts, one native
build per machine), then merge the sub-graphs into one level-sorted
:class:`~rad_tpu.graph.storage.HNSWGraph` and *stitch* the shard boundaries:

* **layer 0** — every node queries every *other* shard's sub-graph for its
  ``stitch_k`` cross-shard nearest neighbors (a batched HNSW search per
  shard pair, NOT a scan, so stitching costs O(N·(S-1)) searches and scales
  like the build itself). The resulting directed candidate edges are applied
  in both directions and each affected row is re-selected with the HNSW
  diversity heuristic over (existing ∪ entrants).
* **layers l >= 1** — memberships shrink geometrically (≈ N/M^l), so the
  cross-shard k-NN there is exact: a blocked brute-force top-k per shard
  pair, merged the same way. At-scale arithmetic: even at N=500M/M=16 the
  layer-1 stitch is ~31M queries × (N/M/S) db rows per pair ≈ 2×10¹⁴
  dist-evals — ~80 chip-minutes at the measured 4.4×10¹⁰/s kernel rate,
  embarrassingly parallel across shard pairs like everything else here.

Quality intuition: a random shard is a uniform sample of the library, so
each sub-graph is a valid HNSW over that sample; a node's true top-k has
≈ (S-1)/S of its mass in *other* shards, which is precisely what the
per-shard-pair searches recover. The merge never drops an intra-shard edge
unless the diversity heuristic prefers a cross-shard one.

Reference parity note: usearch builds one monolithic index on one host
(reference README.md:58; examples/DUDEZ_example.ipynb:192). This module
exists because a 2B-molecule build cannot — partitioned construction is the
multi-card analogue of "add more build machines".
"""

from __future__ import annotations

import logging
from typing import Callable, List, Tuple

import numpy as np

from rad_tpu.fp.pack import popcount_rows_np
from rad_tpu.graph.storage import HNSWGraph

logger = logging.getLogger(__name__)

__all__ = ["build_hnsw_partitioned"]


def _resolve_builder(builder) -> Callable[..., HNSWGraph]:
    """Map a builder name to a callable (same kwargs as build_hnsw)."""
    if callable(builder):
        return builder
    if builder == "host":
        from rad_tpu.build.reference import build_hnsw
        return build_hnsw
    if builder == "native":
        from rad_tpu.native import build_hnsw_native
        return build_hnsw_native
    if builder == "device":
        from rad_tpu.build.device import build_hnsw_device
        return build_hnsw_device
    if builder == "exact":
        from rad_tpu.build.exact import build_hnsw_exact
        return build_hnsw_exact
    if builder == "auto":
        try:
            from rad_tpu.native import build_hnsw_native as b
            b  # touch
            return b
        except Exception:  # pragma: no cover - native toolchain missing
            from rad_tpu.build.reference import build_hnsw
            return build_hnsw
    raise ValueError(f"unknown builder {builder!r}")


def _pair_dist_np(packed: np.ndarray, pops: np.ndarray,
                  a: np.ndarray, b: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """Tanimoto distance between id arrays ``a`` and ``b`` (same shape)."""
    sa = np.maximum(a, 0)
    sb = np.maximum(b, 0)
    inter = popcount_rows_np(packed[sa] & packed[sb]).astype(np.int64)
    union = pops[sa].astype(np.int64) + pops[sb] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        sim = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    d = (1.0 - sim).astype(np.float32)
    return np.where(valid, d, np.float32(np.inf))


def _merge_edges_into_layer(
    table: np.ndarray,
    packed: np.ndarray,
    pops: np.ndarray,
    e_src: np.ndarray,
    e_dst: np.ndarray,
    e_d: np.ndarray,
    heuristic: bool,
    heuristic_chunk: int = 2048,
) -> np.ndarray:
    """Apply directed candidate edges (src→dst, d) to a padded layer table.

    Both directions are merged: every edge also enters as (dst→src, d).
    Each affected row is rewritten as a selection over
    (existing neighbors ∪ candidate entrants): the HNSW diversity heuristic
    with backfill when ``heuristic`` (matches the reference builder's
    overflow re-pruning, rad_tpu.build.reference._add_reverse), else the
    plain distance-top-cap (the device builder's stitch rule).
    """
    cap = table.shape[1]
    # both directions
    src = np.concatenate([e_src, e_dst])
    dst = np.concatenate([e_dst, e_src])
    d = np.concatenate([e_d, e_d])

    # group by src, ascending distance; keep at most `cap` entrants per row
    # (more can never survive the top-cap selection)
    order = np.lexsort((d, src))
    src, dst, d = src[order], dst[order], d[order]
    first = np.empty(src.shape, np.bool_)
    first[:1] = True
    first[1:] = src[1:] != src[:-1]
    group = np.cumsum(first) - 1
    starts = np.flatnonzero(first)
    rank = np.arange(src.shape[0]) - starts[group]
    keep = rank < cap
    rows_aff = src[starts]                       # unique affected rows
    r = rows_aff.shape[0]
    ent_ids = np.full((r, cap), -1, np.int64)
    ent_d = np.full((r, cap), np.inf, np.float32)
    ent_ids[group[keep], rank[keep]] = dst[keep]
    ent_d[group[keep], rank[keep]] = d[keep]

    existing = table[rows_aff].astype(np.int64)  # [R, cap]
    ex_valid = existing >= 0
    ex_d = _pair_dist_np(packed, pops,
                         np.broadcast_to(rows_aff[:, None], existing.shape),
                         existing, ex_valid)

    all_ids = np.concatenate([existing, ent_ids], axis=1)   # [R, 2cap]
    all_d = np.concatenate([ex_d, ent_d], axis=1)

    # per-row dedupe (an entrant may already be an edge, or appear in both
    # directions): sort by id, invalidate repeats, then sort ascending by d
    by_id = np.argsort(all_ids, axis=1, kind="stable")
    ri = np.arange(r)[:, None]
    sid = np.take_along_axis(all_ids, by_id, axis=1)
    dup = np.zeros_like(sid, np.bool_)
    dup[:, 1:] = (sid[:, 1:] == sid[:, :-1]) & (sid[:, 1:] >= 0)
    dup_orig = np.zeros_like(dup)
    np.put_along_axis(dup_orig, by_id, dup, axis=1)
    all_d = np.where(dup_orig | (all_ids < 0), np.inf, all_d)

    by_d = np.argsort(all_d, axis=1, kind="stable")
    cand_ids = np.take_along_axis(all_ids, by_d, axis=1)
    cand_d = np.take_along_axis(all_d, by_d, axis=1)
    cand_ids = np.where(np.isfinite(cand_d), cand_ids, -1)

    if not heuristic:
        table[rows_aff] = cand_ids[:, :cap].astype(np.int32)
        return table

    # diversity heuristic, vectorized on device (same code path as the
    # batched device builder) in fixed-size chunks — one compile per
    # (chunk, k, cap) shape regardless of row count
    import jax
    import jax.numpy as jnp
    from rad_tpu.build.device import _select_neighbors

    sel_jit = jax.jit(_select_neighbors, static_argnums=(5, 6))
    packed_d = jnp.asarray(packed)
    pops_d = jnp.asarray(pops)
    k = cand_ids.shape[1]
    chunk = min(heuristic_chunk, max(r, 1))
    for lo in range(0, r, chunk):
        hi = min(lo + chunk, r)
        b = hi - lo
        pad = chunk - b
        rows_c = np.concatenate([rows_aff[lo:hi], np.zeros(pad, np.int64)])
        d_c = np.concatenate(
            [cand_d[lo:hi], np.full((pad, k), np.inf, np.float32)])
        id_c = np.concatenate(
            [cand_ids[lo:hi], np.full((pad, k), -1, np.int64)])
        active = np.concatenate([np.ones(b, bool), np.zeros(pad, bool)])
        sel = sel_jit(packed_d, pops_d,
                      jnp.asarray(rows_c.astype(np.int32)),
                      jnp.asarray(d_c), jnp.asarray(id_c.astype(np.int32)),
                      cap, k, jnp.asarray(active))
        table[rows_aff[lo:hi]] = np.asarray(sel)[:b]
    return table


def build_hnsw_partitioned(
    packed: np.ndarray,
    keys: np.ndarray | None = None,
    n_shards: int = 4,
    connectivity: int = 16,
    expansion_add: int = 200,
    ndim: int | None = None,
    seed: int = 0,
    builder: str | Callable[..., HNSWGraph] = "auto",
    stitch_k: int | None = None,
    stitch_ef: int | None = None,
    heuristic: bool = True,
    search_chunk: int = 4096,
    builder_kwargs: dict | None = None,
) -> HNSWGraph:
    """Build an HNSW graph by partitioning, independent sub-builds, and a
    cross-shard stitch. Same parameter semantics as
    :func:`rad_tpu.build.reference.build_hnsw`, plus:

    n_shards:   number of partitions (round-robin over input rows).
    builder:    'auto' (native C++ if available, else host), 'host',
                'native', 'device', 'exact' (the all-pairs builder —
                the accelerator's per-shard choice; its O(shard²)
                distances are exactly the regime sharding creates), or a
                callable with build_hnsw's kwargs — runs once per shard.
                On a pod, map shards onto chips per-process.
    stitch_k:   cross-shard nearest neighbors requested per (node, shard)
                pair for the layer-0 stitch (default: ``connectivity``).
    stitch_ef:  search beam width for the stitch queries
                (default: ``max(64, 2*stitch_k)``).
    heuristic:  re-select stitched rows with the HNSW diversity heuristic
                (default) instead of a plain distance-top-cap merge.
    builder_kwargs: extra kwargs forwarded verbatim to every per-shard
                builder call — e.g. ``{"probes": 16}`` routes 'exact'
                shards through the subquadratic cluster-probed candidate
                stage (:func:`rad_tpu.build.exact.build_hnsw_exact`).
                Must match the chosen builder's signature.

    Deterministic given (packed, seed, n_shards, builder, stitch params).
    """
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    ndim = ndim or w * 32
    m = connectivity
    if keys is None:
        keys = np.arange(n, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    n_shards = min(n_shards, n)
    build = _resolve_builder(builder)
    if n_shards == 1:
        return build(packed, keys=keys, connectivity=m,
                     expansion_add=expansion_add, ndim=ndim, seed=seed,
                     **(builder_kwargs or {}))
    stitch_k = stitch_k or m
    stitch_ef = stitch_ef or max(64, 2 * stitch_k)

    # ------------------------------------------------------------ partition
    shard_of = np.arange(n) % n_shards           # uniform sample per shard
    sub_graphs: List[HNSWGraph] = []
    for s in range(n_shards):
        idx = np.flatnonzero(shard_of == s)
        logger.info("building shard %d/%d (%d nodes)", s + 1, n_shards,
                    idx.size)
        # sub keys = ORIGINAL row indices, so local ids map back exactly
        g = build(packed[idx], keys=idx.astype(np.int64), connectivity=m,
                  expansion_add=expansion_add, ndim=ndim,
                  seed=seed * 1_000_003 + s, **(builder_kwargs or {}))
        sub_graphs.append(g)

    # -------------------------------------------------------------- merge
    levels_orig = np.empty(n, np.int32)
    for g in sub_graphs:
        levels_orig[np.asarray(g.keys)] = np.asarray(g.levels)
    order = np.lexsort((np.arange(n), -levels_orig))
    gid_of_orig = np.empty(n, np.int64)
    gid_of_orig[order] = np.arange(n)
    g_packed = packed[order]
    g_pops = popcount_rows_np(g_packed)
    g_levels = levels_orig[order]
    g_shard = shard_of[order]
    max_level = int(g_levels[0]) if n else 0
    layer_sizes = [int((g_levels >= l).sum()) for l in range(max_level + 1)]

    tables: List[np.ndarray] = [
        np.full((layer_sizes[l], 2 * m if l == 0 else m), -1, np.int32)
        for l in range(max_level + 1)
    ]
    sub_gids: List[np.ndarray] = []              # local id -> global id
    for g in sub_graphs:
        l2g = gid_of_orig[np.asarray(g.keys)]
        sub_gids.append(l2g)
        for l, t in enumerate(g.neighbors):
            t = np.asarray(t)
            n_l = t.shape[0]
            mapped = np.where(t >= 0,
                              l2g[np.maximum(t, 0).astype(np.int64)],
                              -1).astype(np.int32)
            rows = l2g[:n_l]
            # table width can exceed the sub table's (never narrower)
            tables[l][rows, : t.shape[1]] = mapped

    # -------------------------------------------------------------- stitch
    # layer 0: per shard pair (s queries t), batched sub-graph searches
    from rad_tpu.search.knn import search_device

    e_src: List[np.ndarray] = []
    e_dst: List[np.ndarray] = []
    e_d: List[np.ndarray] = []
    for t, g_t in enumerate(sub_graphs):
        k_t = min(stitch_k, len(g_t))
        if k_t == 0:
            continue
        l2g_t = sub_gids[t]
        for s in range(n_shards):
            if s == t:
                continue
            q_orig = np.flatnonzero(shard_of == s)
            d_st, i_st = search_device(
                g_t, packed[q_orig], k=k_t,
                expansion_search=max(stitch_ef, k_t),
                chunk_size=search_chunk)
            d_st = np.asarray(d_st)
            i_st = np.asarray(i_st)
            valid = i_st >= 0
            src = np.broadcast_to(
                gid_of_orig[q_orig][:, None], i_st.shape)[valid]
            dst = l2g_t[np.maximum(i_st, 0).astype(np.int64)][valid]
            e_src.append(src)
            e_dst.append(dst)
            e_d.append(d_st[valid])
    if e_src:
        tables[0] = _merge_edges_into_layer(
            tables[0], g_packed, g_pops,
            np.concatenate(e_src), np.concatenate(e_dst),
            np.concatenate(e_d), heuristic)

    # layers >= 1: exact cross-shard k-NN among the (small) layer members
    if max_level >= 1:
        import jax.numpy as jnp
        from rad_tpu.fp.tanimoto import bruteforce_topk_blocked

        for l in range(1, max_level + 1):
            n_l = layer_sizes[l]
            members = np.arange(n_l)
            e_src, e_dst, e_d = [], [], []
            for t in range(n_shards):
                mem_t = members[g_shard[:n_l] == t]
                if mem_t.size == 0:
                    continue
                k_t = min(stitch_k, mem_t.size)
                q_mem = members[g_shard[:n_l] != t]
                if q_mem.size == 0:
                    continue
                d_qt, j_qt = bruteforce_topk_blocked(
                    jnp.asarray(g_packed[q_mem]),
                    jnp.asarray(g_packed[mem_t]), k_t)
                d_qt = np.asarray(d_qt)
                j_qt = np.asarray(j_qt)
                valid = np.isfinite(d_qt)
                src = np.broadcast_to(q_mem[:, None], j_qt.shape)[valid]
                dst = mem_t[np.maximum(j_qt, 0).astype(np.int64)][valid]
                e_src.append(src)
                e_dst.append(dst)
                e_d.append(d_qt[valid])
            if e_src:
                tables[l] = _merge_edges_into_layer(
                    tables[l], g_packed, g_pops,
                    np.concatenate(e_src), np.concatenate(e_dst),
                    np.concatenate(e_d), heuristic)

    import jax.numpy as jnp
    return HNSWGraph(
        packed=jnp.asarray(g_packed),
        popcounts=jnp.asarray(g_pops),
        keys=keys[order],  # host int64 (jnp would truncate to int32)
        levels=jnp.asarray(g_levels),
        neighbors=tuple(tables),
        ndim=ndim,
        connectivity=m,
    )
