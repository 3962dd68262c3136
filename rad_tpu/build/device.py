"""Batched on-device HNSW construction (JAX/XLA).

The accelerator rethink of usearch's C++ insert loop (SURVEY.md §7 hard part #1).
The reference inserts one vector at a time — greedy descent, an
``expansion_add``-wide beam, heuristic pruning, bidirectional relinking —
under fine-grained locks. On a device the same algorithm is reorganized around
batches and static shapes:

1. **Levels up front** — levels are sampled for the whole library and nodes
   are re-ordered level-descending (rad_tpu.graph.storage id scheme), so
   construction is one pass of batched insertions against a growing prefix.
2. **Batched forward search** — all B nodes of a batch run the greedy
   descent + per-layer beam *in parallel* against the already-built prefix
   (a mask hides ids ≥ batch start). One jitted ``insert_batch`` program per
   batch; XLA sees only gathers, popcounts, sorts and masked top-ks.
3. **Vectorized neighbor-selection heuristic** — the diversity rule
   (candidate kept iff closer to the query than to every kept candidate,
   Algorithm 4 of the HNSW paper) runs as a masked scan over the top
   ``heuristic_k`` candidates with a precomputed candidate-pairwise distance
   block, then backfills (keepPrunedConnections).
4. **Reverse links as sorted segment merges** — instead of per-node locked
   appends, all (target j ← new i) edges of a batch are sorted by
   (j, distance); each affected row gathers its ≤M0 best entrants plus its
   existing neighbors and is re-written as the distance-top-M0 of the union.
   Taking only the best M0 entrants per row is lossless: no more than M0
   entries can survive the merge anyway.
5. **Intra-batch stitch** — nodes of one batch cannot see each other during
   the forward search (the prefix mask), which would lose locality that the
   sequential algorithm has. A layer-0 stitch pass computes the batch's
   B×B distance block (one popcount block) and distance-merges
   each node's nearest in-batch peers into its row, both directions.

Builds are deterministic given (fingerprints, seed, batch_size).

Memory note: the beam's visited set is a per-node fixed-capacity id hash
table [B, H] (rad_tpu.search.visited) with H set by expansion_add — batch
memory is independent of library size, so device builds scale to HBM-sized
libraries; billion-scale construction shards over the pod (per-shard
sub-graphs + stitch, rad_tpu.parallel).
"""

from __future__ import annotations

import logging
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rad_tpu.build.reference import sample_levels
from rad_tpu.fp.pack import popcount, popcount_rows_np
from rad_tpu.graph.storage import HNSWGraph

logger = logging.getLogger(__name__)

__all__ = ["build_hnsw_device"]

INF = jnp.inf


def _dist_rows(packed, pops, q_ids, cand_ids, valid):
    """Tanimoto dist between node q (by id) and candidate ids.

    q_ids: [B], cand_ids: [B, K], valid: [B, K] → [B, K] f32 (+inf masked).
    """
    q = packed[q_ids]                       # [B, W]
    safe = jnp.maximum(cand_ids, 0)
    c = packed[safe]                        # [B, K, W]
    inter = jnp.sum(popcount(c & q[:, None, :]), axis=-1)
    union = pops[q_ids][:, None] + pops[safe] - inter
    sim = jnp.where(union > 0, inter / jnp.maximum(union, 1), 1.0)
    return jnp.where(valid, (1.0 - sim).astype(jnp.float32), INF)


def _beam_search_batch(packed, pops, adj_l, q_ids, ep_ids, ep_ds,
                       prefix_limit, active, ef: int, n: int,
                       extra_visible=None):
    """Masked batched beam search at one layer over the built prefix.

    adj_l: [N_l, M_l]; ep_ids/ep_ds: [B, S] seed candidates; active: [B]
    (inactive rows keep their seeds). Returns (beam_d, beam_id) [B, ef]
    ascending. Candidates with id >= prefix_limit (not yet inserted) are
    invisible — unless ``extra_visible`` (an [>=N_l] bool array in node-id
    space) marks them visible, which is how incremental insertion
    (rad_tpu.build.incremental) exposes the pre-existing graph whose node
    ids interleave with the new nodes'.

    The visited set is size-gated (rad_tpu.search.visited): a dense
    [B, N] bitmap while it fits the memory budget (exact, one gather +
    one scatter), else a fixed-capacity id hash table [B, H] with H
    independent of N. In hash mode a beam-membership mask keeps results
    exact if a (rare) insert fails and a generous iteration cap bounds
    tie-churn.
    """
    from rad_tpu.search.visited import (hashset_check_insert_batch,
                                        use_dense_visited,
                                        visited_capacity_for)

    b, s = ep_ids.shape
    m_l = adj_l.shape[1]
    dense = use_dense_visited(b, n)
    max_iters = 16 * ef + 256

    beam_d = jnp.full((b, ef), INF).at[:, :s].set(
        jnp.where(active[:, None], ep_ds, INF))
    beam_id = jnp.full((b, ef), -1, jnp.int32).at[:, :s].set(
        jnp.where(active[:, None], ep_ids, -1))
    # sort seeds ascending
    beam_d, beam_id = jax.lax.sort((beam_d, beam_id), num_keys=1)
    expanded = ~jnp.isfinite(beam_d)
    if dense:
        # sentinel-index scatter: invalid slots (-1) map out of range and
        # drop — never clamp to a real column
        visited = jnp.zeros((b, n), jnp.bool_).at[
            jnp.arange(b)[:, None],
            jnp.where(beam_id >= 0, beam_id, n)].set(True, mode="drop")
    else:
        h = visited_capacity_for(ef, m_l, n)
        visited = jnp.full((b, h), -1, jnp.int32)
        visited, _ = hashset_check_insert_batch(visited, beam_id,
                                                beam_id >= 0)

    def cond(c):
        beam_d, beam_id, expanded, visited, it = c
        return jnp.any(~expanded & jnp.isfinite(beam_d)) & (it < max_iters)

    def body(c):
        beam_d, beam_id, expanded, visited, it = c
        sel = jnp.argmin(jnp.where(expanded, INF, beam_d), axis=1)   # [B]
        rowsel = jnp.arange(b)
        has_work = ~expanded[rowsel, sel] & jnp.isfinite(beam_d[rowsel, sel])
        expanded = expanded.at[rowsel, sel].set(True)
        u = jnp.maximum(beam_id[rowsel, sel], 0)
        nbrs = adj_l[u]                                              # [B, M_l]
        vis = nbrs < prefix_limit[:, None]
        if extra_visible is not None:
            vis = vis | extra_visible[jnp.maximum(nbrs, 0)]
        valid = (nbrs >= 0) & vis & has_work[:, None]
        if dense:
            seen = visited[rowsel[:, None], jnp.maximum(nbrs, 0)]
            valid = valid & ~seen
            visited = visited.at[
                rowsel[:, None], jnp.where(valid, nbrs, n)].set(
                True, mode="drop")
        else:
            in_beam = jnp.any(
                nbrs[:, :, None] == beam_id[:, None, :], axis=2)
            valid = valid & ~in_beam
            visited, seen = hashset_check_insert_batch(visited, nbrs,
                                                       valid)
            valid = valid & ~seen
        d_n = _dist_rows(packed, pops, q_ids, nbrs, valid)
        all_d = jnp.concatenate([beam_d, d_n], axis=1)
        all_i = jnp.concatenate([beam_id, jnp.where(valid, nbrs, -1)],
                                axis=1)
        all_e = jnp.concatenate(
            [expanded, jnp.zeros((b, m_l), jnp.bool_)], axis=1)
        sd, si, se = jax.lax.sort((all_d, all_i, all_e), num_keys=1)
        return sd[:, :ef], si[:, :ef], se[:, :ef], visited, it + 1

    beam_d, beam_id, expanded, visited, _ = jax.lax.while_loop(
        cond, body, (beam_d, beam_id, expanded, visited, jnp.int32(0)))
    return beam_d, beam_id


def _select_neighbors(packed, pops, q_ids, cand_d, cand_id, m: int,
                      heuristic_k: int, active, int8_pairs: bool = False):
    """Vectorized HNSW neighbor-selection heuristic with backfill.

    cand_d/cand_id: [B, K] ascending. Returns sel_ids [B, m] (-1 padded),
    in candidate order (matches the sequential heuristic's output order).

    ``int8_pairs``: compute the [B, kh, kh] pairwise-intersection block as
    a batched int8 matmul over bit-unpacked candidate rows (exact — 0/1
    dots) instead of the SWAR popcount broadcast; same values, on the
    tensor cores. Used by the exact builder's selection stage.
    """
    b, k = cand_d.shape
    kh = min(heuristic_k, k)
    top_d = cand_d[:, :kh]
    top_i = cand_id[:, :kh]
    valid = jnp.isfinite(top_d) & (top_i >= 0) & active[:, None]

    # pairwise distances among the top-kh candidates
    safe = jnp.maximum(top_i, 0)
    rows = packed[safe]                               # [B, kh, W]
    if int8_pairs:
        from rad_tpu.fp.tanimoto import unpack_bitmajor
        bits = unpack_bitmajor(rows, jnp.int8)        # [B, kh, d]
        inter = jax.lax.dot_general(
            bits, bits,
            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)         # [B, kh, kh]
    else:
        inter = jnp.sum(popcount(rows[:, :, None, :] & rows[:, None, :, :]),
                        axis=-1)
    p = pops[safe]
    union = p[:, :, None] + p[:, None, :] - inter
    sim = jnp.where(union > 0, inter / jnp.maximum(union, 1), 1.0)
    pair_d = (1.0 - sim).astype(jnp.float32)          # [B, kh, kh]

    def heur_step(j, carry):
        sel_mask, n_sel = carry
        d_cq = top_d[:, j]
        d_cs = pair_d[:, j, :]                        # [B, kh]
        viol = jnp.any(sel_mask & (d_cs <= d_cq[:, None]), axis=1)
        take = valid[:, j] & ~viol & (n_sel < m)
        sel_mask = sel_mask.at[:, j].set(take)
        return sel_mask, n_sel + take.astype(jnp.int32)

    sel_mask = jnp.zeros((b, kh), jnp.bool_)
    n_sel = jnp.zeros((b,), jnp.int32)
    sel_mask, n_sel = jax.lax.fori_loop(0, kh, heur_step, (sel_mask, n_sel))

    def backfill_step(j, carry):
        sel_mask, n_sel = carry
        take = valid[:, j] & ~sel_mask[:, j] & (n_sel < m)
        sel_mask = sel_mask.at[:, j].set(sel_mask[:, j] | take)
        return sel_mask, n_sel + take.astype(jnp.int32)

    sel_mask, n_sel = jax.lax.fori_loop(0, kh, backfill_step,
                                        (sel_mask, n_sel))

    # compact selected ids (in candidate order) into [B, m]
    order_key = jnp.where(sel_mask,
                          jnp.arange(kh, dtype=jnp.int32)[None, :], kh)
    sort_key, sorted_ids = jax.lax.sort(
        (order_key, jnp.where(sel_mask, top_i, -1)), num_keys=1)
    return sorted_ids[:, :m]


def _apply_reverse_links(packed, pops, adj_l, fwd_ids, src_ids, cap: int,
                         active):
    """Distance-merge reverse edges (j ← i) into the rows of all targets.

    fwd_ids: [B, m] forward selections of src_ids [B]. Each affected row j
    is rewritten as the distance-top-cap of (existing ∪ new entrants).
    """
    b, m = fwd_ids.shape
    k = b * m
    n_l = adj_l.shape[0]

    j_flat = fwd_ids.reshape(-1)
    i_flat = jnp.repeat(src_ids, m)
    ok = (j_flat >= 0) & jnp.repeat(active, m)
    # d(i, j) for each pair
    d_flat = _dist_rows(packed, pops,
                        jnp.maximum(i_flat, 0),
                        jnp.maximum(j_flat, 0)[:, None],
                        ok[:, None])[:, 0]
    j_key = jnp.where(ok, j_flat, n_l)  # sentinel sorts last
    sj, sd, si = jax.lax.sort((j_key, d_flat, i_flat), num_keys=2)

    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sj[1:] != sj[:-1]]) & (sj < n_l)
    # entrants for row r (a first-occurrence p): positions p..p+cap-1 where
    # sj still equals sj[p]
    offs = jnp.arange(cap, dtype=jnp.int32)
    pos = jnp.arange(k, dtype=jnp.int32)[:, None] + offs[None, :]  # [k, cap]
    pos_c = jnp.minimum(pos, k - 1)
    ent_same = (sj[pos_c] == sj[:, None]) & (pos < k)
    ent_ids = jnp.where(ent_same, si[pos_c], -1)
    ent_d = jnp.where(ent_same, sd[pos_c], INF)

    row_j = jnp.where(first, sj, 0)
    existing = adj_l[row_j]                                  # [k, cap_row]
    ex_valid = (existing >= 0) & first[:, None]
    ex_d = _dist_rows(packed, pops, row_j, existing, ex_valid)

    all_ids = jnp.concatenate([existing, ent_ids], axis=1)
    all_d = jnp.concatenate(
        [jnp.where(ex_valid, ex_d, INF),
         jnp.where(first[:, None], ent_d, INF)], axis=1)
    # dedupe (an entrant can't already exist, but two batches could have
    # produced duplicates defensively): sort by (d) and keep cap best
    sd2, sids2 = jax.lax.sort((all_d, all_ids), num_keys=1)
    new_rows = jnp.where(jnp.isfinite(sd2[:, :cap]), sids2[:, :cap], -1)

    write_j = jnp.where(first, sj, n_l)
    return adj_l.at[write_j].set(new_rows, mode="drop")


def _stitch_batch(packed, pops, adj0, batch_ids, active, m: int, cap: int):
    """Layer-0 intra-batch stitch: distance-merge each batch node's nearest
    in-batch peers into its row (both directions via symmetry of the loop)."""
    b = batch_ids.shape[0]
    q = packed[batch_ids]
    inter = jnp.sum(popcount(q[:, None, :] & q[None, :, :]), axis=-1)
    p = pops[batch_ids]
    union = p[:, None] + p[None, :] - inter
    sim = jnp.where(union > 0, inter / jnp.maximum(union, 1), 1.0)
    d = (1.0 - sim).astype(jnp.float32)
    mask = active[:, None] & active[None, :] \
        & ~jnp.eye(b, dtype=jnp.bool_)
    d = jnp.where(mask, d, INF)
    neg, idx = jax.lax.top_k(-d, min(m, b))
    peer_d = -neg                                            # [B, m]
    peer_ids = jnp.where(jnp.isfinite(peer_d), batch_ids[idx], -1)

    existing = adj0[batch_ids]
    ex_valid = (existing >= 0) & active[:, None]
    ex_d = _dist_rows(packed, pops, batch_ids, existing, ex_valid)
    all_ids = jnp.concatenate([existing, peer_ids], axis=1)
    all_d = jnp.concatenate([jnp.where(ex_valid, ex_d, INF), peer_d],
                            axis=1)
    sd, sids = jax.lax.sort((all_d, all_ids), num_keys=1)
    new_rows = jnp.where(jnp.isfinite(sd[:, :cap]), sids[:, :cap], -1)
    write = jnp.where(active, batch_ids, adj0.shape[0])
    return adj0.at[write].set(new_rows, mode="drop")


def _make_insert_batch(n: int, layer_sizes: Tuple[int, ...], m: int,
                       ef: int, heuristic_k: int, batch: int,
                       stitch: bool):
    """Build the jitted insert_batch for a fixed problem geometry."""
    max_level = len(layer_sizes) - 1

    @jax.jit
    def insert_batch(adj_layers, packed, pops, levels, b_lo):
        batch_ids = b_lo + jnp.arange(batch, dtype=jnp.int32)
        active = batch_ids < n
        safe_ids = jnp.minimum(batch_ids, n - 1)
        lv = levels[safe_ids]
        prefix = jnp.broadcast_to(b_lo, (batch,))

        # entry point: node 0 (top of the hierarchy)
        ep = jnp.zeros((batch,), jnp.int32)
        d_ep = _dist_rows(packed, pops, safe_ids, ep[:, None],
                          active[:, None])[:, 0]
        eps_d = d_ep[:, None]
        eps_i = ep[:, None]

        new_layers = list(adj_layers)
        for l in range(max_level, -1, -1):
            adj_l = new_layers[l]
            in_layer = (lv >= l) & active
            above = (lv < l) & active

            # greedy step for nodes whose level < l (descend only)
            def greedy_cond(c):
                ep_i, ep_di, improved = c
                return jnp.any(improved)

            def greedy_body(c):
                ep_i, ep_di, improved = c
                nbrs = adj_l[jnp.minimum(ep_i, adj_l.shape[0] - 1)]
                valid = (nbrs >= 0) & above[:, None] & improved[:, None]
                d_n = _dist_rows(packed, pops, safe_ids, nbrs, valid)
                jbest = jnp.argmin(d_n, axis=1)
                dbest = d_n[jnp.arange(batch), jbest]
                better = dbest < ep_di
                return (jnp.where(better, nbrs[jnp.arange(batch), jbest],
                                  ep_i),
                        jnp.where(better, dbest, ep_di),
                        better)

            g_ep, g_d, _ = jax.lax.while_loop(
                greedy_cond, greedy_body,
                (eps_i[:, 0], eps_d[:, 0], above))

            # beam for nodes that live on this layer
            beam_d, beam_id = _beam_search_batch(
                packed, pops, adj_l, safe_ids, eps_i, eps_d,
                prefix, in_layer, ef, n)

            cap = adj_l.shape[1]
            sel = _select_neighbors(packed, pops, safe_ids, beam_d, beam_id,
                                    min(m, cap), heuristic_k, in_layer)

            # forward write (only in-layer rows; others dropped)
            write_rows = jnp.where(in_layer, safe_ids, adj_l.shape[0])
            fwd = jnp.full((batch, cap), -1, jnp.int32).at[
                :, : sel.shape[1]].set(sel)
            adj_l = adj_l.at[write_rows].set(fwd, mode="drop")

            # reverse links
            adj_l = _apply_reverse_links(packed, pops, adj_l, sel, safe_ids,
                                         cap, in_layer)

            if l == 0 and stitch:
                adj_l = _stitch_batch(packed, pops, adj_l, safe_ids, active,
                                      m, cap)

            new_layers[l] = adj_l

            # seeds for the next layer down: beam results if on this layer,
            # else the greedy entry point
            eps_d = jnp.where(in_layer[:, None], beam_d[:, :ef],
                              jnp.concatenate(
                                  [g_d[:, None],
                                   jnp.full((batch, ef - 1), INF)], axis=1))
            eps_i = jnp.where(in_layer[:, None], beam_id[:, :ef],
                              jnp.concatenate(
                                  [g_ep[:, None],
                                   jnp.full((batch, ef - 1), -1,
                                            jnp.int32)], axis=1))
        return tuple(new_layers)

    return insert_batch


def build_hnsw_device(
    packed: np.ndarray,
    keys: np.ndarray | None = None,
    connectivity: int = 16,
    expansion_add: int = 200,
    ndim: int | None = None,
    seed: int = 0,
    batch_size: int = 128,
    heuristic_k: int | None = None,
    stitch: bool = True,
    fused_loop: bool = False,
) -> HNSWGraph:
    """Build an HNSW graph with batched on-device insertion.

    Same parameter semantics as the host builder
    (rad_tpu.build.reference.build_hnsw); ``batch_size`` trades build speed
    against fidelity to the sequential insertion order (nodes within a batch
    see each other only through the stitch pass). ``fused_loop`` compiles
    the whole insertion sweep into one ``fori_loop`` program — use it on
    high-dispatch-latency links; the stepwise default keeps compiles small.
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

    levels_raw = sample_levels(n, m, seed)
    order = np.lexsort((np.arange(n), -levels_raw))
    packed = packed[order]
    keys = keys[order]
    levels = levels_raw[order]
    max_level = int(levels[0]) if n else 0
    layer_sizes = tuple(int((levels >= l).sum()) for l in range(max_level + 1))

    packed_d = jnp.asarray(packed)
    pops_d = jnp.asarray(popcount_rows_np(packed))
    levels_d = jnp.asarray(levels)
    adj_layers = tuple(
        jnp.full((layer_sizes[l], m0 if l == 0 else m), -1, jnp.int32)
        for l in range(max_level + 1)
    )

    ef = max(expansion_add, m0)
    insert_batch = _make_insert_batch(n, layer_sizes, m, ef, heuristic_k,
                                      batch_size, stitch)

    n_batches = math.ceil(max(n - 1, 0) / batch_size)
    if fused_loop:
        # one compiled program for the whole build: no per-batch dispatch
        # (matters on high-latency device links)
        @jax.jit
        def build_all(layers, packed_a, pops_a, levels_a):
            def body(bi, ls):
                b_lo = (1 + bi * batch_size).astype(jnp.int32)
                return insert_batch(ls, packed_a, pops_a, levels_a, b_lo)
            return jax.lax.fori_loop(0, n_batches, body, layers)

        adj_layers = build_all(adj_layers, packed_d, pops_d, levels_d)
    else:
        for bi in range(n_batches):
            b_lo = 1 + bi * batch_size  # node 0 needs no insertion
            adj_layers = insert_batch(adj_layers, packed_d, pops_d,
                                      levels_d, jnp.int32(b_lo))
    adj_layers = jax.block_until_ready(adj_layers)

    return HNSWGraph(
        packed=packed_d,
        popcounts=jnp.asarray(popcount_rows_np(packed)),
        keys=keys,  # host int64 (jnp would truncate to int32)
        levels=levels_d,
        neighbors=tuple(np.asarray(t) for t in adj_layers),
        ndim=ndim,
        connectivity=m,
    )
