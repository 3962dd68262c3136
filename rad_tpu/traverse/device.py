"""Device-resident best-first traversal engine (the accelerator hot path).

The reference serializes its traversal state through Redis — ZSET frontier,
visited SET, scored HASH, with Lua scripts for atomicity
(rad/priority_queue.py, rad/visited.py, rad/scored.py) — because shared
mutable state on CPU needs an external arbiter. Here the entire state lives
in HBM as arrays and one jitted step performs pop → neighbor gather →
dedup → frontier merge as a single compiled program: atomic *by construction*
(SURVEY.md §7 design stance).

Data layout
-----------
All per-layer structures are flattened by the *row* trick: because node ids
are level-sorted (rad_tpu.graph.storage), layer ``l`` is the id range
``[0, N_l)``, and the pair (node, level) maps to a single int32
``row = layer_offset[l] + node`` with ``R = Σ_l N_l ≈ N·M/(M-1)`` total rows.
The frontier stores (score, row); the per-(node, level) "visited/enqueued"
set is one ``[R] bool``; the adjacency is one ``[R, M0] int32`` table.
Level is recovered with a searchsorted over the (≤ ~8-entry) offset vector.

Traversal-step semantics preserved exactly (SURVEY.md §0): pop the global
minimum; expand its neighbors at its level; score each neighbor at most once
globally; enqueue each (neighbor, level) at most once; descend the expanded
node to level-1 with its own score; lower score = better.

The user scoring function is host-side Python (a docking program / ML model),
so the step is split at the scoring boundary into two jitted halves —
``expand`` (pop + gather + emit unscored candidate ids) and ``integrate``
(write scores + visited/enqueued updates + frontier merge) — driven by
:class:`DeviceTraverser`, which overlaps host scoring of batch *k* with
device expansion of batch *k+1* (the analogue of the reference's
prefetch-proxy pipeline, rad/coordination_service.py:314-347).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rad_tpu.graph.storage import HNSWGraph

__all__ = ["DeviceGraph", "TraversalState", "prepare_device_graph",
           "pack_device_graph", "init_state", "auto_frontier_capacity",
           "expand", "integrate", "prime"]

INF = jnp.inf


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceGraph:
    """Traversal view of an HNSWGraph: one flat padded adjacency table.

    adj:        [R, M0] int32 — neighbor node ids, -1 padded; row r encodes
                (node, level) per the row trick above. When ``adj_bits <
                32`` the table is instead ``[R, ceil(M0*adj_bits/32)]
                uint32`` bit-packed rows (rad_tpu.graph.adjpack) and the
                expansion gather decodes each popped batch on the fly —
                the single-card scale lever for graphs whose int32 table
                alone would not fit in device memory. ``adj_group = G > 1`` stores G packed rows per
                table row (``[R/G, G*W]``) so the minor dim is a multiple
                of 8 words — XLA pads HBM minor dims to 8-element
                multiples, which otherwise restores the int32 footprint
                (rad_tpu.graph.adjpack.adj_group_for).
    offsets:    [L+2] int32 — layer_offset[l] = Σ_{l' < l} N_{l'};
                offsets[L+1] = R sentinel.
    """

    adj: jnp.ndarray
    offsets: jnp.ndarray
    n_nodes: int
    n_rows: int
    m0: int
    max_level: int
    adj_bits: int = 32
    adj_group: int = 1

    def tree_flatten(self):
        return (self.adj, self.offsets), (self.n_nodes, self.n_rows, self.m0,
                                          self.max_level, self.adj_bits,
                                          self.adj_group)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        adj, offsets = leaves
        return cls(adj, offsets, *aux)


def pack_device_graph(dg: "DeviceGraph", bits: int | None = None,
                      chunk: int = 1 << 22) -> "DeviceGraph":
    """Re-encode a DeviceGraph's adjacency as ``bits``-wide packed fields.

    ``bits=None`` picks :func:`rad_tpu.graph.adjpack.adj_bits_for`
    (n_nodes). Packs in chunks on device so peak extra HBM is one chunk's
    int32 rows; the int32 source must still be resident, so for graphs
    near the HBM ceiling generate packed directly instead
    (benchmarks/bench_scale.py --packed-adj).

    Output rows are grouped ``adj_group_for(m0, bits)`` per table row so
    the stored minor dim is a multiple of 8 words — a layout that pads
    minor dims to 8-element multiples would otherwise hand the saved
    bits straight back (a [R, 14] uint32 table stored as [R, 16] is the
    full int32 footprint at 28-bit/200M).
    """
    from rad_tpu.graph.adjpack import (adj_bits_for, adj_group_for,
                                       pack_adjacency_rows,
                                       packed_adj_words)

    if dg.adj_bits < 32:
        return dg
    if bits is None:
        bits = adj_bits_for(dg.n_nodes)
    if bits >= 32:
        return dg
    r = dg.adj.shape[0]
    w = packed_adj_words(dg.m0, bits)
    g = adj_group_for(dg.m0, bits)
    chunk = -(-chunk // g) * g
    r_grp = -(-r // g)

    # pack + update in ONE jitted program with the output donated: an
    # eager dynamic_update_slice materializes a fresh full-size table per
    # chunk (~50 copies of a ~13 GB table at 200M rows) on a device where
    # this function is aimed at graphs near the HBM ceiling
    @partial(jax.jit, donate_argnums=(0,), static_argnames=("pad",))
    def _pack_into(out, src, lo_grp, pad):
        if pad:
            src = jnp.concatenate(
                [src, jnp.full((pad, src.shape[1]), -1, src.dtype)])
        rows = pack_adjacency_rows(src, bits=bits).reshape(-1, g * w)
        return jax.lax.dynamic_update_slice(out, rows, (lo_grp, 0))

    out = jnp.zeros((r_grp, g * w), jnp.uint32)
    for lo in range(0, r, chunk):
        src = dg.adj[lo:lo + chunk]
        out = _pack_into(out, src, lo // g, -len(src) % g)
    return dataclasses.replace(dg, adj=out, adj_bits=bits, adj_group=g)


def flatten_adjacency_host(graph: HNSWGraph):
    """Host-side flatten of per-layer neighbor tables into the [R, M0]
    traversal-table layout → ``(adj int32 [R, M0], offsets int32 [L+2],
    m0, r)``. Pure numpy — callers that shard or re-pack the table
    (rad_tpu.parallel.shard_graph) use this directly so the full int32
    table never round-trips through a device."""
    if any(np.dtype(t.dtype) == np.uint32 for t in graph.neighbors):
        raise ValueError(
            "uint32 adjacency (>2**31-id serving-format tables) cannot be "
            "flattened into the int32 device traversal table; such graphs "
            "are served via mmap (HNSWGraph.load(mmap=True) + the HTTP "
            "server) or traversed sharded (rad_tpu.parallel)")
    m0 = max(int(t.shape[1]) for t in graph.neighbors)
    sizes = graph.layer_sizes
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    r = int(offsets[-1])
    adj = np.full((r, m0), -1, dtype=np.int32)
    for l, t in enumerate(graph.neighbors):
        t = np.asarray(t)
        adj[offsets[l]:offsets[l] + t.shape[0], : t.shape[1]] = t
    # offsets gets a trailing sentinel so searchsorted(side='right')-1 maps
    # any row in [offsets[L], R) to level L.
    offsets_arr = np.concatenate([offsets, [r]]).astype(np.int32)
    return adj, offsets_arr, m0, r


def prepare_device_graph(graph: HNSWGraph,
                         packed_adjacency: bool | int = False
                         ) -> DeviceGraph:
    """Flatten per-layer neighbor tables into the [R, M0] traversal table.

    ``packed_adjacency=True`` (or an explicit field width) packs the
    table to grouped bit-fields ON THE HOST before upload — unlike
    :func:`pack_device_graph`, the int32 table never touches the device,
    so graphs whose int32 footprint alone exceeds device memory can
    still be loaded for traversal.
    """
    adj, offsets_arr, m0, r = flatten_adjacency_host(graph)
    bits, grp = 32, 1
    if packed_adjacency:
        from rad_tpu.graph.adjpack import (adj_bits_for, adj_group_for,
                                           pack_adjacency_numpy,
                                           packed_adj_words)
        bits = (packed_adjacency if isinstance(packed_adjacency, int)
                and packed_adjacency is not True
                else adj_bits_for(len(graph)))
        if bits >= 32:
            # >=32-bit fields cannot shrink the table; leave it unpacked
            # (pack_device_graph applies the same guard) — packing here
            # would hand the engine grouped uint32 rows it reads via the
            # int32 path, silently corrupting traversal
            bits, grp = 32, 1
        else:
            grp = adj_group_for(m0, bits)
            w = packed_adj_words(m0, bits)
            r_pad = -(-r // grp) * grp
            out = np.zeros((r_pad // grp, grp * w), np.uint32)
            step = (1 << 20) // grp * grp or grp  # chunk the uint64 temps
            for lo in range(0, r, step):
                src = adj[lo:lo + step]
                if src.shape[0] % grp:
                    src = np.concatenate(
                        [src,
                         np.full((-src.shape[0] % grp, m0), -1, np.int32)])
                out[lo // grp: lo // grp + src.shape[0] // grp] = \
                    pack_adjacency_numpy(src, bits).reshape(-1, grp * w)
            adj = out
    return DeviceGraph(
        adj=jnp.asarray(adj),
        offsets=jnp.asarray(offsets_arr),
        n_nodes=len(graph),
        n_rows=r,
        m0=m0,
        max_level=graph.max_level,
        adj_bits=bits,
        adj_group=grp,
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class TraversalState:
    """Device-resident traversal state (all static shapes).

    f_score/f_row: [C] frontier slots (+inf score = empty).
    enqueued:      [R] bool — (node, level) ever pushed to the frontier
                   (replaces the Redis visited SET, rad/visited.py:17-29).
    f_live:        scalar i32 — count of live (finite, unpopped) frontier
                   entries across head + buffer + cold, maintained
                   incrementally so the while-loop termination check is
                   O(1) instead of an O(C) scan every step.
    cold_score/cold_row/cold_n/watermark: the optional SECOND frontier
                   level (``head_capacity`` in :func:`init_state`). The
                   head stays a small sorted array whose merges are cheap;
                   entries scoring ≥ ``watermark`` append unsorted to the
                   cold store and only re-enter via a (rare) refill sort
                   when the head drains. Invariant: every cold entry ≥
                   watermark ≥ every live head/buffer entry, so pops from
                   head+buffer remain globally exact. Classic single-level
                   layout = cold capacity 0 (the default). Equal-score
                   entries may pop in a different order than the classic
                   layout once spills occur (the only semantic difference).
    scored:        [N] bool; scores: [N] f32 — global once-only scoring
                   record (replaces rad/scored.py:37-48).
    order_log:     [cap] i32 — node ids in scoring order (insertion-order
                   retrieval parity, rad/scored.py:63-85).
    n_scored, n_dropped, n_steps: scalar counters (n_dropped counts finite
    frontier entries lost to capacity-C overflow — observability for
    capacity planning).
    """

    f_score: jnp.ndarray
    f_row: jnp.ndarray
    f_cursor: jnp.ndarray
    f_buf_score: jnp.ndarray
    f_buf_row: jnp.ndarray
    f_buf_n: jnp.ndarray
    f_live: jnp.ndarray
    cold_score: jnp.ndarray
    cold_row: jnp.ndarray
    cold_n: jnp.ndarray
    watermark: jnp.ndarray
    enqueued: jnp.ndarray
    scored: jnp.ndarray
    scores: jnp.ndarray
    order_log: jnp.ndarray
    n_scored: jnp.ndarray
    n_dropped: jnp.ndarray
    n_steps: jnp.ndarray

    def tree_flatten(self):
        # plain field references — dataclasses.astuple deep-COPIES every
        # leaf (a full state buffer copy per jit dispatch, and the donated
        # buffers would be the throwaway copies instead of the caller's)
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self)), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


# head_capacity="auto" switches init_state to the two-level frontier at
# this capacity. Module-level so tests can shrink them and exercise the
# auto-enabled path end-to-end at test scale.
AUTO_HEAD_CAPACITY = 1 << 16
AUTO_HEAD_THRESHOLD = 1 << 18


def auto_frontier_capacity(n_rows: int, cap_max: int = 1 << 22) -> int:
    """Lossless-by-construction frontier capacity when affordable.

    Every (node, level) row enters the frontier at most once EVER (the
    ``enqueued`` check-and-set), so capacity ≥ n_rows can never drop a
    finite entry. Up to ``cap_max`` (default 4M entries = 32 MB of
    score+row) that exactness is cheap; past it the frontier sheds its
    worst entries at merges (counted in ``n_dropped``).
    """
    want = min(max(n_rows, 1 << 12), cap_max)
    return 1 << (want - 1).bit_length()


def init_state(dg: DeviceGraph, frontier_capacity: int | None = None,
               log_capacity: int | None = None,
               buffer_capacity: int = 1 << 15,
               head_capacity: int | None | str = "auto",
               score_table: bool = True) -> TraversalState:
    """The frontier is a sorted main array [C] plus an append buffer [P].

    Pushes go to the buffer (no sort); a full merge-sort happens only when
    the buffer fills — amortizing the O(C log C) merge over many steps.
    Because the main array is sorted and pops always take the global
    minimum, main-array pops consume a moving *prefix* tracked by
    ``f_cursor`` — each pop is then just a B-slice of main + a top-k over
    the (small) buffer, never a scan of C. Pop order is identical to a
    sort-every-step frontier; only the *timing* of capacity-overflow drops
    differs (none happen until a merge).

    ``frontier_capacity=None`` auto-sizes via
    :func:`auto_frontier_capacity` — zero drops guaranteed for graphs up
    to ~4M rows.

    ``head_capacity`` (< frontier_capacity) enables the TWO-LEVEL layout:
    the sorted head shrinks to ``head_capacity`` slots (merges sort
    head+buffer instead of the whole capacity) and a FULL
    ``frontier_capacity``-slot unsorted cold store holds entries at/above
    the watermark — total capacity is ``head_capacity +
    frontier_capacity`` (the head is extra, so the lossless guarantee at
    ``frontier_capacity >= n_rows`` is preserved verbatim; memory grows
    by the head, drops can only be fewer than the single-level layout at
    equal nominal capacity). Much cheaper steady-state merges. Equal-score
    pop order may differ from the single-level layout once spills occur.

    The default ``"auto"`` enables it (head = 2¹⁶) once the frontier is
    large enough for merge sorts to dominate (capacity ≥ 2¹⁸); small
    frontiers stay single-level. ``None`` forces
    the classic single-level layout.

    ``score_table=False`` allocates a 1-slot ``scores`` dummy instead of
    the ``[N] f32`` table (0.9 GiB at 240M — pure ballast when a custom
    ``StateOps.gather_scores`` recomputes candidate scores, e.g. id-mode
    scorers). Never allocating it matters at the HBM ceiling: replacing
    it after the fact still pays the transient allocation.
    """
    if frontier_capacity is None:
        frontier_capacity = auto_frontier_capacity(dg.n_rows)
    if head_capacity == "auto":
        head_capacity = (AUTO_HEAD_CAPACITY
                         if frontier_capacity >= AUTO_HEAD_THRESHOLD
                         else None)
    if head_capacity is not None and head_capacity < frontier_capacity:
        head, cold_cap = head_capacity, frontier_capacity
    else:
        head, cold_cap = frontier_capacity, 0
    cap = log_capacity if log_capacity is not None else dg.n_nodes
    return TraversalState(
        f_score=jnp.full((head,), INF, jnp.float32),
        f_row=jnp.zeros((head,), jnp.int32),
        f_cursor=jnp.zeros((), jnp.int32),
        f_buf_score=jnp.full((buffer_capacity,), INF, jnp.float32),
        f_buf_row=jnp.zeros((buffer_capacity,), jnp.int32),
        f_buf_n=jnp.zeros((), jnp.int32),
        f_live=jnp.zeros((), jnp.int32),
        cold_score=jnp.full((cold_cap,), INF, jnp.float32),
        cold_row=jnp.zeros((cold_cap,), jnp.int32),
        cold_n=jnp.zeros((), jnp.int32),
        watermark=jnp.asarray(jnp.inf, jnp.float32),
        enqueued=jnp.zeros((dg.n_rows,), jnp.bool_),
        scored=jnp.zeros((dg.n_nodes,), jnp.bool_),
        scores=(jnp.full((dg.n_nodes,), INF, jnp.float32) if score_table
                else jnp.zeros((1,), jnp.float32)),
        order_log=jnp.full((cap,), -1, jnp.int32),
        n_scored=jnp.zeros((), jnp.int32),
        n_dropped=jnp.zeros((), jnp.int32),
        n_steps=jnp.zeros((), jnp.int32),
    )


def _level_of_row(dg: DeviceGraph, row: jnp.ndarray) -> jnp.ndarray:
    # offsets has L+2 entries with a sentinel; level = #offsets <= row - 1,
    # clamped into [0, max_level].
    lev = jnp.searchsorted(dg.offsets[: dg.max_level + 2], row,
                           side="right") - 1
    return jnp.clip(lev, 0, dg.max_level).astype(jnp.int32)


class DenseStateOps:
    """Access layer for the big per-node/per-row state arrays.

    The default implementation indexes dense device-resident arrays. The
    pod engine substitutes shard-aware ops (rad_tpu.parallel.sharded):
    gathers become owned-contribution psums, scatters become masked local
    writes — which is what lets `scored`/`scores`/`enqueued` shard row-wise
    across chips while the step logic stays identical.

    Contract: ``gather_*(arr, safe_idx)`` — indices pre-clamped into range;
    ``scatter_*(arr, idx, vals)`` — out-of-range (sentinel) indices drop.
    """

    @staticmethod
    def gather_scored(arr, idx):
        return arr[idx]

    @staticmethod
    def gather_scores(arr, idx):
        return arr[idx]

    @staticmethod
    def gather_enqueued(arr, idx):
        return arr[idx]

    # The three big state scatters are per-update latency-bound at 100M
    # rows: 32k indices over 100M rows are too sparse for locality, so
    # pre-sorting the (idx, val) pairs costs more than it saves.
    @staticmethod
    def scatter_scored(arr, idx, vals):
        return arr.at[idx].set(vals, mode="drop")

    @staticmethod
    def scatter_scores(arr, idx, vals):
        return arr.at[idx].set(vals, mode="drop")

    @staticmethod
    def scatter_enqueued(arr, idx, vals):
        return arr.at[idx].set(vals, mode="drop")

    # batch dedup on the hot path: dense engines use the sort-free scatter
    # variant while its [sentinel+1] scratch stays cheap, and switch to the
    # O(K log K) argsort once the scratch's per-step broadcast+scatter is
    # O(N) work that matters (past 2^23 rows). Shard-aware
    # ops always override with the argsort (an O(value range) scratch per
    # chip would defeat sharding).
    @staticmethod
    def first_occurrence(values, sentinel):
        if sentinel + 1 > (1 << 23):
            return _first_occurrence(values, sentinel)
        return _first_occurrence_scatter(values, sentinel)


DENSE_OPS = DenseStateOps()


def _first_occurrence(values: jnp.ndarray, sentinel: int) -> jnp.ndarray:
    """Mask of first occurrences of each value (sentinel entries excluded),
    computed in the *original* order via argsort + inverse scatter.

    O(K log² K) sort but O(1) extra memory — the variant for sharded state
    ops, where a value-range scratch array per chip would defeat sharding.
    """
    n = values.shape[0]
    perm = jnp.argsort(values, stable=True)
    sorted_vals = values[perm]
    prev = jnp.concatenate([jnp.array([-1], values.dtype), sorted_vals[:-1]])
    first_sorted = (sorted_vals != prev) & (sorted_vals != sentinel)
    first = jnp.zeros((n,), jnp.bool_).at[perm].set(first_sorted)
    return first


def _first_occurrence_scatter(values: jnp.ndarray,
                              sentinel: int) -> jnp.ndarray:
    """Same mask via scatter-min over a value-range scratch — no sorts.

    ``values`` must lie in [0, sentinel]. Each key's slot records the
    minimum batch position writing it (min-combine: order-independent,
    deterministic); a position is a first occurrence iff it equals its
    slot. The [sentinel+1] scratch is a fresh per-step fill — one HBM
    memset (μs) instead of a K log² K argsort on the hot path."""
    k = values.shape[0]
    pos = jnp.arange(k, dtype=jnp.int32)
    scratch = jnp.full((sentinel + 1,), k, jnp.int32)
    scratch = scratch.at[values].min(pos, mode="drop")
    return (scratch[values] == pos) & (values != sentinel)


def _refill_two_level(state: TraversalState) -> TraversalState:
    """Rebuild the head from head-residual + buffer + cold (one big sort).

    The best H entries become the new sorted head; the next CC stay in the
    (now sorted) cold store; anything past total capacity drops (counted).
    The new watermark is the head's max — every remaining cold entry is ≥
    it by construction.
    """
    h = state.f_score.shape[0]
    cc = state.cold_score.shape[0]
    live = jnp.arange(h, dtype=jnp.int32) >= state.f_cursor
    all_s = jnp.concatenate([jnp.where(live, state.f_score, INF),
                             state.f_buf_score, state.cold_score])
    all_r = jnp.concatenate([state.f_row, state.f_buf_row, state.cold_row])
    ss, sr = jax.lax.sort((all_s, all_r), num_keys=1)
    head_s, head_r = ss[:h], sr[:h]
    cold_s, cold_r = ss[h:h + cc], sr[h:h + cc]
    n_cold = jnp.sum(jnp.isfinite(cold_s)).astype(jnp.int32)
    dropped = jnp.sum(jnp.isfinite(ss[h + cc:])).astype(jnp.int32)
    watermark = jnp.where(n_cold > 0, head_s[h - 1], jnp.inf)
    p = state.f_buf_score.shape[0]
    return dataclasses.replace(
        state,
        f_score=head_s, f_row=head_r,
        f_cursor=jnp.zeros((), jnp.int32),
        f_buf_score=jnp.full((p,), INF, jnp.float32),
        f_buf_row=jnp.zeros((p,), jnp.int32),
        f_buf_n=jnp.zeros((), jnp.int32),
        f_live=state.f_live - dropped,
        cold_score=cold_s, cold_row=cold_r, cold_n=n_cold,
        watermark=watermark,
        n_dropped=state.n_dropped + dropped,
    )


def expand_impl(
    state: TraversalState, dg: DeviceGraph, batch: int,
    gather_adj=None, ops: DenseStateOps = DENSE_OPS,
    refill: str = "cond",
) -> Tuple[TraversalState, dict]:
    """Pop the ``batch`` best frontier entries and gather their neighbors.

    Returns the post-pop state and a dict of device arrays:
      exp_node/exp_level/exp_score/exp_valid: [B] — the popped expansions.
      cand:      [B, M0] neighbor node ids (-1 invalid).
      to_score:  [B*M0] unique unscored node ids, compacted to the front,
                 -1 padded — the batch handed to the host scoring bridge.

    ``gather_adj(rows) -> [B, M0]`` overrides the adjacency row gather —
    the hook the sharded pod engine uses to fetch rows from whichever chip
    owns them (rad_tpu.parallel.sharded).
    """
    b = batch
    c = state.f_score.shape[0]
    p = state.f_buf_score.shape[0]
    assert c >= b, "frontier_capacity must be >= batch"
    if state.cold_score.shape[0] > 0 and refill != "skip":
        # two-level layout: when head+buffer can't satisfy this batch and
        # the cold store holds entries, refill first (rare: once per ~H
        # pops). Pops themselves never touch cold — the watermark
        # invariant keeps the global minimum inside head+buffer.
        # ``refill`` lifts the decision for vmapped callers (the
        # multi-campaign engine): "force" refills unconditionally (an
        # exact rebuild — harmless when not needed), "skip" trusts the
        # caller's scalar check that no campaign needs one this step.
        if refill == "force":
            state = _refill_two_level(state)
        else:
            hb_live = state.f_live - state.cold_n
            need = (hb_live < b) & (state.cold_n > 0)
            state = jax.lax.cond(need, _refill_two_level, lambda s: s,
                                 state)
    # main candidates: the next B entries at the sorted prefix's cursor
    start = jnp.minimum(state.f_cursor, c - b)
    offs = start + jnp.arange(b, dtype=jnp.int32)
    main_s = jnp.where(offs >= state.f_cursor,
                       jax.lax.dynamic_slice(state.f_score, (start,), (b,)),
                       INF)
    main_r = jax.lax.dynamic_slice(state.f_row, (start,), (b,))
    # buffer candidates: its top-B (the only selection over a large array,
    # and P is small)
    bneg, bidx = jax.lax.top_k(-state.f_buf_score, b)
    cat_s = jnp.concatenate([main_s, -bneg])
    cat_r = jnp.concatenate([main_r, state.f_buf_row[bidx]])
    neg, sel = jax.lax.top_k(-cat_s, b)
    pop_score = -neg
    pop_row = cat_r[sel]
    valid = jnp.isfinite(pop_score)
    from_main = (sel < b) & valid
    f_cursor = state.f_cursor + jnp.sum(from_main).astype(jnp.int32)
    from_buf = (sel >= b) & valid
    buf_slot = jnp.where(from_buf, bidx[jnp.maximum(sel - b, 0)], p)
    f_score = state.f_score
    f_buf_score = state.f_buf_score.at[buf_slot].set(INF, mode="drop")

    level = _level_of_row(dg, pop_row)
    node = pop_row - dg.offsets[level]
    safe_row = jnp.where(valid, pop_row, 0)
    if gather_adj is None:
        if dg.adj_bits < 32:
            from rad_tpu.graph.adjpack import unpack_adjacency_rows
            g = dg.adj_group
            if g > 1:
                w = dg.adj.shape[1] // g
                sup = dg.adj[safe_row // g]  # [B, G*W]
                cols = ((safe_row % g)[:, None] * w
                        + jnp.arange(w, dtype=jnp.int32)[None, :])
                adj_rows = jnp.take_along_axis(sup, cols, axis=1)
            else:
                adj_rows = dg.adj[safe_row]
            adj_rows = unpack_adjacency_rows(adj_rows, dg.m0, dg.adj_bits)
        else:
            adj_rows = dg.adj[safe_row]
    else:
        adj_rows = gather_adj(safe_row)
    cand = jnp.where(valid[:, None], adj_rows, -1)  # [B, M0]

    n = dg.n_nodes
    cand_flat = cand.reshape(-1)
    cand_ok = cand_flat >= 0
    safe_cand = jnp.where(cand_ok, cand_flat, 0)
    unscored = cand_ok & ~ops.gather_scored(state.scored, safe_cand)
    ids = jnp.where(unscored, cand_flat, n)
    # Unique unscored ids, compacted to the front *preserving adjacency
    # order* — scoring order then matches the reference's per-work-item
    # neighbor order exactly (rad/distributed_worker.py:296-308), which the
    # insertion-order result API exposes.
    mask = unscored & ops.first_occurrence(ids, n)
    k = ids.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    to_score = jnp.full((k,), -1, jnp.int32).at[
        jnp.where(mask, pos, k)].set(cand_flat, mode="drop")

    new_state = dataclasses.replace(state, f_score=f_score,
                                    f_cursor=f_cursor,
                                    f_buf_score=f_buf_score,
                                    f_live=state.f_live
                                    - jnp.sum(valid).astype(jnp.int32),
                                    n_steps=state.n_steps + 1)
    out = {
        "exp_node": node,
        "exp_level": level,
        "exp_score": pop_score,
        "exp_valid": valid,
        "cand": cand,
        "to_score": to_score,
    }
    return new_state, out


expand = jax.jit(expand_impl, static_argnames=("batch", "refill"),
                 donate_argnums=(0,))


def integrate_impl(
    state: TraversalState,
    dg: DeviceGraph,
    exp_node: jnp.ndarray,
    exp_level: jnp.ndarray,
    exp_score: jnp.ndarray,
    exp_valid: jnp.ndarray,
    cand: jnp.ndarray,
    to_score: jnp.ndarray,
    new_scores: jnp.ndarray,
    ops: DenseStateOps = DENSE_OPS,
    commit: str = "cond",
) -> TraversalState:
    """Integrate host scores and complete the traversal step.

    Performs, as one fused program: scored-set insert-if-absent + order log
    append; per-(node, level) enqueued check-and-set; frontier push of new
    candidates; level descent of the expanded nodes; capacity-C frontier
    merge (worst entries drop, counted in n_dropped).

    ``commit`` selects the frontier-commit policy: ``"cond"`` (default)
    decides append-vs-merge with a `lax.cond` on the actual push count;
    ``"append"``/``"merge"`` force the branch with no cond — for callers
    that lift the decision to a scalar OUTSIDE a vmap (the multi-campaign
    engine, rad_tpu.traverse.multi: a vmapped cond executes both branches
    every step, which would merge-sort every step). Forcing ``"append"``
    is only sound when the caller guarantees the buffer cannot overflow
    this step (f_buf_n + p_new <= P).
    """
    n = dg.n_nodes
    cap = state.order_log.shape[0]

    b, m0 = cand.shape
    cand_flat = cand.reshape(-1)
    cand_ok = cand_flat >= 0
    safe_cand = jnp.where(cand_ok, cand_flat, 0)
    lev_flat = jnp.repeat(exp_level, m0)
    row_flat = dg.offsets[lev_flat] + safe_cand
    # -- scored set: insert-if-absent (reference rad/scored.py:37-48)
    # With pipelined drivers the same id can arrive in two in-flight
    # batches; the first integration wins and later ones are no-ops, so the
    # order log never duplicates.
    ts_ok = to_score >= 0
    already = ops.gather_scored(state.scored, jnp.where(ts_ok, to_score, 0))
    fresh = ts_ok & ~already
    ts_idx = jnp.where(fresh, to_score, n)  # n = OOB -> dropped
    scores = ops.scatter_scores(state.scores, ts_idx, new_scores)
    scored = ops.scatter_scored(state.scored, ts_idx, jnp.ones_like(ts_ok))

    # -- candidate enqueue: check-and-set at the expansion level -----------
    row_key = jnp.where(cand_ok, row_flat, dg.n_rows)
    first = ops.first_occurrence(row_key, dg.n_rows)
    not_enq = ~ops.gather_enqueued(state.enqueued,
                                   jnp.where(cand_ok, row_flat, 0))
    push = cand_ok & not_enq & first
    enq_idx = jnp.where(push, row_flat, dg.n_rows)
    enqueued = ops.scatter_enqueued(state.enqueued, enq_idx,
                                    jnp.ones_like(push))
    cand_score = jnp.where(push, ops.gather_scores(scores, safe_cand), INF)

    k = to_score.shape[0]
    pos_in_batch = jnp.cumsum(fresh.astype(jnp.int32)) - 1
    # ring semantics: past capacity the log keeps the most recent `cap`
    # entries (a billion-run log can be drained periodically by the driver)
    log_pos = jnp.where(fresh,
                        (state.n_scored + pos_in_batch) % cap, cap)
    order_log = state.order_log.at[log_pos].set(to_score, mode="drop")
    n_new = jnp.sum(fresh).astype(jnp.int32)
    n_scored = state.n_scored + n_new
    cand_row_entry = jnp.where(push, row_flat, 0)

    # -- descent: re-enqueue expanded node at level-1 ----------------------
    can_desc = exp_valid & (exp_level > 0)
    down_row = dg.offsets[jnp.maximum(exp_level - 1, 0)] + exp_node
    down_ok = can_desc & ~ops.gather_enqueued(
        enqueued, jnp.where(can_desc, down_row, 0))
    # dedup within batch (same node popped at two levels descending to same
    # row is impossible; but two pops of identical row are)
    down_key = jnp.where(down_ok, down_row, dg.n_rows)
    down_first = _first_occurrence(down_key, dg.n_rows)
    down_ok = down_ok & down_first
    enqueued = ops.scatter_enqueued(
        enqueued, jnp.where(down_ok, down_row, dg.n_rows),
        jnp.ones_like(down_ok))
    desc_score = jnp.where(down_ok, exp_score, INF)
    desc_row = jnp.where(down_ok, down_row, 0)

    # -- frontier push: append to buffer; merge-sort only when full --------
    # Pushes stay in candidate order and are compacted with cumsums instead
    # of a sort (this was a [B*M0+B]-key 2-array sort on the hot path).
    # Tie/pop order is UNCHANGED: the old stable score-sort kept equal-score
    # pushes in candidate order, cumsum compaction keeps the same relative
    # slot order for equal scores, and every downstream selection (buffer
    # top_k, stable merge sorts) breaks ties by slot position.
    new_scores_all = jnp.concatenate([cand_score, desc_score])
    new_rows_all = jnp.concatenate([cand_row_entry, desc_row])
    p_new = new_scores_all.shape[0]
    c = state.f_score.shape[0]
    p = state.f_buf_score.shape[0]
    cc = state.cold_score.shape[0]
    two_level = cc > 0

    cold_s, cold_r = state.cold_score, state.cold_row
    cold_n, watermark = state.cold_n, state.watermark
    f_live0, n_dropped0 = state.f_live, state.n_dropped
    finite = jnp.isfinite(new_scores_all)
    if two_level:
        # route: scores < watermark take the head/buffer path; the rest
        # append straight to the (unsorted) cold store, compacted in
        # candidate order.
        qual = finite & (new_scores_all < watermark)
        n_push = jnp.sum(qual).astype(jnp.int32)
        to_cold = finite & ~qual
        n_cold_new = jnp.sum(to_cold).astype(jnp.int32)
        pos_cold = jnp.where(
            to_cold, cold_n + jnp.cumsum(to_cold.astype(jnp.int32)) - 1, cc)
        cold_s = cold_s.at[pos_cold].set(new_scores_all, mode="drop")
        cold_r = cold_r.at[pos_cold].set(new_rows_all, mode="drop")
        kept_cold = jnp.minimum(cold_n + n_cold_new, cc) - cold_n
        cold_n = cold_n + kept_cold
        f_live0 = f_live0 + kept_cold
        n_dropped0 = n_dropped0 + (n_cold_new - kept_cold)
        buf_scores_new = jnp.where(qual, new_scores_all, INF)
    else:
        n_push = jnp.sum(finite).astype(jnp.int32)
        buf_scores_new = new_scores_all

    def do_append(args):
        (f_score, f_row, cursor, buf_s, buf_r, buf_n, f_live,
         c_s, c_r, c_n, wm, n_dropped) = args
        fin = jnp.isfinite(buf_scores_new)
        pos = buf_n + jnp.cumsum(fin.astype(jnp.int32)) - 1
        pos = jnp.where(fin, pos, p)  # drop pad/cold-routed entries
        buf_s = buf_s.at[pos].set(buf_scores_new, mode="drop")
        buf_r = buf_r.at[pos].set(new_rows_all, mode="drop")
        return (f_score, f_row, cursor, buf_s, buf_r, buf_n + n_push,
                f_live + n_push, c_s, c_r, c_n, wm, n_dropped)

    def do_merge(args):
        (f_score, f_row, cursor, buf_s, buf_r, buf_n, f_live,
         c_s, c_r, c_n, wm, n_dropped) = args
        # entries before the cursor were already popped: mask them out
        live = jnp.arange(c, dtype=jnp.int32) >= cursor
        all_s = jnp.concatenate([jnp.where(live, f_score, INF), buf_s,
                                 buf_scores_new])
        all_r = jnp.concatenate([f_row, buf_r, new_rows_all])
        ss, sr = jax.lax.sort((all_s, all_r), num_keys=1)
        if two_level:
            # overflow SPILLS to the cold store instead of dropping; the
            # watermark becomes the head's max so later sub-watermark
            # pushes keep flowing to the head
            spill_s, spill_r = ss[c:], sr[c:]
            spill_n = jnp.sum(jnp.isfinite(spill_s)).astype(jnp.int32)
            sp_idx = jnp.arange(spill_s.shape[0], dtype=jnp.int32)
            sp_pos = jnp.where(jnp.isfinite(spill_s), c_n + sp_idx, cc)
            c_s = c_s.at[sp_pos].set(spill_s, mode="drop")
            c_r = c_r.at[sp_pos].set(spill_r, mode="drop")
            kept = jnp.minimum(c_n + spill_n, cc) - c_n
            c_n = c_n + kept
            wm = jnp.where(spill_n > 0, ss[c - 1], wm)
            dropped_now = spill_n - kept
        else:
            dropped_now = jnp.sum(jnp.isfinite(ss[c:])).astype(jnp.int32)
        return (ss[:c], sr[:c], jnp.zeros((), jnp.int32),
                jnp.full((p,), INF, jnp.float32),
                jnp.zeros((p,), jnp.int32),
                jnp.zeros((), jnp.int32),
                f_live + n_push - dropped_now,
                c_s, c_r, c_n, wm,
                n_dropped + dropped_now)

    args = (state.f_score, state.f_row, state.f_cursor, state.f_buf_score,
            state.f_buf_row, state.f_buf_n, f_live0,
            cold_s, cold_r, cold_n, watermark, n_dropped0)
    if commit == "merge" or p_new > p:
        # forced merge, or buffer smaller than one step's pushes
        out_args = do_merge(args)
    elif commit == "append":
        out_args = do_append(args)
    else:
        out_args = jax.lax.cond(
            state.f_buf_n + n_push <= p, do_append, do_merge, args)
    (f_score, f_row, cursor, buf_s, buf_r, buf_n, f_live,
     cold_s, cold_r, cold_n, watermark, n_dropped) = out_args

    return dataclasses.replace(
        state,
        f_score=f_score,
        f_row=f_row,
        f_cursor=cursor,
        f_buf_score=buf_s,
        f_buf_row=buf_r,
        f_buf_n=buf_n,
        f_live=f_live,
        cold_score=cold_s,
        cold_row=cold_r,
        cold_n=cold_n,
        watermark=watermark,
        enqueued=enqueued,
        scored=scored,
        scores=scores,
        order_log=order_log,
        n_scored=n_scored,
        n_dropped=n_dropped,
    )


integrate = jax.jit(integrate_impl, static_argnames=("commit",),
                    donate_argnums=(0,))


@jax.jit
def prime(
    state: TraversalState,
    dg: DeviceGraph,
    node_ids: jnp.ndarray,
    node_scores: jnp.ndarray,
) -> TraversalState:
    """Seed the traversal from scored top-layer nodes.

    Mirrors RADTraverser.prime (reference rad/traverser.py:128-176): insert
    each top-layer node into the scored set, mark it enqueued at
    ``start_level = max(0, max_level - 1)``, and push it into the frontier at
    that level with its score. ``node_ids`` padded with -1.

    Insert-if-absent like :func:`integrate`: in-batch duplicate ids and
    ids already scored/enqueued are skipped, so a duplicate seed list or
    a re-prime of a live state cannot double-count ``n_scored``,
    duplicate the order log, or push a frontier row twice. The append
    buffer is folded into the re-sort (and reset), so the two-level
    cold>=watermark>=head/buffer invariant survives a mid-run prime.
    """
    n = dg.n_nodes
    cap = state.order_log.shape[0]
    k = node_ids.shape[0]
    ok = node_ids >= 0
    safe_ids = jnp.where(ok, node_ids, 0)
    start_level = max(0, dg.max_level - 1)
    row = dg.offsets[start_level] + safe_ids
    already = jnp.where(ok, state.scored[safe_ids], True)
    already_enq = jnp.where(ok, state.enqueued[row], True)
    first = _first_occurrence(jnp.where(ok, row, dg.n_rows), dg.n_rows)
    fresh = ok & first & ~already & ~already_enq

    idx = jnp.where(fresh, node_ids, n)
    scores = state.scores.at[idx].set(node_scores, mode="drop")
    scored = state.scored.at[idx].set(True, mode="drop")
    pos_in_batch = jnp.cumsum(fresh.astype(jnp.int32)) - 1
    log_pos = jnp.where(fresh,
                        (state.n_scored + pos_in_batch) % cap, cap)
    order_log = state.order_log.at[log_pos].set(node_ids, mode="drop")
    n_scored = state.n_scored + jnp.sum(fresh).astype(jnp.int32)

    enq_idx = jnp.where(fresh, row, dg.n_rows)
    enqueued = state.enqueued.at[enq_idx].set(True, mode="drop")

    entry_score = jnp.where(fresh, node_scores, INF)
    entry_row = jnp.where(fresh, row, 0)
    c = state.f_score.shape[0]
    live = jnp.arange(c, dtype=jnp.int32) >= state.f_cursor
    # fold the append buffer into the re-sort (unused slots hold INF by
    # construction) — leaving it out would let buffer entries sit above a
    # lowered watermark, breaking globally-exact pops
    all_scores = jnp.concatenate(
        [jnp.where(live, state.f_score, INF), state.f_buf_score,
         entry_score])
    all_rows = jnp.concatenate([state.f_row, state.f_buf_row, entry_row])
    sorted_scores, sorted_rows = jax.lax.sort((all_scores, all_rows),
                                              num_keys=1)
    cc = state.cold_score.shape[0]
    cold_s, cold_r = state.cold_score, state.cold_row
    cold_n, watermark = state.cold_n, state.watermark
    n_dropped = state.n_dropped
    spill_fin = jnp.sum(jnp.isfinite(sorted_scores[c:])).astype(jnp.int32)
    if cc > 0:
        # head overflow spills to the cold store (two-level layout)
        spill_s, spill_r = sorted_scores[c:], sorted_rows[c:]
        sp_idx = jnp.arange(spill_s.shape[0], dtype=jnp.int32)
        sp_pos = jnp.where(jnp.isfinite(spill_s), cold_n + sp_idx, cc)
        cold_s = cold_s.at[sp_pos].set(spill_s, mode="drop")
        cold_r = cold_r.at[sp_pos].set(spill_r, mode="drop")
        kept = jnp.minimum(cold_n + spill_fin, cc) - cold_n
        cold_n = cold_n + kept
        watermark = jnp.where(spill_fin > 0, sorted_scores[c - 1],
                              watermark)
        n_dropped = n_dropped + (spill_fin - kept)
        lost = spill_fin - kept
    else:
        lost = spill_fin
    f_live = (state.f_live
              + jnp.sum(jnp.isfinite(entry_score)).astype(jnp.int32)
              - lost)
    p = state.f_buf_score.shape[0]
    return dataclasses.replace(
        state,
        f_score=sorted_scores[:c],
        f_row=sorted_rows[:c],
        f_cursor=jnp.zeros((), jnp.int32),
        f_buf_score=jnp.full((p,), INF, jnp.float32),
        f_buf_row=jnp.zeros((p,), jnp.int32),
        f_buf_n=jnp.zeros((), jnp.int32),
        f_live=f_live,
        cold_score=cold_s,
        cold_row=cold_r,
        cold_n=cold_n,
        watermark=watermark,
        enqueued=enqueued,
        scored=scored,
        scores=scores,
        order_log=order_log,
        n_scored=n_scored,
        n_dropped=n_dropped,
    )


@partial(jax.jit, static_argnames=("batch",), donate_argnums=(0,))
def fused_step(
    state: TraversalState,
    dg: DeviceGraph,
    packed: jnp.ndarray,
    pops: jnp.ndarray,
    target_packed: jnp.ndarray,
    target_pop: jnp.ndarray,
    batch: int,
) -> TraversalState:
    """One fully device-resident traversal step with an on-device scorer.

    For scoring functions expressible on-device (similarity-to-target,
    ML surrogates), the entire pop→score→integrate step fuses into one
    compiled program with no host round trip — the zero-callback fast path
    used by benchmarks and the sharded pod engine. The scorer here is
    Tanimoto distance to ``target_packed`` (the virtual-actives analogue of
    the reference's lookup-table scorer, examples/DUDEZ_example.ipynb).
    """
    from rad_tpu.fp.tanimoto import tanimoto_rows_to_target  # local: cycle

    state, out = expand(state, dg, batch)
    ts = out["to_score"]
    ok = ts >= 0
    rows = packed[jnp.where(ok, ts, 0)]
    scores = tanimoto_rows_to_target(rows, pops[jnp.where(ok, ts, 0)],
                                     target_packed, target_pop, valid=ok)
    return integrate(state, dg, out["exp_node"], out["exp_level"],
                     out["exp_score"], out["exp_valid"], out["cand"],
                     out["to_score"], scores)


@partial(jax.jit, static_argnames=("batch", "narrow_width"),
         donate_argnums=(0,))
def fused_run(
    state: TraversalState,
    dg: DeviceGraph,
    packed: jnp.ndarray,
    pops: jnp.ndarray,
    target_packed: jnp.ndarray,
    target_pop: jnp.ndarray,
    n_to_score: jnp.ndarray,
    batch: int,
    max_steps=1 << 20,
    narrow_width: int | None = None,
) -> TraversalState:
    """Run the fully device-resident traversal to ``n_to_score`` in ONE
    compiled program — a `lax.while_loop` over :func:`fused_step`'s body.

    This is BASELINE config 3 (device-side traversal with an on-device
    scorer): zero host round trips until termination, so throughput is pure
    device speed regardless of dispatch latency.

    ``max_steps`` is TRACED (one compile serves every step budget — it
    exists so :func:`segmented_run` can re-dispatch the same program with
    varying bounds; :func:`fused_run_segmented` is bit-identical by
    while-loop continuation).

    ``narrow_width`` (power of two, < batch*M0): exhaustive-tail
    optimization. ``to_score`` is unique unscored ids compacted to the
    front of a fixed [B*M0] vector; in the exhaustive regime late steps
    discover only ~B live entries, yet the [B*M0, W] fingerprint gather
    and the [B*M0]-wide score/scored/log scatters still pay per-slot
    latency for the padding. When the live count fits, a
    `lax.cond` runs the score+integrate half at this width instead —
    identical scored set, order, and drop behavior (the trimmed slots are
    -1 padding whose scatters drop anyway; tests/test_traverse.py pins
    equality). Steps that discover more than ``narrow_width`` take the
    full-width branch. In a screening run steps almost always exceed the
    narrow width, so the branch only adds a cond there. Default None;
    enable for exhaustive/high-coverage sweeps.
    """
    from rad_tpu.fp.tanimoto import tanimoto_rows_to_target  # local: cycle

    def cond(carry):
        st, steps = carry
        return ((st.n_scored < n_to_score)
                & (steps < max_steps)
                & (frontier_live(st) > 0))

    def score_integrate(st, out, ts):
        ok = ts >= 0
        rows = packed[jnp.where(ok, ts, 0)]
        scores = tanimoto_rows_to_target(
            rows, pops[jnp.where(ok, ts, 0)], target_packed, target_pop,
            valid=ok)
        return integrate_impl(st, dg, out["exp_node"], out["exp_level"],
                              out["exp_score"], out["exp_valid"],
                              out["cand"], ts, scores)

    def body(carry):
        st, steps = carry
        st, out = expand_impl(st, dg, batch)
        ts = out["to_score"]
        if narrow_width is None or narrow_width >= ts.shape[0]:
            st = score_integrate(st, out, ts)
        else:
            n_new = jnp.sum(ts >= 0)
            st = jax.lax.cond(
                n_new <= narrow_width,
                lambda s, o: score_integrate(s, o, o["to_score"]
                                             [:narrow_width]),
                lambda s, o: score_integrate(s, o, o["to_score"]),
                st, out)
        return st, steps + 1

    state, _ = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
    return state


def segmented_run(run, state: TraversalState, n_to_score,
                  max_steps: int = 1 << 20, seg_init: int = 64,
                  seg_target_s: float = 8.0,
                  seg_max: int = 1 << 20) -> TraversalState:
    """Drive an unbounded fused traversal as a host loop of bounded
    device programs.

    ``run(state, n_to_score, step_budget) -> state`` must execute the
    fused while-loop with a TRACED ``step_budget`` (so every segment
    reuses one compiled program — :func:`fused_run` and
    :func:`make_device_run`'s runner qualify). Results are bit-identical
    to a single unbounded call: the loop body is deterministic in the
    carried state, so stopping at a step bound and re-entering continues
    the exact same trajectory.

    Segments bound each device program's run time and give progress
    visibility and checkpoint granularity (a dispatch-size constant set:
    ROADMAP design item 1). The driver times each segment and resizes
    toward ``seg_target_s`` seconds (first segment ``seg_init`` steps; a
    compile-polluted first measurement just shrinks segment 2 to the
    floor and the rate re-estimates there). Per-segment cost is one
    scalar readback.

    ``seg_init`` is deliberately SMALL (64): the first dispatch carries
    the compile, and a large first segment can swallow an entire short
    run into that compile-polluted window. Time from segment 2, or
    pre-warm with a one-step call, when measuring.
    """
    n_to_score = jnp.asarray(n_to_score, jnp.int32)
    # Loop iterations executed in a segment = max over campaign lanes of
    # the PER-LANE n_steps delta (scalar for the single engine, [T] for
    # multi states). NOT the delta of the max: a frozen max lane would
    # stall the global max while other lanes still step, and the driver
    # would break with work remaining.
    prev_steps = np.asarray(state.n_steps)
    done = 0
    seg = max(1, min(seg_init, max_steps, seg_max))
    while done < max_steps:
        t0 = time.perf_counter()
        state = run(state, n_to_score, jnp.int32(seg))
        n_steps = np.asarray(state.n_steps)  # readback: forces+serializes
        dt = time.perf_counter() - t0
        stepped = int(np.max(n_steps - prev_steps))
        prev_steps = n_steps
        done += stepped
        if stepped < seg:
            break  # terminated inside the segment (budget / dead frontier);
            # a budget landing exactly on a segment boundary just costs one
            # further ~ms no-op dispatch before this fires
        per_step = dt / max(stepped, 1)
        # rate-floor of 256 steps/segment, but never past the remaining
        # budget or the caller's ceiling
        seg = min(max(256, int(seg_target_s / max(per_step, 1e-7))),
                  seg_max, max_steps - done)
        if seg <= 0:
            break
    return state


def fused_run_segmented(
    state: TraversalState,
    dg: DeviceGraph,
    packed: jnp.ndarray,
    pops: jnp.ndarray,
    target_packed: jnp.ndarray,
    target_pop: jnp.ndarray,
    n_to_score,
    batch: int,
    max_steps: int = 1 << 20,
    narrow_width: int | None = None,
    seg_init: int = 64,
    seg_target_s: float = 8.0,
    seg_max: int = 1 << 20,
) -> TraversalState:
    """:func:`fused_run` behind :func:`segmented_run`, for budgets implying
    more than a few seconds of device time."""
    return segmented_run(
        lambda st, nts, sb: fused_run(st, dg, packed, pops, target_packed,
                                      target_pop, nts, batch, max_steps=sb,
                                      narrow_width=narrow_width),
        state, n_to_score, max_steps=max_steps, seg_init=seg_init,
        seg_target_s=seg_target_s, seg_max=seg_max)


def make_device_run(dg: DeviceGraph, packed: jnp.ndarray, pops: jnp.ndarray,
                    scorer, batch: int, max_steps: int = 1 << 20,
                    narrow_width: int | None = None):
    """Compile a full traversal loop around an arbitrary jittable scorer.

    ``scorer(fp_rows [K, W] uint32, pop_rows [K] int32) -> [K] float32`` —
    an ML surrogate (MLP over fingerprint bits, a learned docking model), a
    similarity measure, anything jittable. This is the single-chip
    generalization of :func:`fused_run` (whose scorer is fixed to
    Tanimoto-to-target); the reference's analogous capability is Chemprop
    scoring workers (reference README.md:206).

    ``narrow_width``: same exhaustive-tail trim as :func:`fused_run` —
    when a step discovers <= this many unscored ids, the scorer + score
    integration run at this width instead of the padded [B*M0]
    (bit-identical results; for an MLP surrogate the scorer itself also
    shrinks 8x). Opt-in; adds a cond per step in the screening regime.

    Returns ``run(state, n_to_score, step_budget=None) -> state``. The
    step budget is TRACED (defaults to ``max_steps``), so
    ``segmented_run(run, ...)`` can drive it in bounded segments with one
    compiled program.
    """

    # graph arrays enter as ARGUMENTS, not closure constants: a closed-over
    # [N, W] matrix gets baked into the program as a literal (128 MB at 1M
    # molecules), which bloats/overflows compile payloads.
    @partial(jax.jit, donate_argnums=(0,))
    def _run(state: TraversalState, n_to_score, step_budget,
             dg_a: DeviceGraph, packed_a, pops_a) -> TraversalState:
        def cond(carry):
            st, steps = carry
            return ((st.n_scored < n_to_score)
                    & (steps < step_budget)
                    & (frontier_live(st) > 0))

        def score_integrate(st, out, ts):
            ok = ts >= 0
            safe = jnp.where(ok, ts, 0)
            raw = scorer(packed_a[safe], pops_a[safe])
            scores = jnp.where(ok, raw.astype(jnp.float32), INF)
            return integrate_impl(st, dg_a, out["exp_node"],
                                  out["exp_level"], out["exp_score"],
                                  out["exp_valid"], out["cand"], ts,
                                  scores)

        def body(carry):
            st, steps = carry
            st, out = expand_impl(st, dg_a, batch)
            ts = out["to_score"]
            if narrow_width is None or narrow_width >= ts.shape[0]:
                st = score_integrate(st, out, ts)
            else:
                n_new = jnp.sum(ts >= 0)
                st = jax.lax.cond(
                    n_new <= narrow_width,
                    lambda s, o: score_integrate(s, o, o["to_score"]
                                                 [:narrow_width]),
                    lambda s, o: score_integrate(s, o, o["to_score"]),
                    st, out)
            return st, steps + 1

        state, _ = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
        return state

    def run(state: TraversalState, n_to_score,
            step_budget=None) -> TraversalState:
        if step_budget is None:
            step_budget = jnp.int32(max_steps)
        return _run(state, n_to_score, step_budget, dg, packed, pops)

    return run


def save_state(state: TraversalState, path: str) -> None:
    """Checkpoint a traversal to disk.

    The analogue of the reference's implicit Redis-namespace resume
    (SURVEY.md §5 checkpoint/resume): traversal state is a pytree of
    arrays, so a checkpoint is one ``.npz``.
    """
    arrays = {f.name: np.asarray(getattr(state, f.name))
              for f in dataclasses.fields(TraversalState)}
    np.savez(path, **arrays)


def save_state_atomic(state: TraversalState, path: str) -> None:
    """Write-then-rename :func:`save_state` so a crash mid-save never
    corrupts the last good checkpoint, and the file lands at exactly
    ``path`` whatever its suffix (np.savez appends ``.npz`` to any other
    suffix, which used to break the save/load round-trip)."""
    import os
    tmp = f"{path}.tmp.{os.getpid()}"
    save_state(state, tmp)
    if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)


def load_state(path: str) -> TraversalState:
    """Restore a traversal checkpoint written by :func:`save_state`."""
    import os
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"   # a bare save_state() output for this path
    data = np.load(path)
    arrays = {f.name: jnp.asarray(data[f.name])
              for f in dataclasses.fields(TraversalState)
              if f.name in data}
    if "f_live" not in arrays:  # pre-0.2 checkpoint: recount from arrays
        c = arrays["f_score"].shape[0]
        live = jnp.arange(c, dtype=jnp.int32) >= arrays["f_cursor"]
        arrays["f_live"] = (
            jnp.sum(live & jnp.isfinite(arrays["f_score"]))
            + jnp.sum(jnp.isfinite(arrays["f_buf_score"]))
        ).astype(jnp.int32)
    if "cold_score" not in arrays:  # pre-two-level checkpoint
        arrays["cold_score"] = jnp.full((0,), INF, jnp.float32)
        arrays["cold_row"] = jnp.zeros((0,), jnp.int32)
        arrays["cold_n"] = jnp.zeros((), jnp.int32)
        arrays["watermark"] = jnp.asarray(jnp.inf, jnp.float32)
    return TraversalState(**arrays)


def read_order_log(state: TraversalState) -> np.ndarray:
    """Scored node ids in traversal order (host-side).

    Below capacity this is the complete insertion order; past capacity the
    log is a ring and only the most recent ``cap`` ids are available — the
    returned array is then those, oldest first.
    """
    cap = state.order_log.shape[0]
    n = int(state.n_scored)
    log = np.asarray(state.order_log)
    if n <= cap:
        return log[:n]
    head = n % cap
    return np.concatenate([log[head:], log[:head]])


def gather_scores(state: TraversalState, ids) -> np.ndarray:
    """Host float array of ``state.scores[ids]`` via an ON-DEVICE gather.

    ``np.asarray(state.scores)[ids]`` downloads the full ``[N]`` scores
    first — ~1 GB at the 240M single-card scale, and a
    cross-device gather of the whole array when the state is row-sharded.
    This pulls only ``len(ids)`` floats.
    """
    ids = np.asarray(ids)
    if ids.size == 0:
        return np.zeros((0,), np.float32)
    return np.asarray(state.scores[jnp.asarray(ids, jnp.int32)])


def read_order_log_since(state: TraversalState, start: int) -> np.ndarray:
    """Scored node ids in positions [start, n_scored) — the incremental
    drain for runs whose total scored count exceeds the ring capacity.

    A driver polling ``drain = read_order_log_since(state, seen);
    seen = int(state.n_scored)`` between steps keeps the complete insertion
    order on the host while the device ring stays a fixed
    ``log_capacity``. Raises if more than ``cap`` entries accumulated since
    ``start`` (drain more often or enlarge the ring)."""
    cap = state.order_log.shape[0]
    n = int(state.n_scored)
    if n - start > cap:
        raise RuntimeError(
            f"order log overran: {n - start} new entries > ring capacity "
            f"{cap}; drain more frequently or raise log_capacity")
    log = np.asarray(state.order_log)
    idx = np.arange(start, n) % cap
    return log[idx]


def frontier_live(state: TraversalState) -> jnp.ndarray:
    """Count of live frontier entries (main past cursor + buffer) — the
    incrementally-maintained scalar, O(1) (the while-loop termination check
    reads this every step; the old O(C) scan cost ~0.85 ms/step at C=2²⁰)."""
    return state.f_live


def frontier_live_scan(state: TraversalState) -> jnp.ndarray:
    """O(C) recount of live frontier entries — the invariant oracle for
    :func:`frontier_live` (tests assert they agree after every phase)."""
    c = state.f_score.shape[0]
    live = jnp.arange(c, dtype=jnp.int32) >= state.f_cursor
    total = (jnp.sum(live & jnp.isfinite(state.f_score))
             + jnp.sum(jnp.isfinite(state.f_buf_score)))
    if state.cold_score.shape[0] > 0:
        total = total + jnp.sum(jnp.isfinite(state.cold_score))
    return total.astype(jnp.int32)


def frontier_size(state: TraversalState) -> int:
    """Host-side: number of live frontier entries (main + append buffer)."""
    return int(frontier_live(state))


def frontier_empty(state: TraversalState) -> bool:
    return frontier_size(state) == 0
