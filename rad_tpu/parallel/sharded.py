"""Graph-sharded kernels: the pod-scale engine over the interconnect.

Partitioning scheme (SURVEY.md §5 / §7 layer 8): the *graph* is the long
axis. Fingerprints ``[N, W]`` and the flat adjacency ``[R, M0]`` are sharded
row-wise across the mesh's ``graph`` axis; the traversal state (frontier,
visited/scored bitmaps, counters) is replicated — it is tiny next to the
fingerprint matrix (2B molecules × 128 B = 256 GB vs ~MBs of state). Each
step, every card:

1. pops the same replicated frontier batch (deterministic, no collective);
2. contributes the adjacency/fingerprint rows it owns; a single ``psum``
   combines them (each row has exactly one owner, so the sum *is* the
   gather) — the all-to-all neighbor exchange over the interconnect;
3. runs the identical integrate/merge on the replicated state.

Per-step interconnect traffic is O(B·M0) ints + O(B·M0·W) words,
independent of N.
XLA inserts the collectives from the ``shard_map`` specs; nothing here
hand-schedules DMA (scaling-book recipe: pick a mesh, annotate, let XLA
place collectives).
"""

from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rad_tpu.fp.pack import popcount
from rad_tpu.graph.storage import HNSWGraph
from rad_tpu.traverse.device import (
    DeviceGraph,
    TraversalState,
    expand_impl,
    integrate_impl,
)

__all__ = [
    "ShardedGraph",
    "shard_graph",
    "shard_graph_streamed",
    "put_sharded_rows",
    "sharded_bruteforce_topk",
    "sharded_fused_step",
    "make_sharded_step",
    "make_sharded_step_full",
    "make_sharded_step_multi",
    "TrafficMeter",
    "make_sharded_expand_integrate",
    "make_sharded_search",
    "make_sharded_search_2d",
    "init_state_sharded",
]


@jax.tree_util.register_pytree_node_class
@dataclass
class ShardedGraph:
    """A DeviceGraph + fingerprints laid out for a 1-D graph mesh.

    packed/pops padded to a multiple of the mesh size and row-sharded;
    adj likewise; offsets replicated. ``n_nodes``/``n_rows`` are the true
    (unpadded) sizes; ``n_pad_nodes``/``n_pad_rows`` the padded ones.
    """

    packed: jnp.ndarray
    pops: jnp.ndarray
    adj: jnp.ndarray
    offsets: jnp.ndarray
    n_nodes: int
    n_rows: int
    n_pad_nodes: int
    n_pad_rows: int
    m0: int
    max_level: int
    axis: str
    adj_bits: int = 32
    adj_group: int = 1

    def tree_flatten(self):
        return (self.packed, self.pops, self.adj, self.offsets), (
            self.n_nodes, self.n_rows, self.n_pad_nodes, self.n_pad_rows,
            self.m0, self.max_level, self.axis, self.adj_bits,
            self.adj_group)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)

    def device_graph(self) -> DeviceGraph:
        return DeviceGraph(adj=self.adj, offsets=self.offsets,
                           n_nodes=self.n_nodes, n_rows=self.n_rows,
                           m0=self.m0, max_level=self.max_level,
                           adj_bits=self.adj_bits, adj_group=self.adj_group)


def _pad_rows(arr: np.ndarray, mult: int, fill) -> np.ndarray:
    n = arr.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad, *arr.shape[1:]), fill, arr.dtype)], axis=0)


def _global_put(arr_np: np.ndarray, mesh: Mesh, spec: P):
    """Place host data onto the mesh under ``spec``.

    Single-process: a plain device_put. Multi-process (DCN pods, where the
    mesh spans devices this process cannot address): build the global array
    from per-shard callbacks — every process holds the full host copy and
    contributes the shards it owns (jax.make_array_from_callback)."""
    sh = NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        return jax.make_array_from_callback(
            arr_np.shape, sh, lambda idx: arr_np[idx])
    return jax.device_put(jnp.asarray(arr_np), sh)


def shard_graph(graph: HNSWGraph, mesh: Mesh, axis: str = "graph",
                packed_adjacency: bool | int = False) -> ShardedGraph:
    """Lay a built graph out across the mesh's ``axis`` (row-sharded).

    ``packed_adjacency=True`` stores each shard's adjacency rows as
    bit-packed fields (rad_tpu.graph.adjpack; an int gives the field
    width explicitly) in the grouped ``[R/G, G*W]`` layout — the same
    ~12-37% adjacency-HBM saving as the single-chip engine's
    ``--packed-adj``, applied per shard. The owned-gather fetches packed
    super-rows over the interconnect (proportionally *less* interconnect traffic per
    expansion) and decodes after the psum."""
    from rad_tpu.graph.adjpack import (adj_bits_for, adj_group_for,
                                       pack_adjacency_numpy,
                                       packed_adj_words)
    from rad_tpu.traverse.device import flatten_adjacency_host

    # host-side flatten: the full int32 table must never round-trip
    # through a single device before sharding (at ~100M nodes that is a
    # 6-26 GB device-memory commit for nothing)
    adj_host, offsets_np, m0, r = flatten_adjacency_host(graph)
    n_nodes, max_level = len(graph), graph.max_level
    nd = mesh.shape[axis]
    packed = _pad_rows(np.asarray(graph.packed), nd, 0)
    pops = _pad_rows(np.asarray(graph.popcounts), nd, 0)
    bits, grp = 32, 1
    if packed_adjacency:
        bits = (packed_adjacency if isinstance(packed_adjacency, int)
                and packed_adjacency is not True
                else adj_bits_for(n_nodes))
        if bits >= 32:
            bits = 32  # >=32-bit fields cannot shrink; keep unpacked
        else:
            grp = adj_group_for(m0, bits)
    adj = _pad_rows(adj_host, nd * grp, -1)
    n_pad_rows = adj.shape[0]
    if bits < 32:
        w = packed_adj_words(m0, bits)
        out = np.empty((adj.shape[0] // grp, grp * w), np.uint32)
        step = (1 << 20) // grp * grp or grp  # chunk the 8B/elem pack temps
        for lo in range(0, adj.shape[0], step):
            src = adj[lo:lo + step]
            out[lo // grp: lo // grp + src.shape[0] // grp] = \
                pack_adjacency_numpy(src, bits).reshape(-1, grp * w)
        adj = out
    return ShardedGraph(
        packed=_global_put(packed, mesh, P(axis, None)),
        pops=_global_put(pops, mesh, P(axis)),
        adj=_global_put(adj, mesh, P(axis, None)),
        offsets=_global_put(offsets_np, mesh, P()),
        n_nodes=n_nodes,
        n_rows=r,
        n_pad_nodes=packed.shape[0],
        n_pad_rows=n_pad_rows,
        m0=m0,
        max_level=max_level,
        axis=axis,
        adj_bits=bits,
        adj_group=grp,
    )


def put_sharded_rows(mesh: Mesh, axis: str, global_shape, dtype,
                     make_shard):
    """Assemble a row-sharded global array from per-shard host callbacks.

    ``make_shard(start, stop) -> np.ndarray [stop-start, ...]`` is invoked
    once per mesh device with the global row range that device owns; each
    chunk is placed directly on its device and freed before the next is
    built, so peak host memory is ONE shard rather than the global array —
    the difference between "fits" and "cannot exist" at billion-node scale
    (the reference's 2B library is ~256 GB of fingerprints alone,
    reference index.html:568-580). ``global_shape[0]`` must divide evenly
    by the mesh's ``axis`` size. Works multi-process too: each process
    builds only the shards it can address.
    """
    global_shape = tuple(int(s) for s in global_shape)
    nd = mesh.shape[axis]
    if global_shape[0] % nd:
        raise ValueError(
            f"global row count {global_shape[0]} is not divisible by the "
            f"{nd}-device '{axis}' mesh axis — pad rows first")
    sh = NamedSharding(mesh, P(axis, *(None,) * (len(global_shape) - 1)))
    shards = []
    for dev_, idx in sh.addressable_devices_indices_map(global_shape).items():
        sl = idx[0]
        start = 0 if sl.start is None else int(sl.start)
        stop = global_shape[0] if sl.stop is None else int(sl.stop)
        chunk = np.ascontiguousarray(make_shard(start, stop),
                                     dtype=np.dtype(dtype))
        expect = (stop - start, *global_shape[1:])
        if chunk.shape != expect:
            raise ValueError(f"make_shard({start}, {stop}) returned shape "
                             f"{chunk.shape}; expected {expect}")
        shards.append(jax.device_put(chunk, dev_))
        del chunk
    return jax.make_array_from_single_device_arrays(global_shape, sh, shards)


def _pad_range_fn(fn, n_real: int, ncols: int, fill, dtype):
    """Wrap a [0, n_real) row-range callback so reads past n_real yield
    ``fill`` rows (the shard-padding region)."""
    def wrapped(start, stop):
        if start >= n_real:
            return np.full((stop - start, ncols), fill, dtype)
        real = np.ascontiguousarray(fn(start, min(stop, n_real)),
                                    dtype=dtype)
        if stop <= n_real:
            return real
        return np.concatenate(
            [real, np.full((stop - n_real, ncols), fill, dtype)])
    return wrapped


def shard_graph_streamed(mesh: Mesh, *, n_nodes: int, layer_sizes,
                         m0: int, make_adj_rows, make_packed_rows,
                         make_pops_rows=None, fp_words: int = 32,
                         axis: str = "graph",
                         packed_adjacency: bool | int = False
                         ) -> ShardedGraph:
    """Build a :class:`ShardedGraph` shard-by-shard from host callbacks.

    :func:`shard_graph` materializes the FULL adjacency + fingerprint
    tables on the host before placing them — fine to ~100M nodes, but a
    billion-node graph is ~60 GB of adjacency that must never exist twice
    (and on a real pod cannot exist on any single host at 2B). Here the
    caller supplies row-range producers and every mesh device receives
    exactly its rows:

    - ``make_adj_rows(start, stop) -> [stop-start, m0] int32`` flat
      traversal-table rows (``row = offsets[level] + node`` layout,
      level-0 block first, -1 padded — rad_tpu.traverse.device docstring);
    - ``make_packed_rows(start, stop) -> [stop-start, fp_words] uint32``
      packed fingerprints by node id;
    - ``make_pops_rows(start, stop) -> [stop-start] int32`` per-node
      popcounts (computed from the fingerprints via ``np.bitwise_count``
      when omitted).

    ``layer_sizes`` is ``[N_0, N_1, ...]``; rows/nodes are padded to mesh
    multiples here (callbacks are only consulted for real rows).
    ``packed_adjacency`` packs each adjacency shard to grouped bit-fields
    before placement (rad_tpu.graph.adjpack), so the int32 table never
    exists anywhere at once.
    """
    layer_sizes = [int(s) for s in layer_sizes]
    offsets = np.concatenate([[0], np.cumsum(layer_sizes)]).astype(np.int32)
    r = int(offsets[-1])
    offsets_arr = np.concatenate([offsets, [r]]).astype(np.int32)
    nd = mesh.shape[axis]
    max_level = len(layer_sizes) - 1

    bits, grp = 32, 1
    if packed_adjacency:
        from rad_tpu.graph.adjpack import (adj_bits_for, adj_group_for,
                                           pack_adjacency_numpy,
                                           packed_adj_words)
        bits = (packed_adjacency if isinstance(packed_adjacency, int)
                and packed_adjacency is not True
                else adj_bits_for(n_nodes))
        if bits >= 32:
            bits = 32  # >=32-bit fields cannot shrink; keep unpacked
        else:
            grp = adj_group_for(m0, bits)

    n_pad_nodes = -(-n_nodes // nd) * nd
    n_pad_rows = -(-r // (nd * grp)) * (nd * grp)

    adj_rows = _pad_range_fn(make_adj_rows, r, m0, -1, np.int32)
    fp_rows_raw = _pad_range_fn(make_packed_rows, n_nodes, fp_words, 0,
                                np.uint32)
    fp_rows = fp_rows_raw
    if make_pops_rows is None:
        # compute pops as a side product of the fingerprint placement
        # pass so the (possibly expensive) row producer is consulted ONCE
        # per shard — at 2B nodes the callbacks read ~256 GB of
        # fingerprints; re-invoking them for popcounts doubles ingestion.
        # Cache cost: one int32 per node (8 GB at 2B) until the pops pass
        # consumes it — small next to the adjacency being placed.
        pops_cache: dict = {}

        def fp_rows(start, stop):
            chunk = fp_rows_raw(start, stop)
            pops_cache[(start, stop)] = np.bitwise_count(chunk).sum(
                axis=1).astype(np.int32)
            return chunk

        def pops_fn(start, stop):
            got = pops_cache.pop((start, stop), None)
            if got is not None:
                return got
            return np.bitwise_count(fp_rows_raw(start, stop)).sum(
                axis=1).astype(np.int32)
    else:
        def pops_fn(start, stop):
            if start >= n_nodes:
                return np.zeros(stop - start, np.int32)
            real = np.ascontiguousarray(
                make_pops_rows(start, min(stop, n_nodes)), dtype=np.int32)
            if stop <= n_nodes:
                return real
            return np.concatenate(
                [real, np.zeros(stop - n_nodes, np.int32)])

    if bits < 32:
        w = packed_adj_words(m0, bits)

        def adj_shard(start, stop):
            # start/stop are PACKED table rows; each covers grp flat rows
            flat = adj_rows(start * grp, stop * grp)
            return pack_adjacency_numpy(flat, bits).reshape(-1, grp * w)

        adj = put_sharded_rows(mesh, axis, (n_pad_rows // grp, grp * w),
                               np.uint32, adj_shard)
    else:
        adj = put_sharded_rows(mesh, axis, (n_pad_rows, m0), np.int32,
                               adj_rows)

    return ShardedGraph(
        packed=put_sharded_rows(mesh, axis, (n_pad_nodes, fp_words),
                                np.uint32, fp_rows),
        pops=put_sharded_rows(mesh, axis, (n_pad_nodes,), np.int32,
                              lambda s, e: pops_fn(s, e)),
        adj=adj,
        offsets=_global_put(offsets_arr, mesh, P()),
        n_nodes=n_nodes,
        n_rows=r,
        n_pad_nodes=n_pad_nodes,
        n_pad_rows=n_pad_rows,
        m0=m0,
        max_level=max_level,
        axis=axis,
        adj_bits=bits,
        adj_group=grp,
    )


def _owned_gather(local: jnp.ndarray, global_idx: jnp.ndarray,
                  shard_size: int, axis: str, fill_shift: int):
    """Gather rows of a row-sharded array by global index inside shard_map.

    Exactly one shard owns each index; every shard contributes
    ``value + fill_shift`` for owned rows and 0 elsewhere, and one psum
    reconstructs the row on all shards (then the shift is removed).
    ``fill_shift=1`` lets -1 sentinels survive the zero-fill.
    """
    me = jax.lax.axis_index(axis)
    start = me * shard_size
    loc = global_idx - start
    own = (loc >= 0) & (loc < shard_size)
    safe = jnp.clip(loc, 0, shard_size - 1)
    vals = local[safe]
    contrib = jnp.where(
        own.reshape(own.shape + (1,) * (vals.ndim - own.ndim)),
        vals + jnp.asarray(fill_shift, vals.dtype),
        jnp.zeros((), vals.dtype))
    total = jax.lax.psum(contrib, axis)
    return total - jnp.asarray(fill_shift, vals.dtype)


def _adj_gatherer(sg: ShardedGraph, adj_l, adj_shard: int, axis: str):
    """``gather_adj(rows) -> [B, M0] int32`` closure for the shard bodies.

    int32 storage: one owned-gather (fill_shift=1 so out-of-shard rows
    decode to the -1 sentinel). Packed storage (shard_graph
    packed_adjacency=True): owned-gather the ``[B, G*W]`` uint32
    super-rows (psum'ing ~bits/32 of the int32 interconnect bytes), slice the
    target sub-row, and decode — the sharded twin of the single-chip
    grouped decode in rad_tpu.traverse.device.expand_impl. Every in-range
    row has exactly one owner, so the uint32 zero fill is unreachable for
    the engine's clipped pop rows."""
    if sg.adj_bits >= 32:
        def gather_adj(rows):
            return _owned_gather(adj_l, rows, adj_shard, axis,
                                 fill_shift=1)
        return gather_adj

    from rad_tpu.graph.adjpack import unpack_adjacency_rows
    g = sg.adj_group
    w = sg.adj.shape[-1] // g

    def gather_adj(rows):
        sup = _owned_gather(adj_l, rows // g, adj_shard // g, axis,
                            fill_shift=0)
        cols = ((rows % g)[:, None] * w
                + jnp.arange(w, dtype=jnp.int32)[None, :])
        sub = jnp.take_along_axis(sup, cols, axis=1)
        return unpack_adjacency_rows(sub, sg.m0, sg.adj_bits)

    return gather_adj


@partial(jax.jit, static_argnames=("k", "mesh", "axis"))
def _sharded_topk_impl(packed, pops, queries, q_pops, n_nodes, k, mesh, axis):
    nd = mesh.shape[axis]
    shard = packed.shape[0] // nd

    def local_topk(packed_l, pops_l, q, qp):
        me = jax.lax.axis_index(axis)
        inter = jnp.sum(popcount(q[:, None, :] & packed_l[None, :, :]),
                        axis=-1)
        union = qp[:, None] + pops_l[None, :] - inter
        sim = jnp.where(union > 0, inter / jnp.maximum(union, 1), 1.0)
        d = (1.0 - sim).astype(jnp.float32)
        gids = me * shard + jnp.arange(shard, dtype=jnp.int32)[None, :]
        d = jnp.where(gids < n_nodes, d, jnp.inf)
        # smallest-k via ONE stable variadic sort (ids ride as payload):
        # bit-identical to top_k(-d) + take_along_axis (stable ascending
        # sort = top_k's smaller-index tie preference) without the id
        # gather XLA's top_k lowering emits (build/exact._merge_topk)
        sd, sids = jax.lax.sort(
            (d, jnp.broadcast_to(gids, d.shape)), num_keys=1,
            is_stable=True)
        # all-gather each shard's top-k and reduce to the global top-k
        all_d = jax.lax.all_gather(sd[:, :k], axis, axis=1).reshape(
            q.shape[0], -1)
        all_i = jax.lax.all_gather(sids[:, :k], axis, axis=1).reshape(
            q.shape[0], -1)
        gd, gi = jax.lax.sort((all_d, all_i), num_keys=1, is_stable=True)
        return gd[:, :k], gi[:, :k]

    # check_vma=False: the outputs *are* replicated (both sides of the final
    # top_k come from an all_gather), but varying-mesh-axis inference cannot
    # prove it through top_k.
    return jax.shard_map(
        local_topk, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(packed, pops, queries, q_pops)


def sharded_bruteforce_topk(sg: ShardedGraph, queries, k: int,
                            mesh: Mesh) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-NN with the distance matrix sharded over the graph axis.

    Each chip scans its fingerprint shard (dist-evals scale 1/n_dev), then a
    k-sized all-gather + final top-k merges — the standard sharded-search
    reduction; per-query interconnect traffic is O(n_dev·k), not O(N).
    """
    q_np = np.atleast_2d(np.asarray(queries, np.uint32))
    from rad_tpu.fp.pack import popcount_rows_np
    queries = _global_put(q_np, mesh, P())
    q_pops = _global_put(popcount_rows_np(q_np).astype(np.int32), mesh, P())
    return _sharded_topk_impl(sg.packed, sg.pops, queries, q_pops,
                              sg.n_nodes, k, mesh, sg.axis)


def _shard_traffic(nd, adj_shard, fp_shard, offsets, out):
    """Per-shard service counts for one step (hub-imbalance probe,
    SURVEY.md §7 hard part 6).

    ``adj_rows[s]`` = adjacency rows shard ``s`` served this step (one per
    valid expansion); ``fp_rows[s]`` = candidate fingerprint rows it
    served. Computed from replicated expand outputs — identical on every
    shard, no collective. Skew across shards = hub-node load imbalance.
    """
    node, lvl, valid = out["exp_node"], out["exp_level"], out["exp_valid"]
    rows = offsets[jnp.maximum(lvl, 0)] + jnp.maximum(node, 0)
    adj_c = jnp.zeros((nd,), jnp.int32).at[
        jnp.where(valid, rows // adj_shard, nd)].add(1, mode="drop")
    ts = out["to_score"]
    fp_c = jnp.zeros((nd,), jnp.int32).at[
        jnp.where(ts >= 0, jnp.maximum(ts, 0) // fp_shard, nd)].add(
        1, mode="drop")
    return adj_c, fp_c


def make_sharded_step(sg: ShardedGraph, mesh: Mesh, batch: int,
                      scorer=None, traffic: bool = False):
    """Build the jitted pod traversal step: replicated state, sharded graph.

    Returns ``step(state, target_packed, target_pop) -> state`` — the
    multi-chip equivalent of :func:`rad_tpu.traverse.device.fused_step`.

    ``scorer(fp_rows [K, W] uint32, pop_rows [K] int32, target_packed,
    target_pop) -> [K] float32`` is any jittable surrogate (an ML scorer, a
    pharmacophore model, ...); the default is Tanimoto distance to
    ``target_packed``. It runs replicated on every chip over candidates
    gathered from their owning shards.

    ``traffic=True`` makes the step return ``(state, traffic_dict)`` with
    per-shard service counts ``{"adj_rows": [n_dev], "fp_rows": [n_dev]}``
    for that step — the hub-imbalance instrumentation (skewed counts mean
    hot shards; see :class:`TrafficMeter`).
    """
    axis = sg.axis
    nd = mesh.shape[axis]
    adj_shard = sg.n_pad_rows // nd
    fp_shard = sg.n_pad_nodes // nd
    dg_meta = DeviceGraph(adj=jnp.zeros((1, 1), jnp.int32),
                          offsets=sg.offsets, n_nodes=sg.n_nodes,
                          n_rows=sg.n_rows, m0=sg.m0,
                          max_level=sg.max_level)
    if scorer is None:
        scorer = tanimoto_to_target_scorer

    def shard_body(state: TraversalState, adj_l, packed_l, pops_l,
                   offsets, target_packed, target_pop):
        dg = dataclasses.replace(dg_meta, offsets=offsets)

        gather_adj = _adj_gatherer(sg, adj_l, adj_shard, axis)

        state, out = expand_impl(state, dg, batch, gather_adj=gather_adj)
        ts = out["to_score"]
        ok = ts >= 0
        safe = jnp.where(ok, ts, 0)
        fp_rows = _owned_gather(packed_l, safe, fp_shard, axis, fill_shift=0)
        pop_rows = _owned_gather(pops_l, safe, fp_shard, axis, fill_shift=0)
        raw = scorer(fp_rows, pop_rows, target_packed, target_pop)
        scores = jnp.where(ok, raw.astype(jnp.float32), jnp.inf)
        state = integrate_impl(state, dg, out["exp_node"], out["exp_level"],
                               out["exp_score"], out["exp_valid"],
                               out["cand"], out["to_score"], scores)
        if traffic:
            adj_c, fp_c = _shard_traffic(nd, adj_shard, fp_shard, offsets,
                                         out)
            return state, adj_c, fp_c
        return state

    state_spec = jax.tree_util.tree_map(lambda _: P(),
                                        _state_structure())
    out_specs = (state_spec, P(), P()) if traffic else state_spec
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(state_spec, P(axis, None), P(axis, None), P(axis),
                  P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )

    # graph arrays enter the jitted program as ARGUMENTS, not closure
    # constants: multihost jit cannot close over non-addressable global
    # arrays, and closure constants bloat compile payloads (the
    # make_device_run lesson)
    @jax.jit
    def _step(state: TraversalState, adj, packed, pops, offsets,
              target_packed, target_pop):
        return mapped(state, adj, packed, pops, offsets,
                      target_packed, target_pop)

    def step(state: TraversalState, target_packed, target_pop):
        res = _step(state, sg.adj, sg.packed, sg.pops, sg.offsets,
                    target_packed, target_pop)
        if traffic:
            state, adj_c, fp_c = res
            return state, {"adj_rows": adj_c, "fp_rows": fp_c}
        return res

    return step


class TrafficMeter:
    """Accumulates per-shard service counts across steps and reports the
    hub-imbalance profile (SURVEY.md §7 hard part 6: high-degree hub nodes
    concentrate gather traffic on their owning shard).

    Feed it the ``traffic_dict`` a ``traffic=True`` sharded step returns::

        step = make_sharded_step(sg, mesh, batch=64, traffic=True)
        meter = TrafficMeter(n_devices)
        state, t = step(state, target, t_pop); meter.add(t)
        print(meter.stats())   # imbalance = max/mean rows served per shard
    """

    def __init__(self, n_devices: int):
        self.n_devices = n_devices
        self.adj_rows = np.zeros((n_devices,), np.int64)
        self.fp_rows = np.zeros((n_devices,), np.int64)
        self.steps = 0

    def add(self, traffic: dict) -> None:
        self.adj_rows += np.asarray(traffic["adj_rows"], np.int64)
        self.fp_rows += np.asarray(traffic["fp_rows"], np.int64)
        self.steps += 1

    @staticmethod
    def _imbalance(counts: np.ndarray) -> float:
        mean = counts.mean()
        return float(counts.max() / mean) if mean > 0 else 1.0

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "adj_rows_per_shard": self.adj_rows.tolist(),
            "fp_rows_per_shard": self.fp_rows.tolist(),
            "adj_imbalance": self._imbalance(self.adj_rows),
            "fp_imbalance": self._imbalance(self.fp_rows),
        }


class _ShardStateOps:
    """Shard-aware state accessors for row-sharded scored/scores/enqueued.

    Gathers reconstruct values from the owning shard with one psum (exactly
    one owner per index); scatters apply only the locally-owned writes — no
    collective at all on the write path.
    """

    def __init__(self, axis: str, node_shard: int, row_shard: int):
        self.axis = axis
        self.node_shard = node_shard
        self.row_shard = row_shard

    def _gather(self, arr, idx, shard):
        me = jax.lax.axis_index(self.axis)
        loc = idx - me * shard
        own = (loc >= 0) & (loc < shard)
        vals = arr[jnp.clip(loc, 0, shard - 1)]
        contrib = jnp.where(own, vals.astype(jnp.int32), 0)
        total = jax.lax.psum(contrib, self.axis)
        return total.astype(arr.dtype)

    def _scatter(self, arr, idx, vals, shard):
        me = jax.lax.axis_index(self.axis)
        loc = idx - me * shard
        own = (loc >= 0) & (loc < shard)
        return arr.at[jnp.where(own, loc, shard)].set(vals, mode="drop")

    def gather_scored(self, arr, idx):
        return self._gather(arr, idx, self.node_shard).astype(jnp.bool_)

    def gather_enqueued(self, arr, idx):
        return self._gather(arr, idx, self.row_shard).astype(jnp.bool_)

    def gather_scores(self, arr, idx):
        # f32 bit pattern survives the int32 psum via bitcast
        me = jax.lax.axis_index(self.axis)
        loc = idx - me * self.node_shard
        own = (loc >= 0) & (loc < self.node_shard)
        vals = arr[jnp.clip(loc, 0, self.node_shard - 1)]
        bits = jax.lax.bitcast_convert_type(vals, jnp.int32)
        total = jax.lax.psum(jnp.where(own, bits, 0), self.axis)
        return jax.lax.bitcast_convert_type(total, jnp.float32)

    @staticmethod
    def first_occurrence(values, sentinel):
        # O(1)-memory argsort dedup: a [value range] scratch per chip (the
        # dense ops' scatter variant) would defeat state sharding
        from rad_tpu.traverse.device import _first_occurrence
        return _first_occurrence(values, sentinel)

    def scatter_scored(self, arr, idx, vals):
        return self._scatter(arr, idx, vals, self.node_shard)

    def scatter_scores(self, arr, idx, vals):
        return self._scatter(arr, idx, vals, self.node_shard)

    def scatter_enqueued(self, arr, idx, vals):
        return self._scatter(arr, idx, vals, self.row_shard)


def init_state_sharded(sg: ShardedGraph, mesh: Mesh,
                       frontier_capacity: int | None = None,
                       log_capacity: int | None = None,
                       buffer_capacity: int = 1 << 15) -> TraversalState:
    """TraversalState with scored/scores/enqueued row-sharded over the mesh
    (padded sizes) and the frontier/log/counters replicated — the layout
    for libraries whose *state* no longer fits one chip (docs/SCALING.md).
    """
    if frontier_capacity is None:
        from rad_tpu.traverse.device import auto_frontier_capacity
        frontier_capacity = auto_frontier_capacity(sg.n_pad_rows)
    cap = log_capacity if log_capacity is not None else sg.n_nodes
    row_sh = NamedSharding(mesh, P(sg.axis))
    rep = NamedSharding(mesh, P())

    def dev(x, sh):
        return jax.device_put(x, sh)

    return TraversalState(
        f_score=dev(jnp.full((frontier_capacity,), jnp.inf, jnp.float32),
                    rep),
        f_row=dev(jnp.zeros((frontier_capacity,), jnp.int32), rep),
        f_cursor=dev(jnp.zeros((), jnp.int32), rep),
        f_buf_score=dev(jnp.full((buffer_capacity,), jnp.inf, jnp.float32),
                        rep),
        f_buf_row=dev(jnp.zeros((buffer_capacity,), jnp.int32), rep),
        f_buf_n=dev(jnp.zeros((), jnp.int32), rep),
        f_live=dev(jnp.zeros((), jnp.int32), rep),
        cold_score=dev(jnp.full((0,), jnp.inf, jnp.float32), rep),
        cold_row=dev(jnp.zeros((0,), jnp.int32), rep),
        cold_n=dev(jnp.zeros((), jnp.int32), rep),
        watermark=dev(jnp.asarray(jnp.inf, jnp.float32), rep),
        enqueued=dev(jnp.zeros((sg.n_pad_rows,), jnp.bool_), row_sh),
        scored=dev(jnp.zeros((sg.n_pad_nodes,), jnp.bool_), row_sh),
        scores=dev(jnp.full((sg.n_pad_nodes,), jnp.inf, jnp.float32),
                   row_sh),
        order_log=dev(jnp.full((cap,), -1, jnp.int32), rep),
        n_scored=dev(jnp.zeros((), jnp.int32), rep),
        n_dropped=dev(jnp.zeros((), jnp.int32), rep),
        n_steps=dev(jnp.zeros((), jnp.int32), rep),
    )


def make_sharded_step_full(sg: ShardedGraph, mesh: Mesh, batch: int,
                           scorer=None, traffic: bool = False):
    """Pod step with BOTH graph and state sharded (billion-molecule layout).

    Like :func:`make_sharded_step` but ``scored``/``scores``/``enqueued``
    are row-sharded too (create the state with :func:`init_state_sharded`).
    Per-chip state memory drops from O(N) to O(N / n_devices); the extra
    cost is one psum per state gather, riding the same interconnect exchange as the
    fingerprint gathers. ``traffic=True`` as in :func:`make_sharded_step`.
    """
    axis = sg.axis
    nd = mesh.shape[axis]
    adj_shard = sg.n_pad_rows // nd
    fp_shard = sg.n_pad_nodes // nd
    # padded dg: sentinels must lie outside every shard
    dg_meta = DeviceGraph(adj=jnp.zeros((1, 1), jnp.int32),
                          offsets=sg.offsets, n_nodes=sg.n_pad_nodes,
                          n_rows=sg.n_pad_rows, m0=sg.m0,
                          max_level=sg.max_level)
    if scorer is None:
        scorer = tanimoto_to_target_scorer
    ops = _ShardStateOps(axis, fp_shard, adj_shard)

    def shard_body(state: TraversalState, adj_l, packed_l, pops_l,
                   offsets, target_packed, target_pop):
        dg = dataclasses.replace(dg_meta, offsets=offsets)

        gather_adj = _adj_gatherer(sg, adj_l, adj_shard, axis)

        state, out = expand_impl(state, dg, batch, gather_adj=gather_adj,
                                 ops=ops)
        ts = out["to_score"]
        ok = ts >= 0
        safe = jnp.where(ok, ts, 0)
        fp_rows = _owned_gather(packed_l, safe, fp_shard, axis, fill_shift=0)
        pop_rows = _owned_gather(pops_l, safe, fp_shard, axis, fill_shift=0)
        raw = scorer(fp_rows, pop_rows, target_packed, target_pop)
        scores = jnp.where(ok, raw.astype(jnp.float32), jnp.inf)
        state = integrate_impl(state, dg, out["exp_node"], out["exp_level"],
                               out["exp_score"], out["exp_valid"],
                               out["cand"], out["to_score"], scores,
                               ops=ops)
        if traffic:
            adj_c, fp_c = _shard_traffic(nd, adj_shard, fp_shard, offsets,
                                         out)
            return state, adj_c, fp_c
        return state

    rep_spec = jax.tree_util.tree_map(lambda _: P(), _state_structure())
    state_spec = dataclasses.replace(
        rep_spec, enqueued=P(axis), scored=P(axis), scores=P(axis))
    out_specs = (state_spec, P(), P()) if traffic else state_spec
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(state_spec, P(axis, None), P(axis, None), P(axis),
                  P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )

    # graph arrays enter the jitted program as ARGUMENTS, not closure
    # constants: multihost jit cannot close over non-addressable global
    # arrays, and closure constants bloat compile payloads (the
    # make_device_run lesson)
    @jax.jit
    def _step(state: TraversalState, adj, packed, pops, offsets,
              target_packed, target_pop):
        return mapped(state, adj, packed, pops, offsets,
                      target_packed, target_pop)

    def step(state: TraversalState, target_packed, target_pop):
        res = _step(state, sg.adj, sg.packed, sg.pops, sg.offsets,
                    target_packed, target_pop)
        if traffic:
            state, adj_c, fp_c = res
            return state, {"adj_rows": adj_c, "fp_rows": fp_c}
        return res

    return step


def make_sharded_step_multi(sg: ShardedGraph, mesh: Mesh, batch: int):
    """Multi-campaign × pod composition: T vmapped campaigns over the
    graph-sharded step.

    T independent screenings share ONE row-sharded graph: per-campaign
    state stacks on a leading [T] axis (build with
    rad_tpu.traverse.multi.init_multi / prime_multi) and is replicated
    across the mesh, while adjacency/fingerprint gathers ride the same
    owned-gather psums as the single-campaign pod step — vmapped over
    campaigns with a SHARED (non-batched) local operand, as the
    single-card multi engine gathers. Frontier commit/refill decisions
    are scalar-lifted across campaigns exactly as in the single-chip
    multi engine (rad_tpu.traverse.multi.multi_step), so each campaign's
    result is bit-identical to its solo pod run at the same budget.

    Returns ``step(states, targets [T, W], t_pops [T], budgets [T])``.
    """
    from rad_tpu.traverse.multi import multi_step

    axis = sg.axis
    nd = mesh.shape[axis]
    adj_shard = sg.n_pad_rows // nd
    fp_shard = sg.n_pad_nodes // nd
    dg_meta = DeviceGraph(adj=jnp.zeros((1, 1), jnp.int32),
                          offsets=sg.offsets, n_nodes=sg.n_nodes,
                          n_rows=sg.n_rows, m0=sg.m0,
                          max_level=sg.max_level)

    def shard_body(states: TraversalState, adj_l, packed_l, pops_l,
                   offsets, targets, t_pops, budgets):
        dg = dataclasses.replace(dg_meta, offsets=offsets)

        gather_adj = _adj_gatherer(sg, adj_l, adj_shard, axis)

        def expand_score(state, target, t_pop, refill):
            state, out = expand_impl(state, dg, batch, refill=refill,
                                     gather_adj=gather_adj)
            ts = out["to_score"]
            ok = ts >= 0
            safe = jnp.where(ok, ts, 0)
            fp_rows = _owned_gather(packed_l, safe, fp_shard, axis,
                                    fill_shift=0)
            pop_rows = _owned_gather(pops_l, safe, fp_shard, axis,
                                     fill_shift=0)
            raw = tanimoto_to_target_scorer(fp_rows, pop_rows, target,
                                            t_pop)
            scores = jnp.where(ok, raw.astype(jnp.float32), jnp.inf)
            return state, out, scores

        def vm_expand_score(sts, refill):
            return jax.vmap(
                lambda s, tg, tp: expand_score(s, tg, tp, refill)
            )(sts, targets, t_pops)

        return multi_step(states, dg, budgets, batch, vm_expand_score)

    state_spec = jax.tree_util.tree_map(lambda _: P(), _state_structure())
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(state_spec, P(axis, None), P(axis, None), P(axis),
                  P(), P(), P(), P()),
        out_specs=state_spec,
        check_vma=False,
    )

    @jax.jit
    def _step(states, adj, packed, pops, offsets, targets, t_pops,
              budgets):
        return mapped(states, adj, packed, pops, offsets, targets,
                      t_pops, budgets)

    def step(states: TraversalState, targets, t_pops, budgets):
        budgets = jnp.broadcast_to(jnp.asarray(budgets, jnp.int32),
                                   (targets.shape[0],))
        return _step(states, sg.adj, sg.packed, sg.pops, sg.offsets,
                     targets, t_pops, budgets)

    return step


_OUT_KEYS = ("exp_node", "exp_level", "exp_score", "exp_valid", "cand",
             "to_score")


def make_sharded_expand_integrate(sg: ShardedGraph, mesh: Mesh, batch: int,
                                  shard_state: bool = False):
    """The pod engine split at the scoring boundary: ``(expand, integrate)``.

    This is what lets a *host* scoring function (an external docking
    program, the reference's entire reason to exist —
    rad/distributed_worker.py:296-308) drive a graph no single chip holds:
    ``expand`` pops the replicated frontier, gathers adjacency rows from
    their owning shards over the interconnect, and returns the unscored candidate ids to
    the host; ``integrate`` writes the host's scores back and completes the
    step. Both compile once per shape; all ``expand`` outputs are replicated
    (derived from replicated state + psum'd gathers), so the host reads one
    logical array.

    ``shard_state=True`` additionally row-shards scored/scores/enqueued
    (create the state with :func:`init_state_sharded`) — the layout for
    billion-molecule libraries.

        expand(state) -> (state, out)    out: dict of _OUT_KEYS arrays
        integrate(state, out, new_scores [B*M0] f32) -> state

    Drive with rad_tpu.traverse.pipeline.pipelined_traverse (the prefetch
    overlap of rad/coordination_service.py:314-347).
    """
    axis = sg.axis
    nd = mesh.shape[axis]
    adj_shard = sg.n_pad_rows // nd
    fp_shard = sg.n_pad_nodes // nd
    if shard_state:
        dg_meta = DeviceGraph(adj=jnp.zeros((1, 1), jnp.int32),
                              offsets=sg.offsets, n_nodes=sg.n_pad_nodes,
                              n_rows=sg.n_pad_rows, m0=sg.m0,
                              max_level=sg.max_level)
        ops = _ShardStateOps(axis, fp_shard, adj_shard)
    else:
        dg_meta = DeviceGraph(adj=jnp.zeros((1, 1), jnp.int32),
                              offsets=sg.offsets, n_nodes=sg.n_nodes,
                              n_rows=sg.n_rows, m0=sg.m0,
                              max_level=sg.max_level)
        from rad_tpu.traverse.device import DENSE_OPS
        ops = DENSE_OPS

    rep_spec = jax.tree_util.tree_map(lambda _: P(), _state_structure())
    if shard_state:
        state_spec = dataclasses.replace(
            rep_spec, enqueued=P(axis), scored=P(axis), scores=P(axis))
    else:
        state_spec = rep_spec

    def expand_body(state: TraversalState, adj_l, offsets):
        dg = dataclasses.replace(dg_meta, offsets=offsets)

        gather_adj = _adj_gatherer(sg, adj_l, adj_shard, axis)

        state, out = expand_impl(state, dg, batch, gather_adj=gather_adj,
                                 ops=ops)
        return state, tuple(out[k] for k in _OUT_KEYS)

    expand_mapped = jax.shard_map(
        expand_body, mesh=mesh,
        in_specs=(state_spec, P(axis, None), P()),
        out_specs=(state_spec, tuple(P() for _ in _OUT_KEYS)),
        check_vma=False,
    )

    @jax.jit
    def _expand(state: TraversalState, adj, offsets):
        state, outs = expand_mapped(state, adj, offsets)
        return state, dict(zip(_OUT_KEYS, outs))

    def expand(state: TraversalState):
        return _expand(state, sg.adj, sg.offsets)

    def integrate_body(state: TraversalState, offsets, exp_node, exp_level,
                       exp_score, exp_valid, cand, to_score, new_scores):
        dg = dataclasses.replace(dg_meta, offsets=offsets)
        return integrate_impl(state, dg, exp_node, exp_level, exp_score,
                              exp_valid, cand, to_score, new_scores,
                              ops=ops)

    integrate_mapped = jax.shard_map(
        integrate_body, mesh=mesh,
        in_specs=(state_spec,) + tuple(P() for _ in range(8)),
        out_specs=state_spec,
        check_vma=False,
    )

    @jax.jit
    def _integrate(state: TraversalState, offsets, out: dict, new_scores):
        return integrate_mapped(state, offsets, out["exp_node"],
                                out["exp_level"], out["exp_score"],
                                out["exp_valid"], out["cand"],
                                out["to_score"], new_scores)

    def integrate(state: TraversalState, out: dict, new_scores):
        return _integrate(state, sg.offsets, out, new_scores)

    return expand, integrate


def tanimoto_to_target_scorer(fp_rows, pop_rows, target_packed, target_pop):
    """Default on-device scorer: Tanimoto distance to a target fingerprint
    (the virtual-actives analogue of the reference notebook's lookup table)."""
    from rad_tpu.fp.tanimoto import tanimoto_rows_to_target
    return tanimoto_rows_to_target(fp_rows, pop_rows, target_packed,
                                   target_pop)


def _state_structure():
    """A TraversalState skeleton for building replicated PartitionSpecs."""
    import dataclasses as _dc
    z = jnp.zeros(())
    n_fields = len(_dc.fields(TraversalState))
    return TraversalState(*([z] * n_fields))


def make_sharded_search(sg: ShardedGraph, mesh: Mesh, k: int, ef: int,
                        batch: int):
    """Graph-sharded HNSW kNN: the beam walks a graph no chip holds whole.

    Queries are replicated (one beam per query, vmapped); every beam
    iteration gathers the expanded node's adjacency row and the candidate
    fingerprints from whichever chips own them via the owned-gather psum.
    Per-iteration interconnect traffic is O(B·M0·W) — independent of N. Loop
    decisions depend only on replicated values, so all chips execute
    identical trip counts.

    Returns ``search(queries [B, W] uint32) -> (dists [B, k], ids [B, k])``
    with B == ``batch``.
    """
    shard_body = _make_search_shard_body(sg, k, ef)

    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(sg.axis, None), P(sg.axis, None), P(sg.axis), P(),
                  P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def _search(adj, packed, pops, offsets, queries):
        from rad_tpu.fp.pack import popcount_rows
        q_pops = popcount_rows(queries)
        return mapped(adj, packed, pops, offsets, queries, q_pops)

    def search(queries):
        if queries.shape[0] != batch:
            raise ValueError(
                f"search built for batch={batch} got {queries.shape[0]} "
                f"queries — each batch size is its own compiled program "
                f"(build one search per size, or pad the query block)")
        return _search(sg.adj, sg.packed, sg.pops, sg.offsets, queries)

    return search


def _make_search_shard_body(sg: ShardedGraph, k: int, ef: int):
    """The per-shard beam-search body shared by the 1-D (replicated-query)
    and 2-D (query-sharded) sharded searches. Collectives run over the
    graph axis only, so a query shard's beam is oblivious to how many
    data-rows the mesh has."""
    axis = sg.axis
    n = sg.n_nodes
    m0 = sg.m0
    max_level = sg.max_level

    def shard_body(adj_l, packed_l, pops_l, offsets, queries, q_pops):
        # shard sizes come from the local block shapes (static at trace);
        # packed storage holds adj_group rows per local table row
        adj_shard = adj_l.shape[0] * sg.adj_group
        fp_shard = packed_l.shape[0]

        gather_adj_rows = _adj_gatherer(sg, adj_l, adj_shard, axis)

        def gather_fps(ids):                 # [B, K] -> [B, K, W], [B, K]
            flat = ids.reshape(-1)
            safe = jnp.maximum(flat, 0)
            fps = _owned_gather(packed_l, safe, fp_shard, axis, fill_shift=0)
            pops = _owned_gather(pops_l, safe, fp_shard, axis, fill_shift=0)
            return (fps.reshape(*ids.shape, -1), pops.reshape(ids.shape))

        b = queries.shape[0]

        def dist_to(ids, valid):             # [B, K] ids -> [B, K] dists
            fps, pops = gather_fps(jnp.where(valid, ids, 0))
            inter = jnp.sum(popcount(fps & queries[:, None, :]), axis=-1)
            union = q_pops[:, None] + pops - inter
            sim = jnp.where(union > 0, inter / jnp.maximum(union, 1), 1.0)
            return jnp.where(valid, (1.0 - sim).astype(jnp.float32),
                             jnp.inf)

        # greedy descent through upper layers (all queries in lockstep)
        ep = jnp.zeros((b,), jnp.int32)
        d_ep = dist_to(ep[:, None], jnp.ones((b, 1), jnp.bool_))[:, 0]
        for l in range(max_level, 0, -1):
            def cond(c):
                _, _, improved = c
                return jnp.any(improved)

            def body(c):
                ep_i, d_i, improved = c
                rows = gather_adj_rows(offsets[l] + ep_i)
                valid = (rows >= 0) & improved[:, None]
                d_n = dist_to(rows, valid)
                j = jnp.argmin(d_n, axis=1)
                dbest = d_n[jnp.arange(b), j]
                better = dbest < d_i
                return (jnp.where(better, rows[jnp.arange(b), j], ep_i),
                        jnp.where(better, dbest, d_i),
                        better)

            ep, d_ep, _ = jax.lax.while_loop(
                cond, body, (ep, d_ep, jnp.ones((b,), jnp.bool_)))

        # layer-0 beam, batched across queries; visited is size-gated
        # (rad_tpu.search.visited): dense [B, N] bitmap within budget,
        # else a bounded id hash table [B, H] (H independent of N),
        # replicated across shards — both ops are order-independent, so
        # every shard computes identical tables.
        from rad_tpu.search.visited import (hashset_check_insert_batch,
                                            use_dense_visited,
                                            visited_capacity_for)

        dense = use_dense_visited(b, n)
        max_iters = 16 * ef + 256
        beam_d = jnp.full((b, ef), jnp.inf).at[:, 0].set(d_ep)
        beam_id = jnp.full((b, ef), -1, jnp.int32).at[:, 0].set(ep)
        expanded = jnp.zeros((b, ef), jnp.bool_)
        if dense:
            visited = jnp.zeros((b, n), jnp.bool_).at[
                jnp.arange(b), jnp.maximum(ep, 0)].set(True)
        else:
            h = visited_capacity_for(ef, m0, n)
            visited, _ = hashset_check_insert_batch(
                jnp.full((b, h), -1, jnp.int32), ep[:, None],
                jnp.ones((b, 1), jnp.bool_))

        def bcond(c):
            beam_d, beam_id, expanded, visited, it = c
            return jnp.any(~expanded & jnp.isfinite(beam_d)) \
                & (it < max_iters)

        def bbody(c):
            beam_d, beam_id, expanded, visited, it = c
            sel = jnp.argmin(jnp.where(expanded, jnp.inf, beam_d), axis=1)
            rowsel = jnp.arange(b)
            has_work = ~expanded[rowsel, sel] \
                & jnp.isfinite(beam_d[rowsel, sel])
            expanded = expanded.at[rowsel, sel].set(True)
            u = jnp.maximum(beam_id[rowsel, sel], 0)
            nbrs = gather_adj_rows(u)                      # layer-0 rows
            valid = (nbrs >= 0) & has_work[:, None]
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
            d_n = dist_to(nbrs, valid)
            all_d = jnp.concatenate([beam_d, d_n], axis=1)
            all_i = jnp.concatenate(
                [beam_id, jnp.where(valid, nbrs, -1)], axis=1)
            all_e = jnp.concatenate(
                [expanded, jnp.zeros((b, m0), jnp.bool_)], axis=1)
            sd, si, se = jax.lax.sort((all_d, all_i, all_e), num_keys=1)
            return sd[:, :ef], si[:, :ef], se[:, :ef], visited, it + 1

        beam_d, beam_id, expanded, visited, _ = jax.lax.while_loop(
            bcond, bbody,
            (beam_d, beam_id, expanded, visited, jnp.int32(0)))
        return beam_d[:, :k], beam_id[:, :k]

    return shard_body


def make_sharded_search_2d(sg: ShardedGraph, mesh: Mesh, k: int, ef: int,
                           batch: int, data_axis: str = "data"):
    """Query-parallel × graph-parallel kNN over a 2-D mesh.

    The 1-D :func:`make_sharded_search` replicates the query batch on every
    chip; on a ``(data, graph)`` mesh the batch additionally *shards* over
    the ``data`` axis — each data-row of the mesh runs an independent beam
    over its query shard while the graph stays sharded over the ``graph``
    axis within the row. Query throughput then scales with
    ``mesh.shape[data_axis]`` at constant per-chip memory: the pod-scale
    layout for bulk similarity screening (e.g. all-pairs library
    comparison).

    ``batch`` is the GLOBAL query count (must divide by the data-axis
    size). Build the mesh with
    ``make_mesh((n_data, n_graph), axis_names=("data", "graph"))`` and the
    ShardedGraph with the same mesh (graph arrays are sharded over
    ``graph`` only, replicated across ``data`` automatically).
    """
    axis = sg.axis
    nd_data = mesh.shape[data_axis]
    assert batch % nd_data == 0, (batch, nd_data)
    inner = _make_search_shard_body(sg, k, ef)

    mapped = jax.shard_map(
        inner, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis), P(),
                  P(data_axis, None), P(data_axis)),
        out_specs=(P(data_axis, None), P(data_axis, None)),
        check_vma=False,
    )

    @jax.jit
    def _search(adj, packed, pops, offsets, queries):
        from rad_tpu.fp.pack import popcount_rows
        q_pops = popcount_rows(queries)
        return mapped(adj, packed, pops, offsets, queries, q_pops)

    def search(queries):
        return _search(sg.adj, sg.packed, sg.pops, sg.offsets, queries)

    return search


def sharded_fused_step(state: TraversalState, sg: ShardedGraph, mesh: Mesh,
                       target_packed, target_pop, batch: int):
    """One-shot convenience wrapper over :func:`make_sharded_step`.

    The built step is memoized per (graph, mesh, batch) — each
    `make_sharded_step` call creates a fresh `jax.jit` whose cache is
    empty, and a full pod-step recompile costs minutes through the
    remote-compile service. Loops should still call
    :func:`make_sharded_step` once and reuse the returned step.
    """
    key = (id(sg), id(mesh), batch)
    cached = _FUSED_STEP_CACHE.get(key)
    # id() keys can be reused after gc — validate identity via the refs
    if cached is None or cached[0]() is not sg or cached[1]() is not mesh:
        step = make_sharded_step(sg, mesh, batch)
        _FUSED_STEP_CACHE[key] = (weakref.ref(sg), weakref.ref(mesh), step)
    else:
        step = cached[2]
    return step(state, target_packed, target_pop)


_FUSED_STEP_CACHE: dict = {}
