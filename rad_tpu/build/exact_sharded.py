"""Mesh-sharded stage drivers for the exact builder: distributed build.

``build_hnsw_exact(mesh=...)`` routes each big layer's three stages
through these drivers so construction scales with cards —
``shard_map`` over a 1-D device mesh, XLA collectives over NVLink —
while producing the EXACT same graph, edge for edge, as the
single-device build (pinned by tests/test_build_sharded.py):

* candidates — q-blocks are independent, so each device runs the shared
  per-q-block body (:func:`rad_tpu.build.exact._make_one_qblock`) over
  its own contiguous q-block span against the replicated fingerprint
  matrix. Zero collectives; the output candidate table comes out
  row-sharded. Replicating the packed matrix bounds the regime to
  layers that fit one card (~100M rows of 1024-bit — far past the exact
  builder's O(N²) break-even; beyond that, partition-and-stitch).
* selection — rows are independent; each device selects for its own
  row span from its local candidate shard. Zero collectives.
* symmetrization — the one genuinely global stage: a directed selection
  (i → j, d) must reach BOTH row i's and row j's incident-edge tables.
  Each device folds its own source rows' edges into a full-height
  per-destination table (bounded sorts), then ONE ``all_to_all`` redistributes the tables' row spans
  to their owners, and each device merge-reduces the D sub-tables it
  received for its span. Fold order is irrelevant to the result — every
  fold is a lossless truncation to the per-destination top-``cap`` by
  (distance, src), so any merge tree yields the global answer
  (:func:`rad_tpu.build.exact._merge_rows` dedups the (dst, src)
  duplicate pairs that mutual selections emit from two different source
  devices).

The reference has no distributed build — usearch parallelizes inserts
over threads of ONE machine (reference examples/DUDEZ_example.ipynb:192);
its multi-machine story is serve-only. Here the same arrays that make
the single-card build compute-bound make the distributed build an
embarrassingly-parallel fan-out plus one collective.

These drivers run each stage as ONE program per layer (no host-loop
dispatch bounding, unlike the single-device path's dispatch-size
constants in rad_tpu.build.exact).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rad_tpu.build.exact import (INF, _fold_edges, _make_one_qblock,
                                 _make_one_qblock_probed, _merge_rows,
                                 SYMM_EDGES_PER_SORT)

__all__ = ["allpairs_topk_sharded", "probed_topk_sharded",
           "select_layer_sharded", "symmetrize_sharded", "replicate"]


def replicate(arr, mesh: Mesh):
    """Place ``arr`` fully replicated over ``mesh`` (host → every device)."""
    return jax.device_put(arr, NamedSharding(mesh, P()))


def allpairs_topk_sharded(packed, n_real: int, k: int, q_block: int,
                          col_block: int, impl: str,
                          approx_recall: float | None, bucket: int | None,
                          interpret: bool, mesh: Mesh, axis: str):
    """Sharded :func:`rad_tpu.build.exact._allpairs_topk`: device ``i``
    computes q-blocks ``[i·s, (i+1)·s)`` with the identical per-block
    body, so per-row results are bit-identical to the single-device
    driver. Requires ``n_pad % (D · q_block) == 0`` (the builder pads
    big layers to the mesh unit). Returns row-sharded
    ([n_pad, k] dists, [n_pad, k] ids)."""
    n_pad, _ = packed.shape
    d_mesh = mesh.shape[axis]
    nq = n_pad // q_block
    if nq % d_mesh:
        raise ValueError(f"n_pad={n_pad} q-blocks ({nq}) must divide "
                         f"evenly over the {d_mesh}-device '{axis}' axis")
    s = nq // d_mesh

    def body(packed_rep, n_real_s):
        i = jax.lax.axis_index(axis)
        one = _make_one_qblock(packed_rep, n_real_s, k, q_block,
                               col_block, impl, approx_recall,
                               bucket, interpret)
        d, ids = jax.lax.map(
            one, i * s + jnp.arange(s, dtype=jnp.int32))
        return (d.reshape(s * q_block, k), ids.reshape(s * q_block, k))

    mapped = jax.shard_map(body, mesh=mesh, in_specs=(P(), P()),
                           out_specs=(P(axis, None), P(axis, None)),
                           check_vma=False)
    return jax.jit(mapped)(packed, jnp.int32(n_real))


def probed_topk_sharded(packed_cl, perm_cl, scan_cols, k: int,
                        q_block: int, csize: int, impl: str,
                        approx_recall: float | None, bucket: int | None,
                        interpret: bool, mesh: Mesh, axis: str):
    """Sharded probed candidate stage: device ``i`` runs the shared
    probed q-block body over its span of PERMUTED q-blocks. The permuted
    block count need not divide the mesh — tail devices re-compute
    clamped blocks, and the caller's position-keyed scatter is
    idempotent (same convention as the single-device span overlap).
    Returns ([D·s·q_block, k] dists, ids, positions) in permuted space,
    row-sharded, for the caller's scatter."""
    n_tot, _ = packed_cl.shape
    d_mesh = mesh.shape[axis]
    nq = n_tot // q_block
    s = -(-nq // d_mesh)

    def body(packed_rep, perm_rep, cols_rep):
        i = jax.lax.axis_index(axis)
        one = _make_one_qblock_probed(packed_rep, perm_rep, cols_rep, k,
                                      q_block, csize, impl,
                                      approx_recall, bucket, interpret)
        qs = jnp.minimum(i * s + jnp.arange(s, dtype=jnp.int32), nq - 1)
        d, ids = jax.lax.map(one, qs)
        pos = (qs[:, None] * q_block
               + jnp.arange(q_block, dtype=jnp.int32)[None, :])
        return (d.reshape(s * q_block, k), ids.reshape(s * q_block, k),
                pos.reshape(s * q_block))

    mapped = jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis)),
        check_vma=False)
    return jax.jit(mapped)(packed_cl, perm_cl, scan_cols)


def select_layer_sharded(packed, pops, cand_d, cand_id, n_real: int,
                         m: int, heuristic_k: int, sel_block: int,
                         mesh: Mesh, axis: str, int8_pairs: bool = False):
    """Sharded :func:`rad_tpu.build.exact._select_layer`: rows are
    independent, so each device selects for its own row span from its
    local candidate shard against the replicated fingerprints. Requires
    ``n_pad % (D · sel_block) == 0``."""
    from rad_tpu.build.device import _dist_rows, _select_neighbors

    n_pad, k = cand_d.shape
    d_mesh = mesh.shape[axis]
    rs = n_pad // d_mesh
    if n_pad % d_mesh or rs % sel_block:
        raise ValueError(f"n_pad={n_pad} rows must split into "
                         f"sel_block={sel_block} chunks per device")
    nch = rs // sel_block

    def body(packed_rep, pops_rep, cd, ci, n_real_s):
        i = jax.lax.axis_index(axis)
        q_ids = i * rs + jnp.arange(rs, dtype=jnp.int32)

        def one(chunk):
            cdc, cic, qi = chunk
            active = qi < n_real_s
            safe_q = jnp.minimum(qi, n_real_s - 1)
            sel = _select_neighbors(packed_rep, pops_rep, safe_q, cdc,
                                    cic, m, heuristic_k, active,
                                    int8_pairs=int8_pairs)
            sel_d = _dist_rows(packed_rep, pops_rep, safe_q, sel,
                               (sel >= 0) & active[:, None])
            return sel, sel_d

        sel, sel_d = jax.lax.map(
            one, (cd.reshape(nch, sel_block, k),
                  ci.reshape(nch, sel_block, k),
                  q_ids.reshape(nch, sel_block)))
        return sel.reshape(rs, -1), sel_d.reshape(rs, -1)

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P(axis, None), P()),
        out_specs=(P(axis, None), P(axis, None)),
        check_vma=False)
    return jax.jit(mapped)(packed, pops, cand_d, cand_id,
                           jnp.int32(n_real))


def symmetrize_sharded(sel, sel_d, n_real: int, cap: int, mesh: Mesh,
                       axis: str,
                       edges_per_sort: int = SYMM_EDGES_PER_SORT):
    """Sharded per-destination top-``cap`` incident-edge merge.

    Device ``i`` folds edges from ITS source rows into a full-height
    [n_pad, cap] table (row-chunked so each 3-key sort stays bounded),
    one ``all_to_all`` hands every
    device the D partial tables covering its own row span, and a local
    merge-reduce finishes. Bit-identical to the single-device forms:
    each fold/merge is a lossless truncation (an entrant dropped locally
    was beaten by ``cap`` distinct same-destination entrants that also
    beat it globally), so the final table is the global per-destination
    top-``cap`` by (distance, src) regardless of fold placement, with
    (dst, src) duplicate pairs — emitted from two different source
    devices when selections are mutual — deduped by
    :func:`rad_tpu.build.exact._merge_rows`."""
    n_pad, m = sel.shape
    d_mesh = mesh.shape[axis]
    if n_pad % d_mesh:
        raise ValueError(f"n_pad={n_pad} must divide over {d_mesh} devices")
    rs = n_pad // d_mesh
    b = max(1, min(rs, edges_per_sort // (2 * m)))

    def body(sel_l, sel_d_l, n_real_s):
        i = jax.lax.axis_index(axis)
        r0 = i * rs
        run_d = jnp.full((n_pad, cap), INF)
        run_s = jnp.full((n_pad, cap), -1, jnp.int32)
        for c0 in range(0, rs, b):
            bb = min(b, rs - c0)  # static per unrolled fold
            run_d, run_s = _fold_edges(
                run_d, run_s, sel_l[c0:c0 + bb], sel_d_l[c0:c0 + bb],
                r0 + c0, n_real_s, cap)
        td = jax.lax.all_to_all(run_d.reshape(d_mesh, rs, cap), axis,
                                split_axis=0, concat_axis=0, tiled=False)
        ts = jax.lax.all_to_all(run_s.reshape(d_mesh, rs, cap), axis,
                                split_axis=0, concat_axis=0, tiled=False)
        out_d, out_s = td[0], ts[0]
        for j in range(1, d_mesh):
            out_d, out_s = _merge_rows(out_d, out_s, td[j], ts[j], cap)
        return out_s

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P()),
        out_specs=P(axis, None),
        check_vma=False)
    return jax.jit(mapped)(sel, sel_d, jnp.int32(n_real))
