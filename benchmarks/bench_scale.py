#!/usr/bin/env python
"""Single-chip engine scale ceiling: a 100M-node device-resident traversal.

BASELINE config 3 names ZINC-100M device-side traversal as the staged
scale target; this benchmark runs the traversal engine at that node count
on ONE chip. Everything big — the layered HNSW-shaped adjacency, the
score table, the fingerprints — is GENERATED ON DEVICE inside jitted
programs, because at 100M nodes the adjacency alone is ~7 GB and
host->device transfer would dominate the
wall-clock (and 100M-node graph *construction* is a pod-scale job,
docs/SCALING.md — the partition builder's output has exactly this shape).

Two scorer modes:
  --mode hash  (default): the per-node score is a pre-materialized random
      table gathered by node id — the engine-ceiling measurement (the
      gather models a score/surrogate lookup; a random graph has no
      similarity structure to exploit anyway).
  --mode fps: real packed fingerprints (device-generated random bits) and
      the fused Tanimoto-to-target scorer (`fused_run`) — adds the
      [K, W]-row fingerprint gather + popcount work to every step.

Memory at n=100M, m=8 (the reference README's default connectivity,
/root/reference/README.md:47-53): adjacency [R=114M, 16] int32 = 7.3 GB,
score table 0.4 GB, order log 0.4 GB, enqueued+scored 0.2 GB, frontier
2^22 = 48 MB -> ~8.5 GB of 16 GB HBM.

    python benchmarks/bench_scale.py --n 100000000 --budget 10000000
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def hnsw_layer_sizes(n: int, m: int) -> list[int]:
    """Expected HNSW layer occupancy: n_l = round(n * m^-l), min 1."""
    sizes = []
    l = 0
    while True:
        nl = int(round(n * m ** (-l)))
        if nl < 1:
            break
        sizes.append(nl)
        if nl == 1:
            break
        l += 1
    return sizes


def make_device_graph(n: int, m: int, seed: int, n_chunks: int = 64,
                      packed_bits: int | None = None):
    """HNSW-shaped random layered graph, adjacency generated on device.

    Layer 0 has cap 2m (usearch convention, rad_tpu.build.reference), upper
    layers cap m; the flat table is [R_pad, 2m] with -1 padding. The extra
    R_pad - R rows (chunk round-up) are never referenced: row ids are
    always offsets[level] + node < R.

    ``packed_bits``: emit a bit-packed adjacency (rad_tpu.graph.adjpack)
    instead of int32 — each chunk is packed on device before it lands, so
    the int32 table is never resident and peak HBM is the packed table
    plus one chunk (the 200M+ configuration).
    """
    import jax
    import jax.numpy as jnp
    from rad_tpu.traverse.device import DeviceGraph

    sizes = hnsw_layer_sizes(n, m)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    r = int(offsets[-1])
    m0 = 2 * m
    chunk = -(-r // n_chunks)  # ceil
    grp = 1
    if packed_bits:
        from rad_tpu.graph.adjpack import (adj_group_for,
                                           pack_adjacency_rows,
                                           packed_adj_words)
        grp = adj_group_for(m0, packed_bits)
        chunk = -(-chunk // grp) * grp
    r_pad = chunk * n_chunks
    offsets_dev = jnp.asarray(
        np.concatenate([offsets, [r]]).astype(np.int32))
    sizes_dev = jnp.asarray(np.asarray(sizes + [1], np.int32))
    max_level = len(sizes) - 1

    @partial(jax.jit, static_argnames=("nch",), donate_argnums=(1,))
    def gen(key, adj, offs, szs, nch):
        def body(i, adj):
            lo = i * chunk
            rows = lo + jnp.arange(chunk, dtype=jnp.int32)
            lev = jnp.clip(
                jnp.searchsorted(offs[: max_level + 2], rows,
                                 side="right") - 1, 0, max_level)
            nl = szs[lev]
            safe_nl = jnp.maximum(nl, 1).astype(jnp.uint32)
            bits = jax.random.bits(jax.random.fold_in(key, i),
                                   (chunk, m0), jnp.uint32)
            ids = (bits % safe_nl[:, None]).astype(jnp.int32)
            node = rows - offs[lev]
            ids = jnp.where(ids == node[:, None],
                            (ids + 1) % jnp.maximum(nl, 1)[:, None], ids)
            cap_row = jnp.where(lev == 0, m0, m)
            col_ok = jnp.arange(m0, dtype=jnp.int32)[None, :] < cap_row[:, None]
            ids = jnp.where(col_ok & (nl[:, None] > 1) & (rows[:, None] < r),
                            ids, -1)
            if packed_bits:
                w = packed_adj_words(m0, packed_bits)
                ids = pack_adjacency_rows(ids, packed_bits)
                ids = ids.reshape(chunk // grp, grp * w)
                return jax.lax.dynamic_update_slice(adj, ids, (lo // grp, 0))
            return jax.lax.dynamic_update_slice(adj, ids, (lo, 0))

        return jax.lax.fori_loop(0, nch, body, adj)

    key = jax.random.PRNGKey(seed)
    if packed_bits:
        adj = jnp.zeros(
            (r_pad // grp, grp * packed_adj_words(m0, packed_bits)),
            jnp.uint32)
    else:
        adj = jnp.full((r_pad, m0), -1, jnp.int32)
    adj = gen(key, adj, offsets_dev, sizes_dev, n_chunks)
    dg = DeviceGraph(adj=adj, offsets=offsets_dev, n_nodes=n, n_rows=r,
                     m0=m0, max_level=max_level,
                     adj_bits=packed_bits or 32, adj_group=grp)
    return dg, sizes


def abstract_device_graph(n: int, m: int, n_chunks: int = 64,
                          packed_bits: int | None = None):
    """Same shapes as make_device_graph, but adj is a ShapeDtypeStruct —
    for AOT memory analysis without allocating HBM."""
    import jax
    import jax.numpy as jnp
    from rad_tpu.traverse.device import DeviceGraph

    sizes = hnsw_layer_sizes(n, m)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    r = int(offsets[-1])
    m0 = 2 * m
    chunk = -(-r // n_chunks)
    grp = 1
    if packed_bits:
        from rad_tpu.graph.adjpack import adj_group_for, packed_adj_words
        grp = adj_group_for(m0, packed_bits)
        chunk = -(-chunk // grp) * grp
    r_pad = chunk * n_chunks
    offsets_dev = jnp.asarray(np.concatenate([offsets, [r]]).astype(np.int32))
    if packed_bits:
        adj = jax.ShapeDtypeStruct(
            (r_pad // grp, grp * packed_adj_words(m0, packed_bits)),
            jnp.uint32)
    else:
        adj = jax.ShapeDtypeStruct((r_pad, m0), jnp.int32)
    dg = DeviceGraph(adj=adj, offsets=offsets_dev, n_nodes=n, n_rows=r,
                     m0=m0, max_level=len(sizes) - 1,
                     adj_bits=packed_bits or 32, adj_group=grp)
    return dg, sizes


def make_id_run(batch: int, no_score_table: bool):
    """The id-mode run program (module-level so --mem-analysis can AOT-
    compile exactly what the timed path executes)."""
    import jax
    import jax.numpy as jnp
    from rad_tpu.traverse import device as dev

    def id_score(ids):
        x = ids.astype(jnp.float32) * 0.6180339887498949
        return x - jnp.floor(x)

    if no_score_table:
        class _IdOps(dev.DenseStateOps):
            @staticmethod
            def gather_scores(arr, idx):
                return id_score(idx)

            @staticmethod
            def scatter_scores(arr, idx, vals):
                return arr

        id_ops = _IdOps()
    else:
        id_ops = dev.DENSE_OPS

    @partial(jax.jit, donate_argnums=(0,))
    def _run_id(state, n_to_score, dg_a):
        def cond(carry):
            st, steps = carry
            return ((st.n_scored < n_to_score)
                    & (steps < (1 << 20))
                    & (dev.frontier_live(st) > 0))

        def body(carry):
            st, steps = carry
            st, out = dev.expand_impl(st, dg_a, batch)
            ts = out["to_score"]
            scores = jnp.where(ts >= 0, id_score(ts), jnp.inf)
            st = dev.integrate_impl(
                st, dg_a, out["exp_node"], out["exp_level"],
                out["exp_score"], out["exp_valid"], out["cand"],
                out["to_score"], scores, ops=id_ops)
            return st, steps + 1

        state, _ = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
        return state

    return _run_id, id_score


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--m", type=int, default=8,
                    help="connectivity (reference README default 8)")
    ap.add_argument("--budget", type=int, default=10_000_000,
                    help="n_to_score (default 10%% of 100M)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--frontier", type=int, default=1 << 22)
    ap.add_argument("--buffer", type=int, default=1 << 17)
    ap.add_argument("--head", default="auto")
    ap.add_argument("--mode", choices=["hash", "fps", "id"], default="hash",
                    help="'id' = score computed from the node id in-loop "
                         "(no [N] score table at all — the minimum-memory "
                         "config for the largest single-chip node counts)")
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--log-capacity", type=int, default=None,
                    help="order-log ring capacity (default n)")
    ap.add_argument("--no-score-table", action="store_true",
                    help="id mode only: drop the [N] f32 score table and "
                         "recompute candidate scores from ids in-step "
                         "(saves 4 bytes/node — the 200M config)")
    ap.add_argument("--packed-adj", action="store_true",
                    help="bit-packed adjacency (ceil(log2(n+1))-bit "
                         "fields, rad_tpu.graph.adjpack) — 12.5%% less "
                         "adjacency HBM at 200M; the past-180M config")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--gen-chunks", type=int, default=64,
                    help="generation chunks; raise near the HBM ceiling — "
                         "the packer's [chunk, W] u32 temp is lane-padded "
                         "(minor 14 -> 128, 9.1x) so gen temps scale with "
                         "chunk size (240M needs >=512)")
    ap.add_argument("--mem-analysis", action="store_true",
                    help="id mode: AOT-compile the run program with "
                         "abstract (ShapeDtypeStruct) inputs and print "
                         "XLA's memory analysis — no HBM allocated")
    ap.add_argument("--profile", metavar="DIR",
                    help="wrap one timed run in jax.profiler.trace and "
                         "print the top device ops (leaf events)")
    args = ap.parse_args(argv)
    if args.no_score_table and args.mode != "id":
        ap.error("--no-score-table requires --mode id")

    import jax
    import jax.numpy as jnp
    from rad_tpu.traverse import device as dev

    bits = None
    if args.packed_adj:
        from rad_tpu.graph.adjpack import adj_bits_for
        bits = adj_bits_for(args.n)

    if args.mem_analysis:
        if args.mode not in ("id", "fps"):
            ap.error("--mem-analysis supports --mode id or fps")
        dg_a, sizes = abstract_device_graph(args.n, args.m, packed_bits=bits)
        run_id, id_score = make_id_run(args.batch, args.no_score_table)
        head = args.head if args.head in (None, "auto") else int(args.head)
        if isinstance(head, str) and head.lower() == "none":
            head = None
        n_top = sizes[-1] if sizes[-1] > 1 else (
            sizes[-2] if len(sizes) > 1 else 1)
        top_ids = jnp.arange(max(n_top, 1), dtype=jnp.int32)

        def fresh():
            s = dev.init_state(dg_a, frontier_capacity=args.frontier,
                               buffer_capacity=args.buffer,
                               head_capacity=head,
                               log_capacity=args.log_capacity,
                               score_table=not args.no_score_table)
            return dev.prime(s, dg_a, top_ids,
                             jnp.zeros((top_ids.shape[0],), jnp.float32))

        state_abs = jax.eval_shape(fresh)
        log("lowering + compiling (abstract inputs) ...")
        t0 = time.perf_counter()
        if args.mode == "fps":
            w = args.n_bits // 32
            compiled = dev.fused_run.lower(
                state_abs, dg_a,
                jax.ShapeDtypeStruct((args.n, w), jnp.uint32),
                jax.ShapeDtypeStruct((args.n,), jnp.int32),
                jax.ShapeDtypeStruct((w,), jnp.uint32),
                jax.ShapeDtypeStruct((), jnp.int32),
                jax.ShapeDtypeStruct((), jnp.int32),
                batch=args.batch).compile()
        else:
            compiled = run_id.lower(
                state_abs, jax.ShapeDtypeStruct((), jnp.int32),
                dg_a).compile()
        ma = compiled.memory_analysis()
        log(f"compiled in {time.perf_counter() - t0:.1f}s")
        gib = 1 / 2**30
        print(json.dumps({
            "metric": "scale_mem_analysis",
            "n": args.n, "m": args.m, "packed_adj_bits": bits,
            "argument_gib": ma.argument_size_in_bytes * gib,
            "output_gib": ma.output_size_in_bytes * gib,
            "temp_gib": ma.temp_size_in_bytes * gib,
            "alias_gib": ma.alias_size_in_bytes * gib,
            "peak_gib": (ma.argument_size_in_bytes
                         + ma.output_size_in_bytes
                         + ma.temp_size_in_bytes
                         - ma.alias_size_in_bytes) * gib,
        }, indent=1))
        return 0

    log(f"device: {jax.devices()[0]}")
    t0 = time.perf_counter()
    dg, sizes = make_device_graph(args.n, args.m, seed=0, packed_bits=bits,
                                  n_chunks=args.gen_chunks)
    jax.block_until_ready(dg.adj)
    log(f"graph generated on device: {time.perf_counter() - t0:.1f}s, "
        f"R={dg.n_rows}, levels={len(sizes)}, adj "
        f"{dg.adj.shape} {dg.adj.dtype}"
        f"{f' ({bits}-bit fields)' if bits else ''} "
        f"({dg.adj.nbytes / 1e9:.2f} GB)")

    key = jax.random.PRNGKey(1)
    if args.mode == "id":
        packed = pops = None
    elif args.mode == "hash":
        # score table [N] f32, threaded through the pops argument —
        # gathered by node id inside the loop. (A [N, 1]-shaped table
        # paid a 1.9 ms/step layout-conversion reduce at 100M — profiled.)
        packed = jnp.zeros((args.n, 1), jnp.uint8)
        pops = jax.random.uniform(key, (args.n,), jnp.float32)
        scorer = lambda _rows, table_rows: table_rows
    else:
        w = args.n_bits // 32
        packed = jax.random.bits(key, (args.n, w), jnp.uint32)
        from rad_tpu.fp.pack import popcount_rows
        # chunked AND serialized: popcount materializes an [N, W] int32
        # intermediate (6.4 GB at 50M rows), and async dispatch would queue
        # every chunk's temporaries live at once — block per chunk
        chunks = []
        step = 1 << 21
        for lo in range(0, args.n, step):
            c = popcount_rows(packed[lo:lo + step])
            jax.block_until_ready(c)
            chunks.append(c)
        pops = jnp.concatenate(chunks).astype(jnp.int32)
        target = jax.random.bits(jax.random.PRNGKey(7), (w,), jnp.uint32)
        t_pop = popcount_rows(target[None, :])[0]
    if packed is not None:
        jax.block_until_ready(packed)
        log(f"score source ready ({packed.nbytes / 1e9:.2f} GB)")

    n_top = sizes[-1] if sizes[-1] > 1 else sizes[-2] if len(sizes) > 1 else 1
    top_ids = jnp.arange(max(n_top, 1), dtype=jnp.int32)
    head = args.head if args.head in (None, "auto") else int(args.head)
    if isinstance(head, str) and head.lower() == "none":
        head = None

    def id_score(ids):
        # pseudo-random f32 in [0, 1) from the node id (golden-ratio hash)
        x = ids.astype(jnp.float32) * 0.6180339887498949
        return x - jnp.floor(x)

    # jitted + state-donating prime: eager prime dispatches each .at[].set
    # as its own computation with non-donated operands, transiently holding
    # TWO copies of the [R]/[N] state arrays (~1.2 GiB at 240M — the
    # difference between fitting and ResourceExhausted at the ceiling)
    prime_j = jax.jit(dev.prime, donate_argnums=(0,))

    def fresh_state():
        # id mode recomputes candidate scores from node ids inside the
        # step (ops override below) — the [N] f32 score table is pure
        # ballast at the largest node counts (0.9 GiB at 240M), and even
        # a transient allocation of it breaks the 240M config
        s = dev.init_state(dg, frontier_capacity=args.frontier,
                           buffer_capacity=args.buffer,
                           head_capacity=head,
                           log_capacity=args.log_capacity,
                           score_table=not args.no_score_table)
        if args.mode == "hash":
            seed_scores = pops[: top_ids.shape[0]]
        elif args.mode == "id":
            seed_scores = id_score(top_ids)
        else:
            from rad_tpu.fp.tanimoto import tanimoto_matrix
            seed_scores = tanimoto_matrix(
                target[None, :], packed[: top_ids.shape[0]])[0]
        return prime_j(s, dg, top_ids, seed_scores)

    if args.mode == "hash":
        run = dev.make_device_run(dg, packed, pops, scorer,
                                  batch=args.batch)
        run_fn = lambda st: run(st, jnp.int32(args.budget))
    elif args.mode == "id":
        _run_id, _ = make_id_run(args.batch, args.no_score_table)
        run_fn = lambda st: _run_id(st, jnp.int32(args.budget), dg)
    else:
        run_fn = lambda st: dev.fused_run(
            st, dg, packed, pops, target, t_pop,
            jnp.int32(args.budget), batch=args.batch)

    log("compiling + first run ...")
    t0 = time.perf_counter()
    state = fresh_state()
    # serialize init/prime before dispatching the run: dispatches run
    # ahead of buffer frees, so without a barrier the pre-prime state
    # copies are still live when the run program's buffers allocate
    jax.block_until_ready(state.f_score)
    state = run_fn(state)
    scored = int(state.n_scored)
    log(f"first run: {time.perf_counter() - t0:.1f}s, scored {scored}, "
        f"dropped {int(state.n_dropped)}, steps {int(state.n_steps)}")

    best = math.inf
    for i in range(args.runs):
        state = None  # release the previous final state before reallocating
        state = fresh_state()
        jax.block_until_ready(state.f_score)
        t0 = time.perf_counter()
        state = run_fn(state)
        scored = int(state.n_scored)  # host readback forces completion
        dt = time.perf_counter() - t0
        log(f"run {i}: {dt:.2f}s, {scored} scored -> "
            f"{scored / dt:.0f} nodes/s (dropped {int(state.n_dropped)})")
        best = min(best, dt)

    if args.profile:
        import jax.profiler
        from rad_tpu.utils.profiling import aggregate_xla_ops
        state = fresh_state()
        jax.block_until_ready(state.f_score)
        with jax.profiler.trace(args.profile):
            state = run_fn(state)
            _ = int(state.n_scored)
        ops, n_ev = aggregate_xla_ops(args.profile)
        total = sum(ops.values())
        log(f"profile: {n_ev} events, {total/1e6:.1f} ms total device time")
        for name, ns in sorted(ops.items(), key=lambda kv: -kv[1])[:25]:
            log(f"  {ns/1e6:10.2f} ms  {name}")

    print(json.dumps({
        "metric": "scale_traversal_nodes_per_sec",
        "value": scored / best,
        "unit": "nodes/s",
        "n": args.n,
        "mode": args.mode,
        "budget": args.budget,
        "batch": args.batch,
        "m": args.m,
        "packed_adj_bits": bits,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
