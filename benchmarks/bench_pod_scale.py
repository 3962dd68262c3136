#!/usr/bin/env python
"""Billion-node pod traversal on the virtual CPU mesh (BASELINE config 5).

BASELINE.json's final staged config is a billion-scale graph sharded
across several cards (the reference's proof point is 2B molecules
behind one service, reference index.html:568-580). Pod hardware is not
available in this container, so this benchmark executes the REAL pod
program — `make_sharded_step_full`: graph AND state row-sharded,
owned-gather psums for every adjacency/fingerprint/state access — at the
stated scale on the 8-virtual-device CPU mesh the test suite uses.
What it validates that the toy dryrun cannot:

- the billion-row sharded arrays ASSEMBLE (per-shard streamed
  construction, `shard_graph_streamed` — nothing ever materializes the
  global table);
- the full sharded step COMPILES and EXECUTES at 1B-node shapes and makes
  correct progress (scored-bitmap population == n_scored, monotone);
- per-shard traffic stays balanced at scale (TrafficMeter).

Throughput on virtual CPU devices predicts nothing about cards — XLA:CPU
on shared cores serializes what NVLink would parallelize; the number
reported here is recorded only to show the run is real.

    python benchmarks/bench_pod_scale.py --n 1000000000 --budget 200000

Synthetic HNSW-shaped topology (same generator family as bench_scale.py:
a random layered graph exercises the engine; a real 1B build is a
partition-and-stitch job, rad_tpu/build/partition.py).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def make_row_callbacks(n: int, m: int, fp_words: int, seed: int,
                       sub: int = 4_000_000):
    """Host (numpy) twins of bench_scale.make_device_graph's generator:
    random layered HNSW-shaped adjacency in the flat row layout
    (row = offsets[level] + node, level-0 block first, -1 padding) plus
    random packed fingerprints — produced per row-range so only one
    shard's rows ever exist on the host."""
    from benchmarks.bench_scale import hnsw_layer_sizes

    sizes = hnsw_layer_sizes(n, m)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    sizes_arr = np.asarray(sizes, np.int64)
    m0 = 2 * m

    def adj_rows(start, stop):
        # full-range raw bits + modulo: numpy's bounded integers() with a
        # per-row bound array takes the per-element path (~1000x slower,
        # measured 554 s vs 0.1 s per 8M rows) — never use it at scale
        out = np.empty((stop - start, m0), np.int32)
        for lo in range(start, stop, sub):
            hi = min(lo + sub, stop)
            rows = np.arange(lo, hi, dtype=np.int64)
            lev = np.searchsorted(offsets, rows, side="right") - 1
            nl = sizes_arr[lev]
            safe = np.maximum(nl, 2).astype(np.uint64)
            rng = np.random.default_rng(seed * 1_000_003 + lo)
            bits = rng.integers(0, 1 << 64, size=(hi - lo, m0),
                                dtype=np.uint64)
            ids = (bits % (safe[:, None] - 1)).astype(np.int64)
            node = rows - offsets[lev]
            ids = np.where(ids >= node[:, None], ids + 1, ids)  # skip self
            cap = np.where(lev == 0, m0, m)
            ok = (np.arange(m0)[None, :] < cap[:, None]) & (nl[:, None] > 1)
            out[lo - start:hi - start] = np.where(ok, ids, -1)
        return out

    def fp_rows(start, stop):
        out = np.empty((stop - start, fp_words), np.uint32)
        for lo in range(start, stop, sub):
            hi = min(lo + sub, stop)
            rng = np.random.default_rng(seed * 7_368_787 + lo)
            out[lo - start:hi - start] = rng.integers(
                0, 1 << 32, size=(hi - lo, fp_words), dtype=np.uint64
            ).astype(np.uint32)
        return out

    return sizes, m0, adj_rows, fp_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000_000)
    ap.add_argument("--m", type=int, default=6,
                    help="connectivity (layer-0 cap 2m)")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--budget", type=int, default=200_000)
    ap.add_argument("--frontier", type=int, default=1 << 22)
    ap.add_argument("--buffer", type=int, default=1 << 15)
    ap.add_argument("--log-capacity", type=int, default=1 << 22)
    ap.add_argument("--fp-words", type=int, default=1,
                    help="fingerprint words (1 = 32-bit engine-scale mode; "
                         "32 = full 1024-bit)")
    ap.add_argument("--packed-adj", action="store_true")
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={args.devices}")

    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass
    assert len(jax.devices()) >= args.devices, jax.devices()

    import jax.numpy as jnp

    from rad_tpu.fp.pack import popcount_rows
    from rad_tpu.parallel import TrafficMeter, make_mesh
    from rad_tpu.parallel.sharded import (init_state_sharded,
                                          make_sharded_step_full,
                                          shard_graph_streamed)
    from rad_tpu.traverse import device as dev
    from rad_tpu.traverse.device import DeviceGraph

    t0 = time.time()
    sizes, m0, adj_rows, fp_rows = make_row_callbacks(
        args.n, args.m, args.fp_words, args.seed)
    mesh = make_mesh(args.devices, axis_names=("graph",))
    sg = shard_graph_streamed(
        mesh, n_nodes=args.n, layer_sizes=sizes, m0=m0,
        make_adj_rows=adj_rows, make_packed_rows=fp_rows,
        fp_words=args.fp_words,
        packed_adjacency=args.packed_adj)
    jax.block_until_ready((sg.adj, sg.packed, sg.pops))
    t_build = time.time() - t0
    adj_gb = sg.adj.size * sg.adj.dtype.itemsize / 2**30
    log(f"sharded graph assembled: n={args.n} rows={sg.n_rows} "
        f"adj {adj_gb:.1f} GB ({sg.adj_bits}-bit) over {args.devices} "
        f"shards in {t_build:.0f}s; host peak RSS {rss_gb():.1f} GB")

    rng = np.random.default_rng(args.seed + 99)
    target = rng.integers(0, 1 << 32, size=(args.fp_words,),
                          dtype=np.uint64).astype(np.uint32)
    t_packed = jnp.asarray(target)
    t_pop = popcount_rows(t_packed[None, :])[0]

    dg_pad = DeviceGraph(adj=sg.adj, offsets=sg.offsets,
                         n_nodes=sg.n_pad_nodes, n_rows=sg.n_pad_rows,
                         m0=sg.m0, max_level=sg.max_level)
    state = init_state_sharded(sg, mesh, frontier_capacity=args.frontier,
                               log_capacity=args.log_capacity,
                               buffer_capacity=args.buffer)
    n_top = sizes[-1]
    seed_fps = fp_rows(0, n_top)
    inter = np.bitwise_count(seed_fps & target[None, :]).sum(1)
    union = (np.bitwise_count(seed_fps).sum(1) + int(np.bitwise_count(
        target).sum()) - inter)
    seed_scores = jnp.asarray(
        1.0 - inter / np.maximum(union, 1), jnp.float32)
    state = dev.prime(state, dg_pad,
                      jnp.arange(n_top, dtype=jnp.int32), seed_scores)
    jax.block_until_ready(state)
    log(f"primed {n_top} top-level seeds; RSS {rss_gb():.1f} GB")

    step = make_sharded_step_full(sg, mesh, batch=args.batch, traffic=True)
    meter = TrafficMeter(args.devices)

    t0 = time.time()
    state, traffic = step(state, t_packed, t_pop)
    jax.block_until_ready(state)
    t_compile = time.time() - t0
    meter.add(traffic)
    log(f"first step (incl. compile): {t_compile:.0f}s; "
        f"n_scored={int(state.n_scored)}")

    t0 = time.time()
    steps, scored0 = 1, int(state.n_scored)
    while int(state.n_scored) < args.budget and steps < args.max_steps:
        state, traffic = step(state, t_packed, t_pop)
        meter.add(traffic)
        steps += 1
        if steps % 20 == 0:
            log(f"step {steps}: n_scored={int(state.n_scored)} "
                f"({time.time()-t0:.0f}s)")
    jax.block_until_ready(state)
    wall = time.time() - t0
    n_scored = int(state.n_scored)

    # correctness: the sharded scored bitmap must agree with the counter
    bitmap = int(jnp.sum(state.scored.astype(jnp.int32)))
    assert bitmap == n_scored, (bitmap, n_scored)
    assert n_scored >= args.budget or steps >= args.max_steps, \
        "sharded run stalled"
    stats = meter.stats()

    result = {
        "metric": "pod_scale_virtual",
        "n_nodes": args.n,
        "m": args.m,
        "devices": args.devices,
        "adj_gb": round(adj_gb, 2),
        "adj_bits": sg.adj_bits,
        "assemble_s": round(t_build, 1),
        "compile_s": round(t_compile, 1),
        "steps": steps,
        "n_scored": n_scored,
        "nodes_per_s_cpu": round((n_scored - scored0) / wall),
        "wall_s": round(wall, 1),
        "adj_imbalance": round(stats["adj_imbalance"], 3),
        "fp_imbalance": round(stats["fp_imbalance"], 3),
        "host_peak_rss_gb": round(rss_gb(), 1),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
