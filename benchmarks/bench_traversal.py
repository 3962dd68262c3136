#!/usr/bin/env python
"""Traversal throughput: nodes scored/sec, fully device-resident.

BASELINE config 3: HBM-resident graph, device-side best-first traversal
with an on-device (mock/surrogate) scorer — `fused_run` compiles the whole
sweep into one program. Build happens on host (native C++ builder).

    python benchmarks/bench_traversal.py --n 200000 --batch 64
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _synthetic_graph(fps: np.ndarray, m: int, seed: int = 0):
    """Random layered graph with HNSW's shape (levels, caps, -1 padding) —
    engine-speed measurements only; adjacency is not similarity-based."""
    from rad_tpu.build.reference import sample_levels
    from rad_tpu.fp.pack import popcount_rows_np
    from rad_tpu.graph.storage import HNSWGraph

    n = fps.shape[0]
    rng = np.random.default_rng(seed)
    levels_raw = sample_levels(n, m, seed)
    order = np.lexsort((np.arange(n), -levels_raw))
    packed = fps[order]
    levels = levels_raw[order]
    max_level = int(levels[0])
    layer_sizes = [int((levels >= l).sum()) for l in range(max_level + 1)]
    neighbors = []
    for l, nl in enumerate(layer_sizes):
        cap = 2 * m if l == 0 else m
        t = rng.integers(0, nl, size=(nl, cap), dtype=np.int32) \
            if nl > 1 else np.full((nl, cap), -1, np.int32)
        if nl > 1:
            # remove self-loops by shifting
            self_rows = t == np.arange(nl, dtype=np.int32)[:, None]
            t = np.where(self_rows, (t + 1) % nl, t)
        neighbors.append(t)
    return HNSWGraph(packed=packed, popcounts=popcount_rows_np(packed),
                     keys=np.arange(n, dtype=np.int64)[order],
                     levels=levels, neighbors=tuple(neighbors),
                     ndim=fps.shape[1] * 32, connectivity=m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--expansion-add", type=int, default=128)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frontier", type=int, default=1 << 18)
    ap.add_argument("--buffer", type=int, default=1 << 17,
                    help="frontier append-buffer capacity")
    ap.add_argument("--head", type=int, default=None,
                    help="two-level frontier: sorted-head capacity "
                         "(< --frontier); merges then sort head+buffer "
                         "instead of the whole capacity")
    ap.add_argument("--n-to-score", type=int, default=None)
    ap.add_argument("--narrow-width", type=int, default=None,
                    help="fused_run narrow_width (exhaustive-tail trim; "
                         "bit-identical results)")
    ap.add_argument("--synthetic-graph", action="store_true",
                    help="skip HNSW construction; use a random layered "
                         "graph of the same shape (engine-throughput-only "
                         "measurement for N beyond practical build time)")
    ap.add_argument("--dedup", choices=["scatter", "sort"],
                    default="scatter",
                    help="batch-dedup implementation on the hot path "
                         "(scatter-min scratch vs 3 argsorts; A/B knob)")
    ap.add_argument("--graph-cache",
                    help="path to save/load the built graph (.npz) so "
                         "config sweeps pay the build once")
    args = ap.parse_args(argv)
    if args.dedup == "sort":
        from rad_tpu.traverse import device as _dev
        _dev.DenseStateOps.first_occurrence = staticmethod(
            _dev._first_occurrence)

    import jax
    import jax.numpy as jnp
    from rad_tpu.fp import random_fingerprints, popcount_rows
    from rad_tpu.fp.tanimoto import tanimoto_matrix
    from rad_tpu.traverse import device as dev

    log(f"device: {jax.devices()[0]}")
    fps = random_fingerprints(args.n, n_bits=args.n_bits, density=0.1,
                              seed=0)
    t0 = time.perf_counter()
    if args.graph_cache and os.path.exists(args.graph_cache):
        from rad_tpu.graph.storage import HNSWGraph
        log(f"loading cached graph {args.graph_cache} ...")
        graph = HNSWGraph.load(args.graph_cache, mmap=False)
    elif args.synthetic_graph:
        log(f"generating synthetic layered graph ({args.n} nodes) ...")
        graph = _synthetic_graph(fps, args.connectivity, seed=0)
    else:
        log(f"building {args.n}-node graph (native) ...")
        try:
            from rad_tpu.native import build_hnsw_native
            graph = build_hnsw_native(
                fps, connectivity=args.connectivity,
                expansion_add=args.expansion_add, seed=0)
        except Exception as e:
            log(f"native builder unavailable ({e}); falling back to python")
            from rad_tpu.build.reference import build_hnsw
            graph = build_hnsw(fps, connectivity=args.connectivity,
                               expansion_add=args.expansion_add, seed=0)
    t_build = time.perf_counter() - t0
    log(f"build: {t_build:.1f}s ({args.n / t_build:.0f} nodes/s)")
    if args.graph_cache and not os.path.exists(args.graph_cache):
        graph.save(args.graph_cache)
        log(f"graph cached -> {args.graph_cache}")

    dg = dev.prepare_device_graph(graph)
    packed = jnp.asarray(np.asarray(graph.packed))
    pops = jnp.asarray(np.asarray(graph.popcounts))
    target = jnp.asarray(random_fingerprints(1, args.n_bits, 0.1, 7)[0])
    t_pop = popcount_rows(target[None, :])[0]

    n_to_score = args.n_to_score or args.n  # exhaust by default
    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    seed_scores = tanimoto_matrix(target[None, :], packed[:n_top])[0]

    def fresh_state():
        s = dev.init_state(dg, frontier_capacity=args.frontier,
                           buffer_capacity=args.buffer,
                           head_capacity=args.head)
        return dev.prime(s, dg, ids, seed_scores)

    def measure():
        log("compiling fused_run ...")
        state = fresh_state()
        t0 = time.perf_counter()
        state = dev.fused_run(state, dg, packed, pops, target, t_pop,
                              jnp.int32(n_to_score), batch=args.batch,
                              narrow_width=args.narrow_width)
        log(f"first run: {time.perf_counter() - t0:.1f}s, scored "
            f"{int(state.n_scored)}, dropped {int(state.n_dropped)}")
        best = np.inf
        scored = 0
        for i in range(3):
            state = fresh_state()
            t0 = time.perf_counter()
            state = dev.fused_run(state, dg, packed, pops, target, t_pop,
                                  jnp.int32(n_to_score), batch=args.batch,
                                  narrow_width=args.narrow_width)
            scored = int(state.n_scored)  # forces completion
            dt = time.perf_counter() - t0
            log(f"run {i}: {dt*1e3:.0f} ms, {scored} scored, "
                f"{scored/dt:.0f} nodes/s")
            best = min(best, dt)
        return scored, best, state

    scored, best, _ = measure()
    print(json.dumps({
        "metric": "traversal_nodes_scored_per_sec",
        "value": scored / best,
        "unit": "nodes/s",
        "n": args.n,
        "batch": args.batch,
        "build_nodes_per_sec": args.n / t_build,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
