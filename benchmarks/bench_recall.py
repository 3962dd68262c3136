#!/usr/bin/env python
"""Recall/ef sweep vs brute force (BASELINE config 2, ZINC-style).

Builds a graph over N random 1024-bit fingerprints, sweeps
``expansion_search`` for batched device kNN, and reports recall@10 against
exact Tanimoto top-k — the parity axis against usearch (BASELINE metric #1).

    python benchmarks/bench_recall.py --n 100000 --q 256
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--expansion-add", type=int, default=128)
    ap.add_argument("--efs", type=int, nargs="+",
                    default=[16, 32, 64, 128, 256])
    ap.add_argument("--library", choices=["tree", "uniform"],
                    default="tree",
                    help="'tree' = clustered analog-series manifold (the "
                         "structure of real chemical libraries; recall=1.0 "
                         "regime); 'uniform' = i.i.d. random bits — the "
                         "distance-concentration adversarial case where "
                         "any HNSW's recall decays with N")
    ap.add_argument("--chain", type=int, default=8,
                    help="query blocks chained inside one jitted scan for "
                         "the RTT-free q/s measurement")
    ap.add_argument("--expand-width", type=int, default=4,
                    help="beam entries expanded per iteration (E): wider "
                         "waves = fewer lockstep iterations per query")
    ap.add_argument("--packed-adj", action="store_true",
                    help="search over the grouped bit-field neighbor "
                         "table (rad_tpu.graph.adjpack) — result-identical; "
                         "measures the decode cost on the search path")
    ap.add_argument("--graph-cache", default=None,
                    help="path to save/reuse the built graph npz — a 1M "
                         "native build costs ~25 min on this one core; "
                         "sweeping search configs should not repeat it")
    ap.add_argument("--fps-npz", default=None,
                    help="load packed fingerprints from this npz's "
                         "'packed' member instead of generating a library "
                         "(e.g. the dudez_workflow --cache file: real "
                         "Morgan/ECFP4 fingerprints of real molecular "
                         "graphs); overrides --library, checks --n")
    args = ap.parse_args(argv)

    import numpy as _np
    import jax.numpy as jnp
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu.graph.storage import HNSWGraph
    from rad_tpu.search.knn import search_device

    graph = None
    if args.graph_cache and os.path.exists(args.graph_cache):
        log(f"loading cached graph {args.graph_cache} ...")
        graph = HNSWGraph.load(args.graph_cache, mmap=False)
        assert len(graph) == args.n and \
            graph.connectivity == args.connectivity, (
                len(graph), graph.connectivity)
        fps = _np.asarray(graph.packed)
        rng = _np.random.default_rng(99)
        queries = fps[rng.choice(args.n, args.q, replace=False)]
    elif args.fps_npz:
        with _np.load(args.fps_npz, allow_pickle=False) as z:
            fps = _np.ascontiguousarray(z["packed"], dtype=_np.uint32)
        assert fps.shape == (args.n, args.n_bits // 32), fps.shape
        log(f"loaded {len(fps)} packed fps from {args.fps_npz}")
        rng = _np.random.default_rng(99)
        queries = fps[rng.choice(args.n, args.q, replace=False)]
    elif args.library == "tree":
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "examples"))
        from enrichment_example import make_library
        fps, _, _ = make_library(args.n, args.n_bits, seed=0)
        rng = _np.random.default_rng(99)
        queries = fps[rng.choice(args.n, args.q, replace=False)]
    else:
        fps = random_fingerprints(args.n, n_bits=args.n_bits, density=0.1,
                                  seed=0)
        queries = random_fingerprints(args.q, n_bits=args.n_bits,
                                      density=0.1, seed=99)
    if graph is None:
        log(f"building {args.n}-node graph ...")
        t0 = time.perf_counter()
        try:
            from rad_tpu.native import build_hnsw_native
            graph = build_hnsw_native(fps, connectivity=args.connectivity,
                                      expansion_add=args.expansion_add,
                                      seed=0)
        except Exception:
            from rad_tpu.build.reference import build_hnsw
            graph = build_hnsw(fps, connectivity=args.connectivity,
                               expansion_add=args.expansion_add, seed=0)
        log(f"build: {time.perf_counter()-t0:.1f}s")
        if args.graph_cache:
            graph.save(args.graph_cache)
            log(f"saved graph cache -> {args.graph_cache}")

    log("exact ground truth ...")
    _, true_ids = bruteforce_topk_blocked(
        jnp.asarray(queries), jnp.asarray(np.asarray(graph.packed)),
        args.k, block=1 << 14)
    true_sets = [set(np.asarray(true_ids)[i].tolist())
                 for i in range(args.q)]

    # Chained q/s: k blocks of DISTINCT queries searched inside one jitted
    # scan, one dispatch + one readback per k blocks. A single search_device
    # call is short, so a per-call dispatch+readback round trip would
    # otherwise sit INSIDE the measurement.
    import jax
    from rad_tpu.search.knn import search_device_jit, _prep

    dg, packed_j, pops_j = _prep(graph, packed_adjacency=args.packed_adj)
    rng_c = _np.random.default_rng(7)
    qk = _np.stack([fps[rng_c.choice(args.n, args.q, replace=False)]
                    for _ in range(args.chain)])
    qk_j = jnp.asarray(qk)

    def make_chain(ef):
        kw = dict(k=args.k, ef=max(ef, args.k), max_level=dg.max_level,
                  expand_width=args.expand_width,
                  adj_bits=dg.adj_bits, adj_group=dg.adj_group,
                  m0_packed=dg.m0)

        @jax.jit
        def chain(packed, pops, adj, offsets, qks):
            def body(c, qb):
                _, ids = search_device_jit(packed, pops, adj, offsets,
                                           qb, **kw)
                return c + ids.sum(), None
            return jax.lax.scan(body, jnp.int32(0), qks)[0]

        return chain

    results = []
    for ef in args.efs:
        _, ids = search_device(graph, queries, k=args.k,
                               expansion_search=ef,
                               expand_width=args.expand_width,
                               packed_adjacency=args.packed_adj)  # warm
        ids = np.asarray(ids)
        t0 = time.perf_counter()
        ids2 = np.asarray(search_device(
            graph, queries, k=args.k, expansion_search=ef,
            expand_width=args.expand_width,
            packed_adjacency=args.packed_adj)[1])
        dt = time.perf_counter() - t0
        recall = float(np.mean([
            len(set(ids[i].tolist()) & true_sets[i]) / args.k
            for i in range(args.q)
        ]))
        qps = args.q / dt
        chain = make_chain(ef)
        np.asarray(chain(packed_j, pops_j, dg.adj, dg.offsets, qk_j))
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(chain(packed_j, pops_j, dg.adj, dg.offsets, qk_j))
            best = min(best, time.perf_counter() - t0)
        qps_chain = args.chain * args.q / best
        log(f"ef={ef:4d}  recall@{args.k}={recall:.3f}  {qps:.0f} q/s "
            f"single-call / {qps_chain:.0f} q/s chained (device rate)")
        results.append({"ef": ef, "recall": recall, "qps": qps,
                        "qps_chained": qps_chain})

    print(json.dumps({
        "metric": f"recall@{args.k}_sweep",
        "n": args.n,
        "connectivity": args.connectivity,
        "expansion_add": args.expansion_add,
        "results": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
