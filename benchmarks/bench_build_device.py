#!/usr/bin/env python
"""Device-builder throughput + recall parity.

Measures the batched on-device HNSW builder (rad_tpu/build/device.py) at
reference build settings (M=16, efC=200 — the reference's own usage is
/root/reference/examples/DUDEZ_example.ipynb:183-192), separating the
one-time XLA compile from steady-state build time, and checks recall@10
parity against the native C++ builder on the same library.

    python benchmarks/bench_build_device.py --n 100000 --batches 1024 --fused

Each (n, batch, fused) triple is one compile; steady state is the SECOND
build at identical shapes.
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


def measure_recall(graph, queries, true_sets, k, ef):
    if true_sets is None:   # --skip-truth
        return float("nan")
    from rad_tpu.search.knn import search_device
    ids = np.asarray(search_device(graph, queries, k=k,
                                   expansion_search=ef)[1])
    # node ids are level-sort-order internal; map to original library
    # indices through the key table before comparing with ground truth
    keys = np.asarray(graph.keys)
    ids = np.where(ids >= 0, keys[np.maximum(ids, 0)], -1)
    return float(np.mean([
        len(set(ids[i].tolist()) & true_sets[i]) / k
        for i in range(len(true_sets))
    ]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--expansion-add", type=int, default=200)
    ap.add_argument("--batches", type=int, nargs="+", default=[1024])
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--stepwise", action="store_true",
                    help="also measure the per-batch-dispatch path")
    ap.add_argument("--q", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef-search", type=int, default=128)
    ap.add_argument("--library", choices=["tree", "uniform"], default="tree")
    ap.add_argument("--skip-native", action="store_true")
    ap.add_argument("--expand-width", type=int, default=None,
                    help="builder beam expand_width (None = module default)")
    ap.add_argument("--exact", action="store_true",
                    help="measure the all-pairs builder "
                         "(rad_tpu.build.exact)")
    ap.add_argument("--candidates", type=int, default=None)
    ap.add_argument("--skip-truth", action="store_true",
                    help="skip the brute-force ground truth + recall "
                         "(throughput-only run — the 1M-scale lean config "
                         "where the ground-truth compile alone is long)")
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu.build.device import build_hnsw_device

    if args.library == "tree":
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "examples"))
        from enrichment_example import make_library
        fps, _, _ = make_library(args.n, args.n_bits, seed=0)
        rng = np.random.default_rng(99)
        queries = fps[rng.choice(args.n, args.q, replace=False)]
    else:
        fps = random_fingerprints(args.n, n_bits=args.n_bits, density=0.1,
                                  seed=0)
        queries = random_fingerprints(args.q, n_bits=args.n_bits,
                                      density=0.1, seed=99)

    if args.skip_truth:
        true_sets = None
    else:
        log("exact ground truth ...")
        _, true_ids = bruteforce_topk_blocked(
            jnp.asarray(queries), jnp.asarray(fps), args.k, block=1 << 14)
        true_sets = [set(np.asarray(true_ids)[i].tolist())
                     for i in range(args.q)]

    out = {"metric": "build_throughput", "n": args.n,
           "connectivity": args.connectivity,
           "expansion_add": args.expansion_add,
           "library": args.library, "rows": []}

    if not args.skip_native:
        from rad_tpu.native import build_hnsw_native
        t0 = time.perf_counter()
        g_nat = build_hnsw_native(fps, connectivity=args.connectivity,
                                  expansion_add=args.expansion_add, seed=0)
        dt = time.perf_counter() - t0
        rec = measure_recall(g_nat, queries, true_sets, args.k,
                             args.ef_search)
        log(f"native: {dt:.1f}s = {args.n/dt:.0f} nodes/s  "
            f"recall@{args.k}={rec:.3f} (threads={os.cpu_count()})")
        out["rows"].append({"builder": "native", "nodes_per_sec":
                            args.n / dt, "recall": rec})
        del g_nat

    if args.exact:
        from rad_tpu.build.exact import build_hnsw_exact
        log("exact: compile+first build ...")
        t0 = time.perf_counter()
        g = build_hnsw_exact(fps, connectivity=args.connectivity, seed=0,
                             candidates=args.candidates)
        t_first = time.perf_counter() - t0
        log(f"exact: first (incl. compile) {t_first:.1f}s")
        t0 = time.perf_counter()
        g = build_hnsw_exact(fps, connectivity=args.connectivity, seed=0,
                             candidates=args.candidates)
        _ = [np.asarray(t).sum() for t in g.neighbors]
        dt = time.perf_counter() - t0
        rec = measure_recall(g, queries, true_sets, args.k, args.ef_search)
        log(f"exact: steady {dt:.1f}s = {args.n/dt:.0f} nodes/s  "
            f"recall@{args.k}={rec:.3f}")
        out["rows"].append({"builder": "exact", "nodes_per_sec":
                            args.n / dt, "first_build_s": t_first,
                            "steady_s": dt, "recall": rec})
        del g

    kw = {}
    if args.expand_width is not None:
        kw["expand_width"] = args.expand_width
    modes = []
    if args.fused:
        modes.append(True)
    if args.stepwise or not modes:
        modes.append(False)
    if args.exact and not (args.fused or args.stepwise):
        modes = []
    for batch in args.batches:
        for fused in modes:
            tag = f"device(batch={batch},fused={fused})"
            log(f"{tag}: compile+first build ...")
            t0 = time.perf_counter()
            g = build_hnsw_device(fps, connectivity=args.connectivity,
                                  expansion_add=args.expansion_add,
                                  seed=0, batch_size=batch,
                                  fused_loop=fused, **kw)
            t_first = time.perf_counter() - t0
            log(f"{tag}: first (incl. compile) {t_first:.1f}s")
            t0 = time.perf_counter()
            g = build_hnsw_device(fps, connectivity=args.connectivity,
                                  expansion_add=args.expansion_add,
                                  seed=0, batch_size=batch,
                                  fused_loop=fused, **kw)
            # force host readback
            _ = [np.asarray(t).sum() for t in g.neighbors]
            dt = time.perf_counter() - t0
            rate = args.n / dt
            rec = measure_recall(g, queries, true_sets, args.k,
                                 args.ef_search)
            log(f"{tag}: steady {dt:.1f}s = {rate:.0f} nodes/s  "
                f"recall@{args.k}={rec:.3f}")
            out["rows"].append({"builder": tag, "nodes_per_sec": rate,
                                "first_build_s": t_first,
                                "steady_s": dt, "recall": rec})
            del g

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
