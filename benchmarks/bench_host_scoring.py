"""End-to-end host-scoring throughput (BASELINE config 4 shape).

A user scoring function runs in host Python while the device expands the
frontier: measures molecules/second through the pipelined stepwise driver
at several pipeline depths — the dispatch-latency-hiding story (the
reference's prefetch-proxy overlap,
rad/coordination_service.py:314-347). Prints one JSON line.
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
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n-to-score", type=int, default=100_000)
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--graph-cache", default=None)
    args = ap.parse_args(argv)

    import jax
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.traverse.driver import DeviceTraverser

    log(f"device: {jax.devices()[0]}")
    if args.graph_cache and os.path.exists(args.graph_cache):
        from rad_tpu.graph.storage import HNSWGraph
        graph = HNSWGraph.load(args.graph_cache, mmap=False)
    else:
        from rad_tpu.native import build_hnsw_native
        fps = random_fingerprints(args.n, n_bits=args.n_bits, density=0.1,
                                  seed=0)
        log(f"building {args.n}-node graph (native) ...")
        graph = build_hnsw_native(fps, connectivity=16, expansion_add=64,
                                  seed=0)
        if args.graph_cache:
            graph.save(args.graph_cache)

    def scoring_fn(smiles: str) -> float:
        # deterministic, microseconds-cheap stand-in: measures ENGINE +
        # pipeline overhead; a real docking fn adds its own (dominant) cost
        k = int(smiles)
        return float((1103515245 * k + 12345) % 99991) / 99991.0

    results = {}
    for depth in args.depths:
        t = DeviceTraverser(graph, scoring_fn, batch_size=args.batch,
                            n_score_threads=8)
        t.prime()
        t0 = time.perf_counter()
        stats = t.traverse(n_to_score=args.n_to_score,
                           pipeline_depth=depth)
        dt = time.perf_counter() - t0
        rate = stats["n_scored"] / dt
        results[str(depth)] = {"mol_per_sec": rate,
                               "n_scored": stats["n_scored"],
                               "seconds": dt,
                               "scoring_time": stats["scoring_time"],
                               "device_time": stats["device_time"]}
        log(f"pipeline_depth={depth}: {stats['n_scored']} scored in "
            f"{dt:.1f}s = {rate:,.0f} mol/s (host scoring "
            f"{stats['scoring_time']:.1f}s, device {stats['device_time']:.1f}s)")
        t.shutdown()

    print(json.dumps({"metric": "host_scoring_mol_per_sec", "n": len(graph),
                      "batch": args.batch, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
