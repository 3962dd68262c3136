"""Frontier-capacity sweep: what do forced drops cost in enrichment?

Runs the same 1M-node traversal (Tanimoto-to-target scorer, 10% budget) at
several frontier capacities — from heavily undersized to the auto/lossless
size — and reports drops + fraction of the library's true top-N recovered.
One JSON line.
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
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n-to-score", type=int, default=None,
                    help="default: 10%% of n")
    ap.add_argument("--n-top", type=int, default=100)
    ap.add_argument("--caps", type=int, nargs="+",
                    default=[1 << 15, 1 << 17, 0],
                    help="frontier capacities; 0 = auto (lossless)")
    ap.add_argument("--graph-cache", default=None)
    args = ap.parse_args(argv)
    n_to_score = args.n_to_score or args.n // 10

    import jax
    import jax.numpy as jnp
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.fp.pack import popcount_rows
    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu.traverse import device as dev

    log(f"device: {jax.devices()[0]}")
    if args.graph_cache and os.path.exists(args.graph_cache):
        from rad_tpu.graph.storage import HNSWGraph
        graph = HNSWGraph.load(args.graph_cache, mmap=False)
        log(f"loaded cached graph ({len(graph)} nodes)")
    else:
        from rad_tpu.native import build_hnsw_native
        fps = random_fingerprints(args.n, n_bits=args.n_bits, density=0.1,
                                  seed=0)
        graph = build_hnsw_native(fps, connectivity=16, expansion_add=128,
                                  seed=0)
        if args.graph_cache:
            graph.save(args.graph_cache)

    dg = dev.prepare_device_graph(graph)
    packed = jnp.asarray(np.asarray(graph.packed))
    pops = jnp.asarray(np.asarray(graph.popcounts))
    target = jnp.asarray(random_fingerprints(1, n_bits=args.n_bits,
                                             density=0.1, seed=7)[0])
    t_pop = popcount_rows(target[None, :])[0]

    # true top-N by the scorer (exact, blocked)
    log("computing exact top-N ground truth ...")
    d, ids = bruteforce_topk_blocked(target[None, :], packed, args.n_top,
                                     block=1 << 14)
    true_top = set(np.asarray(ids)[0].tolist())

    from rad_tpu.fp.tanimoto import tanimoto_matrix
    n_top_layer = graph.layer_sizes[graph.max_level]
    seed_ids = jnp.arange(n_top_layer, dtype=jnp.int32)
    seed_scores = tanimoto_matrix(target[None, :], packed[:n_top_layer])[0]

    results = []
    for cap in args.caps:
        cap_real = cap if cap else dev.auto_frontier_capacity(dg.n_rows)
        state = dev.init_state(dg, cap or None, buffer_capacity=1 << 14)
        state = dev.prime(state, dg, seed_ids, seed_scores)
        t0 = time.perf_counter()
        state = dev.fused_run(state, dg, packed, pops, target, t_pop,
                              jnp.int32(n_to_score), batch=args.batch)
        scored_ids = dev.read_order_log(state)
        dt = time.perf_counter() - t0
        found = len(true_top & set(scored_ids.tolist()))
        rec = {"cap": int(cap_real),
               "n_scored": int(state.n_scored),
               "n_dropped": int(state.n_dropped),
               "top_found": found,
               "top_frac": found / args.n_top,
               "seconds": dt}
        log(f"cap 2^{int(np.log2(cap_real))}: scored {rec['n_scored']}, "
            f"dropped {rec['n_dropped']}, top-{args.n_top} found "
            f"{found} ({100 * rec['top_frac']:.0f}%) in {dt:.1f}s")
        results.append(rec)

    print(json.dumps({"metric": "frontier_cap_enrichment", "n": len(graph),
                      "n_to_score": n_to_score, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
