"""Partition-and-stitch build benchmark: build rate + recall vs monolithic.

Builds the same library twice — monolithic native build vs S-shard
partition-and-stitch (native sub-builds + device stitch searches) — and
reports wall-clock and recall@10 against exact ground truth for both.
The at-scale story (docs/SCALING.md >=500M) runs sub-builds on separate
hosts/chips; here they run sequentially, so the interesting numbers are
the stitch overhead and the recall delta.

Prints one JSON line.
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
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--expansion-add", type=int, default=128)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--library", choices=["tree", "uniform"],
                    default="tree")
    ap.add_argument("--builder", default="native",
                    choices=["native", "host", "device", "exact"],
                    help="sub-build backend for the partitioned path "
                         "('exact' = the all-pairs builder: the "
                         "per-chip shard build at pod scale)")
    ap.add_argument("--skip-mono", action="store_true",
                    help="skip the monolithic baseline (at 1M the native "
                         "single-core build alone is ~25 min)")
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    from rad_tpu.build.partition import build_hnsw_partitioned
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu.native import build_hnsw_native
    from rad_tpu.search.knn import search_device

    if args.library == "tree":
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "examples"))
        from enrichment_example import make_library
        fps, _, _ = make_library(args.n, args.n_bits, seed=0)
    else:
        fps = random_fingerprints(args.n, n_bits=args.n_bits, density=0.1,
                                  seed=0)
    rng = np.random.default_rng(99)
    queries = fps[rng.choice(args.n, args.q, replace=False)]

    log("exact ground truth ...")
    _, true_ids = bruteforce_topk_blocked(
        jnp.asarray(queries), jnp.asarray(fps), args.k, block=1 << 14)
    true_keys = np.asarray(true_ids)  # key == original row index

    def recall(graph):
        _, ids = search_device(graph, queries, k=args.k,
                               expansion_search=args.ef)
        keys = np.asarray(graph.keys)[np.maximum(np.asarray(ids), 0)]
        return float(np.mean([
            len(set(keys[i].tolist()) & set(true_keys[i].tolist())) / args.k
            for i in range(args.q)]))

    if args.skip_mono:
        t_mono, r_mono = None, None
    else:
        log(f"monolithic native build ({args.n}) ...")
        t0 = time.perf_counter()
        mono = build_hnsw_native(fps, connectivity=args.connectivity,
                                 expansion_add=args.expansion_add, seed=0)
        t_mono = time.perf_counter() - t0
        r_mono = recall(mono)
        log(f"  {t_mono:.1f}s, recall@{args.k}={r_mono:.3f}")

    log(f"partitioned build ({args.shards} shards, "
        f"builder={args.builder}) ...")
    t0 = time.perf_counter()
    part = build_hnsw_partitioned(
        fps, n_shards=args.shards, connectivity=args.connectivity,
        expansion_add=args.expansion_add, seed=0, builder=args.builder)
    t_part = time.perf_counter() - t0
    r_part = recall(part)
    log(f"  {t_part:.1f}s total (sequential sub-builds), "
        f"recall@{args.k}={r_part:.3f}")

    print(json.dumps({
        "metric": "partition_build",
        "n": args.n, "shards": args.shards, "builder": args.builder,
        "monolithic_seconds": t_mono, "monolithic_recall": r_mono,
        "partitioned_seconds_sequential": t_part,
        "partitioned_recall": r_part,
        "est_parallel_seconds": (
            None if t_mono is None else t_mono / args.shards
            + (t_part - t_mono)),  # per-shard build in parallel + stitch
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
