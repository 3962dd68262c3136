"""Single-card probed build at ≥30M nodes.

Streamed scan+select never materializes the [n_pad, k] candidate tables
(15 GB at 30M), and the bucketed symmetrization's working set is one
destination group at a time. At M=8 the resident arrays are (arithmetic
from the shapes):

    packed [30M, 32] u32            3.84 GB   (layer prefix upload)
    packed_cl (permuted copy)       3.84 GB   (scan layout, freed after)
    sel + sel_d [30M, 16]           1.92 + 1.92 GB
    out rows / buffers / temps      ~2 GB

Stages: library (cached), build (timed, per-layer logs), recall@10 at
ef32/128 vs blocked exact ground truth, slim save, tuned traversal
rate. Every result is appended to the results JSONL as it exists.

Reference bar: usearch `add` at 2B (reference index.html:568-580) —
this measures the largest similarity graph BUILT in this project so
far; traversal/serving beyond it are covered by bench_scale /
bench_serving.
"""

from __future__ import annotations

import argparse
import gc
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
    ap.add_argument("--n", type=int, default=30_000_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--connectivity", type=int, default=8,
                    help="M=8 -> M0=16: the 30M single-chip memory point "
                         "(M=16 sel tables alone add 3.8 GB)")
    ap.add_argument("--probes", type=int, default=16)
    ap.add_argument("--csize", type=int, default=1 << 13)
    ap.add_argument("--recall", type=int, default=500)
    ap.add_argument("--ef", default="32,128")
    ap.add_argument("--save", default=None,
                    help="slim (exclude_vectors) .npz save path")
    ap.add_argument("--traverse-budget", type=int, default=1_000_000)
    ap.add_argument("--results", default="/tmp/build_big.jsonl")
    args = ap.parse_args(argv)

    from rad_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import logging
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")

    import jax
    import jax.numpy as jnp
    from benchmarks.bench_probe_sweep import load_library
    from rad_tpu.build.exact import build_hnsw_exact
    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu.search.knn import search_device

    results_f = open(args.results, "a", buffering=1)

    def record(rec: dict):
        rec = {"n": args.n, "m": args.connectivity, **rec}
        results_f.write(json.dumps(rec) + "\n")
        results_f.flush()
        os.fsync(results_f.fileno())
        log(f"RECORDED {rec}")

    fps = load_library(args.n, args.n_bits)
    n = fps.shape[0]

    t0 = time.perf_counter()
    g = build_hnsw_exact(fps, connectivity=args.connectivity, seed=0,
                         probes=args.probes, probe_csize=args.csize,
                         probe_min_n=0)
    for t in g.neighbors:
        if t.shape[0]:
            np.asarray(t[-1:])
    build_s = time.perf_counter() - t0
    record({"kind": "build", "build_s": round(build_s, 1),
            "nodes_per_s": round(n / build_s, 1),
            "probes": args.probes, "csize": args.csize,
            "layers": [int(t.shape[0]) for t in g.neighbors]})
    gc.collect()
    time.sleep(20)

    # ---- recall@10 vs blocked exact ground truth (member queries)
    rng = np.random.default_rng(17)
    qidx = rng.choice(n, size=args.recall, replace=False)
    q = np.ascontiguousarray(fps[qidx])
    keys = np.asarray(g.keys)
    t0 = time.perf_counter()
    _, i_t = bruteforce_topk_blocked(jnp.asarray(q), g.packed, 10)
    truth = keys[np.maximum(np.asarray(i_t), 0)]
    log(f"ground truth {time.perf_counter() - t0:.1f}s")
    out = {"kind": "recall"}
    for ef in (int(x) for x in args.ef.split(",")):
        t0 = time.perf_counter()
        _, i_s = search_device(g, q, k=10, expansion_search=ef)
        i_s = np.asarray(i_s)
        i_s = np.where(i_s >= 0, keys[np.maximum(i_s, 0)], -1)
        rec = float(np.mean([
            len(set(i_s[r].tolist()) & set(truth[r].tolist())) / 10.0
            for r in range(args.recall)]))
        out[f"recall_at_10_ef{ef}"] = round(rec, 4)
        log(f"ef={ef}: {rec:.4f} ({time.perf_counter() - t0:.1f}s)")
    record(out)

    if args.save:
        t0 = time.perf_counter()
        g.save(args.save, exclude_vectors=True, slim=True)
        record({"kind": "save", "path": args.save,
                "save_s": round(time.perf_counter() - t0, 1),
                "bytes": os.path.getsize(args.save)})

    # ---- tuned traversal rate on the real graph (score table from the
    # library scores if present, else synthetic)
    if args.traverse_budget:
        from rad_tpu.traverse import device as dev

        sc_path = f"/tmp/bes_lib_n{n}_b{args.n_bits}_s0_scores.npy"
        if os.path.exists(sc_path):
            scores = np.load(sc_path, mmap_mode="r")
            table = jnp.asarray(np.asarray(scores)[keys]
                                .astype(np.float32))
        else:
            table = jnp.asarray(
                rng.standard_normal(n).astype(np.float32))
        dg = dev.prepare_device_graph(g)
        dummy = jnp.zeros((n, 1), jnp.uint8)
        run = dev.make_device_run(dg, dummy, table, lambda _r, t: t,
                                  batch=1024)
        state = dev.init_state(dg, frontier_capacity=1 << 22,
                               buffer_capacity=1 << 17,
                               head_capacity=1 << 16)
        n_top = g.layer_sizes[g.max_level]
        state = dev.prime(state, dg, jnp.arange(n_top, dtype=jnp.int32),
                          table[:n_top])
        # pre-warm the compile outside the timing window (gap
        # decomposition: a cold first dispatch is ~40 s of compile)
        state = run(state, jnp.int32(args.traverse_budget), jnp.int32(1))
        np.asarray(state.n_steps)
        t0 = time.perf_counter()
        state = dev.segmented_run(run, state,
                                  jnp.int32(args.traverse_budget))
        ns = int(state.n_scored)
        dt = time.perf_counter() - t0
        record({"kind": "traverse", "n_scored": ns, "s": round(dt, 1),
                "scored_per_s": round(ns / dt, 1), "batch": 1024})

    print(json.dumps({"metric": "build_big", "n": n,
                      "nodes_per_s": round(n / build_s, 1),
                      "results_file": args.results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
