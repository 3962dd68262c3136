"""Probed-build sweep at scale: nodes/s + recall@10 vs probes/granularity.

The subquadratic cluster-probed
build was measured only at 1M (where it loses to exact) — its claimed
>=5M payoff regime was a prediction. This driver measures it, designed
around the remote-compile economics:

* every sweep build uses ``probe_width``-padded probe lists, so ONE
  compile of the probed span serves every probe count in the sweep
  (padded scans burn kernel time on dead clusters — sweep builds are for
  RECALL, not throughput);
* the one throughput build (``--throughput``) runs unpadded at the
  chosen operating point, twice, steady-state timed;
* ground truth is computed once and reused across sweep points (all
  builds share the level sort — same seed);
* every result is appended to a results JSONL the moment it exists, so
  a crash mid-sweep loses nothing.

Prints one JSON line with all measurements.
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


def load_library(n: int, n_bits: int, kind: str = "batched"):
    """Same cache protocol as bench_exact_stages (shared files).

    ``kind``: "batched" (the synthetic analog-series generator every r4
    10M number used) or "morgan" (combinatorial drug-like SMILES through
    the in-tree Morgan fingerprinter — a structurally different library
    class: tests whether the probed-vs-exact recall
    inversion generalizes beyond the one generator)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "examples"))
    if kind == "morgan":
        cache = f"/tmp/morgan_lib_n{n}_b{n_bits}.npy"
        if os.path.exists(cache):
            log(f"library loaded from {cache}")
            return np.load(cache)
        t0 = time.perf_counter()
        from rad_tpu.chem.library import make_smiles_library
        smiles, _scores = make_smiles_library(n, seed=0)
        from rad_tpu.native import smiles_fingerprints_native
        fps = smiles_fingerprints_native(smiles, n_bits=n_bits, radius=2)
        np.save(cache, fps)
        log(f"morgan library generated ({time.perf_counter() - t0:.0f}s)"
            f" -> {cache}")
        return fps
    cache = f"/tmp/bes_lib_n{n}_b{n_bits}_s0.npy"
    if os.path.exists(cache):
        log(f"library loaded from {cache}")
        return np.load(cache)
    t0 = time.perf_counter()
    if n > 2_000_000:
        from enrichment_example import make_library_batched
        fps, _ = make_library_batched(n, n_bits, seed=0)
    else:
        from enrichment_example import make_library
        fps = make_library(n, n_bits, seed=0)[0]
    np.save(cache, fps)
    log(f"library generated ({time.perf_counter() - t0:.0f}s) -> {cache}")
    return fps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--csize", type=int, default=1 << 13)
    ap.add_argument("--sweep", default="qblock:16,qblock:32,qblock:64",
                    help="comma list of granularity:probes sweep points "
                         "(recall-only; probe lists padded to --width)")
    ap.add_argument("--width", type=int, default=64,
                    help="probe_width for sweep builds (one compile)")
    ap.add_argument("--throughput", default=None,
                    help="granularity:probes for the unpadded steady-"
                         "state throughput build (e.g. qblock:32)")
    ap.add_argument("--recall", type=int, default=500)
    ap.add_argument("--ef", default="32,128",
                    help="comma list of search expansion widths; recall "
                         "is recorded per ef (separates candidate "
                         "quality from search-beam navigability)")
    ap.add_argument("--probe-sample", type=int, default=16)
    ap.add_argument("--save", default=None,
                    help="save the throughput build's graph here (.npz) "
                         "for downstream end-to-end benches")
    ap.add_argument("--results", default="/tmp/probe_sweep_results.jsonl")
    ap.add_argument("--cooldown", type=float, default=20.0,
                    help="sleep between builds")
    ap.add_argument("--library", default="batched",
                    choices=["batched", "morgan"],
                    help="library class (see load_library)")
    args = ap.parse_args(argv)

    from rad_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import logging
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")


    import jax
    import jax.numpy as jnp
    from rad_tpu.build.exact import build_hnsw_exact
    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu.search.knn import search_device

    log(f"device: {jax.devices()[0]}")
    fps = load_library(args.n, args.n_bits, kind=args.library)
    n = fps.shape[0]
    m = args.connectivity

    results_f = open(args.results, "a", buffering=1)

    def record(rec: dict):
        rec = {"n": n, "library": args.library, **rec}
        results_f.write(json.dumps(rec) + "\n")
        results_f.flush()
        os.fsync(results_f.fileno())
        log(f"RECORDED {rec}")

    def barrier(g):
        for t in g.neighbors:
            if t.shape[0]:
                np.asarray(t[-1:])

    # ---- ground truth (once; shared level sort across all builds) ----
    rng = np.random.default_rng(17)
    qidx = rng.choice(n, size=args.recall, replace=False)
    q = np.ascontiguousarray(fps[qidx])
    truth = None  # original-index ground truth, computed on first graph

    efs = [int(x) for x in str(args.ef).split(",") if x.strip()]

    def eval_recall(g):
        nonlocal truth
        keys = np.asarray(g.keys)
        if truth is None:
            t0 = time.perf_counter()
            _, i_t = bruteforce_topk_blocked(jnp.asarray(q), g.packed, 10)
            i_t = keys[np.maximum(np.asarray(i_t), 0)]
            truth = i_t
            log(f"ground truth: {time.perf_counter() - t0:.1f}s")
        out = {}
        # edge recall: the sampled queries are library members — what
        # fraction of their true 10-NN sit in their layer-0 adjacency
        # row (union with self-row truth hit). Separates edge quality
        # (candidate/selection stages) from search-beam navigation.
        row_of = np.empty(n, np.int64)
        row_of[keys] = np.arange(n)
        q_rows = row_of[qidx]
        adj = np.asarray(g.neighbors[0][jnp.asarray(q_rows)])
        adj_orig = np.where(adj >= 0, keys[np.maximum(adj, 0)], -1)
        edge_hits = np.mean([
            len((set(adj_orig[r].tolist()) | {qidx[r]})
                & set(truth[r].tolist())) / 10.0
            for r in range(args.recall)])
        out["edge_recall_at_10"] = round(float(edge_hits), 4)
        log(f"edge recall: {edge_hits:.4f}")
        for ef in efs:
            t0 = time.perf_counter()
            _, i_s = search_device(g, q, k=10, expansion_search=ef)
            i_s = np.asarray(i_s)
            i_s = np.where(i_s >= 0, keys[np.maximum(i_s, 0)], -1)
            rec = float(np.mean([
                len(set(i_s[r].tolist()) & set(truth[r].tolist())) / 10.0
                for r in range(args.recall)]))
            log(f"recall eval ef={ef}: {time.perf_counter() - t0:.1f}s "
                f"-> {rec:.4f}")
            out[f"recall_at_10_ef{ef}"] = rec
        return out

    def one_build(gran: str, probes: int, width: int | None):
        t0 = time.perf_counter()
        if gran == "exact":
            # probes=None: the fully exact O(N²) candidate stage — the
            # baseline the probed recalls are interpreted against
            g = build_hnsw_exact(fps, connectivity=m, seed=0)
        else:
            g = build_hnsw_exact(
                fps, connectivity=m, seed=0, probes=probes,
                probe_csize=args.csize, probe_sample=args.probe_sample,
                probe_granularity=gran, probe_width=width,
                probe_min_n=0)
        barrier(g)
        return g, time.perf_counter() - t0

    # ------------------------------------------------- recall sweep
    points = []
    if args.sweep:
        for tok in args.sweep.split(","):
            gran, p = tok.strip().split(":")
            points.append((gran, int(p)))
    for gran, p in points:
        log(f"=== sweep {gran}:{p} (width {args.width}) ===")
        g, dt = one_build(gran, p, args.width)
        rec = eval_recall(g)
        record({"kind": "sweep", "granularity": gran, "probes": p,
                "width": args.width, "build_s": round(dt, 2), **rec})
        del g
        gc.collect()
        time.sleep(args.cooldown)

    # ------------------------------------------------- throughput build
    if args.throughput:
        gran, p = args.throughput.strip().split(":")
        p = int(p)
        log(f"=== throughput {gran}:{p} (unpadded) ===")
        g, dt1 = one_build(gran, p, None)
        rec = eval_recall(g)
        # free build 1 + its eval buffers BEFORE building again: both
        # graphs plus one build's ~11 GB working set do not fit 15.5 GB
        # of HBM, and the server frees a dead client's buffers lazily
        # (measured RE in r5 build 2 at layer-0 selection)
        del g
        gc.collect()
        time.sleep(args.cooldown)
        g2, dt2 = one_build(gran, p, None)
        best = min(dt1, dt2)
        record({"kind": "throughput", "granularity": gran, "probes": p,
                "build_s": round(best, 2),
                "nodes_per_s": round(n / best, 1),
                "cold_build_s": round(dt1, 2), **rec})
        if args.save:
            t0 = time.perf_counter()
            g2.save(args.save)
            record({"kind": "save", "path": args.save,
                    "save_s": round(time.perf_counter() - t0, 1),
                    "bytes": os.path.getsize(args.save)})
        del g2
        gc.collect()

    out = {"metric": "probe_sweep", "n": n, "csize": args.csize,
           "results_file": args.results}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
