#!/usr/bin/env python
"""Serve a 100M+-node mmap'd graph over HTTP.

The reference's proof point is 2B molecules served from one CPU server via
a memory-mapped vector-free index (reference index.html:568-580;
scripts/start_hnsw_server.py:69 ``view=True, exclude_vectors=True``).
This benchmark reproduces that deployment at the scale this machine's
disk allows:

1. synthesize a structurally-valid level-sorted HNSW adjacency at ``--n``
   nodes (graph topology only — the serving path never touches vectors,
   exactly like the reference's exclude_vectors deployment; the
   reference's own CI serves a random test index,
   scripts/start_hnsw_server.py:26-56);
2. save it ``exclude_vectors=True`` (~14 GB at 100M, M=16);
3. load with the genuine npz-member mmap (``HNSWGraph.load(mmap=True)``)
   and serve with the stdlib HTTP server;
4. measure /neighbors latency (p50/p99) and throughput with concurrent
   keep-alive clients, plus server RSS to prove the graph is paged, not
   resident.

    python benchmarks/bench_serving.py --n 100000000
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synth_graph_file(n: int, m: int, path: str, seed: int = 0,
                     chunk_rows: int = 4_000_000, slim: bool = False) -> dict:
    """Write a valid level-sorted HNSW-format graph of n nodes (no vectors).

    Streamed via :class:`NpzStreamWriter` in ``chunk_rows`` pieces so peak
    RAM is O(chunk), not O(n) — a 1B-node file is ~70 GiB of adjacency that
    must never be resident at once (the reference's 2B serving file is the
    same deal, reference index.html:568-580).

    Levels are the expected geometric occupancy (hnsw_layer_sizes, the
    same model bench_scale's device generator uses) rather than sampled:
    per-element sampling + a global 1B-element sort costs tens of CPU-
    minutes on this host for zero structural difference. Neighbor ids
    come from full-range raw bits + modulo — numpy's bounded
    ``Generator.integers`` with a varying bound is ~1000x slower than the
    full-range mask path (measured: 554 s vs 0.1 s per 8M rows).

    ``slim=True`` writes the v2 serving format: the keys and levels
    members are OMITTED and declared derivable in the meta
    (``identity_keys`` — keys == node ids, and ``derived_levels`` — level
    from the level-sorted layer sizes), and per-layer edge counts are
    recorded so ``levels_stats`` never scans the file. At 2B nodes those
    two members alone are 24 GB — the difference between the reference's
    2B deployment fitting this disk or not."""
    from benchmarks.bench_scale import hnsw_layer_sizes
    from rad_tpu.graph.storage import NpzStreamWriter

    layer_sizes = hnsw_layer_sizes(n, m)
    max_level = len(layer_sizes) - 1
    sizes_asc = np.asarray(layer_sizes[::-1], np.int64)
    w = NpzStreamWriter(path)
    if not slim:
        with w.member("keys", (n,), np.int64) as mb:
            for i in range(0, n, chunk_rows):
                mb.write(np.arange(i, min(i + chunk_rows, n),
                                   dtype=np.int64))
        # level-sorted descending ids: node i's level = #{l : i < N_l} - 1
        with w.member("levels", (n,), np.int32) as mb:
            for i in range(0, n, chunk_rows):
                ids = np.arange(i, min(i + chunk_rows, n), dtype=np.int64)
                lev = (len(layer_sizes)
                       - np.searchsorted(sizes_asc, ids, side="right") - 1)
                mb.write(lev.astype(np.int32))
    rng = np.random.default_rng(seed + 1)
    edges_per_layer = []
    t_start = time.time()
    for l, n_l in enumerate(layer_sizes):
        cap = 2 * m if l == 0 else m
        edges = 0
        with w.member(f"neighbors_{l}", (n_l, cap), np.int32) as mb:
            if n_l <= 1:
                if n_l:
                    mb.write(np.full((n_l, cap), -1, np.int32))
                edges_per_layer.append(0)
                continue
            for i in range(0, n_l, chunk_rows):
                rows = min(chunk_rows, n_l - i)
                # random neighbors != self, a few -1 pads at tail columns
                bits = rng.integers(0, 1 << 32, size=(rows, cap),
                                    dtype=np.uint32)
                a = (bits % np.uint32(n_l - 1)).astype(np.int32)
                ids = np.arange(i, i + rows, dtype=np.int32)[:, None]
                a = np.where(a >= ids, a + 1, a)          # skip self
                pad = (bits[:, 0] & np.uint32(3)).astype(np.int64)
                for p in range(1, 4):
                    a[pad == p, cap - p:] = -1
                edges += rows * cap - int(pad.sum())      # pad in {0,1,2,3}
                mb.write(a)
                del a, bits
                if l == 0 and i % (16 * chunk_rows) == 0 and i:
                    done = i / n_l
                    log(f"  layer 0: {done:5.1%} "
                        f"({(time.time()-t_start)/60:.1f} min)")
        edges_per_layer.append(edges)
    meta = {"ndim": 32 * 32, "connectivity": m,
            "n_layers": max_level + 1, "exclude_vectors": True,
            "version": 2 if slim else 1,
            "edges_per_layer": edges_per_layer}
    if slim:
        meta["identity_keys"] = True
        meta["derived_levels"] = True
    w.close(meta)
    return {"max_level": max_level, "layer_sizes": layer_sizes}


def rss_mb() -> float:
    """CURRENT resident set (not peak): the paged-not-resident claim."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024
    return -1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--path", default="/tmp/serving_graph.npz")
    ap.add_argument("--port", type=int, default=8941)
    ap.add_argument("--requests", type=int, default=5000)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--keep-file", action="store_true")
    ap.add_argument("--slim", action="store_true",
                    help="v2 serving format: omit keys/levels members "
                         "(identity/derived), record edge counts in meta — "
                         "how 2B nodes fit a ~100 GB disk")
    args = ap.parse_args(argv)

    from rad_tpu.graph.storage import HNSWGraph
    from rad_tpu.server.http_server import create_hnsw_server

    if not os.path.exists(args.path):
        # synthesize in a CHILD process so this (serving) process's RSS
        # reflects only mmap paging, never the construction arrays
        log(f"synthesizing {args.n}-node graph file (subprocess) ...")
        t0 = time.time()
        import subprocess
        subprocess.run(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r}); "
             f"from benchmarks.bench_serving import synth_graph_file; "
             f"synth_graph_file({args.n}, {args.connectivity}, "
             f"{args.path!r}, slim={args.slim})"],
            check=True)
        log(f"wrote {args.path} in {time.time()-t0:.0f}s "
            f"({os.path.getsize(args.path)/2**30:.1f} GiB)")

    t0 = time.time()
    graph = HNSWGraph.load(args.path, mmap=True)
    t_load = time.time() - t0
    log(f"mmap load: {t_load:.2f}s for "
        f"{os.path.getsize(args.path)/2**30:.1f} GiB file; "
        f"n={len(graph)}, max_level={graph.max_level}, "
        f"has_vectors={graph.has_vectors}")

    server, _app = create_hnsw_server(graph, host="127.0.0.1",
                                     port=args.port)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    time.sleep(0.5)

    import http.client

    n = len(graph)
    rng = np.random.default_rng(7)
    node_ids = rng.integers(0, n, size=args.requests)

    def worker(ids, out):
        conn = http.client.HTTPConnection("127.0.0.1", args.port)
        lat = []
        for nid in ids:
            t0 = time.perf_counter()
            conn.request("GET", f"/neighbors/{int(nid)}/0")
            resp = conn.getresponse()
            body = resp.read()
            lat.append(time.perf_counter() - t0)
            assert resp.status == 200, (resp.status, body[:200])
        conn.close()
        out.extend(lat)

    # warm (first-touch page faults) then measured
    wout = []
    worker(node_ids[:200], wout)

    lats: list = []
    chunks = np.array_split(node_ids, args.threads)
    threads = [threading.Thread(target=worker, args=(c, lats))
               for c in chunks]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    lats_ms = np.sort(np.asarray(lats)) * 1e3
    result = {
        "metric": "serving_neighbors",
        "n_nodes": n,
        "format": "v2-slim" if args.slim else "v1",
        "file_gib": round(os.path.getsize(args.path) / 2**30, 2),
        "mmap_load_s": round(t_load, 2),
        "qps": round(len(lats) / wall),
        "threads": args.threads,
        "p50_ms": round(float(lats_ms[len(lats_ms) // 2]), 3),
        "p99_ms": round(float(lats_ms[int(len(lats_ms) * 0.99)]), 3),
        "server_rss_mb": round(rss_mb(), 1),
    }
    server.shutdown()
    if not args.keep_file:
        os.remove(args.path)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
