"""One end-to-end artifact at scale: build → save → mmap-serve → traverse
→ enrichment, on ONE graph.

Every stage is the real production component, composed exactly as a user
would: the subquadratic probed exact build (rad_tpu.build.exact), .npz
persistence + mmap load (rad_tpu.graph.storage — the reference's
``view=True`` serving file, scripts/start_hnsw_server.py:69), the stdlib
HTTP server's /neighbors path, the device-resident traversal engine with
a device-scored table (the retrospective-screening protocol of the
reference notebook, DUDEZ_example.ipynb:359-408), and the enrichment
curve vs ground-truth top scores.

Defaults measure at 10M nodes. Reuses the /tmp library + graph caches of
bench_exact_stages / bench_probe_sweep, so a sweep run earlier in the
session makes this cheap. Results are flushed per stage to a JSONL, and
one summary JSON line is printed at the end.

    python benchmarks/bench_e2e.py --n 10000000 --graph /tmp/g10m.npz
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def library_scores(n: int, n_bits: int, fps: np.ndarray) -> np.ndarray:
    """True scores for the cached library (deterministic regeneration;
    cached alongside the fingerprints after the first call)."""
    cache = f"/tmp/bes_lib_n{n}_b{n_bits}_s0_scores.npy"
    if os.path.exists(cache):
        return np.load(cache)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "examples"))
    t0 = time.perf_counter()
    if n > 2_000_000:
        from enrichment_example import make_library_batched
        fps2, scores = make_library_batched(n, n_bits, seed=0)
    else:
        from enrichment_example import make_library
        fps2, scores, _ = make_library(n, n_bits, seed=0)
    assert np.array_equal(fps2[:64], fps[:64]), \
        "regenerated library diverges from the cached fingerprints"
    np.save(cache, scores)
    log(f"scores regenerated ({time.perf_counter() - t0:.0f}s) -> {cache}")
    return scores


def serve_and_measure(path: str, n: int, port: int, n_req: int,
                      timeout: float = 900.0) -> dict:
    """Launch the real HTTP server on the mmap'd file; measure /neighbors
    latency from a keep-alive client."""
    import http.client

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable,
         os.path.join(repo, "scripts", "start_hnsw_server.py"),
         "--hnsw-path", path, "--port", str(port), "--host", "127.0.0.1"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env={**os.environ, "PYTHONPATH": "", "JAX_PLATFORMS": "cpu"},
    )
    try:
        t0 = time.monotonic()
        up = False
        while time.monotonic() - t0 < timeout:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=2) as r:
                    if r.status == 200:
                        up = True
                        break
            except Exception:
                time.sleep(1.0)
        if not up:
            raise RuntimeError("server did not come up")
        t_up = time.monotonic() - t0

        rng = np.random.default_rng(3)
        ids = rng.integers(0, n, size=n_req)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        # warm
        conn.request("GET", f"/neighbors/{int(ids[0])}/0")
        conn.getresponse().read()
        lats = []
        t0 = time.monotonic()
        for i in ids:
            t1 = time.monotonic()
            conn.request("GET", f"/neighbors/{int(i)}/0")
            r = conn.getresponse()
            body = r.read()
            assert r.status == 200, (r.status, body[:200])
            lats.append(time.monotonic() - t1)
        total = time.monotonic() - t0
        conn.close()
        lats_ms = np.sort(np.array(lats) * 1e3)
        return {
            "startup_s": round(t_up, 1),
            "p50_ms": round(float(lats_ms[len(lats_ms) // 2]), 3),
            "p99_ms": round(float(lats_ms[int(len(lats_ms) * 0.99)]), 3),
            "req_per_s": round(n_req / total, 1),
        }
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except Exception:
            proc.kill()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--graph", default="/tmp/e2e_graph.npz",
                    help="graph file; built (and saved here) if absent")
    ap.add_argument("--probes", type=int, default=32)
    ap.add_argument("--csize", type=int, default=1 << 13)
    ap.add_argument("--granularity", default="qblock")
    ap.add_argument("--probe-min-n", type=int, default=0,
                    help="probing size floor for the build (0 matches "
                         "the sweep builds: probed upper layers reuse "
                         "their compiled shapes)")
    ap.add_argument("--batch", type=int, default=512,
                    help="traversal batch for the THROUGHPUT run (the "
                         "measured efficient point)")
    ap.add_argument("--throughput-frac", type=float, default=0.10,
                    help="library fraction scored in the throughput run")
    ap.add_argument("--enrich-batch", type=int, default=64,
                    help="traversal batch for the ENRICHMENT run — "
                         "best-first depth needs tens of rounds within "
                         "the budget (docs/ARCHITECTURE.md batch-depth)")
    ap.add_argument("--score-frac", type=float, default=0.01,
                    help="fraction of the library to score in the "
                         "enrichment run (reference protocol: ~1%%)")
    ap.add_argument("--n-top", type=int, default=1000)
    ap.add_argument("--serve-requests", type=int, default=2000)
    ap.add_argument("--port", type=int, default=8941)
    ap.add_argument("--results", default="/tmp/e2e_results.jsonl")
    ap.add_argument("--stages", nargs="+",
                    default=["build", "serve", "traverse"])
    ap.add_argument("--smiles-db", default="/tmp/e2e_smiles.db",
                    help="SQLite SMILES store for the host_scored stage "
                         "(created on first use, cached)")
    ap.add_argument("--pipeline-depth", type=int, default=4)
    ap.add_argument("--host-batch", type=int, default=1024)
    args = ap.parse_args(argv)

    from rad_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import logging
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")

    import jax
    import jax.numpy as jnp
    from rad_tpu.graph.storage import HNSWGraph

    log(f"device: {jax.devices()[0]}")
    results_f = open(args.results, "a", buffering=1)
    summary = {"metric": "e2e_at_scale", "n": args.n}

    def record(stage: str, rec: dict):
        summary[stage] = rec
        results_f.write(json.dumps({"stage": stage, "n": args.n, **rec})
                        + "\n")
        results_f.flush()
        os.fsync(results_f.fileno())
        log(f"RECORDED {stage}: {rec}")

    from benchmarks.bench_probe_sweep import load_library
    fps = load_library(args.n, args.n_bits)

    # ------------------------------------------------------------- build
    if "build" in args.stages and not os.path.exists(args.graph):
        from rad_tpu.build.exact import build_hnsw_exact
        t0 = time.perf_counter()
        g = build_hnsw_exact(fps, connectivity=args.connectivity, seed=0,
                             probes=args.probes, probe_csize=args.csize,
                             probe_granularity=args.granularity,
                             probe_min_n=args.probe_min_n)
        for t in g.neighbors:
            if t.shape[0]:
                np.asarray(t[-1:])
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g.save(args.graph)
        record("build", {"build_s": round(build_s, 1),
                         "nodes_per_s": round(args.n / build_s, 1),
                         "save_s": round(time.perf_counter() - t0, 1),
                         "file_bytes": os.path.getsize(args.graph),
                         "probes": args.probes,
                         "granularity": args.granularity})
        del g
        gc.collect()
        time.sleep(15)
    elif os.path.exists(args.graph):
        record("build", {"reused": args.graph,
                         "file_bytes": os.path.getsize(args.graph)})

    # ------------------------------------------------------------- serve
    if "serve" in args.stages:
        rec = serve_and_measure(args.graph, args.n, args.port,
                                args.serve_requests)
        record("serve", rec)

    # ------------------------------------ traverse + enrichment (device)
    if "traverse" in args.stages:
        from rad_tpu.traverse import device as dev

        t0 = time.perf_counter()
        graph = HNSWGraph.load(args.graph, mmap=True)
        load_s = time.perf_counter() - t0
        keys = np.asarray(graph.keys)
        scores = library_scores(args.n, args.n_bits, fps)
        table_by_node = scores[keys].astype(np.float32)

        dg = dev.prepare_device_graph(graph)
        # device-scored table: the scorer is a gather of the per-node
        # score table threaded through the pops argument (dudez_workflow
        # --device-scored pattern); fingerprints are never uploaded
        dummy_fps = jnp.zeros((len(keys), 1), jnp.uint8)
        table_j = jnp.asarray(table_by_node)
        n_top_nodes = graph.layer_sizes[graph.max_level]
        prime_ids = jnp.arange(n_top_nodes, dtype=jnp.int32)
        prime_scores = jnp.asarray(table_by_node[:n_top_nodes])

        def traverse(batch, frac):
            run = dev.make_device_run(dg, dummy_fps, table_j,
                                      lambda _rows, t: t, batch=batch)
            state = dev.init_state(dg)
            state = dev.prime(state, dg, prime_ids, prime_scores)
            n_to_score = int(frac * args.n)
            # pre-warm: the first dispatch carries the remote compile
            # (~40 s) — r4's 9.1k/22.9k scored/s rows were ~94% compile
            # inside the timing window.
            # One 1-step segment compiles + makes 1 step of progress;
            # timing starts after, on the same trajectory.
            state = run(state, jnp.int32(n_to_score), jnp.int32(1))
            np.asarray(state.n_steps)
            t0 = time.perf_counter()
            state = dev.segmented_run(run, state, n_to_score)
            n_scored = int(state.n_scored)
            dt = time.perf_counter() - t0
            return state, n_scored, dt

        # throughput run: the efficient batch point, 10% of the library
        state, n_scored, dt = traverse(args.batch, args.throughput_frac)
        record("traverse", {
            "mmap_load_s": round(load_s, 2),
            "n_scored": n_scored,
            "traverse_s": round(dt, 1),
            "scored_per_s": round(n_scored / dt, 1),
            "batch": args.batch,
        })
        del state
        gc.collect()

        # enrichment run: modest batch for best-first depth, 1% budget
        state, n_scored, dt = traverse(args.enrich_batch, args.score_frac)
        order_nodes = np.asarray(state.order_log)[:n_scored]
        order_keys = keys[order_nodes]
        true_top = np.argsort(scores, kind="stable")[: args.n_top]
        found = len(set(order_keys.tolist()) & set(true_top.tolist()))
        record("enrichment", {
            "n_scored": n_scored,
            "traverse_s": round(dt, 1),
            "batch": args.enrich_batch,
            "scored_frac": round(n_scored / args.n, 4),
            f"top{args.n_top}_found_frac": round(found / args.n_top, 4),
        })

    # ----------------------- traverse + enrichment through the HOST
    # scoring boundary: the reference's actual
    # deployment semantics — a user host scoring_fn(smiles) in the loop
    # with SMILES looked up from a real SQLite store per batch
    # (/root/reference/rad/distributed_worker.py:296-308)
    if "host_scored" in args.stages:
        from rad_tpu.store.smiles_store import (SQLiteSmilesStore,
                                                create_smiles_db)
        from rad_tpu.traverse.driver import DeviceTraverser

        base_n = min(args.n, 1_000_000)

        def all_smiles():
            # combinatorial drug-like SMILES, unique per key: past the
            # base library size each repeat carries an isotope-tagged
            # counterion (still valid SMILES — dot-disconnected salt)
            from rad_tpu.chem.library import make_smiles_library
            base, _ = make_smiles_library(base_n, seed=0)
            for k in range(args.n):
                a, b = divmod(k, base_n)
                yield k, (base[b] if a == 0
                          else f"{base[b]}.[{20 + a}Na+]")

        if not os.path.exists(args.smiles_db):
            t0 = time.perf_counter()
            n_rows = create_smiles_db(args.smiles_db, all_smiles())
            record("smiles_db", {
                "rows": n_rows, "build_s": round(time.perf_counter() - t0, 1),
                "file_bytes": os.path.getsize(args.smiles_db)})

        graph = HNSWGraph.load(args.graph, mmap=True)
        keys = np.asarray(graph.keys)
        scores = library_scores(args.n, args.n_bits, fps)
        # the reference DUDE-Z protocol scores from a precomputed
        # smiles -> DOCK-score dict (examples/DUDEZ_example.ipynb:52);
        # same here, keyed by the store's own strings
        t0 = time.perf_counter()
        score_of = {smi: float(scores[k]) for k, smi in all_smiles()}
        log(f"score dict: {len(score_of)} entries "
            f"({time.perf_counter() - t0:.0f}s)")

        tr = DeviceTraverser(
            graph, score_of.__getitem__,
            smiles_store=SQLiteSmilesStore(args.smiles_db),
            batch_size=args.host_batch,
            frontier_capacity=1 << 22, buffer_capacity=1 << 17,
            head_capacity=1 << 16, n_score_threads=8)
        tr.prime()
        n_budget = int(args.score_frac * args.n)
        t0 = time.perf_counter()
        stats = tr.traverse(n_to_score=n_budget,
                            pipeline_depth=args.pipeline_depth)
        dt = time.perf_counter() - t0
        n_scored = int(tr.state.n_scored)
        order_nodes = np.asarray(tr.state.order_log)[:n_scored]
        order_keys = keys[order_nodes]
        true_top = np.argsort(scores, kind="stable")[: args.n_top]
        found = len(set(order_keys.tolist()) & set(true_top.tolist()))
        record("host_scored", {
            "n_scored": n_scored,
            "traverse_s": round(dt, 1),
            "mol_per_s": round(n_scored / dt, 1),
            "batch": args.host_batch,
            "pipeline_depth": args.pipeline_depth,
            "scoring_time_s": round(tr.stats["scoring_time"], 1),
            "device_time_s": round(tr.stats["device_time"], 1),
            "scored_frac": round(n_scored / args.n, 4),
            f"top{args.n_top}_found_frac": round(found / args.n_top, 4),
        })

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
