"""Decompose real-graph traversal throughput into step rate x discovery.

Tuned traversal on the saved 10M probed graph scores
~22.9k/s while the same engine does 3.7M nodes/s on synthetic graphs —
a ~160x gap with no decomposition behind it. scored/s factors exactly as

    scored/s  =  steps/s  x  new-scored-per-step

and the two factors implicate different causes:

* ``steps/s`` low  -> the STEP got expensive at 10M state sizes
  (frontier sorts, gathers) — an engine lever.
* ``new/step`` low -> the traversal is DISCOVERY-limited: most
  neighbors of each popped batch are already scored, so a step's
  [B*M0] candidate slots yield only a trickle of fresh work — an
  algorithmic property of the (graph, score-field) pair.

This driver measures both factors per fixed-size segment over the whole
run, under controlled arms:

* ``real``    — the saved graph + its correlated score table (the e2e
  configuration that measured 22.9k/s).
* ``random``  — same graph, randomly permuted score table: breaks the
  score-structure correlation while keeping graph topology. If
  ``new/step`` recovers here, score correlation (analog-series
  clustering) drives re-discovery, not the graph shape.
* ``synthetic`` — a same-M random-adjacency graph of the same size
  (``bench_scale``-style) at the same config: the engine-ceiling
  reference point (topology AND scores decorrelated).

Plus ``--profile``: one xplane-profiled segment on the real arm
(device-plane op aggregation via rad_tpu.utils.profiling).

Usage (device):
    python benchmarks/bench_gap_decompose.py \
        --graph /tmp/g10m_p16.npz \
        --scores /tmp/bes_lib_n10000000_b1024_s0_scores.npy \
        --arms real,random --budget 1000000

Reference context: this measures the hot loop a reference user feels
through rad.traverser.RADTraverser's worker pulls
(/root/reference/rad/coordination_service.py:349-413).
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


def _segment_curve(run, state, dev, seg_steps: int, budget: int,
                   max_segments: int = 4096):
    """Drive ``run`` in fixed ``seg_steps`` chunks; return per-segment
    (steps, new_scored, seconds) plus totals. Bit-identical trajectory to
    one long run (segmented_run's continuation property)."""
    import jax.numpy as jnp

    rows = []
    prev_steps = int(np.asarray(state.n_steps))
    prev_scored = int(np.asarray(state.n_scored))
    t_total0 = time.perf_counter()
    for _ in range(max_segments):
        t0 = time.perf_counter()
        state = run(state, jnp.int32(budget), jnp.int32(seg_steps))
        n_steps = int(np.asarray(state.n_steps))  # readback barrier
        dt = time.perf_counter() - t0
        n_scored = int(np.asarray(state.n_scored))
        stepped = n_steps - prev_steps
        fresh = n_scored - prev_scored
        rows.append((stepped, fresh, dt))
        prev_steps, prev_scored = n_steps, n_scored
        if stepped < seg_steps or n_scored >= budget:
            break
    total_s = time.perf_counter() - t_total0
    return state, rows, total_s


def _summarize(rows, total_s, label):
    steps = sum(r[0] for r in rows)
    scored = sum(r[1] for r in rows)
    # exclude the first segment from rate stats (compile pollution)
    tail = rows[1:] if len(rows) > 1 else rows
    tail_steps = sum(r[0] for r in tail)
    tail_scored = sum(r[1] for r in tail)
    tail_s = sum(r[2] for r in tail)
    out = {
        "arm": label,
        "segments": len(rows),
        "steps": steps,
        "scored": scored,
        "total_s": round(total_s, 2),
        "scored_per_s": round(scored / max(total_s, 1e-9), 1),
        "steps_per_s": round(tail_steps / max(tail_s, 1e-9), 1),
        "ms_per_step": round(1e3 * tail_s / max(tail_steps, 1), 3),
        "new_per_step": round(tail_scored / max(tail_steps, 1), 1),
        # the number a warm-cache user sees (segment 1 = compile window)
        "sustained_scored_per_s": round(
            tail_scored / max(tail_s, 1e-9), 1),
    }
    # discovery decay curve: new/step for 8 evenly spaced segments
    if len(rows) >= 2:
        idx = np.linspace(0, len(rows) - 1, num=min(8, len(rows)),
                          dtype=int)
        out["new_per_step_curve"] = [
            round(rows[i][1] / max(rows[i][0], 1), 1) for i in idx]
        out["ms_per_step_curve"] = [
            round(1e3 * rows[i][2] / max(rows[i][0], 1), 2) for i in idx]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="/tmp/g10m_p16.npz")
    ap.add_argument("--scores",
                    default="/tmp/bes_lib_n10000000_b1024_s0_scores.npy")
    ap.add_argument("--arms", default="real,random")
    ap.add_argument("--budget", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--buffer", type=int, default=1 << 17)
    ap.add_argument("--head", type=int, default=1 << 16)
    ap.add_argument("--cap", type=int, default=1 << 22)
    ap.add_argument("--seg-steps", type=int, default=64,
                    help="fixed steps per instrumented segment (device "
                         "time stays bounded)")
    ap.add_argument("--profile", action="store_true",
                    help="xplane-profile one mid-run segment (real arm)")
    ap.add_argument("--profile-dir", default="/tmp/gap_xplane")
    ap.add_argument("--results", default="/tmp/gap_decompose.jsonl")
    args = ap.parse_args(argv)

    from rad_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    from rad_tpu.graph.storage import HNSWGraph
    from rad_tpu.traverse import device as dev

    results_f = open(args.results, "a", buffering=1)

    def record(rec):
        results_f.write(json.dumps(rec) + "\n")
        results_f.flush()
        os.fsync(results_f.fileno())
        log(f"RECORDED {rec}")

    t0 = time.time()
    g = HNSWGraph.load(args.graph, mmap=True)
    n = len(g.keys)
    keys = np.asarray(g.keys)
    scores = np.load(args.scores, mmap_mode="r")
    log(f"graph {n} loaded ({time.time() - t0:.1f}s)")

    dg = dev.prepare_device_graph(g)
    dummy = jnp.zeros((n, 1), jnp.uint8)
    n_top = g.layer_sizes[g.max_level]

    def make(table):
        # scorer = table lookup (the retrospective-protocol scorer the
        # e2e artifact used; pops slot carries the table)
        run = dev.make_device_run(dg, dummy, table, lambda _r, t: t,
                                  batch=args.batch)
        state = dev.init_state(dg, frontier_capacity=args.cap,
                               buffer_capacity=args.buffer,
                               head_capacity=args.head)
        state = dev.prime(state, dg, jnp.arange(n_top, dtype=jnp.int32),
                          table[:n_top])
        return run, state

    arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    for arm in arms:
        if arm == "real":
            table = jnp.asarray(np.asarray(scores)[keys]
                                .astype(np.float32))
        elif arm == "random":
            rng = np.random.default_rng(5)
            table = jnp.asarray(rng.permutation(
                np.asarray(scores)[keys]).astype(np.float32))
        elif arm == "synthetic":
            # same N/M random-regular adjacency, uniform scores — the
            # engine-ceiling reference (bench_scale's topology class)
            rng = np.random.default_rng(7)
            table = jnp.asarray(
                rng.standard_normal(n).astype(np.float32))
            m0 = g.neighbors[0].shape[1]
            sy_adj = rng.integers(0, n, size=(n, m0), dtype=np.int64)
            sy = dataclass_replace_layer0(g, sy_adj)
            dg_s = dev.prepare_device_graph(sy)
            run = dev.make_device_run(dg_s, dummy, table,
                                      lambda _r, t: t, batch=args.batch)
            state = dev.init_state(dg_s, frontier_capacity=args.cap,
                                   buffer_capacity=args.buffer,
                                   head_capacity=args.head)
            state = dev.prime(state, dg_s,
                              jnp.arange(n_top, dtype=jnp.int32),
                              table[:n_top])
            state, rows, total_s = _segment_curve(
                run, state, dev, args.seg_steps, args.budget)
            record(_summarize(rows, total_s, arm))
            del state, run, dg_s
            continue
        else:
            raise SystemExit(f"unknown arm {arm!r}")
        run, state = make(table)
        state, rows, total_s = _segment_curve(
            run, state, dev, args.seg_steps, args.budget)
        summary = _summarize(rows, total_s, arm)
        record(summary)

        if args.profile and arm == "real":
            # profile a FRESH mid-run segment: rebuild state, advance
            # half the budget unprofiled, then trace one segment
            run2, st2 = make(table)
            st2 = dev.segmented_run(run2, st2,
                                    jnp.int32(args.budget // 2))
            os.makedirs(args.profile_dir, exist_ok=True)
            with jax.profiler.trace(args.profile_dir):
                st2 = run2(st2, jnp.int32(args.budget),
                           jnp.int32(args.seg_steps))
                np.asarray(st2.n_steps)
            from rad_tpu.utils.profiling import aggregate_xla_ops
            try:
                agg, n_ev = aggregate_xla_ops(args.profile_dir)
                top = sorted(agg.items(), key=lambda kv: -kv[1])[:15]
                record({"arm": "real_profile", "n_events": n_ev,
                        "top_ops_ms": [[k, round(v / 1e6, 3)]
                                       for k, v in top]})
            except Exception as e:  # profile parse is best-effort
                log(f"profile aggregation failed: {e}")
            del run2, st2
        del run, state, table
        import gc
        gc.collect()
        time.sleep(10)

    print(json.dumps({"metric": "gap_decompose",
                      "results_file": args.results}))
    return 0


def dataclass_replace_layer0(g, adj0):
    """Same graph object with layer-0 adjacency replaced (synthetic arm)."""
    import dataclasses

    return dataclasses.replace(
        g, neighbors=(np.asarray(adj0, np.int32),) + tuple(
            g.neighbors[1:]))


if __name__ == "__main__":
    sys.exit(main())
