"""Per-op decomposition of the traversal step via the on-device profiler.

Runs the fused exhaustive sweep in two phases — untraced warm-up into the
late (tail) regime, then a bounded traced window — and aggregates the
device plane's "XLA Ops" line per op name. This is the ground-truth
breakdown of the step (microbenches of isolated ops are confounded by
loop-carry copies and readback; the profiler is not).

Caveat: while/cond event durations include overlapped child
waits — read leaf fusion/gather/scatter/sort lines, not the loop events.

Prints one JSON line with the top ops by total device time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--graph-cache", default="/tmp/g1m_exact.npz")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--buffer", type=int, default=1 << 14)
    ap.add_argument("--frontier", type=int, default=1 << 20)
    ap.add_argument("--warm-steps", type=int, default=2000)
    ap.add_argument("--trace-steps", type=int, default=300)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from rad_tpu.fp import popcount_rows, random_fingerprints
    from rad_tpu.fp.tanimoto import tanimoto_matrix
    from rad_tpu.graph.storage import HNSWGraph
    from rad_tpu.traverse import device as dev

    log(f"device: {jax.devices()[0]}")
    if not os.path.exists(args.graph_cache):
        raise SystemExit(f"graph cache missing: {args.graph_cache} "
                         "(run bench_engine_grid first)")
    graph = HNSWGraph.load(args.graph_cache, mmap=False)
    dg = dev.prepare_device_graph(graph)
    packed = jnp.asarray(np.asarray(graph.packed))
    pops = jnp.asarray(np.asarray(graph.popcounts))
    target = jnp.asarray(random_fingerprints(1, graph.ndim, 0.1, 7)[0])
    t_pop = popcount_rows(target[None, :])[0]
    n_top = graph.layer_sizes[graph.max_level]
    seed_ids = jnp.arange(n_top, dtype=jnp.int32)
    seed_scores = tanimoto_matrix(target[None, :], packed[:n_top])[0]
    n = len(graph)

    state = dev.init_state(dg, frontier_capacity=args.frontier,
                           buffer_capacity=args.buffer)
    state = dev.prime(state, dg, seed_ids, seed_scores)

    log(f"warm-up: {args.warm_steps} steps into the tail regime ...")
    state = dev.fused_run(state, dg, packed, pops, target, t_pop,
                          jnp.int32(n), batch=args.batch,
                          max_steps=args.warm_steps)
    warm_scored = int(state.n_scored)
    log(f"  warm: {warm_scored} scored, {int(state.n_steps)} steps")

    logdir = tempfile.mkdtemp(prefix="radprof_")
    log(f"tracing {args.trace_steps} steps -> {logdir}")
    t0 = time.perf_counter()
    jax.profiler.start_trace(logdir)
    state = dev.fused_run(state, dg, packed, pops, target, t_pop,
                          jnp.int32(n), batch=args.batch,
                          max_steps=args.trace_steps)
    scored = int(state.n_scored)  # readback barrier
    jax.profiler.stop_trace()
    wall = time.perf_counter() - t0
    steps = args.trace_steps
    log(f"  traced window: {wall*1e3:.0f} ms wall, "
        f"{(scored - warm_scored)} scored")

    from rad_tpu.utils.profiling import aggregate_xla_ops
    agg, n_events = aggregate_xla_ops(logdir)
    total_ns = sum(agg.values())
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:args.top]
    log(f"\n{n_events} events, device total {total_ns/1e6:.1f} ms over "
        f"{steps} steps = {total_ns/1e3/steps:.1f} us/step accounted")
    rows = []
    for name, ns in top:
        us_step = ns / 1e3 / steps
        rows.append({"op": name[:90], "us_per_step": round(us_step, 1),
                     "pct": round(100 * ns / total_ns, 1)})
        log(f"  {us_step:8.1f} us/step  {100*ns/total_ns:5.1f}%  {name[:90]}")

    print(json.dumps({"metric": "step_profile", "n": n,
                      "batch": args.batch,
                      "us_per_step_accounted": total_ns / 1e3 / steps,
                      "trace_steps": steps, "ops": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
