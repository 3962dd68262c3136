"""End-to-end single-chip BUILD + SCREEN at multi-million scale.

The reference's flagship workflow (examples/DUDEZ_example.ipynb:359-408:
build the index over the library, traverse best-first with the
precomputed ground-truth scorer, report what fraction of the global
top-N is recovered at small scored budgets) run entirely on one card at
up to 100x its 100k showcase scale:

  1. probed exact build (rad_tpu.build.exact, cluster-probed candidate
     stage past the O(N^2) break-even) — adjacency stays device-resident;
  2. fused device traversal (rad_tpu.traverse.device.fused_run_segmented)
     with the scorer computed IN-LOOP from the packed fingerprints
     (Tanimoto distance to a target library row). As in the reference's
     protocol the score field is the ground truth itself, so top-N
     capture at an x% budget measures pure traversal efficiency;
  3. exact global top-N by blocked brute force for the capture metric.

Prints one JSON line with build/traverse timings and per-budget capture.
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
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--probes", type=int, default=128,
                    help="cluster-probed candidate stage (0 = fully exact "
                         "all-pairs — O(N^2), hours past ~2M nodes)")
    ap.add_argument("--n-top", type=int, default=100)
    ap.add_argument("--budget-fracs", default="0.01,0.05,0.10",
                    help="scored-budget fractions, ascending (one "
                         "continued traversal, snapshot per budget)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--frontier", type=int, default=1 << 22)
    ap.add_argument("--buffer", type=int, default=1 << 17)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from rad_tpu.build.exact import build_hnsw_exact
    from rad_tpu.fp.pack import popcount_rows
    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked, tanimoto_matrix
    from rad_tpu.traverse import device as dev

    log(f"device: {jax.devices()[0]}")
    # shared library cache with bench_exact_stages (same generator/seed)
    cache = f"/tmp/bes_lib_n{args.n}_b{args.n_bits}_s0.npy"
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "examples"))
    if os.path.exists(cache):
        fps = np.load(cache)
        log(f"library loaded from {cache}")
    elif args.n > 2_000_000:
        from enrichment_example import make_library_batched
        fps, _ = make_library_batched(args.n, args.n_bits, seed=0)
        np.save(cache, fps)
    else:
        from enrichment_example import make_library
        fps, _, _ = make_library(args.n, args.n_bits, seed=0)
        np.save(cache, fps)
    n = fps.shape[0]

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    g = build_hnsw_exact(fps, connectivity=args.connectivity,
                         seed=args.seed,
                         probes=args.probes or None)
    for t in g.neighbors:
        if t.shape[0]:
            np.asarray(t[-1:])  # completion barrier, no full download
    t_build = time.perf_counter() - t0
    log(f"build: {t_build:.1f}s ({n / t_build:.0f} nodes/s, "
        f"probes={args.probes or 'exact'})")

    dg = dev.prepare_device_graph(g)

    # ------------------------------------------- scorer + exact top-N
    rng = np.random.default_rng(23)
    target_row = int(rng.integers(n // 2, n))
    target = jnp.asarray(fps[target_row])
    t_pop = popcount_rows(target[None, :])[0]

    chunks = []
    step = 1 << 21
    for lo in range(0, n, step):
        c = popcount_rows(g.packed[lo:lo + step])
        jax.block_until_ready(c)  # serialize: temps of all chunks otherwise
        chunks.append(c)          # queue live at once
    pops = jnp.concatenate(chunks).astype(jnp.int32)

    t0 = time.perf_counter()
    _, i_t = bruteforce_topk_blocked(target[None, :], g.packed, args.n_top)
    truth = set(np.asarray(i_t)[0].tolist())
    log(f"exact top-{args.n_top}: {time.perf_counter() - t0:.1f}s")

    # ------------------------------------------------------------- prime
    n_top_layer = g.neighbors[-1].shape[0]
    top_ids = jnp.arange(max(n_top_layer, 1), dtype=jnp.int32)
    seed_scores = tanimoto_matrix(target[None, :],
                                  g.packed[: top_ids.shape[0]])[0]
    prime_j = jax.jit(dev.prime, donate_argnums=(0,))
    state = dev.init_state(dg, frontier_capacity=args.frontier,
                           buffer_capacity=args.buffer,
                           log_capacity=n)
    state = prime_j(state, dg, top_ids, seed_scores)
    jax.block_until_ready(state.f_score)

    # ---------------------------------------------- screen (continued)
    fracs = [float(f) for f in args.budget_fracs.split(",")]
    budgets = []
    t_first = None
    for f in fracs:
        n_to_score = int(f * n)
        t0 = time.perf_counter()
        state = dev.fused_run_segmented(
            state, dg, g.packed, pops, target, t_pop,
            n_to_score=n_to_score, batch=args.batch)
        scored = int(state.n_scored)
        dt = time.perf_counter() - t0
        if t_first is None:
            t_first = dt
        ids = dev.read_order_log(state)[:scored]
        cap = len(truth.intersection(ids.tolist()))
        log(f"budget {f:.2%}: scored {scored} (+{dt:.1f}s) -> "
            f"top-{args.n_top} capture {cap}")
        budgets.append({"frac": f, "scored": scored, "wall_s": dt,
                        "capture": cap})
    total_scored = budgets[-1]["scored"]
    traverse_s = sum(b["wall_s"] for b in budgets)

    print(json.dumps({
        "metric": "build_screen_e2e", "n": n, "m": args.connectivity,
        "probes": args.probes, "n_top": args.n_top,
        "build_s": round(t_build, 2),
        "build_nodes_per_s": round(n / t_build),
        "traverse_s": round(traverse_s, 2),
        "traverse_nodes_per_s": round(total_scored / traverse_s),
        "budgets": budgets,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
