#!/usr/bin/env python
"""Receptor-panel screening: T campaigns over one library in ONE sweep.

The reference's DUDE-Z workflow screens one receptor per traversal
(lookup-table DOCK scorer, examples/DUDEZ_example.ipynb) — a 43-receptor
panel means 43 sequential campaigns. Here the multi-campaign engine
(rad_tpu.traverse.multi) runs the whole panel in one compiled sweep over
a shared HNSW graph, each campaign with its own score table, and every
campaign's result is bit-identical to running it alone.

    python examples/panel_screening.py --n 20000 --receptors 4
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def make_receptor_scores(fps: np.ndarray, centers: np.ndarray,
                         seed: int) -> np.ndarray:
    """Synthetic per-receptor DOCK scores: molecules near the receptor's
    active-site 'pharmacophore' (a fingerprint centroid) score best, plus
    noise — the same proxy shape as the enrichment examples."""
    from rad_tpu.fp.pack import popcount_rows_np

    rng = np.random.default_rng(seed)
    inter = popcount_rows_np(fps & centers[None, :])
    pops = popcount_rows_np(fps)
    c_pop = int(popcount_rows_np(centers[None, :])[0])
    sim = inter / np.maximum(pops + c_pop - inter, 1)
    return (-sim + rng.normal(0, 0.005, size=len(fps))).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--receptors", type=int, default=4)
    ap.add_argument("--budget-frac", type=float, default=0.10)
    # batch trades sequential decision depth for throughput: enrichment
    # needs >= tens of best-first rounds within the budget, so keep
    # batch*M0 well under budget/10 (docs/ARCHITECTURE.md)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frontier", type=int, default=None,
                    help="per-campaign frontier capacity (default: auto; "
                         "large panels over 1M-row graphs may cap it to "
                         "bound each campaign's merge sort)")
    ap.add_argument("--head", type=int, default=None,
                    help="two-level frontier head per campaign")
    ap.add_argument("--graph-cache", help="save/load the built graph "
                    "(.npz) so parameter sweeps pay the build once")
    ap.add_argument("--repeat", type=int, default=1,
                    help="sweep repetitions (first pays the compile; "
                         "report the best = steady-state panel time)")
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    from enrichment_example import make_library
    from rad_tpu.traverse import device as dev
    from rad_tpu.traverse.multi import (campaign_state,
                                        fused_run_multi_tables, init_multi,
                                        prime_multi)

    fps, _, _ = make_library(args.n, args.n_bits, seed=0)
    t0 = time.perf_counter()
    if args.graph_cache and os.path.exists(args.graph_cache):
        from rad_tpu.graph.storage import HNSWGraph
        graph = HNSWGraph.load(args.graph_cache, mmap=False)
    else:
        try:
            from rad_tpu.native import build_hnsw_native
            graph = build_hnsw_native(fps, connectivity=16,
                                      expansion_add=128, seed=0)
        except Exception:
            from rad_tpu.build.reference import build_hnsw
            graph = build_hnsw(fps, connectivity=16, expansion_add=128,
                               seed=0)
        if args.graph_cache:
            graph.save(args.graph_cache)
    t_build = time.perf_counter() - t0

    # per-receptor score tables, indexed by NODE id (level-sorted order)
    node_fps = np.asarray(graph.packed)
    rng = np.random.default_rng(9)
    # pharmacophore centers drawn from the deeper half of the mutation
    # tree (original order, pre-level-sort) so a similarity gradient
    # exists across the manifold — same design as enrichment_example
    tables = np.stack([
        make_receptor_scores(
            node_fps, fps[rng.integers(args.n // 2, args.n)],
            seed=100 + r)
        for r in range(args.receptors)
    ])

    dg = dev.prepare_device_graph(graph)
    t_tab = jnp.asarray(tables)
    budget = int(args.n * args.budget_frac)

    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    states = init_multi(dg, args.receptors,
                        frontier_capacity=args.frontier,
                        head_capacity=args.head)
    states = prime_multi(states, dg, ids, t_tab[:, :n_top])

    t_sweep = float("inf")
    for rep in range(max(args.repeat, 1)):
        if rep:
            states = init_multi(dg, args.receptors,
                                frontier_capacity=args.frontier,
                                head_capacity=args.head)
            states = prime_multi(states, dg, ids, t_tab[:, :n_top])
        t0 = time.perf_counter()
        # segmented driving: bit-identical to one unbounded call, with
        # each device program bounded at large T/budget
        states = dev.segmented_run(
            lambda st, nts, sb: fused_run_multi_tables(
                st, dg, t_tab, nts, batch=args.batch, max_steps=sb),
            states, budget)
        total = int(np.asarray(states.n_scored).sum())
        t_sweep = min(t_sweep, time.perf_counter() - t0)

    print(f"library {args.n} | {args.receptors} receptors | build "
          f"{t_build:.1f}s | panel sweep {t_sweep:.2f}s "
          f"({total} scorings)")
    found_all = []
    for r in range(args.receptors):
        st = campaign_state(states, r)
        scored = np.asarray(st.scored)
        true_top = set(np.argsort(tables[r], kind="stable")[:100].tolist())
        found = sum(1 for i in true_top if scored[i])
        found_all.append(found)
        print(f"  receptor {r}: scored {int(st.n_scored)} "
              f"({100 * int(st.n_scored) / args.n:.1f}%) | "
              f"top-100 found: {found}")
    print(f"mean top-100 recovery at {100 * args.budget_frac:.0f}% "
          f"scored: {np.mean(found_all):.0f}/100")
    return 0


if __name__ == "__main__":
    sys.exit(main())
