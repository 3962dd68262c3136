#!/usr/bin/env python
"""Traversal under a learned (MLP) scoring model, fully on-device.

The reference screens billion-scale libraries with ML scorers (Chemprop,
reference README.md:206) by calling the model from Python workers. On the
device the model can live *inside* the traversal program: here a small MLP over
unpacked fingerprint bits is fitted to DOCK-like scores on a labeled subset
(the "already-docked" molecules), then the entire best-first sweep — pop,
gather, MLP inference, frontier update — compiles into one program via
``make_device_run``. Zero host round trips during traversal.

    python examples/ml_scorer_example.py --n 20000
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def train_mlp_scorer(packed_train, scores_train, n_bits, hidden=256,
                     steps=300, lr=1e-3, seed=0):
    """Fit score ≈ MLP(bits). Returns (params, scorer_fn(fp_rows, pops))."""
    import jax
    import jax.numpy as jnp
    from rad_tpu.fp.tanimoto import unpack_to_dtype

    rng = np.random.default_rng(seed)
    w1 = jnp.asarray(rng.normal(0, (2 / n_bits) ** 0.5, (n_bits, hidden)),
                     jnp.float32)
    b1 = jnp.zeros((hidden,), jnp.float32)
    w2 = jnp.asarray(rng.normal(0, (2 / hidden) ** 0.5, (hidden, 1)),
                     jnp.float32)
    b2 = jnp.zeros((1,), jnp.float32)
    params = (w1, b1, w2, b2)

    x = unpack_to_dtype(jnp.asarray(packed_train), jnp.float32)
    y = jnp.asarray(scores_train, jnp.float32)
    mu, sd = float(y.mean()), float(y.std()) + 1e-6
    yn = (y - mu) / sd

    def predict(p, xb):
        w1, b1, w2, b2 = p
        h = jax.nn.relu(xb @ w1 + b1)
        return (h @ w2 + b2)[:, 0]

    @jax.jit
    def step(p, _):
        def loss(p):
            return jnp.mean((predict(p, x) - yn) ** 2)
        l, g = jax.value_and_grad(loss)(p)
        p = jax.tree_util.tree_map(lambda a, b: a - lr * b, p, g)
        return p, l

    params, losses = jax.lax.scan(step, params, None, length=steps)

    def scorer(fp_rows, pop_rows):
        xb = unpack_to_dtype(fp_rows, jnp.float32)
        return predict(params, xb) * sd + mu

    return params, scorer, float(losses[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--n-bits", type=int, default=512)
    ap.add_argument("--train-frac", type=float, default=0.05)
    ap.add_argument("--score-frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from enrichment_example import make_library

    from rad_tpu.fp.tanimoto import tanimoto_matrix
    from rad_tpu.native import build_hnsw_native, native_available
    from rad_tpu.traverse import device as dev

    packed, true_scores, _ = make_library(args.n, args.n_bits,
                                          seed=args.seed)
    if native_available():
        graph = build_hnsw_native(packed, connectivity=12,
                                  expansion_add=64, seed=args.seed)
    else:
        from rad_tpu.build.reference import build_hnsw
        graph = build_hnsw(packed, connectivity=12, expansion_add=64,
                           seed=args.seed)
    # map true scores into graph id space
    keys = np.asarray(graph.keys)
    scores_by_id = true_scores[keys]

    # "already docked" random subset trains the surrogate
    rng = np.random.default_rng(args.seed + 1)
    train_ids = rng.choice(args.n, int(args.train_frac * args.n),
                           replace=False)
    gp = np.asarray(graph.packed)
    t0 = time.perf_counter()
    _, scorer, final_loss = train_mlp_scorer(
        gp[train_ids], scores_by_id[train_ids], args.n_bits)
    print(f"surrogate trained on {len(train_ids)} molecules in "
          f"{time.perf_counter()-t0:.1f}s (final normalized MSE "
          f"{final_loss:.3f})")

    # fully on-device traversal under the surrogate
    dg = dev.prepare_device_graph(graph)
    packed_d = jnp.asarray(gp)
    pops_d = jnp.asarray(np.asarray(graph.popcounts))
    # batch 32, NOT the depth-maximizing 4-8 of the exact-scorer
    # workflows: with a noisy surrogate, strict best-first chases noise
    # and wider rounds hedge across candidates (measured 74 vs 49 of the
    # top-100 at batch 32 vs 8 on the 4k test config) — see the
    # batch-depth section of docs/ARCHITECTURE.md
    run = dev.make_device_run(dg, packed_d, pops_d, scorer, batch=32)
    state = dev.init_state(dg, frontier_capacity=1 << 16)
    n_top = graph.layer_sizes[graph.max_level]
    seed_ids = jnp.arange(n_top, dtype=jnp.int32)
    seed_scores = scorer(packed_d[:n_top], pops_d[:n_top])
    state = dev.prime(state, dg, seed_ids, seed_scores)
    budget = int(args.score_frac * args.n)
    t0 = time.perf_counter()
    state = run(state, jnp.int32(budget))
    n_scored = int(state.n_scored)
    dt = time.perf_counter() - t0
    print(f"traversed {n_scored} molecules in {dt:.2f}s "
          f"({n_scored/dt:.0f} mol/s, MLP inference in-loop)")

    # enrichment against the TRUE scores
    found = np.asarray(state.order_log)[:n_scored]
    true_top = set(np.argsort(scores_by_id, kind="stable")[:100].tolist())
    hit = len(true_top & set(found.tolist()))
    print(f"true top-100 found: {hit}/100 while scoring "
          f"{100*n_scored/args.n:.0f}% of the library "
          f"(random expectation {100*n_scored/args.n:.0f})")
    return 0 if hit >= 50 else 1


if __name__ == "__main__":
    sys.exit(main())
