#!/usr/bin/env python
"""Build benchmark on the GPU: the exact builder's bucket kernel against
XLA's plain form, and the exact builder against the native host builder.

    python bench.py [--n 1048576] [--sizes 100000,200000,400000] [--seed 0]

One process on one card; it fails without a GPU. It runs

1. the exact build of ``--n`` fingerprints (connectivity 16) with the
   Pallas-Triton bucket kernel (``impl="triton"``) and with XLA's int8
   block and reshape-max (``impl="int8"``), in turns int8, triton,
   triton, int8 after one untimed warm-up of each, so compilation is
   outside the timed builds;
2. the exact (``impl="triton"``, after an untimed warm-up) and native
   (C++, all host cores) builds at each of ``--sizes``, with each graph's
   distance recall@10 at ef 128: the evidence for what
   ``backend="auto"`` chooses.

The library is chip_smoke.py's family-structured one, from ``--seed``.
Prints the card's name and power limit, then one JSON line with every
time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip()


def timed_build(build, fps, **kw):
    import jax

    t0 = time.perf_counter()
    g = build(fps, connectivity=16, **kw)
    jax.block_until_ready(g.neighbors)
    return time.perf_counter() - t0, g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--sizes", default="100000,200000,400000")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench: needs a GPU, JAX found {dev.platform}")
        return 2
    from chip_smoke import distance_recall_at, make_library
    from rad_tpu.build.exact import build_hnsw_exact
    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu.native import build_hnsw_native
    from rad_tpu.search.knn import search_device
    from rad_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    log(f"device {dev.device_kind} x{len(jax.devices())}; card: {card}")
    sizes = [int(s) for s in args.sizes.split(",") if s]
    lib = make_library(max([args.n] + sizes), 200, args.seed)
    fps = lib.packed

    def recall(g, n):
        truth_d, _ = bruteforce_topk_blocked(
            jax.numpy.asarray(lib.queries), lib.dev[:n], 10,
            block=min(1 << 16, n))
        _, ids = search_device(g, lib.queries, k=10, expansion_search=128)
        ids = np.asarray(ids)
        keys = np.asarray(g.keys)
        found = np.where(ids >= 0, keys[np.maximum(ids, 0)], -1)
        return distance_recall_at(lib.queries, lib.dev, found,
                                  np.asarray(truth_d))

    big = fps[:args.n]
    times = {"int8": [], "triton": []}
    for impl in ("int8", "triton"):
        dt, _ = timed_build(build_hnsw_exact, big, impl=impl)
        log(f"warm-up {impl}: {dt:.3f} s")
    for impl in ("int8", "triton", "triton", "int8"):
        dt, _ = timed_build(build_hnsw_exact, big, impl=impl)
        times[impl].append(dt)
        log(f"exact build {args.n} impl={impl}: {dt:.3f} s")

    crossover = []
    for n in sizes:
        timed_build(build_hnsw_exact, fps[:n], impl="triton")  # compile
        t_exact, g_exact = timed_build(build_hnsw_exact, fps[:n],
                                       impl="triton")
        t_native, g_native = timed_build(build_hnsw_native, fps[:n],
                                         expansion_add=400)
        row = {"n": n, "exact_s": t_exact, "native_s": t_native,
               "exact_recall": recall(g_exact, n),
               "native_recall": recall(g_native, n)}
        crossover.append(row)
        log(f"crossover {row}")

    med = {k: float(np.median(v)) for k, v in times.items()}
    print(json.dumps({
        "metric": "exact_build_nodes_per_s",
        "value": args.n / med["triton"],
        "unit": "nodes/s",
        "n": args.n,
        "build_s": times,
        "kernel_speedup": med["int8"] / med["triton"],
        "crossover": crossover,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
