#!/usr/bin/env python
"""Smoke test of rad_tpu's main path on the GPU.

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --four     # four cards: the sharded pod phase only

One process, one JAX client, holding the card(s) for the whole run. It
exits non-zero without printing a result when JAX finds no GPU. Phases
(each prints its wall time, compile time, the implementation it ran and
``memory_analysis()`` of its compiled step, and fails the run if its
comparison fails):

1. kernels — the Pallas-Triton bucket-min kernel and the int8 XLA distance
   block at real width (4096 queries x 1M rows x 1024 bits) against the
   SWAR popcount reference and IEEE division on the host.
2. build — ``HNSWIndex.build(backend="exact")`` of a 1M-fingerprint
   DUDE-Z-configured library (connectivity 16, expansion_add 400), its
   recall@10 at ef 32 and 128, and the 100k prefix built on the card and
   on the CPU backend of the same process.
3. traverse — ``create_local_traverser`` -> prime -> traverse (1% scored)
   -> ``get_best_molecules(1000)``, and the device engine against the
   host engine at batch 1.
4. device-scored — ``fused_run`` and the ``io_callback`` loop against the
   stepwise engine on the same scores.
5. knn + server — ``search_device`` recall, and the HTTP server (in a
   thread of this process) answering ``/health`` and ``/neighbors``.
6. ``--four`` — ``PodTraverser`` over a graph row-sharded on four cards
   against one card, and ``build_hnsw_exact(mesh=...)`` against the
   one-card build.

The library, queries and scores are made from ``--seed`` on the device.
The last line of standard output is one JSON object with ``"ok"`` and the
device as JAX reports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from functools import partial

import jax
import numpy as np

# the repo root is this file's directory: make `rad_tpu` importable when
# the script runs from a checkout (it fails below if it is not there)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class Size:
    n: int                 # library rows (one card)
    kernel_q: int          # queries of the kernel phase
    q_block: int           # builder block shape timed in the kernel phase
    col_block: int
    chunk: int             # db rows per reference chunk
    exact_q: int           # queries checked against IEEE division on host
    recall_q: int          # kNN queries
    prefix: int            # rows built on both the card and the CPU
    budget: int            # molecules scored by the campaign
    best: int              # top-k of the campaign
    parity_budget: int     # host-engine parity budget (batch 1)
    four_n: int            # library rows of the four-card pod phase
    four_build_n: int      # rows of the four-card exact build


FULL = Size(n=1 << 20, kernel_q=4096, q_block=4096, col_block=8192,
            chunk=1 << 16, exact_q=256, recall_q=1000, prefix=100_000,
            budget=10_486, best=1000, parity_budget=2000,
            four_n=1 << 22, four_build_n=1 << 20)

# the DUDE-Z notebook's index settings (BASELINE.md)
CONNECTIVITY = 16
EXPANSION_ADD = 400
N_BITS = 1024
BUCKET = 64
# distance recall@10 at ef 128 below this means a broken graph (a graph
# of random edges finds ~0). The exact builder's graphs fall well short of
# the native builder's on this family-structured library (PERF.md), so
# the floor checks that the graph works, not that it is good.
RECALL_FLOOR = 0.3


# ---------------------------------------------------------------- reporting

class CompileClock:
    """Sums XLA backend compile time reported by jax.monitoring."""

    def __init__(self) -> None:
        self.total = 0.0
        self._lock = threading.Lock()

    def listener(self, event: str, duration: float, **_) -> None:
        if "backend_compile" in event:
            with self._lock:
                self.total += duration


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: none"
    return ("memory_analysis: args %d B, outputs %d B, temps %d B, "
            "code %d B" % (m.argument_size_in_bytes, m.output_size_in_bytes,
                           m.temp_size_in_bytes,
                           m.generated_code_size_in_bytes))


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------- data

@partial(jax.jit, static_argnames=("n", "n_bits"))
def _library(key, n: int, n_bits: int):
    """Families of analogs: super-families, families mutated from them,
    members mutated from families — similarity falls off smoothly, as in
    a real library. Returns packed ``[n, n_bits / 32]`` uint32."""
    import jax.numpy as jnp

    k = jax.random.split(key, 7)
    n_super = max(1, n // 4096)
    n_fam = max(1, n // 64)
    sup = jax.random.bernoulli(k[0], 0.12, (n_super, n_bits))
    fam_of = jax.random.randint(k[1], (n_fam,), 0, n_super)
    fam = jnp.where(jax.random.bernoulli(k[2], 0.3, (n_fam, n_bits)),
                    jax.random.bernoulli(k[3], 0.12, (n_fam, n_bits)),
                    sup[fam_of])
    parent = jax.random.randint(k[4], (n,), 0, n_fam)
    bits = jnp.where(jax.random.bernoulli(k[5], 0.15, (n, n_bits)),
                     jax.random.bernoulli(k[6], 0.12, (n, n_bits)),
                     fam[parent])
    return pack_bits(bits)


def pack_bits(bits):
    """``[n, n_bits]`` bool -> ``[n, n_bits / 32]`` uint32, LSB first."""
    import jax.numpy as jnp

    n, n_bits = bits.shape
    words = bits.reshape(n, n_bits // 32, 32).astype(jnp.uint32)
    return jnp.sum(words << jnp.arange(32, dtype=jnp.uint32), axis=-1,
                   dtype=jnp.uint32)


@dataclasses.dataclass
class Library:
    packed: np.ndarray        # [n, W] uint32, host
    dev: object               # the same rows on the default device
    queries: np.ndarray       # [recall_q, W] held-out analogs
    scores: np.ndarray        # [n] f32: distance to a hidden target + noise
    target: np.ndarray        # [W] the hidden target


def make_library(n: int, n_queries: int, seed: int) -> Library:
    import jax.numpy as jnp

    from rad_tpu.fp.pack import popcount_rows
    from rad_tpu.fp.tanimoto import tanimoto_rows_to_target

    key = jax.random.PRNGKey(seed)
    k_lib, k_q, k_flip, k_noise = jax.random.split(key, 4)
    dev = _library(k_lib, n, N_BITS)
    # queries and the target: library rows with 10% of their bits redrawn
    rows = jax.random.randint(k_q, (n_queries + 1,), 0, n)
    base = jnp.asarray(
        (dev[rows][:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1,
        bool).reshape(n_queries + 1, N_BITS)
    kf1, kf2 = jax.random.split(k_flip)
    mut = jnp.where(jax.random.bernoulli(kf1, 0.1, base.shape),
                    jax.random.bernoulli(kf2, 0.12, base.shape), base)
    mut_packed = pack_bits(mut)
    queries, target = mut_packed[:n_queries], mut_packed[n_queries]
    dist = tanimoto_rows_to_target(dev, popcount_rows(dev), target,
                                   popcount_rows(target[None])[0])
    scores = dist + 0.02 * jax.random.normal(k_noise, (n,))
    return Library(packed=np.asarray(dev), dev=dev,
                   queries=np.asarray(queries),
                   scores=np.asarray(scores, np.float32),
                   target=np.asarray(target))


def table_scorer(table: np.ndarray):
    """Host scoring function: the node's key (its row) looks up the table,
    the way a docking lookup table scores a SMILES."""
    def scoring_fn(smiles: str) -> float:
        return float(table[int(smiles)])
    return scoring_fn


def key_names(n: int):
    """A SMILES store that names each key by its decimal string, so the
    host engine's scorer sees the same strings the device engine's does."""
    from rad_tpu.store.smiles_store import SmilesStore

    class KeyNames(SmilesStore):
        def get_smiles_batch(self, keys):
            return {int(k): str(int(k)) for k in keys}

        def __len__(self):
            return n

    return KeyNames()


def recall_at(found: np.ndarray, truth: np.ndarray) -> float:
    """Share of the true top-k ids found (ties at the k-th distance make
    this understate a correct answer; see :func:`distance_recall_at`)."""
    hits = [len(set(f.tolist()) & set(t.tolist()))
            for f, t in zip(found, truth)]
    return float(np.sum(hits)) / truth.size


def distance_recall_at(queries, db, found: np.ndarray,
                       truth_d: np.ndarray) -> float:
    """Share of found neighbors no farther than the true k-th neighbor
    (ann-benchmarks' distance-based recall): any of several rows tied at
    the k-th distance is a correct answer."""
    from rad_tpu.fp.tanimoto import tanimoto_distance

    rows = jax.numpy.asarray(np.maximum(found, 0))
    d = np.asarray(tanimoto_distance(jax.numpy.asarray(queries)[:, None, :],
                                     db[rows]))
    ok = (found >= 0) & (d <= truth_d[:, -1:])
    return float(ok.sum()) / found.size


def timed(f, *args, reps: int = 10):
    """Median wall time (ms) of ``f(*args)`` over ``reps`` warm calls."""

    jax.block_until_ready(f(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


# ---------------------------------------------------------------- phases

def phase_kernels(lib: Library, size: Size, interpret: bool = False) -> dict:
    """Triton bucket-min keys and the int8 XLA block against the SWAR
    reference at real width. Intersections: bit-equal. Distances (int8 vs
    SWAR, both XLA): equal. Kernel keys: bit-equal to IEEE-divided keys
    on the host, and within one key step of XLA's (XLA on the GPU divides
    with div.full, up to 2 ulp off)."""
    import jax.numpy as jnp

    from rad_tpu.fp.kernels import tanimoto_bucketmin
    from rad_tpu.fp.pack import popcount, popcount_rows
    from rad_tpu.fp.tanimoto import (bucket_keys, tanimoto_matrix,
                                     tanimoto_matrix_int8,
                                     tanimoto_similarity_int8,
                                     unpack_bitmajor)

    q = lib.dev[:size.kernel_q]
    n = lib.dev.shape[0]

    @jax.jit
    def inter_swar(a, b):
        return jnp.sum(popcount(a[:, None, :] & b[None, :, :]), axis=-1,
                       dtype=jnp.int32)

    @jax.jit
    def inter_int8(a, b):
        return jax.lax.dot_general(
            unpack_bitmajor(a), unpack_bitmajor(b),
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)

    kernel = jax.jit(partial(tanimoto_bucketmin, bucket=BUCKET,
                             interpret=interpret))
    xla_keys = jax.jit(lambda a, b: bucket_keys(
        tanimoto_similarity_int8(a, b), BUCKET))
    dist_i8 = jax.jit(tanimoto_matrix_int8)
    dist_sw = jax.jit(tanimoto_matrix)

    compiled = kernel.lower(q, lib.dev).compile()
    log("  [kernels] " + memory_line(compiled))
    keys = compiled(q, lib.dev)

    inter_diff = dist_diff = key_diff = far = exact_diff = 0
    q_pop = np.asarray(popcount_rows(q), np.float32)
    for c0 in range(0, n, size.chunk):
        db = lib.dev[c0:c0 + size.chunk]
        i_sw, i_i8 = inter_swar(q, db), inter_int8(q, db)
        inter_diff += int(jnp.sum(i_sw != i_i8))
        dist_diff += int(jnp.sum(dist_i8(q, db) != dist_sw(q, db)))
        kx = xla_keys(q, db)
        kk = keys[:, c0 // BUCKET:(c0 + db.shape[0]) // BUCKET]
        differ = kk != kx
        key_diff += int(jnp.sum(differ))
        step = jnp.abs((kk & ~(BUCKET - 1)) - (kx & ~(BUCKET - 1)))
        far += int(jnp.sum(differ & (step > BUCKET)))
        # IEEE division on the host, from the (checked) exact counts
        inter = np.asarray(i_i8[:size.exact_q], np.float32)
        union = (q_pop[:size.exact_q, None]
                 + np.asarray(popcount_rows(db), np.float32)[None, :]
                 - inter)
        sim = np.where(union > 0, inter / np.maximum(union, 1.0),
                       np.float32(1.0)).astype(np.float32)
        host = np.asarray(bucket_keys(jnp.asarray(sim), BUCKET))
        exact_diff += int(np.sum(host != np.asarray(kk[:size.exact_q])))

    qb = lib.dev[:size.q_block]
    db = lib.dev[:size.col_block]
    t_kernel = timed(kernel, qb, db)
    t_xla = timed(xla_keys, qb, db)
    t_swar = timed(jax.jit(lambda a, b: bucket_keys(
        1.0 - tanimoto_matrix(a, b), BUCKET)), qb, db)
    pairs = size.kernel_q * n
    log(f"  [kernels] {size.kernel_q} x {n} x {N_BITS} bits: "
        f"intersections int8 != SWAR: {inter_diff} of {pairs}; "
        f"distances int8 != SWAR: {dist_diff}")
    log(f"  [kernels] bucket keys (bucket {BUCKET}): kernel != IEEE host "
        f"({size.exact_q} queries): {exact_diff}; kernel != XLA int8: "
        f"{key_diff} of {keys.size}, beyond one key step: {far}")
    log(f"  [kernels] block {size.q_block} x {size.col_block} bucket keys:"
        f" triton kernel {t_kernel:.4f} ms, XLA int8 {t_xla:.4f} ms, "
        f"XLA SWAR {t_swar:.4f} ms")
    ok = inter_diff == 0 and dist_diff == 0 and exact_diff == 0 and far == 0
    return {"ok": ok, "impl": "triton kernel; XLA int8 and SWAR references",
            "inter_diff": inter_diff, "dist_diff": dist_diff,
            "exact_key_diff": exact_diff, "xla_key_diff": key_diff,
            "kernel_ms": t_kernel, "xla_int8_ms": t_xla,
            "xla_swar_ms": t_swar}


def compare_graphs(a, b, packed: np.ndarray) -> dict:
    """Rows whose neighbor lists differ between two builds of the same
    rows, split by where each row's first difference lies: at a tie (the
    two neighbors are at the same f32 distance from the row), at a near
    tie (within 2 ulp: XLA on the GPU divides with div.full), or
    elsewhere (a difference carried from an earlier tie, or a fault)."""
    from rad_tpu.fp.pack import popcount_rows_np

    keys_a, keys_b = np.asarray(a.keys), np.asarray(b.keys)
    pops = popcount_rows_np(packed)

    def dist(i, j):
        inter = int(popcount_rows_np(packed[i] & packed[j]))
        union = int(pops[i]) + int(pops[j]) - inter
        sim = (np.float32(inter) / np.float32(union) if union
               else np.float32(1.0))
        return np.float32(1.0) - sim

    per_layer, kinds = [], {"tie": 0, "near_tie": 0, "other": 0}
    for la, lb in zip(a.neighbors, b.neighbors):
        ra, rb = np.asarray(la), np.asarray(lb)
        bad = np.flatnonzero(np.any(ra != rb, axis=1))
        per_layer.append(int(bad.size))
        for r in bad:
            j = int(np.argmax(ra[r] != rb[r]))
            ia, ib = int(ra[r, j]), int(rb[r, j])
            if ia < 0 or ib < 0:
                kinds["other"] += 1
                continue
            ulp = abs(int(dist(keys_a[r], keys_a[ia]).view(np.int32))
                      - int(dist(keys_a[r], keys_b[ib]).view(np.int32)))
            kinds["tie" if ulp == 0 else
                  "near_tie" if ulp <= 2 else "other"] += 1
    return {"rows_differing_per_layer": per_layer, "first_difference": kinds,
            "layer0_rows_differing": per_layer[0] / max(len(ra), 1)
            if per_layer else 0.0,
            "keys_equal": bool(np.array_equal(keys_a, keys_b))}


def phase_build(lib: Library, size: Size, interpret: bool = False):
    """1M exact build through ``HNSWIndex``, its kNN recall, and the 100k
    prefix built on the card against the CPU backend."""

    from rad_tpu.api.index import HNSWIndex
    from rad_tpu.build.exact import build_hnsw_exact
    from rad_tpu.fp.backend import tanimoto_impl
    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked

    impl = tanimoto_impl(jax.devices()[0].platform)
    extra = {"interpret": True, "impl": "triton"} if interpret else {}
    idx = HNSWIndex(ndim=N_BITS, connectivity=CONNECTIVITY,
                    expansion_add=EXPANSION_ADD)
    idx.add(np.arange(len(lib.packed)), lib.packed)
    t0 = time.perf_counter()
    g = idx.build(backend="exact", **extra)
    jax.block_until_ready(g.neighbors)
    t_build = time.perf_counter() - t0

    truth_d, truth = bruteforce_topk_blocked(
        jax.numpy.asarray(lib.queries), lib.dev, 10,
        block=min(1 << 16, len(lib.packed)))
    truth, truth_d = np.asarray(truth), np.asarray(truth_d)
    recall, recall_d = {}, {}
    for ef in (32, 128):
        _, found = idx.search(lib.queries, k=10, expansion_search=ef)
        recall[ef] = recall_at(np.asarray(found), truth)
        recall_d[ef] = distance_recall_at(lib.queries, lib.dev,
                                          np.asarray(found), truth_d)

    p = size.prefix
    t0 = time.perf_counter()
    g_card = build_hnsw_exact(lib.packed[:p], connectivity=CONNECTIVITY,
                              seed=idx.seed, **extra)
    jax.block_until_ready(g_card.neighbors)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        g_cpu = build_hnsw_exact(lib.packed[:p], connectivity=CONNECTIVITY,
                                 seed=idx.seed)
        jax.block_until_ready(g_cpu.neighbors)
    t_cpu = time.perf_counter() - t0
    cmp = compare_graphs(g_card, g_cpu, lib.packed[:p])
    log(f"  [build] {len(lib.packed)} nodes, impl {impl if not interpret else 'triton (interpret)'}: "
        f"{t_build:.3f} s ({len(lib.packed) / t_build:.1f} nodes/s), "
        f"{g.max_level + 1} layers; recall@10 (ids) ef32 "
        f"{recall[32]:.4f}, ef128 {recall[128]:.4f}; distance recall@10 "
        f"ef32 {recall_d[32]:.4f}, ef128 {recall_d[128]:.4f}")
    log(f"  [build] prefix {p}: card {t_card:.3f} s, CPU {t_cpu:.3f} s; "
        f"rows differing per layer {cmp['rows_differing_per_layer']}, "
        f"first difference of each: {cmp['first_difference']}")
    # identical apart from ties: every differing row starts at a tie or a
    # near tie, but for a few that a tie upstream carried along (a fault
    # would change most rows)
    other = cmp["first_difference"]["other"]
    ok = (cmp["keys_equal"] and other <= max(1, p // 1000)
          and recall_d[128] >= RECALL_FLOOR)
    return idx, {"ok": ok, "impl": impl, "build_s": t_build,
                 "recall_ef32": recall[32], "recall_ef128": recall[128],
                 "distance_recall_ef32": recall_d[32],
                 "distance_recall_ef128": recall_d[128],
                 "prefix_card_s": t_card, "prefix_cpu_s": t_cpu, **cmp}


def phase_traverse(idx, lib: Library, size: Size) -> dict:
    """The campaign through the user API, and the device engine against
    the host engine (``structures.py``) at batch 1."""
    from rad_tpu.api.factories import create_local_traverser
    from rad_tpu.traverse import device as dev

    scoring_fn = table_scorer(lib.scores)
    names = key_names(len(lib.scores))
    tr = create_local_traverser(idx, scoring_fn)
    t0 = time.perf_counter()
    tr.prime()
    stats = tr.traverse(n_to_score=size.budget)
    best = tr.get_best_molecules(size.best)
    t_run = time.perf_counter() - t0
    eng = tr._device_engine
    compiled = dev.expand.lower(eng.state, eng.dg,
                                batch=eng.batch_size).compile()
    log("  [traverse] " + memory_line(compiled))
    tr.shutdown()
    true_best = set(np.argsort(lib.scores, kind="stable")[:size.best]
                    .tolist())
    keys = np.asarray(idx.graph.keys)
    found = len({int(keys[m[0]]) for m in best} & true_best) / size.best
    n_scored = int(stats["n_scored"])

    def run(**kw):
        t = create_local_traverser(idx, scoring_fn, smiles_store=names,
                                   **kw)
        t.prime()
        t.traverse(n_to_score=size.parity_budget)
        mols = t.get_molecules()
        t.shutdown()
        return [(int(m[0]), float(m[1])) for m in mols]

    device = run(batch_size=1, head_capacity=None)
    host = run(engine="host")
    common = min(len(device), len(host))
    same = device[:common] == host[:common]
    log(f"  [traverse] scored {n_scored} (budget {size.budget}) in "
        f"{t_run:.3f} s; top-{size.best} found: {found:.4f}; batch-1 "
        f"device vs host engine: first {common} scored "
        f"{'identical in order' if same else 'DIFFER'}")
    ok = same and n_scored >= size.budget and common >= size.parity_budget
    return {"ok": ok, "impl": "DeviceTraverser", "n_scored": n_scored,
            "campaign_s": t_run, "top_found": found,
            "parity_common": common}


def phase_device_scored(idx, lib: Library, size: Size) -> dict:
    """``fused_run`` and ``traverse_with_callback`` against the stepwise
    ``DeviceTraverser`` on one score table (distance to the target,
    computed on the device)."""
    import jax.numpy as jnp

    from rad_tpu.api.factories import create_local_traverser
    from rad_tpu.fp.pack import popcount_rows
    from rad_tpu.fp.tanimoto import tanimoto_rows_to_target
    from rad_tpu.traverse import device as dev
    from rad_tpu.traverse.callback import (make_callback_scorer,
                                           traverse_with_callback)

    g = idx.graph
    packed, pops = jnp.asarray(g.packed), jnp.asarray(g.popcounts)
    target = jnp.asarray(lib.target)
    t_pop = popcount_rows(target[None])[0]
    # scores by node id on the device; the host scorer looks them up by key
    table_by_id = np.asarray(tanimoto_rows_to_target(packed, pops, target,
                                                     t_pop))
    keys = np.asarray(g.keys)
    by_key = np.empty(len(keys), np.float32)
    by_key[keys] = table_by_id
    scoring_fn = table_scorer(by_key)
    batch = 32

    tr = create_local_traverser(idx, scoring_fn, batch_size=batch,
                                head_capacity=None)
    tr.prime()
    tr.traverse(n_to_score=size.budget)
    ref = [(int(m[0]), float(m[1])) for m in tr.get_molecules()]
    dg = tr._device_engine.dg
    tr.shutdown()

    n_top = g.layer_sizes[g.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    seeds = jnp.asarray(table_by_id[:n_top])

    def fresh():  # the DeviceTraverser's own configuration
        return dev.prime(dev.init_state(dg, head_capacity=None), dg, ids,
                         seeds)

    t0 = time.perf_counter()
    compiled = dev.fused_run.lower(fresh(), dg, packed, pops, target, t_pop,
                                   jnp.int32(size.budget),
                                   batch=batch).compile()
    log("  [device-scored] fused_run " + memory_line(compiled))
    st = compiled(fresh(), dg, packed, pops, target, t_pop,
                  jnp.int32(size.budget))
    t_fused = time.perf_counter() - t0

    def mols(state):
        n = int(state.n_scored)
        order = np.asarray(state.order_log)[:n]
        return [(int(i), float(s)) for i, s in
                zip(order, np.asarray(state.scores)[order])]

    fused = mols(st)
    t0 = time.perf_counter()
    st_cb, steps = traverse_with_callback(
        fresh(), dg, make_callback_scorer(g, scoring_fn), size.budget,
        batch=batch)
    cb = mols(st_cb)
    t_cb = time.perf_counter() - t0
    log(f"  [device-scored] {len(ref)} scored: fused_run "
        f"{'==' if fused == ref else '!='} DeviceTraverser ({t_fused:.3f} s"
        f" with compile); io_callback loop {'==' if cb == ref else '!='} "
        f"DeviceTraverser ({steps} steps, {t_cb:.3f} s)")
    ok = fused == ref and cb == ref
    return {"ok": ok, "impl": "fused_run; io_callback while_loop",
            "n_scored": len(ref), "fused_s": t_fused, "callback_s": t_cb}


def phase_knn_server(idx, lib: Library, size: Size) -> dict:
    """``search_device`` recall against brute force on the card, and the
    HTTP server in a thread of this process."""

    from rad_tpu.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu.search.knn import search_device
    from rad_tpu.server.http_server import create_hnsw_server

    g = idx.graph
    truth_d, truth = bruteforce_topk_blocked(
        jax.numpy.asarray(lib.queries), lib.dev, 10,
        block=min(1 << 16, len(lib.packed)))
    truth, truth_d = np.asarray(truth), np.asarray(truth_d)
    keys = np.asarray(g.keys)
    out = {}
    for ef in (32, 128):
        t0 = time.perf_counter()
        _, ids = search_device(g, lib.queries, k=10, expansion_search=ef)
        ids = np.asarray(ids)
        dt = time.perf_counter() - t0
        found = np.where(ids >= 0, keys[np.maximum(ids, 0)], -1)
        out[ef] = (recall_at(found, truth), dt,
                   distance_recall_at(lib.queries, lib.dev, found, truth_d))

    server, _ = create_hnsw_server(g, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            health = json.loads(r.read())
        answers = []
        for node in (0, 1, len(g) - 1):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/neighbors/{node}/0",
                    timeout=30) as r:
                body = json.loads(r.read())
            want = np.asarray(g.neighbors[0][node])
            answers.append(len(body["neighbors"]) // 2
                           == int((want >= 0).sum()))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"  [knn] recall@10 (ids; distance) ef32 {out[32][0]:.4f}; "
        f"{out[32][2]:.4f} ({out[32][1]:.3f} s), ef128 {out[128][0]:.4f}; "
        f"{out[128][2]:.4f} ({out[128][1]:.3f} s) for "
        f"{len(lib.queries)} queries; server /health "
        f"{health.get('status')}, /neighbors answered {sum(answers)} of "
        f"{len(answers)}")
    ok = (health.get("status") == "healthy" and all(answers)
          and out[128][2] >= RECALL_FLOOR)
    return {"ok": ok, "impl": "search_device; ThreadingHTTPServer",
            "recall_ef32": out[32][0], "recall_ef128": out[128][0],
            "distance_recall_ef32": out[32][2],
            "distance_recall_ef128": out[128][2]}


def phase_four(size: Size, seed: int, devices, interpret: bool = False
               ) -> dict:
    """Pod traversal over a graph row-sharded on the devices, against one
    device, and the mesh-sharded exact build against one device."""
    from rad_tpu.build.exact import build_hnsw_exact
    from rad_tpu.graph.storage import HNSWGraph
    from rad_tpu.parallel.pod import PodTraverser
    from rad_tpu.traverse.driver import DeviceTraverser
    from jax.sharding import Mesh

    extra = {"interpret": True, "impl": "triton"} if interpret else {}
    mesh = Mesh(np.asarray(devices), ("graph",))
    lib = make_library(size.four_n, 16, seed)
    t0 = time.perf_counter()
    g = build_hnsw_exact(lib.packed, connectivity=CONNECTIVITY, seed=seed,
                         mesh=mesh, **extra)
    jax.block_until_ready(g.neighbors)
    t_graph = time.perf_counter() - t0
    # one host copy, placed anew by each engine
    g = HNSWGraph(packed=np.asarray(g.packed),
                  popcounts=np.asarray(g.popcounts), keys=np.asarray(g.keys),
                  levels=np.asarray(g.levels),
                  neighbors=tuple(np.asarray(t) for t in g.neighbors),
                  ndim=g.ndim, connectivity=g.connectivity)
    scoring_fn = table_scorer(lib.scores)
    batch = 32

    pod = PodTraverser(g, scoring_fn=scoring_fn, mesh=mesh,
                       batch_size=batch, n_score_threads=1)
    pod.prime()
    t0 = time.perf_counter()
    pod.traverse(n_to_score=size.budget)
    t_pod = time.perf_counter() - t0
    in_use = [d.memory_stats().get("bytes_in_use", -1)
              if d.memory_stats() else -1 for d in devices]
    pod_mols = [(int(m[0]), float(m[1])) for m in pod.get_molecules()]
    pod.shutdown()

    with jax.default_device(devices[0]):
        one = DeviceTraverser(g, scoring_fn, batch_size=batch,
                              n_score_threads=1)
        one.prime()
        t0 = time.perf_counter()
        one.traverse(n_to_score=size.budget)
        t_one = time.perf_counter() - t0
        one_mols = [(int(m[0]), float(m[1])) for m in one.get_molecules()]
        one.shutdown()
    same_traverse = set(pod_mols) == set(one_mols)

    nb = size.four_build_n
    t0 = time.perf_counter()
    g_mesh = build_hnsw_exact(lib.packed[:nb], connectivity=CONNECTIVITY,
                              seed=seed, mesh=mesh, **extra)
    jax.block_until_ready(g_mesh.neighbors)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    with jax.default_device(devices[0]):
        g_one = build_hnsw_exact(lib.packed[:nb], connectivity=CONNECTIVITY,
                                 seed=seed, **extra)
        jax.block_until_ready(g_one.neighbors)
    t_single = time.perf_counter() - t0
    same_build = (np.array_equal(np.asarray(g_mesh.keys),
                                 np.asarray(g_one.keys))
                  and all(np.array_equal(np.asarray(a), np.asarray(b))
                          for a, b in zip(g_mesh.neighbors,
                                          g_one.neighbors)))
    log(f"  [four] graph of {size.four_n} nodes built on {len(devices)} "
        f"devices in {t_graph:.3f} s; bytes_in_use per device during the "
        f"pod run: {in_use}")
    log(f"  [four] PodTraverser {len(pod_mols)} scored in {t_pod:.3f} s vs"
        f" one device {len(one_mols)} in {t_one:.3f} s: scored sets "
        f"{'identical' if same_traverse else 'DIFFER'}")
    log(f"  [four] exact build of {nb}: mesh {t_mesh:.3f} s vs one device "
        f"{t_single:.3f} s: edges "
        f"{'identical' if same_build else 'DIFFER'}")
    return {"ok": same_traverse and same_build, "impl": "shard_map mesh",
            "bytes_in_use": in_use, "pod_s": t_pod, "one_s": t_one,
            "mesh_build_s": t_mesh, "one_build_s": t_single}


# ------------------------------------------------------------------ driver

def run_phase(name: str, clock: CompileClock, results: dict, fn, *args):
    log(f"phase {name}: start")
    c0, t0 = clock.total, time.perf_counter()
    try:
        out = fn(*args)
    except Exception:
        traceback.print_exc()
        out = None
        results[name] = {"ok": False, "error": traceback.format_exc(-1)}
    wall = time.perf_counter() - t0
    res = out[1] if isinstance(out, tuple) else out
    if res is not None:
        results[name] = res
    stats = jax.devices()[0].memory_stats() or {}
    log(f"phase {name}: {'ok' if results[name]['ok'] else 'FAILED'}; "
        f"wall {wall:.3f} s, compile {clock.total - c0:.3f} s, impl "
        f"{results[name].get('impl', '-')}, peak device bytes "
        f"{stats.get('peak_bytes_in_use', 'n/a')}")
    return out[0] if isinstance(out, tuple) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card pod phase")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    devices = devices[:want]

    from rad_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock.listener)
    log(f"device_kind {devices[0].device_kind}, count {len(devices)}")
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; compile cache {cache}")

    results: dict = {}
    size = FULL
    if args.four:
        run_phase("four", clock, results, phase_four, size, args.seed,
                  devices)
    else:
        t0 = time.perf_counter()
        lib = make_library(size.n, size.recall_q, args.seed)
        log(f"library: {size.n} x {N_BITS}-bit fingerprints from seed "
            f"{args.seed} in {time.perf_counter() - t0:.3f} s")
        run_phase("kernels", clock, results, phase_kernels, lib, size)
        idx = run_phase("build", clock, results, phase_build, lib, size)
        if idx is not None:
            run_phase("traverse", clock, results, phase_traverse, idx, lib,
                      size)
            run_phase("device-scored", clock, results, phase_device_scored,
                      idx, lib, size)
            run_phase("knn", clock, results, phase_knn_server, idx, lib,
                      size)
    failed = sorted(k for k, r in results.items() if not r["ok"])
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
