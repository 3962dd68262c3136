"""Bit-packed adjacency (rad_tpu.graph.adjpack): encoding roundtrip and
engine bit-identity with the int32 table.

The packed table is a single-card scale lever: same traversal,
12.5-37.5% less adjacency memory. Correctness bar: unpack(pack(x)) == x for every field width, and the
device engine over a packed DeviceGraph reproduces the int32 engine's
scored set, scores, and discovery order EXACTLY.
"""

import numpy as np
import pytest

from rad_tpu.graph.adjpack import (
    adj_bits_for,
    adj_group_for,
    pack_adjacency_numpy,
    pack_adjacency_rows,
    packed_adj_words,
    unpack_adjacency_rows,
)


def test_adj_group_minor_dim_multiple_of_8():
    # the 200M config: 16 fields x 28 bits = 14 words -> G=4, 56 words
    assert adj_group_for(16, 28) == 4
    # already a multiple of 8 words: no grouping
    assert adj_group_for(16, 16) == 1
    for m0 in (1, 5, 8, 12, 16):
        for bits in (8, 10, 17, 20, 28, 31):
            g = adj_group_for(m0, bits)
            assert (g * packed_adj_words(m0, bits)) % 8 == 0


def _random_adj(r, m0, n_ids, seed, frac_pad=0.3):
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n_ids, (r, m0), dtype=np.int64).astype(np.int32)
    adj[rng.random((r, m0)) < frac_pad] = -1
    return adj


@pytest.mark.parametrize("bits", [8, 17, 20, 28, 31])
def test_pack_roundtrip(bits):
    """Every width, including word-boundary-crossing ones (17, 20, 28)."""
    m0 = 16
    n_ids = min((1 << bits) - 1, 10_000)
    adj = _random_adj(64, m0, n_ids, seed=bits)
    packed_np = pack_adjacency_numpy(adj, bits)
    assert packed_np.shape == (64, packed_adj_words(m0, bits))
    packed_j = np.asarray(pack_adjacency_rows(adj, bits))
    np.testing.assert_array_equal(packed_np, packed_j)
    back = np.asarray(unpack_adjacency_rows(packed_j, m0, bits))
    np.testing.assert_array_equal(back, adj)


def test_pack_roundtrip_odd_m0():
    for m0 in (1, 5, 12):
        adj = _random_adj(32, m0, 500, seed=m0)
        back = np.asarray(unpack_adjacency_rows(
            pack_adjacency_rows(adj, 10), m0, 10))
        np.testing.assert_array_equal(back, adj)


def test_adj_bits_for_sentinel_headroom():
    # the all-ones value is the -1 sentinel: n ids need n <= 2**bits - 1
    assert adj_bits_for(15) == 4      # ids 0..14, sentinel 15
    assert adj_bits_for(16) == 5      # id 15 would collide at 4 bits
    assert adj_bits_for(200_000_000) == 28
    assert adj_bits_for(1) == 1


def test_pack_numpy_rejects_overflow():
    adj = np.full((2, 4), (1 << 8) - 1, np.int32)  # == the 8-bit sentinel
    with pytest.raises(ValueError):
        pack_adjacency_numpy(adj, 8)


@pytest.mark.slow
def test_packed_engine_bit_identical():
    """Full device sweep over a packed DeviceGraph == the int32 engine:
    same scored count, same scores, same discovery order."""
    import jax.numpy as jnp

    from rad_tpu.build.reference import build_hnsw
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.fp.pack import popcount_rows
    from rad_tpu.fp.tanimoto import tanimoto_matrix
    from rad_tpu.traverse import device as dev

    fps = random_fingerprints(600, n_bits=64, density=0.3, seed=31)
    graph = build_hnsw(fps, connectivity=4, expansion_add=24, seed=7)
    dg = dev.prepare_device_graph(graph)
    dg_packed = dev.pack_device_graph(dg, chunk=128)
    assert dg_packed.adj_bits == adj_bits_for(600) == 10
    assert dg_packed.adj.dtype == jnp.uint32
    # grouped storage: G rows per table row, minor dim a multiple of 8
    # words (XLA pads HBM minor dims to 8-element multiples — an
    # ungrouped [R, W] table would silently cost ceil8(W) words/row)
    g = adj_group_for(dg.m0, 10)
    w = packed_adj_words(dg.m0, 10)
    assert dg_packed.adj_group == g
    assert dg_packed.adj.shape == (-(-dg.adj.shape[0] // g), g * w)
    assert (g * w) % 8 == 0

    packed = jnp.asarray(np.asarray(graph.packed))
    pops = jnp.asarray(np.asarray(graph.popcounts))
    target = jnp.asarray(fps[11])
    t_pop = popcount_rows(target[None, :])[0]
    n_top = graph.layer_sizes[graph.max_level]
    seeds = tanimoto_matrix(target[None, :], packed[:n_top])[0]

    def sweep(g):
        st = dev.init_state(g)
        st = dev.prime(st, g, jnp.arange(n_top, dtype=jnp.int32), seeds)
        return dev.fused_run(st, g, packed, pops, target, t_pop,
                             jnp.int32(600), batch=8)

    a = sweep(dg)
    b = sweep(dg_packed)
    assert int(a.n_scored) == int(b.n_scored) > 0
    np.testing.assert_array_equal(np.asarray(a.scored), np.asarray(b.scored))
    np.testing.assert_array_equal(np.asarray(a.scores), np.asarray(b.scores))
    np.testing.assert_array_equal(np.asarray(a.order_log),
                                  np.asarray(b.order_log))


@pytest.mark.slow
def test_driver_packed_adjacency_identical():
    """DeviceTraverser(packed_adjacency=True) — the user-facing knob —
    reproduces the unpacked engine's molecules and discovery order."""
    from rad_tpu.build.reference import build_hnsw
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.store.smiles_store import InMemorySmilesStore
    from rad_tpu.traverse.driver import DeviceTraverser

    n = 150
    fps = random_fingerprints(n, n_bits=64, density=0.3, seed=5)
    graph = build_hnsw(fps, connectivity=4, expansion_add=20, seed=2)
    keys = np.asarray(graph.keys)
    rng = np.random.default_rng(0)
    table = {int(k): float(s) for k, s in
             zip(keys, rng.permutation(n).astype(float))}
    store = InMemorySmilesStore({int(k): f"SMI_{int(k)}" for k in keys})
    scoring_fn = lambda s: table[int(s.split("_")[1])]

    mols = {}
    for packed in (False, True):
        tr = DeviceTraverser(graph, scoring_fn, store, batch_size=4,
                             n_score_threads=1, packed_adjacency=packed)
        if packed:
            assert tr.dg.adj_bits == adj_bits_for(n)
        tr.prime()
        tr.traverse(n_to_score=10**9, timeout=120)
        mols[packed] = tr.get_molecules()
        tr.shutdown()
    assert mols[True] == mols[False]
    assert len(mols[True]) > 100


def test_pack_device_graph_noop_when_wide():
    import jax.numpy as jnp

    from rad_tpu.traverse.device import DeviceGraph, pack_device_graph

    dg = DeviceGraph(adj=jnp.zeros((4, 2), jnp.int32),
                     offsets=jnp.zeros(3, jnp.int32),
                     n_nodes=4, n_rows=4, m0=2, max_level=0)
    assert pack_device_graph(dg, bits=32) is dg
    already = pack_device_graph(dg, bits=8)
    assert pack_device_graph(already, bits=8) is already


def test_prepare_device_graph_host_packing_matches_device_packing():
    """prepare_device_graph(packed_adjacency=True) packs on the HOST
    (the int32 table never touches the device — required past the int32
    HBM ceiling) and must produce the same grouped table as packing the
    uploaded int32 graph with pack_device_graph."""
    import jax.numpy as jnp

    from rad_tpu.build.reference import build_hnsw
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.traverse import device as dev

    fps = random_fingerprints(500, n_bits=128, density=0.25, seed=5)
    graph = build_hnsw(fps, connectivity=5, expansion_add=32, seed=2)
    dg_host = dev.prepare_device_graph(graph, packed_adjacency=True)
    dg_dev = dev.pack_device_graph(dev.prepare_device_graph(graph),
                                   chunk=64)
    assert dg_host.adj_bits == dg_dev.adj_bits
    assert dg_host.adj_group == dg_dev.adj_group
    assert dg_host.adj.dtype == jnp.uint32
    np.testing.assert_array_equal(np.asarray(dg_host.adj),
                                  np.asarray(dg_dev.adj))


def test_prepare_device_graph_wide_bits_stays_unpacked():
    """A resolved field width >= 32 cannot shrink the table; the host
    packer must leave it unpacked instead of emitting grouped uint32 rows
    the engine would read via the int32 path (silent traversal
    corruption; review r3s9). Same guard in shard_graph."""
    import jax.numpy as jnp

    from rad_tpu.build.reference import build_hnsw
    from rad_tpu.fp import random_fingerprints
    from rad_tpu.traverse import device as dev

    fps = random_fingerprints(300, n_bits=128, density=0.25, seed=9)
    graph = build_hnsw(fps, connectivity=6, expansion_add=24, seed=1)
    for width in (32, 40):
        dg = dev.prepare_device_graph(graph, packed_adjacency=width)
        assert (dg.adj_bits, dg.adj_group) == (32, 1)
        assert dg.adj.dtype == jnp.int32

    import jax

    from rad_tpu.parallel import make_mesh
    from rad_tpu.parallel.sharded import shard_graph
    mesh = make_mesh(len(jax.devices()), axis_names=("graph",))
    sg = shard_graph(graph, mesh, packed_adjacency=32)
    assert (sg.adj_bits, sg.adj_group) == (32, 1)
    assert np.dtype(sg.adj.dtype) == np.int32
