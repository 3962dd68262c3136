"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The analogue of the reference's no-cluster multi-node testing strategy
(SURVEY.md §4): pod behavior exercised on one host."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints, popcount_rows
from rad_tpu.fp.tanimoto import bruteforce_topk, tanimoto_matrix
from rad_tpu.parallel import (
    make_mesh,
    shard_graph,
    sharded_bruteforce_topk,
)
from rad_tpu.parallel.sharded import make_sharded_step
from rad_tpu.traverse import device as dev


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh(8, axis_names=("graph",))


@pytest.fixture(scope="module")
def built():
    fps = random_fingerprints(300, n_bits=128, density=0.25, seed=31)
    graph = build_hnsw(fps, connectivity=6, expansion_add=40, seed=4)
    return graph


def test_make_mesh_shapes():
    m1 = make_mesh(4)
    assert m1.shape == {"graph": 4}
    m2 = make_mesh((2, 4), axis_names=("data", "graph"))
    assert m2.shape == {"data": 2, "graph": 4}
    with pytest.raises(ValueError):
        make_mesh(9)


def test_shard_graph_layout(mesh, built):
    sg = shard_graph(built, mesh)
    assert sg.n_pad_nodes % 8 == 0
    assert sg.n_pad_rows % 8 == 0
    assert sg.n_nodes == len(built)
    # padded tails are inert (-1 adjacency, zero fingerprints)
    adj = np.asarray(sg.adj)
    assert (adj[sg.n_rows:] == -1).all()


def test_sharded_bruteforce_matches_dense(mesh, built):
    sg = shard_graph(built, mesh)
    queries = random_fingerprints(6, n_bits=128, density=0.25, seed=90)
    d_sh, i_sh = sharded_bruteforce_topk(sg, queries, k=8, mesh=mesh)
    d_ref, i_ref = bruteforce_topk(
        jnp.asarray(queries), jnp.asarray(np.asarray(built.packed)), 8)
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref), atol=1e-6)
    # ids may differ on exact ties; distances must agree


def test_pod_traverser_lifecycle(mesh, built):
    from rad_tpu.parallel.pod import PodTraverser

    target = random_fingerprints(1, n_bits=128, density=0.25, seed=77)[0]
    pod = PodTraverser(built, target, mesh=mesh, batch_size=8,
                       frontier_capacity=1 << 10)
    with pytest.raises(RuntimeError):
        pod.traverse(n_to_score=5)
    n_top = pod.prime()
    stats = pod.traverse(n_to_score=120, timeout=120)
    assert stats["n_scored"] >= 120
    mols = pod.get_molecules()
    ids = [m[0] for m in mols]
    assert len(ids) == len(set(ids))
    best = pod.get_best_molecules(5)
    assert [m[1] for m in best] == sorted(m[1] for m in mols)[:5]
    # traversal prioritizes molecules similar to the target: the best found
    # should be much closer than the library median
    all_scores = [m[1] for m in mols]
    assert best[0][1] < np.median(all_scores)


@pytest.mark.slow
def test_fully_sharded_state_matches_replicated(mesh, built):
    """Graph AND state sharded (billion-molecule layout) must reproduce the
    replicated-state pod step exactly."""
    from rad_tpu.parallel.sharded import (init_state_sharded,
                                          make_sharded_step_full)

    graph = built
    n = len(graph)
    target = random_fingerprints(1, n_bits=128, density=0.25, seed=55)[0]
    t_packed = jnp.asarray(target)
    t_pop = popcount_rows(t_packed[None, :])[0]
    sg = shard_graph(graph, mesh)
    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    seed_scores = jnp.asarray(np.asarray(tanimoto_matrix(
        jnp.asarray(target[None, :]),
        jnp.asarray(np.asarray(graph.packed)[:n_top])))[0])

    # replicated-state reference
    dg = dev.prepare_device_graph(graph)
    s1 = dev.prime(dev.init_state(dg, frontier_capacity=1 << 10), dg, ids,
                   seed_scores)
    step1 = make_sharded_step(sg, mesh, batch=8)
    for _ in range(10):
        s1 = step1(s1, t_packed, t_pop)

    # fully sharded
    dg_pad = sg.device_graph()
    dg_pad = type(dg_pad)(adj=dg_pad.adj, offsets=dg_pad.offsets,
                          n_nodes=sg.n_pad_nodes, n_rows=sg.n_pad_rows,
                          m0=sg.m0, max_level=sg.max_level)
    s2 = init_state_sharded(sg, mesh, frontier_capacity=1 << 10,
                            log_capacity=n)
    s2 = dev.prime(s2, dg_pad, ids, seed_scores)
    step2 = make_sharded_step_full(sg, mesh, batch=8)
    for _ in range(10):
        s2 = step2(s2, t_packed, t_pop)

    assert int(s1.n_scored) == int(s2.n_scored) > n_top
    np.testing.assert_array_equal(np.asarray(s1.order_log),
                                  np.asarray(s2.order_log))
    np.testing.assert_array_equal(np.asarray(s1.scored),
                                  np.asarray(s2.scored)[:n])
    np.testing.assert_allclose(np.asarray(s1.scores),
                               np.asarray(s2.scores)[:n], atol=1e-6)
    np.testing.assert_array_equal(np.asarray(s1.enqueued),
                                  np.asarray(s2.enqueued)[:dg.n_rows])
    np.testing.assert_allclose(np.asarray(s1.f_score),
                               np.asarray(s2.f_score), atol=1e-6)
    # state really is sharded across the mesh
    assert len(s2.scored.sharding.device_set) == 8


def test_pod_traverser_shard_state(mesh, built):
    """shard_state=True produces the same molecules as the default pod."""
    from rad_tpu.parallel.pod import PodTraverser

    target = random_fingerprints(1, n_bits=128, density=0.25, seed=77)[0]
    results = []
    for shard_state in (False, True):
        pod = PodTraverser(built, target, mesh=mesh, batch_size=8,
                           frontier_capacity=1 << 10,
                           shard_state=shard_state)
        pod.prime()
        pod.traverse(n_to_score=100, timeout=120)
        results.append(pod.get_molecules())
    assert results[0] == results[1]


def test_pod_traverser_custom_scorer(mesh, built):
    """A user-supplied jittable surrogate drives the sharded traversal."""
    from rad_tpu.parallel.pod import PodTraverser

    target = random_fingerprints(1, n_bits=128, density=0.25, seed=78)[0]

    def weird_scorer(fp_rows, pop_rows, target_packed, target_pop):
        # popcount parity surrogate — arbitrary but deterministic/jittable
        return (pop_rows % 7).astype(jnp.float32)

    pod = PodTraverser(built, target, mesh=mesh, batch_size=8,
                       frontier_capacity=1 << 10, scorer=weird_scorer)
    pod.prime()
    pod.traverse(n_to_score=60, timeout=60)
    mols = pod.get_molecules()
    assert len(mols) >= 60
    # scores produced by the surrogate, except the primed seeds (which the
    # prime path scores with the default target distance)
    n_top = built.layer_sizes[built.max_level]
    assert all(m[1] == float(int(m[1])) and 0 <= m[1] < 7
               for m in mols[n_top:])


def test_sharded_beam_search_matches_single_device(mesh, built):
    """Graph-sharded kNN beam must return the same results as the
    single-device jitted search."""
    from rad_tpu.parallel.sharded import make_sharded_search
    from rad_tpu.search.knn import search_device

    sg = shard_graph(built, mesh)
    queries = random_fingerprints(8, n_bits=128, density=0.25, seed=61)
    search = make_sharded_search(sg, mesh, k=5, ef=32, batch=8)
    d_sh, i_sh = search(jnp.asarray(queries))
    d_ref, i_ref = search_device(built, queries, k=5, expansion_search=32)
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref),
                               atol=1e-5)
    # id-level agreement modulo exact distance ties
    d_sh, i_sh, i_ref = map(np.asarray, (d_sh, i_sh, i_ref))
    for b in range(8):
        tie_free = np.ones(5, bool)
        vals, counts = np.unique(np.round(d_sh[b], 6), return_counts=True)
        dup = set(vals[counts > 1].tolist())
        tie_free = ~np.isin(np.round(d_sh[b], 6), list(dup))
        np.testing.assert_array_equal(i_sh[b][tie_free], i_ref[b][tie_free])


@pytest.mark.slow
def test_sharded_traversal_matches_single_device(mesh, built):
    """The pod step must produce bit-identical traversal state to the
    single-device fused step."""
    graph = built
    target = random_fingerprints(1, n_bits=128, density=0.25, seed=55)[0]
    t_packed = jnp.asarray(target)
    t_pop = popcount_rows(t_packed[None, :])[0]

    # single-device reference
    dg = dev.prepare_device_graph(graph)
    packed = jnp.asarray(np.asarray(graph.packed))
    pops = jnp.asarray(np.asarray(graph.popcounts))
    state1 = dev.init_state(dg, frontier_capacity=1 << 10)
    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    seed_scores = np.asarray(tanimoto_matrix(
        jnp.asarray(target[None, :]),
        jnp.asarray(np.asarray(graph.packed)[:n_top])))[0]
    state1 = dev.prime(state1, dg, ids, jnp.asarray(seed_scores))
    for _ in range(12):
        state1 = dev.fused_step(state1, dg, packed, pops, t_packed, t_pop,
                                batch=4)

    # sharded
    sg = shard_graph(graph, mesh)
    step = make_sharded_step(sg, mesh, batch=4)
    state2 = dev.init_state(dg, frontier_capacity=1 << 10)
    state2 = dev.prime(state2, dg, ids, jnp.asarray(seed_scores))
    for _ in range(12):
        state2 = step(state2, t_packed, t_pop)

    assert int(state1.n_scored) == int(state2.n_scored) > n_top
    np.testing.assert_array_equal(np.asarray(state1.scored),
                                  np.asarray(state2.scored))
    np.testing.assert_allclose(np.asarray(state1.scores),
                               np.asarray(state2.scores), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(state1.order_log),
                                  np.asarray(state2.order_log))
    np.testing.assert_array_equal(np.asarray(state1.enqueued),
                                  np.asarray(state2.enqueued))
    # frontier contents identical
    np.testing.assert_allclose(np.asarray(state1.f_score),
                               np.asarray(state2.f_score), atol=1e-6)


def test_sharded_search_2d_matches_1d(built):
    """(data x graph) 2-D mesh: query-sharded search returns the same
    results as the replicated-query 1-D search over the same graph."""
    from rad_tpu.parallel import make_mesh
    from rad_tpu.parallel.sharded import (make_sharded_search,
                                          make_sharded_search_2d,
                                          shard_graph)

    mesh2d = make_mesh((2, 4), axis_names=("data", "graph"))
    sg2 = shard_graph(built, mesh2d)          # graph axis only
    mesh1d = make_mesh(8, axis_names=("graph",))
    sg1 = shard_graph(built, mesh1d)

    queries = np.asarray(built.packed)[:16]   # divides data axis (2)
    s2 = make_sharded_search_2d(sg2, mesh2d, k=4, ef=16, batch=16)
    s1 = make_sharded_search(sg1, mesh1d, k=4, ef=16, batch=16)
    d2, i2 = s2(jnp.asarray(queries))
    d1, i1 = s1(jnp.asarray(queries))
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d1), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i1))
    # self-queries: top-1 is the query itself
    assert (np.asarray(d2)[:, 0] == 0).all()
    assert np.asarray(i2)[:, 0].tolist() == list(range(16))


@pytest.mark.slow
def test_traffic_counters_match_host_recount(mesh, built):
    """traffic=True instrumentation (hub-imbalance probe, SURVEY §7 hard
    part 6): per-shard counts must equal a host recount from the
    single-device engine's expand outputs, and must not perturb the state."""
    from rad_tpu.parallel import TrafficMeter

    graph = built
    target = random_fingerprints(1, n_bits=128, density=0.25, seed=55)[0]
    t_packed = jnp.asarray(target)
    t_pop = popcount_rows(t_packed[None, :])[0]
    dg = dev.prepare_device_graph(graph)
    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    seed_scores = np.asarray(tanimoto_matrix(
        jnp.asarray(target[None, :]),
        jnp.asarray(np.asarray(graph.packed)[:n_top])))[0]

    sg = shard_graph(graph, mesh)
    nd = 8
    adj_shard = sg.n_pad_rows // nd
    fp_shard = sg.n_pad_nodes // nd

    step_t = make_sharded_step(sg, mesh, batch=4, traffic=True)
    step_plain = make_sharded_step(sg, mesh, batch=4)

    st_t = dev.prime(dev.init_state(dg, frontier_capacity=1 << 10),
                     dg, ids, jnp.asarray(seed_scores))
    st_p = dev.prime(dev.init_state(dg, frontier_capacity=1 << 10),
                     dg, ids, jnp.asarray(seed_scores))
    # host-side oracle: the single-device stepwise engine yields the same
    # expand outputs; recount shard ownership from them
    st_h = dev.prime(dev.init_state(dg, frontier_capacity=1 << 10),
                     dg, ids, jnp.asarray(seed_scores))
    packed = jnp.asarray(np.asarray(graph.packed))
    pops = jnp.asarray(np.asarray(graph.popcounts))
    offsets = np.asarray(dg.offsets)

    meter = TrafficMeter(nd)
    exp_adj = np.zeros(nd, np.int64)
    exp_fp = np.zeros(nd, np.int64)
    for _ in range(10):
        st_t, traffic = step_t(st_t, t_packed, t_pop)
        meter.add(traffic)
        st_p = step_plain(st_p, t_packed, t_pop)

        st_h, out = dev.expand(st_h, dg, 4)
        ts = np.asarray(out["to_score"])
        ok = ts >= 0
        node = np.asarray(out["exp_node"])
        lvl = np.asarray(out["exp_level"])
        val = np.asarray(out["exp_valid"])
        rows = offsets[np.maximum(lvl, 0)] + np.maximum(node, 0)
        np.add.at(exp_adj, rows[val] // adj_shard, 1)
        np.add.at(exp_fp, ts[ok] // fp_shard, 1)
        # score with the same scorer and integrate to stay in lockstep
        inter = np.asarray(tanimoto_matrix(
            t_packed[None, :], packed[np.maximum(ts, 0)]))[0]
        scores = jnp.asarray(np.where(ok, inter, np.inf), jnp.float32)
        st_h = dev.integrate(st_h, dg, out["exp_node"], out["exp_level"],
                             out["exp_score"], out["exp_valid"],
                             out["cand"], out["to_score"], scores)

    stats = meter.stats()
    assert stats["steps"] == 10
    np.testing.assert_array_equal(np.asarray(meter.adj_rows), exp_adj)
    np.testing.assert_array_equal(np.asarray(meter.fp_rows), exp_fp)
    assert stats["adj_imbalance"] >= 1.0
    # instrumentation must not change the traversal
    np.testing.assert_array_equal(np.asarray(st_t.scored),
                                  np.asarray(st_p.scored))
    np.testing.assert_array_equal(np.asarray(st_t.order_log),
                                  np.asarray(st_p.order_log))


def test_traffic_counters_fully_sharded(mesh, built):
    """traffic=True on the fully-state-sharded step agrees with the
    replicated-state step's counters."""
    from rad_tpu.parallel import TrafficMeter
    from rad_tpu.parallel.sharded import (init_state_sharded,
                                          make_sharded_step_full)
    from rad_tpu.traverse.device import DeviceGraph

    graph = built
    target = random_fingerprints(1, n_bits=128, density=0.25, seed=55)[0]
    t_packed = jnp.asarray(target)
    t_pop = popcount_rows(t_packed[None, :])[0]
    dg = dev.prepare_device_graph(graph)
    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    seed_scores = jnp.asarray(np.asarray(tanimoto_matrix(
        jnp.asarray(target[None, :]),
        jnp.asarray(np.asarray(graph.packed)[:n_top])))[0])

    sg = shard_graph(graph, mesh)
    step_r = make_sharded_step(sg, mesh, batch=4, traffic=True)
    st_r = dev.prime(dev.init_state(dg, frontier_capacity=1 << 10),
                     dg, ids, seed_scores)

    dg_pad = DeviceGraph(adj=sg.adj, offsets=sg.offsets,
                         n_nodes=sg.n_pad_nodes, n_rows=sg.n_pad_rows,
                         m0=sg.m0, max_level=sg.max_level)
    step_f = make_sharded_step_full(sg, mesh, batch=4, traffic=True)
    st_f = init_state_sharded(sg, mesh, frontier_capacity=1 << 10,
                              log_capacity=len(graph))
    st_f = dev.prime(st_f, dg_pad, ids, seed_scores)

    m_r, m_f = TrafficMeter(8), TrafficMeter(8)
    for _ in range(8):
        st_r, tr = step_r(st_r, t_packed, t_pop)
        st_f, tf = step_f(st_f, t_packed, t_pop)
        m_r.add(tr)
        m_f.add(tf)
    assert int(st_r.n_scored) == int(st_f.n_scored)
    np.testing.assert_array_equal(m_r.adj_rows, m_f.adj_rows)
    np.testing.assert_array_equal(m_r.fp_rows, m_f.fp_rows)


@pytest.mark.slow
def test_multi_campaign_pod_matches_solo_pod(mesh, built):
    """Multi-campaign x pod composition: each vmapped campaign over the
    sharded graph ends bit-identical to its own solo sharded run at the
    same budget."""
    from rad_tpu.parallel.sharded import make_sharded_step_multi
    from rad_tpu.traverse.multi import (campaign_state, init_multi,
                                        multi_active_mask, prime_multi)

    graph = built
    t_count = 3
    targets_np = random_fingerprints(t_count, n_bits=128, density=0.25,
                                     seed=91)
    targets = jnp.asarray(targets_np)
    t_pops = popcount_rows(targets)
    budgets = jnp.asarray([60, 120, 90], jnp.int32)

    dg = dev.prepare_device_graph(graph)
    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    packed = jnp.asarray(np.asarray(graph.packed))
    seed_scores = tanimoto_matrix(targets, packed[:n_top])  # [T, n_top]

    sg = shard_graph(graph, mesh)
    frontier, buffer = 1 << 11, 1 << 8

    # multi x pod
    states = init_multi(dg, t_count, frontier_capacity=frontier,
                        buffer_capacity=buffer)
    states = prime_multi(states, dg, ids, seed_scores)
    step_m = make_sharded_step_multi(sg, mesh, batch=4)
    for _ in range(200):
        if not bool(jnp.any(multi_active_mask(states, budgets))):
            break
        states = step_m(states, targets, t_pops, budgets)

    # solo pod runs
    step_1 = make_sharded_step(sg, mesh, batch=4)
    for t in range(t_count):
        st = dev.init_state(dg, frontier_capacity=frontier,
                            buffer_capacity=buffer, head_capacity=None)
        st = dev.prime(st, dg, ids, seed_scores[t])
        while (int(st.n_scored) < int(budgets[t])
               and int(st.f_live) > 0):
            st = step_1(st, targets[t], t_pops[t])
        got = campaign_state(states, t)
        assert int(got.n_scored) == int(st.n_scored) >= int(budgets[t])
        np.testing.assert_array_equal(np.asarray(got.scored),
                                      np.asarray(st.scored))
        np.testing.assert_array_equal(np.asarray(got.order_log),
                                      np.asarray(st.order_log))
        np.testing.assert_allclose(np.asarray(got.scores),
                                   np.asarray(st.scores), atol=0)


@pytest.mark.slow
def test_packed_adjacency_pod_bit_identical(mesh, built):
    """Packed sharded adjacency (shard_graph packed_adjacency=True): the
    replicated-state pod step, the fully-state-sharded step, and the
    sharded beam search all agree bit-for-bit with int32 storage."""
    from rad_tpu.graph.adjpack import adj_bits_for, adj_group_for
    from rad_tpu.parallel.sharded import (init_state_sharded,
                                          make_sharded_search,
                                          make_sharded_step_full)

    graph = built
    target = random_fingerprints(1, n_bits=128, density=0.25, seed=77)[0]
    t_packed = jnp.asarray(target)
    t_pop = popcount_rows(t_packed[None, :])[0]

    sg_u = shard_graph(graph, mesh)
    sg_p = shard_graph(graph, mesh, packed_adjacency=True)
    bits = adj_bits_for(len(graph))
    assert sg_p.adj_bits == bits
    assert sg_p.adj_group == adj_group_for(sg_u.m0, bits)
    assert sg_p.adj.dtype == jnp.uint32
    assert sg_p.adj.shape[0] * sg_p.adj_group == sg_p.n_pad_rows

    dg = dev.prepare_device_graph(graph)
    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    seed_scores = np.asarray(tanimoto_matrix(
        jnp.asarray(target[None, :]),
        jnp.asarray(np.asarray(graph.packed)[:n_top])))[0]

    # replicated-state pod step
    finals = []
    for sg in (sg_u, sg_p):
        st = dev.init_state(dg, frontier_capacity=1 << 10)
        st = dev.prime(st, dg, ids, jnp.asarray(seed_scores))
        step = make_sharded_step(sg, mesh, batch=4)
        for _ in range(12):
            st = step(st, t_packed, t_pop)
        finals.append(st)
    a, b = finals
    assert int(a.n_scored) == int(b.n_scored) > n_top
    np.testing.assert_array_equal(np.asarray(a.scored), np.asarray(b.scored))
    np.testing.assert_array_equal(np.asarray(a.order_log),
                                  np.asarray(b.order_log))
    np.testing.assert_allclose(np.asarray(a.scores), np.asarray(b.scores),
                               atol=0)
    np.testing.assert_allclose(np.asarray(a.f_score), np.asarray(b.f_score),
                               atol=0)

    # fully-state-sharded step
    finals = []
    for sg in (sg_u, sg_p):
        st = init_state_sharded(sg, mesh, 1 << 10, len(graph), 1 << 8)
        # prime via the padded view (sentinels outside every shard)
        from rad_tpu.parallel.pod import _padded_device_graph
        st = dev.prime(st, _padded_device_graph(sg), ids,
                       jnp.asarray(seed_scores))
        step = make_sharded_step_full(sg, mesh, batch=4)
        for _ in range(12):
            st = step(st, t_packed, t_pop)
        finals.append(st)
    a, b = finals
    assert int(a.n_scored) == int(b.n_scored) > n_top
    np.testing.assert_array_equal(np.asarray(a.scored), np.asarray(b.scored))
    np.testing.assert_array_equal(np.asarray(a.order_log),
                                  np.asarray(b.order_log))

    # sharded beam search
    queries = random_fingerprints(5, n_bits=128, density=0.25, seed=78)
    s_u = make_sharded_search(sg_u, mesh, k=6, ef=24, batch=5)
    s_p = make_sharded_search(sg_p, mesh, k=6, ef=24, batch=5)
    d_u, i_u = s_u(jnp.asarray(queries))
    d_p, i_p = s_p(jnp.asarray(queries))
    np.testing.assert_array_equal(np.asarray(i_u), np.asarray(i_p))
    np.testing.assert_allclose(np.asarray(d_u), np.asarray(d_p), atol=0)


@pytest.mark.slow
def test_shard_graph_streamed_matches_materialized(mesh, built):
    """shard_graph_streamed (per-shard host callbacks, the billion-node
    constructor) produces byte-identical device layout to shard_graph's
    materialize-then-place path, for int32 AND packed adjacency — and the
    pod step over it is bit-identical."""
    from rad_tpu.parallel.sharded import shard_graph_streamed

    graph = built
    dg = dev.prepare_device_graph(graph)
    adj_np = np.asarray(dg.adj)
    fps_np = np.asarray(graph.packed)
    pops_np = np.asarray(graph.popcounts)
    calls = []

    def make_sg(packed_adjacency):
        return shard_graph_streamed(
            mesh,
            n_nodes=len(graph),
            layer_sizes=graph.layer_sizes,
            m0=dg.m0,
            make_adj_rows=lambda s, e: (calls.append((s, e)),
                                        adj_np[s:e])[1],
            make_packed_rows=lambda s, e: fps_np[s:e],
            fp_words=fps_np.shape[1],
            packed_adjacency=packed_adjacency,
        )

    for packed_adjacency in (False, True):
        sg_ref = shard_graph(graph, mesh, packed_adjacency=packed_adjacency)
        sg_st = make_sg(packed_adjacency)
        assert sg_st.n_pad_rows == sg_ref.n_pad_rows
        assert sg_st.n_pad_nodes == sg_ref.n_pad_nodes
        assert (sg_st.adj_bits, sg_st.adj_group) == \
            (sg_ref.adj_bits, sg_ref.adj_group)
        np.testing.assert_array_equal(np.asarray(sg_st.adj),
                                      np.asarray(sg_ref.adj))
        np.testing.assert_array_equal(np.asarray(sg_st.packed),
                                      np.asarray(sg_ref.packed))
        np.testing.assert_array_equal(np.asarray(sg_st.pops),
                                      np.asarray(sg_ref.pops))
        np.testing.assert_array_equal(np.asarray(sg_st.offsets),
                                      np.asarray(sg_ref.offsets))
        # each device's shard was requested exactly once, in its own range
        assert len(calls) == 8
        calls.clear()

    # default pops path (np.bitwise_count) matches the stored popcounts
    sg_auto = make_sg(False)
    np.testing.assert_array_equal(
        np.asarray(sg_auto.pops)[: len(graph)], pops_np)

    # and the pod step over the streamed graph is bit-identical
    target = random_fingerprints(1, n_bits=128, density=0.25, seed=78)[0]
    t_packed = jnp.asarray(target)
    t_pop = popcount_rows(t_packed[None, :])[0]
    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    seed_scores = tanimoto_matrix(
        t_packed[None, :], jnp.asarray(fps_np[:n_top]))[0]
    finals = []
    for sg in (shard_graph(built, mesh), sg_auto):
        st = dev.prime(dev.init_state(dg, frontier_capacity=1 << 10),
                       dg, ids, seed_scores)
        step = make_sharded_step(sg, mesh, batch=4)
        for _ in range(10):
            st = step(st, t_packed, t_pop)
        finals.append(st)
    assert int(finals[0].n_scored) == int(finals[1].n_scored)
    np.testing.assert_array_equal(np.asarray(finals[0].scored),
                                  np.asarray(finals[1].scored))
