"""Segmented dispatch (traverse/device.py segmented_run).

`segmented_run` re-dispatches one compiled program with a traced step
budget, so no single device program grows with the budget; these tests pin that
segmentation is bit-identical to the single unbounded call, for the
fixed-Tanimoto engine, the arbitrary-scorer runner, and the
multi-campaign engine.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.fp.pack import popcount_rows
from rad_tpu.fp.tanimoto import tanimoto_matrix
from rad_tpu.traverse import device as dev
from rad_tpu.traverse import multi as tm


@pytest.fixture(scope="module")
def setup():
    n = 300
    fps = random_fingerprints(n, n_bits=64, density=0.3, seed=33)
    graph = build_hnsw(fps, connectivity=4, expansion_add=20, seed=9)
    dg = dev.prepare_device_graph(graph)
    packed = jnp.asarray(np.asarray(graph.packed))
    pops = jnp.asarray(np.asarray(graph.popcounts))
    target = jnp.asarray(random_fingerprints(1, 64, 0.3, 321)[0])
    t_pop = popcount_rows(target[None, :])[0]
    n_top = graph.layer_sizes[graph.max_level]
    ids = jnp.arange(n_top, dtype=jnp.int32)
    seeds = tanimoto_matrix(target[None, :], packed[:n_top])[0]
    return graph, dg, packed, pops, target, t_pop, ids, seeds


def _fresh(dg, ids, seeds):
    return dev.prime(dev.init_state(dg, frontier_capacity=1 << 12),
                     dg, ids, seeds)


def _assert_states_equal(s1, s2):
    assert int(s1.n_scored) == int(s2.n_scored) > 0
    assert int(s1.n_steps) == int(s2.n_steps)
    np.testing.assert_array_equal(np.asarray(s1.order_log),
                                  np.asarray(s2.order_log))
    np.testing.assert_array_equal(np.asarray(s1.scored),
                                  np.asarray(s2.scored))
    np.testing.assert_allclose(np.asarray(s1.scores),
                               np.asarray(s2.scores), atol=0)


def test_fused_run_segmented_bit_identical(setup):
    """Many tiny segments must reproduce the single-call run exactly —
    while-loop continuation is deterministic in the carried state."""
    graph, dg, packed, pops, target, t_pop, ids, seeds = setup
    budget = jnp.int32(10**9)  # run to queue-empty

    s1 = dev.fused_run(_fresh(dg, ids, seeds), dg, packed, pops, target,
                       t_pop, budget, batch=4)
    # seg_max=7 forces dozens of re-entries on this graph
    s2 = dev.fused_run_segmented(_fresh(dg, ids, seeds), dg, packed, pops,
                                 target, t_pop, budget, batch=4,
                                 seg_init=7, seg_max=7)
    _assert_states_equal(s1, s2)


def test_fused_run_segmented_budget_on_boundary(setup):
    """A scoring budget landing exactly on a segment boundary must
    terminate identically (one further no-op dispatch, same state)."""
    graph, dg, packed, pops, target, t_pop, ids, seeds = setup

    s1 = _fresh(dg, ids, seeds)
    s1 = dev.fused_run(s1, dg, packed, pops, target, t_pop,
                       jnp.int32(10**9), batch=4, max_steps=12)
    s2 = dev.fused_run_segmented(_fresh(dg, ids, seeds), dg, packed, pops,
                                 target, t_pop, jnp.int32(10**9), batch=4,
                                 max_steps=12, seg_init=4, seg_max=4)
    _assert_states_equal(s1, s2)


def test_fused_run_max_steps_traced_single_compile(setup):
    """Distinct step budgets must NOT trigger recompilation (the budget
    is traced — this is what makes segmentation affordable)."""
    graph, dg, packed, pops, target, t_pop, ids, seeds = setup
    dev.fused_run(_fresh(dg, ids, seeds), dg, packed, pops, target,
                  t_pop, jnp.int32(10**9), batch=4, max_steps=3)
    seen = dev.fused_run._cache_size()
    for ms in (5, 11, 17):
        dev.fused_run(_fresh(dg, ids, seeds), dg, packed, pops, target,
                      t_pop, jnp.int32(10**9), batch=4, max_steps=ms)
    assert dev.fused_run._cache_size() == seen


def test_segmented_run_with_make_device_run(setup):
    """The arbitrary-scorer runner's traced step budget drives
    segmented_run to the same state as one unbounded call."""
    graph, dg, packed, pops, target, t_pop, ids, seeds = setup

    def scorer(rows_packed, rows_pops):
        from rad_tpu.fp.tanimoto import tanimoto_rows_to_target
        return tanimoto_rows_to_target(rows_packed, rows_pops, target, t_pop)

    run = dev.make_device_run(dg, packed, pops, scorer, batch=4)
    s1 = run(_fresh(dg, ids, seeds), jnp.int32(10**9))
    s2 = dev.segmented_run(run, _fresh(dg, ids, seeds), 10**9,
                           seg_init=5, seg_max=5)
    _assert_states_equal(s1, s2)


def test_segmented_run_multi_campaign(setup):
    """Multi-campaign: vector n_steps — segmentation by the max-lane
    counter must still be bit-identical per campaign."""
    graph, dg, packed, pops, target, t_pop, ids, seeds = setup
    t = 3
    targets = jnp.asarray(random_fingerprints(t, 64, 0.3, 77))
    t_pops = popcount_rows(targets)

    def fresh_multi():
        states = tm.init_multi(dg, t, frontier_capacity=1 << 12)
        seed_scores = tanimoto_matrix(targets, packed[:ids.shape[0]])
        return tm.prime_multi(states, dg, ids, seed_scores)

    budget = jnp.int32(40)
    s1 = tm.fused_run_multi(fresh_multi(), dg, packed, pops, targets,
                            t_pops, budget, batch=4)
    s2 = dev.segmented_run(
        lambda st, nts, sb: tm.fused_run_multi(st, dg, packed, pops,
                                               targets, t_pops, nts,
                                               batch=4, max_steps=sb),
        fresh_multi(), budget, seg_init=6, seg_max=6)
    assert np.array_equal(np.asarray(s1.n_scored), np.asarray(s2.n_scored))
    np.testing.assert_array_equal(np.asarray(s1.order_log),
                                  np.asarray(s2.order_log))
    np.testing.assert_allclose(np.asarray(s1.scores),
                               np.asarray(s2.scores), atol=0)
