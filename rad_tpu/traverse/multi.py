"""Multi-campaign traversal: T independent screenings in ONE compiled sweep.

The reference runs one scoring campaign per traverser (one receptor, one
Redis namespace); screening a panel — DUDE-Z alone has 43 receptors
(reference examples/DUDEZ_example.ipynb) — means T sequential campaigns.
The engine's per-step cost is a latency-bound chain of [B·M0]-wide state
ops, so batching T campaigns' states into [T, ...] arrays amortizes the
latency chain across campaigns: aggregate nodes/s grows with T at nearly
constant wall-clock per step. The graph and fingerprint matrix are SHARED (read-only) — only
the O(N)-per-campaign state replicates.

Mechanics: each campaign keeps its own :class:`TraversalState` stacked on
a leading T axis; one step vmaps expand → on-device Tanimoto-to-target
scorer → integrate. Two vmap-specific adaptations, both semantics-free:

- the frontier commit decision (append vs merge) is lifted to a SCALAR
  `lax.cond` outside the vmap — a vmapped cond executes both branches,
  which would merge-sort every step. The scalar uses the conservative
  pre-step check ``any(f_buf_n + p_new > P)`` (merge a bit earlier than
  strictly needed); pop order is invariant to merge timing (pinned by
  tests/test_async.py buffer-size invariance), so results are unchanged.
- finished campaigns are FROZEN: the step still computes their lanes (the
  vmap is rectangular) but a `where(active)` mask discards the result, so
  each campaign's final state is bit-identical to running it alone to the
  same budget.

The two-level frontier (``head_capacity`` in :func:`init_multi`) lifts
its refill decision the same way: refill-all when any active campaign
needs one (an exact rebuild is harmless for the others — only
equal-score pop order can shift, the same caveat the single-campaign
two-level layout documents).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rad_tpu.traverse import device as dev
from rad_tpu.traverse.device import DeviceGraph, TraversalState

__all__ = ["init_multi", "prime_multi", "fused_run_multi",
           "fused_run_multi_tables", "campaign_state"]


def init_multi(dg: DeviceGraph, n_campaigns: int,
               frontier_capacity: int | None = None,
               log_capacity: int | None = None,
               buffer_capacity: int = 1 << 15,
               head_capacity: int | None | str = None) -> TraversalState:
    """T stacked fresh states (leading axis = campaign).

    ``head_capacity`` enables the two-level frontier per campaign; the
    multi loop lifts the refill decision to a scalar (refill-all when any
    active campaign needs one — an exact rebuild, harmless when not
    needed; equal-score pop order may differ from solo runs, the same
    caveat as the single-campaign two-level layout)."""
    one = dev.init_state(dg, frontier_capacity, log_capacity,
                         buffer_capacity, head_capacity=head_capacity)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (n_campaigns,) + x.shape),
        one)


@partial(jax.jit, donate_argnums=(0,))
def prime_multi(states: TraversalState, dg: DeviceGraph,
                node_ids: jnp.ndarray,
                node_scores: jnp.ndarray) -> TraversalState:
    """Seed every campaign from the same top-layer nodes with per-campaign
    scores (``node_scores [T, K]``, ``node_ids [K]`` shared)."""
    return jax.vmap(dev.prime, in_axes=(0, None, None, 0))(
        states, dg, node_ids, node_scores)


def multi_active_mask(states: TraversalState, budgets):
    return (states.n_scored < budgets) & (states.f_live > 0)


def multi_step(states, dg, budgets, batch, vm_expand_score,
               integrate_extra=None):
    """ONE multi-campaign step: scalar-lifted refill + commit decisions
    around a vmapped expand→score→integrate, with finished campaigns
    frozen. ``vm_expand_score(states, refill)`` runs the vmapped expand +
    scorer and returns (states, outs, scores).
    ``integrate_extra`` (optional) is a dict of kwargs forwarded to
    ``integrate_impl`` — the sharded composition passes its state ops
    here. Shared by the fused while-loop and the pod multi-step."""
    t = budgets.shape[0]
    p = states.f_buf_score.shape[1]
    p_new = batch * dg.m0 + batch  # max pushes any step can produce
    two_level = states.cold_score.shape[1] > 0
    extra = integrate_extra or {}

    active = multi_active_mask(states, budgets)

    def integrate_with(commit):
        def f(args):
            sts, outs, scs = args
            return jax.vmap(
                lambda s, o, sc: dev.integrate_impl(
                    s, dg, o["exp_node"], o["exp_level"], o["exp_score"],
                    o["exp_valid"], o["cand"], o["to_score"], sc,
                    commit=commit, **extra)
            )(sts, outs, scs)
        return f

    def make_step(refill):
        def step(args):
            states, force_commit = args
            sts, outs, scs = vm_expand_score(states, refill)
            return jax.lax.cond(force_commit, integrate_with("merge"),
                                integrate_with("append"),
                                (sts, outs, scs))
        return step

    # scalar decisions over ACTIVE campaigns only (frozen lanes never
    # change, and a frozen near-full buffer / drained head must not
    # force work forever)
    force_commit = jnp.any(active & (states.f_buf_n + p_new > p))
    if two_level:
        hb_live = states.f_live - states.cold_n
        any_refill = jnp.any(active & (hb_live < batch)
                             & (states.cold_n > 0))
        new_states = jax.lax.cond(any_refill, make_step("force"),
                                  make_step("skip"),
                                  (states, force_commit))
    else:
        new_states = make_step("cond")((states, force_commit))

    def keep(new, old):
        a = active.reshape((t,) + (1,) * (new.ndim - 1))
        return jnp.where(a, new, old)
    return jax.tree_util.tree_map(keep, new_states, states)


def _multi_loop(states, dg, budgets, batch, max_steps, vm_expand_score):
    """Shared multi-campaign while-loop around :func:`multi_step`."""

    def body(carry):
        states, steps = carry
        return multi_step(states, dg, budgets, batch,
                          vm_expand_score), steps + 1

    def cond(carry):
        states, steps = carry
        return jnp.any(multi_active_mask(states, budgets)) \
            & (steps < max_steps)

    states, _ = jax.lax.while_loop(cond, body, (states, jnp.int32(0)))
    return states


@partial(jax.jit, static_argnames=("batch",), donate_argnums=(0,))
def fused_run_multi(
    states: TraversalState,
    dg: DeviceGraph,
    packed: jnp.ndarray,
    pops: jnp.ndarray,
    targets: jnp.ndarray,       # [T, W]
    t_pops: jnp.ndarray,        # [T]
    n_to_score: jnp.ndarray,    # scalar or [T]
    batch: int,
    max_steps=1 << 20,  # TRACED: one compile serves every step budget
) -> TraversalState:
    """Run all campaigns to their budgets in one `lax.while_loop`."""
    from rad_tpu.fp.tanimoto import tanimoto_rows_to_target

    t = targets.shape[0]
    budgets = jnp.broadcast_to(jnp.asarray(n_to_score, jnp.int32), (t,))

    def expand_score(state, target, t_pop, refill):
        state, out = dev.expand_impl(state, dg, batch, refill=refill)
        ts = out["to_score"]
        ok = ts >= 0
        rows = packed[jnp.where(ok, ts, 0)]
        scores = tanimoto_rows_to_target(
            rows, pops[jnp.where(ok, ts, 0)], target, t_pop, valid=ok)
        return state, out, scores

    def vm_expand_score(states, refill):
        return jax.vmap(lambda s, tg, tp: expand_score(s, tg, tp, refill)
                        )(states, targets, t_pops)

    return _multi_loop(states, dg, budgets, batch, max_steps,
                       vm_expand_score)


@partial(jax.jit, static_argnames=("batch",), donate_argnums=(0,))
def fused_run_multi_tables(
    states: TraversalState,
    dg: DeviceGraph,
    score_tables: jnp.ndarray,  # [T, N] float32 — per-campaign node scores
    n_to_score: jnp.ndarray,    # scalar or [T]
    batch: int,
    max_steps=1 << 20,  # TRACED: one compile serves every step budget
) -> TraversalState:
    """Multi-campaign sweep with per-campaign score TABLES.

    The receptor-panel use case (reference examples/DUDEZ_example.ipynb:
    one lookup-table DOCK scorer per receptor): campaign t's score for
    node i is ``score_tables[t, i]``. Same engine as
    :func:`fused_run_multi` with the Tanimoto scorer replaced by a
    per-campaign gather.
    """
    t = score_tables.shape[0]
    n = score_tables.shape[1]
    if t * n >= 2**31:
        raise ValueError(
            f"score_tables [{t}, {n}] flatten to {t * n} entries — past "
            f"int32 index range the per-campaign gather bases overflow "
            f"and later campaigns silently read wrong scores. Shard the "
            f"panel (rad_tpu.parallel.make_sharded_step_multi) or split "
            f"it into smaller table groups.")
    budgets = jnp.broadcast_to(jnp.asarray(n_to_score, jnp.int32), (t,))
    # flatten to one shared [T*N] operand gathered with per-lane offsets:
    # a standard single-operand gather instead of a vmapped gather with a
    # batched operand
    flat = score_tables.reshape(-1)
    bases = jnp.arange(t, dtype=jnp.int32) * n

    def expand_score(state, base, refill):
        state, out = dev.expand_impl(state, dg, batch, refill=refill)
        ts = out["to_score"]
        ok = ts >= 0
        scores = jnp.where(ok, flat[base + jnp.where(ok, ts, 0)], jnp.inf)
        return state, out, scores

    def vm_expand_score(states, refill):
        return jax.vmap(lambda s, b: expand_score(s, b, refill)
                        )(states, bases)

    return _multi_loop(states, dg, budgets, batch, max_steps,
                       vm_expand_score)


def campaign_state(states: TraversalState, i: int) -> TraversalState:
    """Extract campaign ``i``'s state (host-side convenience for the
    single-campaign result APIs: read_order_log, scores, ...)."""
    return jax.tree_util.tree_map(lambda x: x[i], states)
