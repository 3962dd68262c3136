"""Fully-jitted traversal loop with host scoring via io_callback.

The deepest fusion of the scoring bridge (SURVEY.md §7 layer 6): the entire
best-first sweep — pop, gather, dedup, host scoring call, integrate, repeat —
compiles into ONE device program (`lax.while_loop`), with the user scoring
function reached through ``jax.experimental.io_callback``. Against remote or
high-latency backends this collapses per-step dispatch overhead; the host
callback receives a padded id batch and returns a score batch.

Semantics identical to the stepwise engine (same expand/integrate impls).
Termination inside the loop: n_to_score reached, frontier empty, or step
budget exhausted.

Deployment note: io_callback needs the Python host co-located with the
device runtime, as a GPU's host is. The stepwise/pipelined
:class:`rad_tpu.traverse.driver.DeviceTraverser` only ever ships arrays,
never callbacks, for runtimes that cannot serve them.
"""

from __future__ import annotations

import itertools
import logging
import threading
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rad_tpu.graph.storage import HNSWGraph
from rad_tpu.store.smiles_store import SmilesStore
from rad_tpu.traverse import device as dev

logger = logging.getLogger(__name__)

__all__ = ["traverse_with_callback", "make_callback_scorer"]


def make_callback_scorer(
    graph: HNSWGraph,
    scoring_fn: Callable[[str], float],
    smiles_store: Optional[SmilesStore] = None,
    failed_score: float = float("inf"),
):
    """Wrap a SMILES scoring function as an id-batch → score-batch host fn."""
    from rad_tpu.graph.storage import host_keys_view
    keys = host_keys_view(graph.keys)  # virtual keys index lazily

    def score_ids(ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        out = np.zeros(ids.shape, np.float32)
        valid = np.nonzero(ids >= 0)[0]
        if valid.size == 0:
            return out
        id_list = ids[valid]
        if smiles_store is not None:
            smiles = smiles_store.get_smiles_list(
                keys[id_list].tolist())
        else:
            smiles = [str(int(k)) for k in keys[id_list]]
        for j, smi in zip(valid, smiles):
            try:
                out[j] = float(scoring_fn(smi))
            except Exception:
                logger.exception("scoring_fn failed for %r", smi)
                out[j] = failed_score
        return out

    return score_ids


@partial(jax.jit, static_argnames=("batch", "max_steps", "score_batch_shape"))
def _traversal_loop(state, dg, n_to_score, token, batch: int, max_steps: int,
                    score_batch_shape: int):
    def cond(carry):
        state, steps = carry
        return ((state.n_scored < n_to_score)
                & (steps < max_steps)
                & (dev.frontier_live(state) > 0))

    def body(carry):
        state, steps = carry
        state, out = dev.expand_impl(state, dg, batch)
        scores = jax.experimental.io_callback(
            _dispatch_scorer,
            jax.ShapeDtypeStruct((score_batch_shape,), jnp.float32),
            token,
            out["to_score"],
            ordered=True,
        )
        state = dev.integrate_impl(
            state, dg, out["exp_node"], out["exp_level"], out["exp_score"],
            out["exp_valid"], out["cand"], out["to_score"], scores)
        return state, steps + 1

    return jax.lax.while_loop(cond, body, (state, jnp.int32(0)))


# Registry of live scoring functions, keyed by a per-traversal token that
# travels through the compiled loop as a traced operand. One compiled loop
# serves any number of traversals — including CONCURRENT ones — without
# retracing, and nothing global is mutated (two overlapping
# traverse_with_callback calls can never clobber each other's scorer).
_SCORERS: dict = {}
_SCORERS_LOCK = threading.Lock()
_NEXT_TOKEN = itertools.count()


def _dispatch_scorer(token, ids):
    fn = _SCORERS[int(token)]
    return np.asarray(fn(np.asarray(ids)), dtype=np.float32)


def traverse_with_callback(
    state: dev.TraversalState,
    dg: dev.DeviceGraph,
    score_ids: Callable[[np.ndarray], np.ndarray],
    n_to_score: int,
    batch: int = 32,
    max_steps: int = 1 << 20,
):
    """Run the compiled traversal loop to ``n_to_score``. Returns
    (final_state, steps_executed). ``state`` must already be primed.
    Reentrant: concurrent traversals each register their scorer under a
    fresh token."""
    m0 = dg.m0
    with _SCORERS_LOCK:
        token = next(_NEXT_TOKEN)
        _SCORERS[token] = score_ids
    try:
        state, steps = _traversal_loop(
            state, dg, jnp.int32(n_to_score), jnp.int32(token), batch,
            max_steps, score_batch_shape=batch * m0)
        steps = int(steps)  # block before dropping the registry entry
    finally:
        with _SCORERS_LOCK:
            _SCORERS.pop(token, None)
    return state, steps
