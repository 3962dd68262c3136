"""Bounded visited sets for beam search: a fixed-capacity id hash table.

The dense alternative — a ``[B, N]`` bool map per query batch — is exact but
caps scale: 512 queries over a 100M-node library is ~51 GB of bools. This
module replaces it with an open-addressed hash table of the *ids actually
visited* (``[H] int32`` per query, H independent of N), the device analogue of
usearch's reusable visited pools (in-repo prior art:
rad_tpu/native/hnsw_builder.cpp VisitedPool).

Design constraints (all about running inside jit / shard_map):

- **Static shapes**: capacity ``H`` (power of two) and probe depth are
  compile-time constants; a check-and-insert is a gather of ``P`` probe
  slots plus one scatter.
- **Order-independent writes**: colliding inserts in one scatter are
  resolved with ``.at[].max`` — max is commutative/associative, so the
  result is deterministic regardless of scatter order (required for the
  bit-identical single-device vs sharded-replica invariant; plain ``set``
  scatters with duplicate indices have unspecified winners).
- **Fail-open semantics**: membership tests compare full ids, so a hit is
  always true (no false positives → no recall loss). A *failed insert*
  (all P probes occupied) merely leaves the id unmarked — it may be
  revisited, which costs a re-merge but never changes the converged beam:
  re-encountered nodes either sit in the beam already (callers mask those
  with a beam-membership check) or were evicted by strictly better entries
  and cannot re-enter.

Sizing: a beam search visits ≈ expansions × M0 ids ≈ (a few × ef) × M0.
:func:`visited_capacity_for` picks the next power of two with ~4× headroom.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "visited_capacity_for",
    "use_dense_visited",
    "hashset_init",
    "hashset_check_insert",
    "hashset_check_insert_batch",
]

# Below this many B·N bool bytes the dense per-query bitmap is both exact
# and *cheaper* than hashing (one row gather + one scatter vs P-probe
# gathers): small-N builds/searches keep the dense fast path, large ones
# switch to the bounded hash table.
DENSE_VISITED_BUDGET = 1 << 28  # 256 MB


def use_dense_visited(batch: int, n: int,
                      budget: int | None = None) -> bool:
    """True when a [batch, n] bool visited map fits the dense budget.
    Reads the module-level DENSE_VISITED_BUDGET at call time so tests can
    force the hash path at small scales."""
    if budget is None:
        budget = DENSE_VISITED_BUDGET
    return batch * n <= budget

_KNUTH = 2654435761  # 2^32 / golden ratio; multiplicative hashing


def visited_capacity_for(ef: int, m0: int, n: int | None = None) -> int:
    """Power-of-two visited capacity for a beam of width ``ef`` over rows of
    degree ``m0`` — sized at ~4× the typical visit count so probe failures
    are negligible. Clamped to ≥ ``n`` ids' worth only when the library is
    tiny (where the table would otherwise dominate anyway)."""
    est = 4 * max(ef, 1) * max(m0, 1) * 4  # expansions≈4·ef, ×M0, ×4 slack
    cap = 1 << max(10, (est - 1).bit_length())
    if n is not None:
        cap = min(cap, 1 << max(10, (2 * n - 1).bit_length()))
    return cap


def hashset_init(capacity: int) -> jnp.ndarray:
    """Empty table: ``[H] int32`` of -1. ``capacity`` must be a power of 2."""
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return jnp.full((capacity,), -1, jnp.int32)


@partial(jax.jit, static_argnames=("probes",))
def hashset_check_insert(table: jnp.ndarray, ids: jnp.ndarray,
                         valid: jnp.ndarray, probes: int = 4):
    """Check-and-insert ids into one table. Returns ``(table, seen)``.

    ``seen[k]`` is True iff ``ids[k]`` was present *before* this call.
    Valid, unseen ids are inserted at their first free probe slot. Duplicate
    ids within one call all report unseen — callers dedup the batch first
    (they already do, for the beam-merge mask).
    """
    h = table.shape[0]
    shift = 32 - (h.bit_length() - 1)
    uid = ids.astype(jnp.uint32) * jnp.uint32(_KNUTH)
    base = (uid >> jnp.uint32(shift)).astype(jnp.int32)
    offs = jnp.arange(probes, dtype=jnp.int32)
    slot_idx = (base[:, None] + offs[None, :]) & (h - 1)          # [K, P]
    slots = table[slot_idx]                                        # [K, P]
    seen = jnp.any(slots == ids[:, None], axis=-1) & valid
    free = slots < 0
    any_free = jnp.any(free, axis=-1)
    first_free = jnp.argmax(free, axis=-1)
    do_insert = valid & ~seen & any_free
    ins = jnp.where(
        do_insert,
        jnp.take_along_axis(slot_idx, first_free[:, None], axis=1)[:, 0],
        h)
    # max-combine: ties between colliding same-scatter writes resolve
    # deterministically; the loser id stays unmarked (revisit, harmless)
    table = table.at[ins].max(ids, mode="drop")
    return table, seen


def hashset_check_insert_batch(tables: jnp.ndarray, ids: jnp.ndarray,
                               valid: jnp.ndarray, probes: int = 4):
    """Vmapped check-and-insert: ``tables [B, H]``, ``ids/valid [B, K]``."""
    return jax.vmap(
        lambda t, i, v: hashset_check_insert(t, i, v, probes)
    )(tables, ids, valid)
