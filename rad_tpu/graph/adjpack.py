"""Bit-packed adjacency rows — a single-card scale lever.

The traversal engine's dominant device-memory resident is the flat
``[R, M0] int32`` neighbor table (rad_tpu.traverse.device.DeviceGraph). At
200M nodes (m=8, the reference README's default connectivity — reference
README.md:47-53) that table alone is 14.63 GB. But node ids at that scale
only need 28 bits: packing 16 neighbor fields at ``ceil(log2(N+1))`` bits
each shrinks the table 12.5% (28-bit) to 37.5% (20-bit at ≤1M nodes) with a
~16-shift decode per popped batch — noise next to the step's gather chain.

Encoding: each field stores ``id`` as an unsigned ``bits``-wide integer;
the all-ones value (``mask``) is the -1 (no neighbor) sentinel, so valid
ids must satisfy ``id < mask`` i.e. ``n_nodes <= 2**bits - 1``. Fields are
laid out little-endian across a row of ``ceil(M0*bits/32)`` uint32 words:
field k occupies bits ``[k*bits, (k+1)*bits)`` of the row's bit-string,
crossing word boundaries where needed.

The reference keeps usearch's 40-byte uncompressed neighbor slots and
scales by CPU-mmap serving instead (reference index.html:568-580); this
module is the device-side analogue for keeping the *traversal* resident.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["adj_bits_for", "packed_adj_words", "adj_group_for",
           "pack_adjacency_rows", "unpack_adjacency_rows",
           "pack_adjacency_numpy"]


def adj_bits_for(n_nodes: int) -> int:
    """Smallest field width whose all-ones sentinel stays distinct from
    every valid id: ``n_nodes <= 2**bits - 1``."""
    if n_nodes < 1:
        return 1
    return max(1, int(n_nodes).bit_length())


def packed_adj_words(m0: int, bits: int) -> int:
    """uint32 words per packed row."""
    return -(-(m0 * bits) // 32)


def adj_group_for(m0: int, bits: int) -> int:
    """Rows per storage group so the grouped table's minor dim is a
    multiple of 8 uint32 words.

    A layout that pads the minor dim to a multiple of 8 elements stores a
    ``[R, 14]`` uint32 table as ``[R, 16]``, which for 28-bit fields at
    200M nodes restores the full int32 footprint. Grouping G rows into one ``[R/G, G*W]`` super-row with ``G*W % 8 == 0``
    stores the packed bits compact; the per-batch decode adds one
    take_along_axis over the gathered super-rows.
    """
    w = packed_adj_words(m0, bits)
    for g in (1, 2, 4, 8):
        if (g * w) % 8 == 0:
            return g
    return 8


def _field_layout(m0: int, bits: int):
    """Static per-field (word, shift, crosses) decode plan."""
    plan = []
    for k in range(m0):
        lo_bit = k * bits
        word, shift = divmod(lo_bit, 32)
        plan.append((word, shift, shift + bits > 32))
    return plan


def pack_adjacency_rows(adj_rows, bits: int) -> jnp.ndarray:
    """``[..., M0] int32`` neighbor ids (-1 padded) -> ``[..., W] uint32``.

    Jittable; ids must be < 2**bits - 1 (not checked under jit — use
    :func:`adj_bits_for`).
    """
    adj_rows = jnp.asarray(adj_rows)
    m0 = adj_rows.shape[-1]
    w = packed_adj_words(m0, bits)
    mask = jnp.uint32((1 << bits) - 1)
    vals = jnp.where(adj_rows < 0, jnp.int32(-1),
                     adj_rows).astype(jnp.uint32) & mask
    words = [jnp.zeros(adj_rows.shape[:-1], jnp.uint32) for _ in range(w)]
    for k, (word, shift, crosses) in enumerate(_field_layout(m0, bits)):
        v = vals[..., k]
        words[word] = words[word] | (v << jnp.uint32(shift))
        if crosses:
            words[word + 1] = words[word + 1] | (v >> jnp.uint32(32 - shift))
    return jnp.stack(words, axis=-1)


def unpack_adjacency_rows(packed_rows, m0: int, bits: int) -> jnp.ndarray:
    """``[..., W] uint32`` packed rows -> ``[..., M0] int32`` (-1 padded).

    Jittable (the engine's per-batch decode: M0 static shift/or/mask
    chains, vectorized over rows).
    """
    packed_rows = jnp.asarray(packed_rows)
    mask = jnp.uint32((1 << bits) - 1)
    out = []
    for word, shift, crosses in _field_layout(m0, bits):
        v = packed_rows[..., word] >> jnp.uint32(shift)
        if crosses:
            v = v | (packed_rows[..., word + 1] << jnp.uint32(32 - shift))
        v = v & mask
        out.append(jnp.where(v == mask, jnp.int32(-1), v.astype(jnp.int32)))
    return jnp.stack(out, axis=-1)


def pack_adjacency_numpy(adj: np.ndarray, bits: int) -> np.ndarray:
    """Host-side reference packer (chunked; for tests and host graph prep)."""
    adj = np.asarray(adj, dtype=np.int64)
    m0 = adj.shape[-1]
    if adj.size and int(adj.max()) >= (1 << bits) - 1:
        raise ValueError(
            f"ids up to {int(adj.max())} do not fit {bits}-bit fields "
            f"(max {(1 << bits) - 2}; all-ones is the -1 sentinel)")
    w = packed_adj_words(m0, bits)
    mask = np.uint64((1 << bits) - 1)
    vals = np.where(adj < 0, np.int64(-1), adj).astype(np.uint64) & mask
    words = np.zeros(adj.shape[:-1] + (w,), np.uint32)
    for k, (word, shift, crosses) in enumerate(_field_layout(m0, bits)):
        v = vals[..., k]
        words[..., word] |= (v << np.uint64(shift)).astype(
            np.uint64).astype(np.uint32)
        if crosses:
            words[..., word + 1] |= (v >> np.uint64(32 - shift)).astype(
                np.uint32)
    return words
