"""Tanimoto distance over packed binary fingerprints (XLA path).

Distance: ``1 - |a ∧ b| / |a ∨ b|`` over packed uint32 rows — semantics of
usearch's b1 'tanimoto' metric (reference: README.md:47-53). Two compute
strategies:

* **SWAR popcount** (:func:`tanimoto_matrix`): pure jnp integer ops. Works
  on any backend; used as the correctness reference and for small gathers.
* **Matrix product** (:func:`tanimoto_matrix_int8`,
  :func:`tanimoto_matrix_mxu`): ``|a ∧ b| = a · b`` for 0/1 vectors, so the
  intersection popcount of a whole ``[B, N]`` distance matrix is one matrix
  product on the tensor cores — int8 operands with int32 accumulation, or
  bf16 with f32 accumulation; both exact (products are 0/1, sums
  ≤ n_bits ≪ 2^24). Union via precomputed row popcounts:
  ``|a ∨ b| = |a| + |b| − |a ∧ b|``.

Every form divides ``inter / union`` in f32 (:func:`similarity`). Where
the division rounds to nearest (XLA on the CPU, NumPy, the Triton kernel)
all forms give bit-identical similarities; XLA on the GPU divides with
``div.full``, up to 2 ulp off, the same way for every form.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rad_tpu.fp.pack import popcount, popcount_rows

__all__ = [
    "similarity",
    "tanimoto_distance",
    "tanimoto_matrix",
    "tanimoto_similarity",
    "tanimoto_matrix_int8",
    "tanimoto_similarity_int8",
    "tanimoto_matrix_mxu",
    "unpack_bitmajor",
    "bucket_keys",
    "decode_bucket_keys",
    "tanimoto_rows_to_target",
    "unpack_to_dtype",
    "bruteforce_topk",
]


def similarity(inter, union):
    """Tanimoto similarity from intersection and union counts (f32).

    ``union == 0`` (two empty sets) counts as similarity 1. Integer
    counts are converted to f32 exactly (they are at most ``n_bits``), so
    every caller on a platform gets the same bits for the same counts."""
    inter = jnp.asarray(inter, jnp.float32)
    union = jnp.asarray(union, jnp.float32)
    return jnp.where(union > 0, inter / jnp.maximum(union, 1.0),
                     jnp.float32(1.0))


def tanimoto_rows_to_target(rows: jnp.ndarray, row_pops: jnp.ndarray,
                            target_packed: jnp.ndarray, target_pop,
                            valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """``1 - Tanimoto(rows[i], target)`` (f32), ``+inf`` where ``valid``
    is False.

    THE candidate scorer shared by every engine (device fused step and
    its narrow path, the multi-campaign sweep, the pod shard bodies, the
    beam search) — one definition so the conventions (``union == 0``
    counts as similarity 1; masked lanes are +inf; precomputed row
    popcounts instead of a second popcount over the union) can never
    diverge between engines.
    """
    inter = jnp.sum(popcount(rows & target_packed[None, :]), axis=-1)
    union = target_pop + row_pops - inter
    sim = jnp.where(union > 0, inter / jnp.maximum(union, 1), 1.0)
    d = (1.0 - sim).astype(jnp.float32)
    return d if valid is None else jnp.where(valid, d, jnp.inf)


def tanimoto_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Tanimoto distance between packed rows (broadcasting over leading dims).

    ``a``: ``[..., W] uint32``, ``b``: ``[..., W] uint32`` → ``[...] float32``.
    Empty ∪ empty is defined as distance 0 (identical empty sets).
    """
    inter = jnp.sum(popcount(a & b), axis=-1, dtype=jnp.int32)
    union = jnp.sum(popcount(a | b), axis=-1, dtype=jnp.int32)
    return 1.0 - similarity(inter, union)


def tanimoto_matrix(queries: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """Dense distance matrix ``[B, N]`` via SWAR popcount on the VPU.

    ``queries``: ``[B, W] uint32``; ``db``: ``[N, W] uint32``.
    """
    return tanimoto_distance(queries[:, None, :], db[None, :, :])


def tanimoto_similarity(queries: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """Dense similarity matrix ``[B, N]`` via SWAR popcount."""
    inter = jnp.sum(popcount(queries[:, None, :] & db[None, :, :]), axis=-1,
                    dtype=jnp.int32)
    union = jnp.sum(popcount(queries[:, None, :] | db[None, :, :]), axis=-1,
                    dtype=jnp.int32)
    return similarity(inter, union)


def unpack_bitmajor(packed: jnp.ndarray, dtype=jnp.int8) -> jnp.ndarray:
    """Unpack ``[..., W] uint32`` → ``[..., W*32]`` 0/1 in bit-major order.

    Feature ``b * (W*4) + byte`` is bit ``b`` of byte ``byte``: each of the
    eight shift-and-mask steps writes one contiguous slice, and the
    bucket-min kernel unpacks its tiles in the same order. Any fixed
    permutation of the features leaves dot products, and so Tanimoto,
    unchanged.
    """
    *lead, w = packed.shape
    as_bytes = jax.lax.bitcast_convert_type(
        packed.astype(jnp.uint32), jnp.uint8).reshape(*lead, w * 4)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (as_bytes[..., None, :] >> shifts[:, None]) & jnp.uint8(1)
    return bits.reshape(*lead, 8 * w * 4).astype(dtype)


def tanimoto_similarity_int8(queries: jnp.ndarray,
                             db: jnp.ndarray) -> jnp.ndarray:
    """Dense similarity ``[B, N]`` from one int8 matrix product.

    The 0/1 operands are int8 and the product accumulates in int32, which
    is exact and runs on the tensor cores at the int8 rate; XLA fuses the
    unpack into the operands' producers."""
    inter = jax.lax.dot_general(
        unpack_bitmajor(queries), unpack_bitmajor(db),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    union = popcount_rows(queries)[:, None] + popcount_rows(db)[None, :] \
        - inter
    return similarity(inter, union)


def tanimoto_matrix_int8(queries: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """Dense distance ``[B, N]``, bit-equal to :func:`tanimoto_matrix`, from
    one int8 matrix product (:func:`tanimoto_similarity_int8`)."""
    return 1.0 - tanimoto_similarity_int8(queries, db)


def bucket_keys(sim: jnp.ndarray, bucket: int) -> jnp.ndarray:
    """Best entry of every ``bucket`` columns of ``sim [Q, N]`` as one int32
    key each: ``[Q, N // bucket]``.

    The f32 similarity (>= 0, so its bits order like the value) has its
    low ``log2(bucket)`` mantissa bits replaced by the column's index in
    the bucket, and one integer max per bucket picks the winner's
    similarity and position together. Ties after truncation go to the
    larger index. This is the plain XLA form (the distance block, then a
    reshape and max) of :func:`rad_tpu.fp.kernels.tanimoto_bucketmin`.
    """
    q, n = sim.shape
    bits = jax.lax.bitcast_convert_type(sim, jnp.int32)
    local = jnp.arange(n, dtype=jnp.int32) & (bucket - 1)
    keys = (bits & ~jnp.int32(bucket - 1)) | local
    return keys.reshape(q, n // bucket, bucket).max(axis=2)


def decode_bucket_keys(keys: jnp.ndarray, bucket: int):
    """Bucket keys -> ``(dist, column)``.

    ``dist`` carries the truncated similarity (low ``log2(bucket)``
    mantissa bits zeroed: at most a 2^-17 relative overestimate of the
    distance at bucket 64); columns are exact."""
    local = keys & jnp.int32(bucket - 1)
    sim = jax.lax.bitcast_convert_type(keys & ~jnp.int32(bucket - 1),
                                       jnp.float32)
    col = jnp.arange(keys.shape[-1], dtype=jnp.int32) * bucket
    return 1.0 - sim, col + local


def unpack_to_dtype(packed: jnp.ndarray, dtype=jnp.bfloat16) -> jnp.ndarray:
    """Unpack ``[..., W] uint32`` → ``[..., W*32]`` 0/1 values of ``dtype``."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32).astype(dtype)


@partial(jax.jit, static_argnames=())
def tanimoto_matrix_mxu(
    q_unpacked: jnp.ndarray,
    db_unpacked: jnp.ndarray,
    q_pops: jnp.ndarray,
    db_pops: jnp.ndarray,
) -> jnp.ndarray:
    """Distance matrix from pre-unpacked 0/1 bf16 operands via one matmul.

    ``q_unpacked``: ``[B, d] bf16``; ``db_unpacked``: ``[N, d] bf16``;
    ``q_pops``: ``[B] int32``; ``db_pops``: ``[N] int32`` → ``[B, N] f32``.
    """
    inter = jnp.dot(
        q_unpacked, db_unpacked.T, preferred_element_type=jnp.float32
    )
    union = q_pops[:, None].astype(jnp.float32) + db_pops[None, :].astype(
        jnp.float32
    ) - inter
    sim = jnp.where(union > 0, inter / jnp.maximum(union, 1.0), 1.0)
    return 1.0 - sim


@partial(jax.jit, static_argnames=("k",))
def bruteforce_topk(queries: jnp.ndarray, db: jnp.ndarray, k: int):
    """Exact k-NN by Tanimoto distance: ``([B, k] dists, [B, k] ids)``.

    Ground truth for recall harnesses (BASELINE config 2) — the analogue of
    brute-force validation in the reference's notebook workflow.
    """
    dists = tanimoto_matrix(queries, db)
    neg, ids = jax.lax.top_k(-dists, k)
    return -neg, ids


def bruteforce_topk_blocked(queries, db, k, block: int = 1 << 16):
    """Memory-bounded exact k-NN for large ``N``: scan over db blocks.

    Keeps a running top-k merge so the full ``[B, N]`` matrix never
    materialises. ``N`` must be a multiple of ``block`` after padding by the
    caller, or it is padded here with empty rows (distance 1).
    """
    b = queries.shape[0]
    n, w = db.shape
    nblocks = -(-n // block)
    pad = nblocks * block - n
    if pad:
        db = jnp.concatenate([db, jnp.zeros((pad, w), jnp.uint32)], axis=0)

    def body(carry, db_blk_and_off):
        best_d, best_i = carry
        db_blk, off = db_blk_and_off
        d = tanimoto_matrix(queries, db_blk)
        ids = off + jnp.arange(block, dtype=jnp.int32)[None, :]
        # Pad rows (beyond real N) get +inf so they never enter the top-k.
        valid = ids < n
        d = jnp.where(valid, d, jnp.inf)
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate([best_i, jnp.broadcast_to(ids, (b, block))], axis=1)
        neg, sel = jax.lax.top_k(-cat_d, k)
        return (-neg, jnp.take_along_axis(cat_i, sel, axis=1)), None

    init = (jnp.full((b, k), jnp.inf), jnp.full((b, k), -1, jnp.int32))
    offs = jnp.arange(nblocks, dtype=jnp.int32) * block
    db_blocks = db.reshape(nblocks, block, w)
    (best_d, best_i), _ = jax.lax.scan(body, init, (db_blocks, offs))
    return best_d, best_i
