"""Tanimoto kernels and their references.

The Pallas-Triton bucket-min kernel runs here in the Pallas interpreter
and must give keys bit-equal to the plain XLA form (SWAR and int8) and to
a NumPy model. Its compiled form runs only on the card (``gpu`` tests)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rad_tpu.fp import random_fingerprints, tanimoto_matrix
from rad_tpu.fp.kernels import tanimoto_bucketmin
from rad_tpu.fp.pack import popcount_rows_np
from rad_tpu.fp.tanimoto import (bucket_keys, decode_bucket_keys,
                                 tanimoto_matrix_int8, tanimoto_similarity,
                                 tanimoto_similarity_int8, unpack_bitmajor)


@pytest.fixture(scope="module")
def data():
    db = random_fingerprints(1024, n_bits=256, density=0.15, seed=41)
    q = random_fingerprints(256, n_bits=256, density=0.15, seed=42)
    return jnp.asarray(q), jnp.asarray(db)


def _ref_bucket_keys(q, db, bucket):
    """NumPy model of the packed-key bucket reduction, with IEEE f32
    division of the exact counts."""
    qb = np.unpackbits(np.asarray(q).view(np.uint8), axis=1)
    dbb = np.unpackbits(np.asarray(db).view(np.uint8), axis=1)
    inter = (qb.astype(np.float32) @ dbb.T.astype(np.float32))
    union = qb.sum(1, dtype=np.float32)[:, None] + \
        dbb.sum(1, dtype=np.float32)[None, :] - inter
    sim = np.where(union > 0, inter / np.maximum(union, 1.0),
                   np.float32(1.0)).astype(np.float32)
    bits = sim.view(np.int32)
    local = np.arange(sim.shape[1], dtype=np.int32) % bucket
    keys = (bits & ~np.int32(bucket - 1)) | local
    return keys.reshape(sim.shape[0], -1, bucket).max(axis=2)


def _kernel(q, db, bucket):
    return np.asarray(tanimoto_bucketmin(q, db, bucket=bucket,
                                         interpret=True))


@pytest.mark.parametrize("n_bits,nq,n,bucket", [
    (256, 256, 1024, 64),
    (256, 128, 512, 32),
    (1024, 64, 256, 64),
    (1024, 128, 256, 128),
    (64, 32, 128, 16),
    (512, 16, 64, 64),
])
def test_bucketmin_kernel_matches_references(n_bits, nq, n, bucket):
    """Keys bit-equal to the XLA forms (SWAR and int8 blocks, then
    reshape-max) and to the NumPy model, across widths (64 bits pads the
    feature axis), tile-sized and smaller shapes, and buckets."""
    q = jnp.asarray(random_fingerprints(nq, n_bits, 0.12, seed=n_bits + 1))
    db = jnp.asarray(random_fingerprints(n, n_bits, 0.12, seed=n_bits + 2))
    keys = _kernel(q, db, bucket)
    assert keys.shape == (nq, n // bucket)
    np.testing.assert_array_equal(
        keys, np.asarray(bucket_keys(tanimoto_similarity(q, db), bucket)))
    np.testing.assert_array_equal(
        keys, np.asarray(bucket_keys(tanimoto_similarity_int8(q, db),
                                     bucket)))
    np.testing.assert_array_equal(keys, _ref_bucket_keys(q, db, bucket))


def test_bucketmin_empty_rows():
    """All-zero rows: an empty query against an empty row is similarity 1
    (union 0), against anything else 0 — the shared convention."""
    db = random_fingerprints(256, 256, 0.15, seed=3)
    db[5] = 0
    db[200] = 0
    q = random_fingerprints(64, 256, 0.15, seed=4)
    q[0] = 0
    q, db = jnp.asarray(q), jnp.asarray(db)
    keys = _kernel(q, db, 64)
    np.testing.assert_array_equal(
        keys, np.asarray(bucket_keys(tanimoto_similarity(q, db), 64)))
    d, col = decode_bucket_keys(jnp.asarray(keys), 64)
    assert np.asarray(col)[0, 0] == 5 and float(np.asarray(d)[0, 0]) == 0.0


def test_bucketmin_kernel_matches_model(data):
    q, db = data
    ref = np.asarray(tanimoto_matrix(q, db))
    for bucket in (32, 64):
        keys = _kernel(q, db, bucket)
        np.testing.assert_array_equal(keys, _ref_bucket_keys(q, db, bucket))
        d, gid = decode_bucket_keys(jnp.asarray(keys), bucket)
        d, gid = np.asarray(d), np.asarray(gid)
        # ids exact; the decoded distance is the truncated similarity's,
        # never below the true winner distance and at most one key step
        # above it
        bucket_d = ref.reshape(ref.shape[0], -1, bucket).min(axis=2)
        chosen_d = ref[np.arange(ref.shape[0])[:, None], gid]
        np.testing.assert_allclose(chosen_d, bucket_d, atol=1e-6)
        assert (d >= chosen_d - 1e-6).all()
        assert (d <= chosen_d + 2.0 ** -14).all()


def test_bucketmin_self_query(data):
    """Self rows win their own bucket at distance 0 with exact identity."""
    _, db = data
    keys = _kernel(db[:128], db, 64)
    d, gid = decode_bucket_keys(jnp.asarray(keys), 64)
    d, gid = np.asarray(d), np.asarray(gid)
    rows = np.arange(128)
    own = rows // 64  # bucket containing the self column
    assert (gid[rows, own] == rows).all()
    np.testing.assert_allclose(d[rows, own], 0.0, atol=1e-6)


@pytest.mark.parametrize("nq,n,bucket", [(64, 256, 48), (60, 256, 64)])
def test_bucketmin_rejects_bad_tiling(nq, n, bucket):
    q = jnp.asarray(random_fingerprints(nq, 256, 0.1, seed=1))
    db = jnp.asarray(random_fingerprints(n, 256, 0.1, seed=2))
    with pytest.raises(ValueError, match="tile"):
        tanimoto_bucketmin(q, db, bucket=bucket, interpret=True)


@pytest.mark.parametrize("n_bits", [64, 256, 1024])
def test_int8_block_matches_swar(n_bits):
    """The int8 XLA distance block is bit-equal to the SWAR reference."""
    q = jnp.asarray(random_fingerprints(48, n_bits, 0.12, seed=5))
    db = jnp.asarray(random_fingerprints(300, n_bits, 0.12, seed=6))
    np.testing.assert_array_equal(np.asarray(tanimoto_matrix_int8(q, db)),
                                  np.asarray(tanimoto_matrix(q, db)))


def test_int8_similarity_bitwise(data):
    q, db = data
    a = np.asarray(tanimoto_similarity_int8(q, db)).view(np.int32)
    b = np.asarray(tanimoto_similarity(q, db)).view(np.int32)
    np.testing.assert_array_equal(a, b)


def test_unpack_bitmajor_dot_is_intersection(data):
    """Any fixed feature order leaves dot products unchanged: the int8
    product of bit-major rows is the AND popcount."""
    q, db = data
    qb = np.asarray(unpack_bitmajor(q[:16]), np.int32)
    dbb = np.asarray(unpack_bitmajor(db[:40]), np.int32)
    want = np.array([[popcount_rows_np(np.asarray(a & b)) for b in db[:40]]
                     for a in q[:16]])
    np.testing.assert_array_equal(qb @ dbb.T, want)
    np.testing.assert_array_equal(qb.sum(1), popcount_rows_np(q[:16]))


def test_unpack_bitmajor_layout():
    """Feature ``b * (W*4) + byte`` is bit ``b`` of byte ``byte``."""
    w = 2
    packed = np.zeros((1, w), np.uint32)
    packed[0, 1] = 1 << 19          # byte 6 (word 1, byte 2), bit 3
    bits = np.asarray(unpack_bitmajor(jnp.asarray(packed)))[0]
    assert bits.dtype == np.int8 and bits.sum() == 1
    assert np.flatnonzero(bits)[0] == 3 * (w * 4) + 6


def test_decode_bucket_keys():
    sim = np.float32(0.75)
    key = (np.array([sim]).view(np.int32) & ~np.int32(63)) | 5
    d, col = decode_bucket_keys(jnp.asarray(np.tile(key, (1, 3))), 64)
    np.testing.assert_array_equal(np.asarray(col)[0], [5, 69, 133])
    np.testing.assert_allclose(np.asarray(d)[0], 0.25, atol=2.0 ** -17)


@pytest.mark.gpu
def test_div_rn_exhaustive_on_gpu(gpu):
    """The kernel's division sequence equals IEEE f32 division for every
    0 <= a <= b <= 4096 (all unions of fingerprints up to 2048 bits)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    from rad_tpu.fp.kernels import _div_rn

    bmax = 4096
    b = np.repeat(np.arange(1, bmax + 1), np.arange(2, bmax + 2))
    a = np.concatenate([np.arange(0, k + 1) for k in range(1, bmax + 1)])
    pad = -len(a) % 1024
    a = np.concatenate([a, np.zeros(pad)]).astype(np.float32)
    b = np.concatenate([b, np.ones(pad)]).astype(np.float32)

    def kernel(a_ref, b_ref, o_ref):
        o_ref[...] = _div_rn(a_ref[...], b_ref[...], False)

    f = pl.pallas_call(
        kernel, grid=(len(a) // 1024,),
        in_specs=[pl.BlockSpec((1024,), lambda i: (i,))] * 2,
        out_specs=pl.BlockSpec((1024,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct(a.shape, jnp.float32),
        compiler_params=plt.CompilerParams(num_warps=4))
    out = np.asarray(jax.jit(f)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(out.view(np.int32),
                                  (a / b).astype(np.float32).view(np.int32))


@pytest.mark.gpu
def test_bucketmin_compiled_matches_model_on_gpu(gpu, data):
    q, db = data
    keys = np.asarray(jax.jit(functools.partial(
        tanimoto_bucketmin, bucket=64))(q, db))
    np.testing.assert_array_equal(keys, _ref_bucket_keys(q, db, 64))
