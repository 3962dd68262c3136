"""Pallas-Triton kernel: the exact builder's fused Tanimoto bucket-min.

The exact builder's hot loop (:mod:`rad_tpu.build.exact`) reduces every
``[q_block, col_block]`` distance block to one winner per ``bucket``
columns. In plain XLA (:func:`rad_tpu.fp.tanimoto.bucket_keys` over a
similarity block) the block's int32 intersections are written to device
memory and read back by the epilogue and the reduction. This kernel keeps
them on chip:

* operands are the bit-unpacked 0/1 rows as int8
  (:func:`rad_tpu.fp.tanimoto.unpack_bitmajor`); each program walks the
  feature axis in ``BK``-wide steps, each one ``int8 x int8 -> int32``
  product on the tensor cores, exact for 0/1 values;
* the epilogue divides exactly, packs similarity and in-bucket index into
  an int32 key, and takes the bucket max, so only ``BN / bucket`` keys per
  query row reach device memory.

Programs are independent (no sum is carried between grid steps), so the
grid fills the card's SMs in any order. Keys are bit-equal to
:func:`rad_tpu.fp.tanimoto.bucket_keys` over IEEE-rounded similarities.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from rad_tpu.fp.pack import popcount_rows
from rad_tpu.fp.tanimoto import unpack_bitmajor

__all__ = ["tanimoto_bucketmin"]

# Tile sizes (powers of two, as Triton requires) and launch shape, the
# fastest of a sweep on the H100 (PERF.md). Three pipeline stages of int8
# operand tiles take 3 * (128 + 128) * 128 B = 96 KB of the 227 KB of
# shared memory; a 4096 x 8192 block is 2048 programs for 132 SMs.
BQ = 128
BN = 128
BK = 128
NUM_WARPS = 4
NUM_STAGES = 3
MAX_WORDS = 64

# f32 a / b rounded to nearest, for the integer operands 0 <= a <= b here.
# Triton lowers "/" to the approximate div.full.f32 (up to 2 ulp off);
# PTX's div.rn.f32 is exact but runs its general slow-path checks. This
# sequence is an approximate reciprocal, a quotient, its exact residual
# (the FMA is exact because the residual is tiny) and one correction. It
# equals IEEE division for every pair with b <= 4096 (all unions of
# fingerprints up to 2048 bits), checked exhaustively on the card
# (tests/test_kernels.py::test_div_rn_exhaustive_on_gpu).
_DIV_RN_ASM = """{
.reg .f32 r, q, e, nq;
rcp.approx.ftz.f32 r, $2;
mul.rn.f32 q, $1, r;
neg.f32 nq, q;
fma.rn.f32 e, nq, $2, $1;
fma.rn.f32 $0, e, r, q;
}"""


def _div_rn(x, y, interpret: bool):
    """f32 ``x / y`` rounded to nearest, as XLA on the CPU and NumPy divide
    (the interpreter runs on the host, whose division is already IEEE)."""
    if interpret:
        return x / y
    [out] = plt.elementwise_inline_asm(
        _DIV_RN_ASM, args=[x, y], constraints="=f,f,f", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, jnp.float32)])
    return out


def _bucketmin_kernel(q_ref, qpop_ref, db_ref, dbpop_ref, out_ref, *,
                      bucket: int, bk: int, interpret: bool):
    bq, d = q_ref.shape
    bn = db_ref.shape[0]

    def step(i, acc):
        a = q_ref[:, pl.ds(i * bk, bk)]
        b = db_ref[:, pl.ds(i * bk, bk)]
        return acc + pl.dot(a, b, trans_b=True)

    inter = jax.lax.fori_loop(0, d // bk, step,
                              jnp.zeros((bq, bn), jnp.int32))
    inter = inter.astype(jnp.float32)                # exact: <= n_bits
    union = qpop_ref[...][:, None] + dbpop_ref[...][None, :] - inter
    sim = jnp.where(union > 0,
                    _div_rn(inter, jnp.maximum(union, 1.0), interpret),
                    1.0)
    bits = jax.lax.bitcast_convert_type(sim, jnp.int32)
    local = jax.lax.broadcasted_iota(jnp.int32, (bq, bn), 1) & (bucket - 1)
    keys = (bits & ~(bucket - 1)) | local
    out_ref[...] = jnp.max(keys.reshape(bq, bn // bucket, bucket), axis=2)


@functools.partial(jax.jit, static_argnames=("bucket", "interpret"))
def tanimoto_bucketmin(q_packed: jnp.ndarray, db_packed: jnp.ndarray,
                       bucket: int = 64,
                       interpret: bool = False) -> jnp.ndarray:
    """Winner of every ``bucket`` database rows for every query, as keys.

    Returns int32 ``keys [Q, N / bucket]``, equal to
    ``bucket_keys(tanimoto_similarity(q, db), bucket)`` with IEEE division;
    decode with :func:`rad_tpu.fp.tanimoto.decode_bucket_keys`. The
    distance matrix never reaches device memory. ``Q`` must be a multiple
    of ``min(Q, BQ)``, ``N`` of ``min(N, BN)``, both tiles powers of two
    (Triton's rule), and ``bucket`` a power of two that divides
    ``min(N, BN)``.

    ``interpret=True`` runs the Pallas interpreter (tests on the CPU);
    without it the kernel compiles through Triton and needs a GPU.
    """
    q, w = q_packed.shape
    n, _ = db_packed.shape
    if w > MAX_WORDS:
        raise ValueError(f"bucketmin: {32 * w}-bit fingerprints exceed the "
                         f"{32 * MAX_WORDS} bits its division is exact for")
    bq, bn = min(BQ, q), min(BN, n)
    if (q % bq or n % bn or bn % bucket or bucket & (bucket - 1)
            or bq & (bq - 1) or bn & (bn - 1)):
        raise ValueError(f"bucketmin: Q={q} N={n} bucket={bucket} do not "
                         f"tile by ({bq}, {bn})")
    # the feature axis is zero-padded to a power of two of at least 32
    # (the tensor cores' least int8 depth); zero bits change no count
    d = max(32, 1 << (32 * w - 1).bit_length())
    bk = min(BK, d)
    pad = (d - 32 * w) // 32
    if pad:
        q_packed = jnp.pad(q_packed, ((0, 0), (0, pad)))
        db_packed = jnp.pad(db_packed, ((0, 0), (0, pad)))
    kernel = functools.partial(_bucketmin_kernel, bucket=bucket, bk=bk,
                               interpret=interpret)
    return pl.pallas_call(
        kernel,
        grid=(q // bq, n // bn),
        in_specs=[
            pl.BlockSpec((bq, d), lambda i, j: (i, 0)),
            pl.BlockSpec((bq,), lambda i, j: (i,)),
            pl.BlockSpec((bn, d), lambda i, j: (j, 0)),
            pl.BlockSpec((bn,), lambda i, j: (j,)),
        ],
        out_specs=pl.BlockSpec((bq, bn // bucket), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((q, n // bucket), jnp.int32),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="tanimoto_bucketmin",
    )(unpack_bitmajor(q_packed), popcount_rows(q_packed).astype(jnp.float32),
      unpack_bitmajor(db_packed),
      popcount_rows(db_packed).astype(jnp.float32))
