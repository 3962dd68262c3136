"""Which Tanimoto implementation serves a platform: the one place that
decides it.

* ``"triton"`` (the GPU): dense distance blocks are one XLA int8 matrix
  product on the tensor cores (:func:`rad_tpu.fp.tanimoto.tanimoto_matrix_int8`),
  and the exact builder's bucket reduction is the Pallas-Triton kernel
  (:func:`rad_tpu.fp.kernels.tanimoto_bucketmin`).
* ``"int8"``: the same dense blocks, with the bucket reduction left to
  XLA (the similarity block, then :func:`rad_tpu.fp.tanimoto.bucket_keys`).
  It is the kernel's plain reference on the card.
* ``"swar"`` (the CPU): SWAR popcount blocks
  (:func:`rad_tpu.fp.tanimoto.tanimoto_matrix`) and the XLA bucket
  reduction.

All three give the same intersections; "triton" and "swar" also divide
with IEEE rounding, so their keys are bit-equal. XLA on the GPU divides
with ``div.full.f32``, up to 2 ulp off, so "int8" on the card can differ
from them in the last bits of a similarity.
"""

from __future__ import annotations

import jax.numpy as jnp

from rad_tpu.fp.tanimoto import (bucket_keys, tanimoto_matrix,
                                 tanimoto_matrix_int8, tanimoto_similarity,
                                 tanimoto_similarity_int8)

__all__ = ["IMPLS", "tanimoto_impl", "dist_block", "bucketmin_keys"]

IMPLS = ("triton", "int8", "swar")


def tanimoto_impl(platform: str) -> str:
    """The implementation for ``platform`` (``jax.Device.platform``).

    Raises on a platform rad_tpu has no implementation for; never picks
    the Pallas interpreter (tests ask for it explicitly)."""
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "swar"
    raise ValueError(f"no Tanimoto implementation for platform "
                     f"{platform!r} (supported: 'gpu', 'cpu')")


def _check(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown Tanimoto implementation {impl!r} "
                         f"(one of {IMPLS})")


def dist_block(q_packed: jnp.ndarray, db_packed: jnp.ndarray,
               impl: str) -> jnp.ndarray:
    """Dense ``[Q, N]`` Tanimoto distances by ``impl``."""
    _check(impl)
    if impl == "swar":
        return tanimoto_matrix(q_packed, db_packed)
    return tanimoto_matrix_int8(q_packed, db_packed)


def bucketmin_keys(q_packed: jnp.ndarray, db_packed: jnp.ndarray,
                   bucket: int, impl: str,
                   interpret: bool = False) -> jnp.ndarray:
    """Per-bucket winner keys ``[Q, N / bucket]`` by ``impl`` (see
    :func:`rad_tpu.fp.tanimoto.bucket_keys`). ``interpret`` runs the
    Triton kernel in the Pallas interpreter (CPU tests)."""
    _check(impl)
    if impl == "triton":
        from rad_tpu.fp.kernels import tanimoto_bucketmin
        return tanimoto_bucketmin(q_packed, db_packed, bucket=bucket,
                                  interpret=interpret)
    sim = (tanimoto_similarity(q_packed, db_packed) if impl == "swar"
           else tanimoto_similarity_int8(q_packed, db_packed))
    return bucket_keys(sim, bucket)
