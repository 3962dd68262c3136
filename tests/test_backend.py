"""The one place that picks a Tanimoto implementation for a platform."""

import numpy as np
import pytest

import jax.numpy as jnp

from rad_tpu.fp import random_fingerprints
from rad_tpu.fp.backend import bucketmin_keys, dist_block, tanimoto_impl


@pytest.mark.parametrize("platform,impl", [("gpu", "triton"),
                                           ("cpu", "swar")])
def test_tanimoto_impl_by_platform(platform, impl):
    assert tanimoto_impl(platform) == impl


def test_tanimoto_impl_rejects_unknown_platform():
    with pytest.raises(ValueError, match="no Tanimoto implementation"):
        tanimoto_impl("tpu")


def test_impls_agree():
    """Every implementation gives the same distances and bucket keys (the
    Triton kernel here through the Pallas interpreter, asked for
    explicitly: nothing picks it by itself)."""
    q = jnp.asarray(random_fingerprints(64, 256, 0.12, seed=1))
    db = jnp.asarray(random_fingerprints(256, 256, 0.12, seed=2))
    ref_d = np.asarray(dist_block(q, db, "swar"))
    np.testing.assert_array_equal(np.asarray(dist_block(q, db, "int8")),
                                  ref_d)
    np.testing.assert_array_equal(np.asarray(dist_block(q, db, "triton")),
                                  ref_d)
    ref_k = np.asarray(bucketmin_keys(q, db, 64, "swar"))
    for impl in ("int8", "triton"):
        np.testing.assert_array_equal(
            np.asarray(bucketmin_keys(q, db, 64, impl, interpret=True)),
            ref_k)


def test_unknown_impl_raises():
    q = jnp.asarray(random_fingerprints(8, 64, 0.2, seed=1))
    with pytest.raises(ValueError, match="unknown Tanimoto"):
        dist_block(q, q, "mosaic")
