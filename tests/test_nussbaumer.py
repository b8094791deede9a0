"""Nussbaumer transform: bit-exactness against the dense Toeplitz path.

The transform is exact mod 2^32 whenever the fixed operand K is divisible
by m (on-grid fast-profile keys; params.key_grid_bits >= log2 m).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# The Nussbaumer transform is an experimental artifact
# (go_tfhe_jax.experimental); the large-N bit-exactness cases are expensive
# on CPU, so they run in the slow tier — but the cheap small-N cases below
# stay in the default tier so the suite keeps a CI representative (a fully
# demoted suite silently loses coverage).
_sl = [pytest.mark.slow]

from go_tfhe_jax.experimental.nussbaumer import (extprod_nuss_ref, forward,
                                        inverse_unnormalized,
                                        negacyclic_mul_nuss_ref, nuss_shape)
from go_tfhe_jax.ops.polymul import (ext_band_from_trgsw,
                                     negacyclic_extprod_toeplitz,
                                     negacyclic_mul_fixed)
from go_tfhe_jax.utils.torus import to_signed, to_unsigned


def test_nuss_shape():
    assert nuss_shape(1024) == (32, 32, 2)
    assert nuss_shape(2048) == (64, 32, 1)
    assert nuss_shape(512) == (32, 16, 1)
    assert nuss_shape(128) == (16, 8, 1)


@pytest.mark.parametrize(
    "n", [64, pytest.param(128, marks=_sl), pytest.param(512, marks=_sl),
          pytest.param(1024, marks=_sl)])
def test_forward_inverse_roundtrip(n):
    """inverse'(forward(a)) == m * a  (mod 2^32)."""
    m, _, _ = nuss_shape(n)
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.integers(-(1 << 31), 1 << 31, (3, n), np.int64)
                    .astype(np.int32))
    back = inverse_unnormalized(forward(a), n)
    np.testing.assert_array_equal(
        np.asarray(to_unsigned(back)),
        np.asarray(to_unsigned(a * jnp.int32(m))))


@pytest.mark.parametrize(
    "n", [64, pytest.param(128, marks=_sl), pytest.param(1024, marks=_sl)])
def test_single_mul_matches_dense(n):
    m, _, _ = nuss_shape(n)
    rng = np.random.default_rng(2)
    # K on the 2^8 grid (superset of the m | K requirement for n <= 2048)
    k = jnp.asarray((rng.integers(0, 1 << 24, n, np.int64) << 8)
                    .astype(np.uint32))
    a = jnp.asarray(rng.integers(-(1 << 20), 1 << 20, (4, n), np.int64)
                    .astype(np.int32))
    want = negacyclic_mul_fixed(to_unsigned(a), k)
    got = negacyclic_mul_nuss_ref(a, k)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize(
    "n,l2", [(128, 4), pytest.param(1024, 4, marks=_sl),
             pytest.param(512, 2, marks=_sl)])
def test_extprod_matches_dense(n, l2):
    rng = np.random.default_rng(3)
    bsk = jnp.asarray((rng.integers(0, 1 << 24, (l2, 2, n), np.int64) << 8)
                      .astype(np.uint32))
    digits = jnp.asarray(
        rng.integers(-128, 128, (5, l2, n), np.int64).astype(np.int32))
    want = negacyclic_extprod_toeplitz(digits, ext_band_from_trgsw(bsk))
    got = extprod_nuss_ref(digits, bsk)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_extprod_full_torus_values():
    """Top-of-torus K values (wrapping transform sums) stay exact."""
    n, l2 = 256, 4
    rng = np.random.default_rng(4)
    bsk = jnp.asarray((rng.integers(0, 1 << 24, (l2, 2, n), np.int64) << 8)
                      .astype(np.uint32))
    bsk = bsk | jnp.uint32(0x8000_0000)     # force huge values
    bsk = bsk & jnp.uint32(0xFFFF_FF00)     # keep on the 2^8 grid
    digits = jnp.asarray(
        rng.integers(-128, 128, (2, l2, n), np.int64).astype(np.int32))
    want = negacyclic_extprod_toeplitz(digits, ext_band_from_trgsw(bsk))
    got = extprod_nuss_ref(digits, bsk)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
