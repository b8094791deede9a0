"""Exact negacyclic polynomial arithmetic vs. independent NumPy oracles.

The reference tests its float64 FFT to <=10 ulp (poly/poly_test.go:10-33);
our integer kernels must match the schoolbook oracle *bit-exactly*.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import negacyclic_mul_oracle
from go_tfhe_jax.ops.polymul import (conv_kernel_from_poly,
                                     ext_band_from_trgsw,
                                     negacyclic_extprod_i32,
                                     negacyclic_extprod_toeplitz,
                                     negacyclic_mul_fixed,
                                     extprod_kernel_from_trgsw,
                                     split_balanced_limbs_i8,
                                     toeplitz_from_band)
from go_tfhe_jax.utils.torus import to_signed

N = 64


def _rand_u32(rng, shape, lo=0, hi=1 << 32):
    return rng.integers(lo, hi, size=shape, dtype=np.uint64).astype(np.uint32)


def test_negacyclic_mul_fixed_exact():
    rng = np.random.default_rng(0)
    a = _rand_u32(rng, (3, N))
    k = _rand_u32(rng, (N,))
    out = np.asarray(negacyclic_mul_fixed(jnp.asarray(a), jnp.asarray(k)))
    for i in range(3):
        np.testing.assert_array_equal(out[i], negacyclic_mul_oracle(a[i], k))


def test_negacyclic_mul_binary_key():
    # The encrypt path multiplies by a binary key polynomial.
    rng = np.random.default_rng(1)
    a = _rand_u32(rng, (N,))
    k = rng.integers(0, 2, size=(N,)).astype(np.uint32)
    out = np.asarray(negacyclic_mul_fixed(jnp.asarray(a), jnp.asarray(k)))
    np.testing.assert_array_equal(out, negacyclic_mul_oracle(a, k))


def test_toeplitz_equals_conv_extprod():
    """Toeplitz-einsum and conv paths produce identical results."""
    rng = np.random.default_rng(2)
    l2 = 4
    trgsw = _rand_u32(rng, (l2, 2, N))
    digits = rng.integers(-(1 << 21), 1 << 21, size=(5, l2, N)).astype(np.int32)

    band = ext_band_from_trgsw(jnp.asarray(trgsw))
    out_t = np.asarray(negacyclic_extprod_toeplitz(jnp.asarray(digits), band))

    kern = extprod_kernel_from_trgsw(jnp.asarray(trgsw))
    out_c = np.asarray(negacyclic_extprod_i32(jnp.asarray(digits), kern))
    np.testing.assert_array_equal(out_t, out_c)


def test_extprod_matches_schoolbook():
    """out[c] = sum_r digits[r] (*) trgsw[r, c]   (mod 2^32)."""
    rng = np.random.default_rng(3)
    l2 = 2
    trgsw = _rand_u32(rng, (l2, 2, N))
    digits = rng.integers(-128, 128, size=(1, l2, N)).astype(np.int32)

    band = ext_band_from_trgsw(jnp.asarray(trgsw))
    out = np.asarray(negacyclic_extprod_toeplitz(jnp.asarray(digits), band))[0]

    for c in range(2):
        acc = np.zeros(N, np.uint32)
        for r in range(l2):
            d_u32 = digits[0, r].astype(np.int64) % (1 << 32)
            acc = (acc.astype(np.uint64) + negacyclic_mul_oracle(
                d_u32.astype(np.uint32), trgsw[r, c])) & 0xFFFFFFFF
            acc = acc.astype(np.uint32)
        np.testing.assert_array_equal(out[c], acc)


def test_split_signed_limbs_exact():
    """split_signed_limbs_i8 reconstructs exactly as INTEGERS (required for
    the multi-limb int8 external product of the large-BGBIT profiles)."""
    from go_tfhe_jax.ops.polymul import split_signed_limbs_i8
    rng = np.random.default_rng(7)
    for bgbit, nd in [(9, 2), (14, 2), (16, 3), (18, 3), (22, 3), (23, 3)]:
        half = 1 << (bgbit - 1)
        x = np.concatenate([
            rng.integers(-half, half, size=(500,)),
            np.array([-half, half - 1, 0, -1, 1])]).astype(np.int32)
        limbs = np.asarray(split_signed_limbs_i8(jnp.asarray(x), nd))
        assert limbs.dtype == np.int8
        recon = sum(limbs[i].astype(np.int64) << (8 * i) for i in range(nd))
        np.testing.assert_array_equal(recon, x.astype(np.int64),
                                      err_msg=f"bgbit={bgbit}")


def test_split_balanced_limbs_reconstruct():
    rng = np.random.default_rng(4)
    x = rng.integers(-(1 << 31), 1 << 31, size=(100,)).astype(np.int32)
    limbs = np.asarray(split_balanced_limbs_i8(jnp.asarray(x), 4))
    assert limbs.dtype == np.int8
    recon = np.zeros(100, np.uint64)
    for i in range(4):
        recon += (limbs[i].astype(np.int64) % (1 << 32)).astype(np.uint64) << (8 * i)
    np.testing.assert_array_equal((recon & 0xFFFFFFFF).astype(np.int64),
                                  x.astype(np.int64) % (1 << 32))


def test_toeplitz_structure():
    """T[j, n] = D[N + n - j]."""
    rng = np.random.default_rng(5)
    d = rng.integers(-(1 << 20), 1 << 20, size=(2 * N,)).astype(np.int32)
    t = np.asarray(toeplitz_from_band(jnp.asarray(d)))
    for j in range(0, N, 7):
        for n in range(0, N, 7):
            assert t[j, n] == d[N + n - j]


def test_conv_kernel_layout():
    """kernel[kw] = D[2N-1-kw]; conv(a,k)[n] = sum a[n+kw-(N-1)]*kernel[kw]."""
    rng = np.random.default_rng(6)
    k = _rand_u32(rng, (N,))
    kern = np.asarray(conv_kernel_from_poly(jnp.asarray(k)))
    assert kern.shape == (2 * N - 1,)
    d = np.concatenate([(-k.astype(np.int64)) % (1 << 32), k]).astype(np.uint32)
    np.testing.assert_array_equal(
        kern.astype(np.int64) % (1 << 32), d[1:][::-1].astype(np.int64))
