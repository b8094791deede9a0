"""Bit-exact tests of the bootstrap sub-kernels against ported Go oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from conftest import (decompose_oracle, monomial_mul_oracle,
                      sample_extract_oracle)
from go_tfhe_jax import cipher
from go_tfhe_jax.ops.blindrotate import blind_rotate, mod_switch_2n
from go_tfhe_jax.ops.decompose import gadget_decompose
from go_tfhe_jax.ops.extprod import cmux, external_product
from go_tfhe_jax.ops.keyswitch import identity_key_switch, ks_digits
from go_tfhe_jax.ops.polymul import prepare_band_limbs
from go_tfhe_jax.ops.rotate import monomial_mul
from go_tfhe_jax.ops.sample_extract import sample_extract

P = tfhe.TEST_FAST


def _rand_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


# ---------------------------------------------------------------------------
# Gadget decomposition.
# ---------------------------------------------------------------------------

def test_gadget_decompose_matches_oracle():
    rng = np.random.default_rng(0)
    x = _rand_u32(rng, (2, P.n))
    out = np.asarray(gadget_decompose(jnp.asarray(x)[None], P))[0]
    # rows are [A digits x L, B digits x L]
    for c in range(2):
        oracle = decompose_oracle(x[c], P)
        for lvl in range(P.l):
            np.testing.assert_array_equal(out[c * P.l + lvl], oracle[lvl])


def test_gadget_decompose_reconstructs():
    """sum_i digit_i * 2^(32-(i+1)BGBIT) ~= x (within rounding tail)."""
    rng = np.random.default_rng(1)
    x = _rand_u32(rng, (1, P.n))
    d = np.asarray(gadget_decompose(jnp.asarray(x)[None], P))[0, :P.l]
    recon = np.zeros(P.n, np.int64)
    for i in range(P.l):
        recon += d[i].astype(np.int64) << (32 - (i + 1) * P.bgbit)
    err = (recon - x.astype(np.int64)[0]) % (1 << 32)
    err = np.minimum(err, (1 << 32) - err)
    assert err.max() <= 1 << (32 - P.l * P.bgbit)


# ---------------------------------------------------------------------------
# Monomial rotation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 5, 63, 64, 65, 127, 128, 200, 255])
def test_monomial_mul_matches_go(k):
    rng = np.random.default_rng(k)
    a = _rand_u32(rng, (P.n,))
    out = np.asarray(monomial_mul(jnp.asarray(a), jnp.int32(k)))
    np.testing.assert_array_equal(out, monomial_mul_oracle(a, k))


def test_monomial_mul_per_row_amounts():
    """One batched call with a different amount per row (the blind
    rotation's case) equals the Go port row by row, wraps included."""
    rng = np.random.default_rng(99)
    ks = np.array([0, 1, 37, P.n - 1, P.n, P.n + 13, 2 * P.n - 1])
    a = _rand_u32(rng, (len(ks), P.n))
    out = np.asarray(monomial_mul(jnp.asarray(a), jnp.asarray(ks, jnp.int32)))
    for row, k in enumerate(ks):
        np.testing.assert_array_equal(out[row], monomial_mul_oracle(a[row], k),
                                      err_msg=f"k={k}")


def test_monomial_mul_composition():
    """X^j * (X^k * p) == X^(j+k) * p up to the NOT-vs-neg ulp convention.

    With the reference's ~x negation the composition is exact only when
    the wrap count parities line up, so test with the *exact* check on
    k + j < N (no double wrap)."""
    rng = np.random.default_rng(5)
    a = _rand_u32(rng, (P.n,))
    out1 = monomial_mul(monomial_mul(jnp.asarray(a), jnp.int32(0)),
                        jnp.int32(17))
    out2 = monomial_mul(jnp.asarray(a), jnp.int32(17))
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))


# ---------------------------------------------------------------------------
# Sample extraction.
# ---------------------------------------------------------------------------

def test_sample_extract_matches_oracle():
    rng = np.random.default_rng(2)
    t = _rand_u32(rng, (2, P.n))
    out = np.asarray(sample_extract(jnp.asarray(t), 0))
    np.testing.assert_array_equal(out, sample_extract_oracle(t, 0))


def test_sample_extract_nonzero_index():
    rng = np.random.default_rng(3)
    t = _rand_u32(rng, (2, P.n))
    for k in [1, 5, P.n - 1]:
        out = np.asarray(sample_extract(jnp.asarray(t), k))
        np.testing.assert_array_equal(out, sample_extract_oracle(t, k))


def test_sample_extract_decrypts(fast_keys):
    """Extraction at 0 of a TRLWE encrypting constant mu decrypts to mu."""
    p, sk, ck = fast_keys
    rng = jax.random.PRNGKey(11)
    mu = np.full((p.n,), cipher.BOOL_TRUE_MU, np.uint32)
    ct = cipher.trlwe_encrypt_torus(rng, jnp.asarray(mu), p.lv1_alpha, sk.lv1)
    lv1 = sample_extract(ct, 0)
    phase = cipher.lwe_phase(lv1, sk.lv1)
    err = int(phase) - cipher.BOOL_TRUE_MU
    err = min(err % (1 << 32), (-err) % (1 << 32))
    assert err < 1 << 24


# ---------------------------------------------------------------------------
# External product / CMUX.
# ---------------------------------------------------------------------------

def _encrypt_trgsw_bit(rng, bit, sk, p):
    return cipher.trgsw_encrypt_torus(rng, jnp.uint32(bit), p.bsk_alpha,
                                      sk.lv1, p)


def test_external_product_selects(fast_keys):
    """TRGSW(0) x ct ~ 0;  TRGSW(1) x ct ~ ct (up to noise)."""
    p, sk, ck = fast_keys
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(21), 3)
    mu = np.full((p.n,), cipher.BOOL_TRUE_MU, np.uint32)
    ct = cipher.trlwe_encrypt_torus(k1, jnp.asarray(mu), p.lv1_alpha, sk.lv1)

    for bit, expect_mu in [(0, 0), (1, cipher.BOOL_TRUE_MU)]:
        g = _encrypt_trgsw_bit(k2 if bit == 0 else k3, bit, sk, p)
        band = prepare_band_limbs(g, p.kernel_limb_drop)
        out = external_product(p, band, ct)
        phase = np.asarray(cipher.trlwe_phase(out, sk.lv1)).astype(np.int64)
        err = (phase - expect_mu) % (1 << 32)
        err = np.minimum(err, (1 << 32) - err)
        assert err.max() < 1 << 26, f"bit={bit}"


def test_cmux_selects(fast_keys):
    p, sk, ck = fast_keys
    keys = jax.random.split(jax.random.PRNGKey(31), 4)
    mu0 = np.full((p.n,), cipher.BOOL_FALSE_MU, np.uint32)
    mu1 = np.full((p.n,), cipher.BOOL_TRUE_MU, np.uint32)
    ct0 = cipher.trlwe_encrypt_torus(keys[0], jnp.asarray(mu0), p.lv1_alpha,
                                     sk.lv1)
    ct1 = cipher.trlwe_encrypt_torus(keys[1], jnp.asarray(mu1), p.lv1_alpha,
                                     sk.lv1)
    for bit, want in [(0, False), (1, True)]:
        g = _encrypt_trgsw_bit(keys[2 + bit], bit, sk, p)
        band = prepare_band_limbs(g, p.kernel_limb_drop)
        out = cmux(p, band, ct0, ct1)
        dec = np.asarray(cipher.trlwe_decrypt_bool(out, sk.lv1))
        assert bool(dec.all()) == want


# ---------------------------------------------------------------------------
# Key switching.
# ---------------------------------------------------------------------------

def test_ks_digits_range():
    rng = np.random.default_rng(4)
    a = _rand_u32(rng, (P.n,))
    d = np.asarray(ks_digits(P, jnp.asarray(a)))
    assert d.shape == (P.n, P.iks_t)
    assert d.min() >= 0 and d.max() < P.base


def test_identity_key_switch_decrypts(fast_keys):
    p, sk, ck = fast_keys
    rng = jax.random.PRNGKey(41)
    mus = jnp.asarray(np.array(
        [cipher.BOOL_TRUE_MU, cipher.BOOL_FALSE_MU], np.uint32))
    lv1 = cipher.lwe_encrypt_torus(rng, mus, p.lv1_alpha, sk.lv1)
    lv0 = identity_key_switch(p, ck.ksk, lv1)
    dec = np.asarray(cipher.lwe_decrypt_bool(lv0, sk.lv0))
    np.testing.assert_array_equal(dec, [True, False])


# ---------------------------------------------------------------------------
# Mod switch + blind rotation.
# ---------------------------------------------------------------------------

def test_mod_switch_formula():
    for b in [0, 1 << 29, 1 << 31, (1 << 32) - 1]:
        got = int(mod_switch_2n(jnp.uint32(b), P))
        # uint32 addition wraps (evaluator/evaluator.go:116 operates on Torus)
        want = ((b + (1 << (31 - P.nbit - 1))) % (1 << 32)) >> (32 - P.nbit - 1)
        assert got == want


def test_blind_rotate_sign(fast_keys):
    """Bootstrapping a fresh encryption of ±1/8 yields a TRLWE whose
    extraction decrypts to the same sign."""
    p, sk, ck = fast_keys
    rng = jax.random.PRNGKey(51)
    bits = np.array([True, False])
    ct = cipher.lwe_encrypt_bool(rng, bits, p.lwe_alpha, sk.lv0)
    rotated = blind_rotate(p, ck.bsk_limbs, ct, ck.testvec)
    lv1 = sample_extract(rotated, 0)
    phase = np.asarray(cipher.lwe_phase(lv1, sk.lv1)).astype(np.int64)
    signs = np.where(phase < (1 << 31), 1, -1)   # positive torus half = +
    np.testing.assert_array_equal(signs, np.where(bits, 1, -1))


def test_centered_decomposition_error():
    """Representation-error spec of the gadget decomposition: floor form
    has error -((x+off) mod grid) in (-grid, 0] (mean -grid/2 — the bias
    whose ring-key walk dominated the bg8/l2 noise, see params.py);
    centered form has error in (-grid/2, grid/2] with near-zero mean."""
    import dataclasses
    import numpy as np
    from go_tfhe_jax.ops.decompose import gadget_decompose
    from go_tfhe_jax.params import TFHEParams

    base = TFHEParams(name="t_center", lwe_n=4, lwe_alpha=1e-7, n=256,
                      lv1_alpha=1e-9, nbit=8, bgbit=8, l=2, basebit=2,
                      iks_t=6, block_size=1)
    cent = dataclasses.replace(base, name="t_center_c",
                               centered_decomposition=True)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.integers(0, 2 ** 32, size=(1, 2, 256),
                                 dtype=np.uint64).astype(np.uint32))
    g = 1 << base.tail_bits
    for p, lo, hi in ((base, -g + 1, 0), (cent, -g // 2 + 1, g // 2)):
        d = np.asarray(gadget_decompose(x, p), np.int64)  # (1, 2*l, n)
        rep = np.zeros((1, 2, 256), np.int64)
        for c in range(2):
            for lv in range(p.l):
                rep[:, c] += d[:, c * p.l + lv] << (32 - (lv + 1) * p.bgbit)
        err = (rep - np.asarray(x, np.int64)) % (1 << 32)
        err = np.where(err >= 1 << 31, err - (1 << 32), err)
        assert err.min() >= lo and err.max() <= hi, (p.name, err.min(),
                                                    err.max())
        if p.centered_decomposition:
            assert abs(err.mean()) < g / 8
