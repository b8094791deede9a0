"""Encrypt/decrypt statistical correctness (mirrors tlwe/tlwe_test.go:26-44,
trlwe tests, and tlwe/programmable_encrypt.go encode/decode)."""

import jax
import jax.numpy as jnp
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher

P = tfhe.TEST_FAST


def _keys(seed=0):
    return tfhe.gen_secret_key(jax.random.PRNGKey(seed), P)


def test_lwe_bool_roundtrip_100():
    sk = _keys()
    rng = jax.random.PRNGKey(1)
    bits = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(2), 0.5, (100,)))
    ct = cipher.lwe_encrypt_bool(rng, bits, P.lwe_alpha, sk.lv0)
    dec = np.asarray(cipher.lwe_decrypt_bool(ct, sk.lv0))
    np.testing.assert_array_equal(dec, bits)


def test_lwe_linear_ops():
    sk = _keys()
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    a = cipher.lwe_encrypt_bool(k1, True, P.lwe_alpha, sk.lv0)
    b = cipher.lwe_encrypt_bool(k2, False, P.lwe_alpha, sk.lv0)
    # true(+1/8) + false(-1/8) = 0 -> decrypts "true" boundary; instead test
    # homomorphic negation: -enc(true) decrypts false.
    neg = cipher.lwe_neg(a)
    assert not bool(cipher.lwe_decrypt_bool(neg, sk.lv0))
    # add/sub consistency: (a+b)-b == a exactly
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_sub(cipher.lwe_add(a, b), b)), np.asarray(a))
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_add_mul(a, b, 3)),
        np.asarray(a + b * jnp.uint32(3)))


def test_lwe_message_roundtrip():
    sk = _keys()
    modulus = 8
    msgs = np.arange(8)
    ct = cipher.lwe_encrypt_message(jax.random.PRNGKey(4), msgs, modulus,
                                    P.lwe_alpha, sk.lv0)
    dec = np.asarray(cipher.lwe_decrypt_message(ct, modulus, sk.lv0))
    np.testing.assert_array_equal(dec, msgs)


def test_encode_message_values():
    # m * 2^31/modulus (tlwe/programmable_encrypt.go:12-26)
    assert cipher.encode_message(0, 4) == 0
    assert cipher.encode_message(1, 4) == 1 << 29
    assert cipher.encode_message(3, 4) == 3 << 29
    assert cipher.encode_message(5, 4) == 1 << 29  # mod 4


def test_trlwe_bool_roundtrip():
    sk = _keys()
    bits = np.asarray(
        jax.random.bernoulli(jax.random.PRNGKey(5), 0.5, (4, P.n)))
    ct = cipher.trlwe_encrypt_bool(jax.random.PRNGKey(6), bits, P.lv1_alpha,
                                   sk.lv1)
    dec = np.asarray(cipher.trlwe_decrypt_bool(ct, sk.lv1))
    np.testing.assert_array_equal(dec, bits)


def test_trgsw_shape_and_gadget():
    sk = _keys()
    ct = cipher.trgsw_encrypt_torus(jax.random.PRNGKey(7), jnp.uint32(1),
                                    P.bsk_alpha, sk.lv1, P)
    assert ct.shape == (2 * P.l, 2, P.n)


def test_batched_encrypt_shapes():
    sk = _keys()
    bits = np.zeros((3, 5), bool)
    ct = cipher.lwe_encrypt_bool(jax.random.PRNGKey(8), bits, P.lwe_alpha,
                                 sk.lv0)
    assert ct.shape == (3, 5, P.lwe_n + 1)
    dec = cipher.lwe_decrypt_bool(ct, sk.lv0)
    assert dec.shape == (3, 5)


def test_sample_extract_to_lv0():
    """SampleExtractIndex2 (trlwe/trlwe.go:133-154): valid only when the
    ring degree equals lwe_n; the extracted sample decrypts under the ring
    key read as a level-0 key."""
    import pytest
    from go_tfhe_jax.ops import sample_extract, sample_extract_to_lv0

    sk = _keys()
    bits = np.asarray(
        jax.random.bernoulli(jax.random.PRNGKey(9), 0.5, (P.n,)))
    ct = cipher.trlwe_encrypt_bool(jax.random.PRNGKey(10), bits,
                                   P.lv1_alpha, sk.lv1)
    # Matching dims (lwe_n == N): identical to level-1 extraction, and the
    # coefficient-0 message decrypts correctly under the ring key.
    out = sample_extract_to_lv0(ct, P.n, k=0)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(sample_extract(ct, 0)))
    dec = bool(cipher.lwe_decrypt_bool(out, sk.lv1))
    assert dec == bool(bits[0])
    # Dimension mismatch is a trace-time error, not a silent wrong answer.
    with pytest.raises(ValueError, match="use sample_extract"):
        sample_extract_to_lv0(ct, P.lwe_n)
