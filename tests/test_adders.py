"""Homomorphic adders: ripple-carry (README.md:78-115) and the PBS nibble
method (examples/add_two_numbers/main.go:44-136)."""

import jax
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import bitutils, cipher
from go_tfhe_jax.models import adders


def test_half_adder(fast_keys):
    p, sk, ck = fast_keys
    a = np.array([False, False, True, True])
    b = np.array([False, True, False, True])
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    ca = cipher.lwe_encrypt_bool(ka, a, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(kb, b, p.lwe_alpha, sk.lv0)
    s, c = adders.half_adder(ck, ca, cb)
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_decrypt_bool(s, sk.lv0)), a ^ b)
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_decrypt_bool(c, sk.lv0)), a & b)


def test_ripple_carry_4bit(fast_keys):
    p, sk, ck = fast_keys
    va, vb = 11, 7                       # 11 + 7 = 18 = 0b10010
    a = bitutils.to_bits(va, 4)
    b = bitutils.to_bits(vb, 4)
    ka, kb = jax.random.split(jax.random.PRNGKey(1))
    ca = bitutils.encrypt_bits(ka, a, p.lwe_alpha, sk.lv0)
    cb = bitutils.encrypt_bits(kb, b, p.lwe_alpha, sk.lv0)
    s_bits, carry = adders.ripple_carry_add(ck, ca, cb)
    s = bitutils.from_bits(np.asarray(bitutils.decrypt_bits(s_bits, sk.lv0)))
    c = bool(cipher.lwe_decrypt_bool(carry, sk.lv0))
    assert s + (int(c) << 4) == va + vb


def test_ripple_carry_batched(fast_keys):
    """Two independent additions in one batch."""
    p, sk, ck = fast_keys
    pairs = [(3, 5), (9, 9)]
    a = np.stack([bitutils.to_bits(x, 4) for x, _ in pairs])
    b = np.stack([bitutils.to_bits(y, 4) for _, y in pairs])
    ka, kb = jax.random.split(jax.random.PRNGKey(2))
    ca = bitutils.encrypt_bits(ka, a, p.lwe_alpha, sk.lv0)
    cb = bitutils.encrypt_bits(kb, b, p.lwe_alpha, sk.lv0)
    s_bits, carry = adders.ripple_carry_add(ck, ca, cb)
    dec = np.asarray(bitutils.decrypt_bits(s_bits, sk.lv0))
    cdec = np.asarray(cipher.lwe_decrypt_bool(carry, sk.lv0))
    for i, (x, y) in enumerate(pairs):
        got = bitutils.from_bits(dec[i]) + (int(cdec[i]) << 4)
        assert got == x + y, (x, y, got)


def test_add8_pbs_nibble():
    """8-bit addition in 3 programmable bootstraps
    (examples/add_two_numbers/main.go:98-136)."""
    p = tfhe.TEST_NIBBLE
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)

    va, vb = 0xA7, 0x5C                 # 167 + 92 = 259 -> 0x03 mod 256
    keys = jax.random.split(k3, 4)
    enc = lambda k, v: cipher.lwe_encrypt_message(k, v, 32, p.lwe_alpha,
                                                  sk.lv0)
    ct_al, ct_ah = enc(keys[0], va & 0xF), enc(keys[1], va >> 4)
    ct_bl, ct_bh = enc(keys[2], vb & 0xF), enc(keys[3], vb >> 4)

    sum_low, sum_high = adders.add8_pbs(ck, ct_al, ct_ah, ct_bl, ct_bh)
    lo = int(cipher.lwe_decrypt_message(sum_low, 32, sk.lv0)) & 0xF
    hi = int(cipher.lwe_decrypt_message(sum_high, 32, sk.lv0)) & 0xF
    assert (hi << 4) | lo == (va + vb) & 0xFF
