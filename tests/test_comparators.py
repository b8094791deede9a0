"""Homomorphic comparators (models/comparators.py): ge/le/gt/lt/eq/neq
over message-encoded integers, exhaustively on a small domain."""

import itertools

import jax
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher
from go_tfhe_jax.models import comparators


@pytest.fixture(scope="module")
def cmp_keys():
    p = tfhe.TEST_PBS                      # message_modulus 8 -> values 0..3
    k1, k2 = jax.random.split(jax.random.PRNGKey(31))
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    return p, sk, ck


def test_comparators_exhaustive(cmp_keys):
    p, sk, ck = cmp_keys
    m = p.message_modulus
    pairs = list(itertools.product(range(m // 2), repeat=2))   # 16 pairs
    a = np.asarray([x for x, _ in pairs])
    b = np.asarray([y for _, y in pairs])
    ka, kb = jax.random.split(jax.random.PRNGKey(33))
    ct_a = cipher.lwe_encrypt_message(ka, a, m, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_message(kb, b, m, p.lwe_alpha, sk.lv0)

    dec = lambda ct: np.asarray(cipher.lwe_decrypt_bool(ct, sk.lv0))
    np.testing.assert_array_equal(dec(comparators.ge(ck, ct_a, ct_b)),
                                  a >= b)
    np.testing.assert_array_equal(dec(comparators.lt(ck, ct_a, ct_b)),
                                  a < b)
    np.testing.assert_array_equal(dec(comparators.gt(ck, ct_a, ct_b)),
                                  a > b)
    np.testing.assert_array_equal(dec(comparators.le(ck, ct_a, ct_b)),
                                  a <= b)
    np.testing.assert_array_equal(dec(comparators.eq(ck, ct_a, ct_b)),
                                  a == b)
    np.testing.assert_array_equal(dec(comparators.neq(ck, ct_a, ct_b)),
                                  a != b)
