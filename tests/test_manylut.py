"""Multi-LUT bootstrapping (PBSmanyLUT): k functions from ONE blind
rotation via a coarse mod switch + interleaved test vector.

Beyond-reference capability (engine.bootstrap_many,
lut.Generator.gen_multi_lut, ops.blindrotate.mod_switch_2n theta>0).
Covers: the coarse mod switch itself, identity+complement in one
bootstrap, 4 functions at theta=2, the many-LUT full adder (1 bootstrap
per bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine, lut
from go_tfhe_jax.ops.blindrotate import mod_switch_2n


def test_coarse_mod_switch_values():
    """theta rounds to multiples of 2^theta of the 2N grid; theta=0 is the
    reference mod switch bit-for-bit."""
    p = tfhe.TEST_PBS
    xs = jnp.asarray(np.arange(0, 2 ** 32, 2 ** 27, dtype=np.uint64)
                     .astype(np.uint32))
    base = np.asarray(mod_switch_2n(xs, p))
    for theta in (1, 2, 3):
        coarse = np.asarray(mod_switch_2n(xs, p, theta))
        assert (coarse % (1 << theta) == 0).all()
        # coarse rounding stays within 2^(theta-1) of the fine value
        assert (np.abs(coarse - base) <= 1 << (theta - 1)).all()


def test_bootstrap_many_two_functions(pbs_keys):
    """identity and complement of the same input, ONE bootstrap."""
    p, sk, ck = pbs_keys
    m = p.message_modulus
    gen = lut.Generator(p)
    mlut = gen.gen_multi_lut([lambda x: x, lambda x: (m - 1) - x], theta=1)
    msgs = np.arange(8) % (m // 2)        # stay in the first torus half
    ct = cipher.lwe_encrypt_message(jax.random.PRNGKey(3), msgs, m,
                                    p.lwe_alpha, sk.lv0)
    out = engine.bootstrap_many(ck, ct, mlut, k=2, theta=1)
    assert out.shape == (2,) + ct.shape
    ident = np.asarray(cipher.lwe_decrypt_message(out[0], m, sk.lv0))
    compl = np.asarray(cipher.lwe_decrypt_message(out[1], m, sk.lv0))
    np.testing.assert_array_equal(ident, msgs)
    np.testing.assert_array_equal(compl, (m - 1) - msgs)


def test_bootstrap_many_four_functions_theta2(pbs_keys):
    """four functions at theta=2 from one rotation."""
    p, sk, ck = pbs_keys
    m = p.message_modulus
    fns = [lambda x: x, lambda x: (x + 1) % (m // 2),
           lambda x: (2 * x) % (m // 2), lambda x: 0]
    gen = lut.Generator(p)
    mlut = gen.gen_multi_lut(fns, theta=2)
    msgs = np.asarray([0, 1, 2, 3])
    ct = cipher.lwe_encrypt_message(jax.random.PRNGKey(5), msgs, m,
                                    p.lwe_alpha, sk.lv0)
    out = engine.bootstrap_many(ck, ct, mlut, k=4, theta=2)
    for t, f in enumerate(fns):
        got = np.asarray(cipher.lwe_decrypt_message(out[t], m, sk.lv0))
        np.testing.assert_array_equal(got, [f(x) for x in msgs],
                                      err_msg=f"function {t}")


def test_full_adder_manylut():
    """sum and carry of a+b+cin from ONE bootstrap, all 8 input combos."""
    from go_tfhe_jax.models import adders

    p = tfhe.TEST_NIBBLE
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    a = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    b = np.array([0, 0, 1, 1, 0, 0, 1, 1])
    c = np.array([0, 1, 0, 1, 0, 1, 0, 1])
    keys = jax.random.split(k3, 3)
    enc = lambda k, v: cipher.lwe_encrypt_message(k, v, 8, p.lwe_alpha,
                                                  sk.lv0)
    s_ct, c_ct = adders.full_adder_manylut(
        ck, enc(keys[0], a), enc(keys[1], b), enc(keys[2], c))
    s = np.asarray(cipher.lwe_decrypt_message(s_ct, 8, sk.lv0))
    cout = np.asarray(cipher.lwe_decrypt_message(c_ct, 8, sk.lv0))
    np.testing.assert_array_equal(s, (a + b + c) & 1)
    np.testing.assert_array_equal(cout, (a + b + c) >> 1)


def test_ripple_add_manylut_4bit():
    """4-bit addition at 1 bootstrap/bit: 11 + 7 = 18 (with carry out)."""
    from go_tfhe_jax.models import adders

    p = tfhe.TEST_NIBBLE
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(9), 3)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    va, vb = 11, 7
    bits = lambda v: np.asarray([(v >> i) & 1 for i in range(4)])
    ka, kb = jax.random.split(k3)
    enc = lambda k, v: cipher.lwe_encrypt_message(k, bits(v), 8,
                                                  p.lwe_alpha, sk.lv0)
    s_bits, carry = adders.ripple_add_manylut(ck, enc(ka, va), enc(kb, vb))
    s = np.asarray(cipher.lwe_decrypt_message(s_bits, 8, sk.lv0))
    cout = int(cipher.lwe_decrypt_message(carry, 8, sk.lv0))
    total = sum(int(s[i]) << i for i in range(4)) | (cout << 4)
    assert total == va + vb, (s.tolist(), cout)


def test_gates_and_or_single_bootstrap(fast_keys):
    """gates.AND_OR: both truth tables from one bootstrap, outputs valid
    +-1/8 booleans that compose with ordinary gates."""
    from go_tfhe_jax import gates

    p, sk, ck = fast_keys
    bits_a = np.array([False, False, True, True])
    bits_b = np.array([False, True, False, True])
    ka, kb = jax.random.split(jax.random.PRNGKey(15))
    ct_a = cipher.lwe_encrypt_bool(ka, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(kb, bits_b, p.lwe_alpha, sk.lv0)
    and_ct, or_ct = gates.AND_OR(ck, ct_a, ct_b)
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_decrypt_bool(and_ct, sk.lv0)),
        bits_a & bits_b)
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_decrypt_bool(or_ct, sk.lv0)),
        bits_a | bits_b)
    # composability: NAND of the two outputs through the normal gate path
    nand = gates.NAND(ck, and_ct, or_ct)
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_decrypt_bool(nand, sk.lv0)),
        ~((bits_a & bits_b) & (bits_a | bits_b)))


def test_bootstrap_many_per_ciphertext_luts(pbs_keys):
    """Per-ciphertext multi-LUT batches: different function PAIRS per
    ciphertext in one call (inexpressible upstream even for k=1)."""
    p, sk, ck = pbs_keys
    m = p.message_modulus
    gen = lut.Generator(p)
    mlut_a = gen.gen_multi_lut([lambda x: x, lambda x: (x + 1) % (m // 2)],
                               theta=1)
    mlut_b = gen.gen_multi_lut([lambda x: (2 * x) % (m // 2), lambda x: 0],
                               theta=1)
    msgs = np.asarray([1, 2, 3, 1])
    ct = cipher.lwe_encrypt_message(jax.random.PRNGKey(17), msgs, m,
                                    p.lwe_alpha, sk.lv0)
    luts = jnp.stack([mlut_a, mlut_b, mlut_a, mlut_b])
    out = engine.bootstrap_many(ck, ct, luts, k=2, theta=1)
    got0 = np.asarray(cipher.lwe_decrypt_message(out[0], m, sk.lv0))
    got1 = np.asarray(cipher.lwe_decrypt_message(out[1], m, sk.lv0))
    # per-ct fn0: id(1), (2*2)%4=0, id(3), (2*1)%4=2
    np.testing.assert_array_equal(got0, [1, 0, 3, 2])
    # per-ct fn1: (1+1)%4=2, 0, (3+1)%4=0, 0
    np.testing.assert_array_equal(got1, [2, 0, 0, 0])
