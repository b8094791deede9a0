"""Gate truth tables over all input combinations (gates/gates_test.go:23-480).

All four (a, b) combos are evaluated in ONE batched call per gate — the
reference's Batch* API is subsumed by the batch axis."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, gates

A = np.array([False, False, True, True])
B = np.array([False, True, False, True])

TRUTH = {
    "NAND": ~(A & B),
    "AND": A & B,
    "OR": A | B,
    "XOR": A ^ B,
    "XNOR": ~(A ^ B),
    "NOR": ~(A | B),
    "ANDNY": ~A & B,
    "ANDYN": A & ~B,
    "ORNY": ~A | B,
    "ORYN": A | ~B,
}


@pytest.fixture(scope="module")
def enc(fast_keys):
    p, sk, ck = fast_keys
    ka, kb = jax.random.split(jax.random.PRNGKey(100))
    ca = cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    return ca, cb


@pytest.mark.parametrize("name", sorted(TRUTH))
def test_gate_truth_table(fast_keys, enc, name):
    p, sk, ck = fast_keys
    ca, cb = enc
    out = getattr(gates, name)(ck, ca, cb)
    dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
    np.testing.assert_array_equal(dec, TRUTH[name], err_msg=name)


def test_not_no_bootstrap(fast_keys, enc):
    p, sk, ck = fast_keys
    ca, _ = enc
    dec = np.asarray(cipher.lwe_decrypt_bool(gates.NOT(ca), sk.lv0))
    np.testing.assert_array_equal(dec, ~A)


def test_copy(fast_keys, enc):
    ca, _ = enc
    np.testing.assert_array_equal(np.asarray(gates.COPY(ca)), np.asarray(ca))


def test_constant(fast_keys):
    p, sk, ck = fast_keys
    for v in (True, False):
        ct = gates.constant(p, v, (3,))
        dec = np.asarray(cipher.lwe_decrypt_bool(ct, sk.lv0))
        np.testing.assert_array_equal(dec, np.full(3, v))


def test_mux_all_combos(fast_keys):
    """MUX over all 8 (sel, a, b) combos (gates/gates_test.go:338-366)."""
    p, sk, ck = fast_keys
    sel = np.array([False, False, False, False, True, True, True, True])
    a = np.array([False, False, True, True] * 2)
    b = np.array([False, True, False, True] * 2)
    ks, ka, kb = jax.random.split(jax.random.PRNGKey(200), 3)
    cs = cipher.lwe_encrypt_bool(ks, sel, p.lwe_alpha, sk.lv0)
    ca = cipher.lwe_encrypt_bool(ka, a, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(kb, b, p.lwe_alpha, sk.lv0)
    out = gates.MUX(ck, cs, ca, cb)
    dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
    np.testing.assert_array_equal(dec, np.where(sel, a, b))
    # MUX output composes with ordinary gates (it is noisier than a
    # fresh bootstrap output: two summed branch bootstraps + key switch)
    dec2 = np.asarray(cipher.lwe_decrypt_bool(
        gates.AND(ck, out, cs), sk.lv0))
    np.testing.assert_array_equal(dec2, np.where(sel, a, b) & sel)
    # and the reference's 3-gate composition agrees (gates/gates.go:107)
    dec3 = np.asarray(cipher.lwe_decrypt_bool(
        gates.MUX_3GATE(ck, cs, ca, cb), sk.lv0))
    np.testing.assert_array_equal(dec3, np.where(sel, a, b))


def test_gate_composition(fast_keys, enc):
    """Bootstrapped outputs are valid inputs: AND(OR(a,b), NAND(a,b))."""
    p, sk, ck = fast_keys
    ca, cb = enc
    out = gates.AND(ck, gates.OR(ck, ca, cb), gates.NAND(ck, ca, cb))
    dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
    np.testing.assert_array_equal(dec, (A | B) & ~(A & B))


def test_multi_dim_batch(fast_keys):
    """Gates broadcast over arbitrary leading axes."""
    p, sk, ck = fast_keys
    a = np.resize(A, (2, 4))
    b = np.resize(B, (2, 4))
    ka, kb = jax.random.split(jax.random.PRNGKey(300))
    ca = cipher.lwe_encrypt_bool(ka, a, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(kb, b, p.lwe_alpha, sk.lv0)
    out = gates.XOR(ck, ca, cb)
    assert out.shape == (2, 4, p.lwe_n + 1)
    dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
    np.testing.assert_array_equal(dec, a ^ b)
