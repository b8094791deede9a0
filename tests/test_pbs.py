"""Programmable bootstrapping + LUT machinery
(mirrors evaluator/programmable_bootstrap_test.go, lut/lut_test.go,
params/uint_params_test.go)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, lut


def test_lut_is_trivial_trlwe(pbs_keys):
    """A coefficients all zero (lut/lut_test.go:10-53)."""
    p, sk, ck = pbs_keys
    gen = lut.Generator(p, p.message_modulus)
    table = np.asarray(gen.gen_lut(lambda x: x))
    assert table.shape == (2, p.n)
    np.testing.assert_array_equal(table[0], 0)
    assert table[1].any()


def test_encoder_roundtrip():
    enc = lut.Encoder(8)
    assert enc.scale == 1.0 / 16
    for m in range(8):
        assert enc.decode(enc.encode(m)) == m


def test_encoder_zero_is_zero():
    assert lut.Encoder(4).encode(0) == 0


def test_mod_switch_domain(pbs_keys):
    p, _, _ = pbs_keys
    gen = lut.Generator(p, p.message_modulus)
    assert gen.mod_switch(0) == 0
    assert gen.mod_switch((1 << 32) - 1) % gen.lut_size == 0  # rounds up
    assert 0 <= gen.mod_switch(1 << 31) < gen.lut_size


@pytest.mark.parametrize("fname,f", [
    ("identity", lambda x: x),
    ("complement", lambda x: 7 - x),        # modulus-1 - x
    ("mod4", lambda x: x % 4),
    ("double", lambda x: (2 * x) % 8),
])
def test_pbs_functions(pbs_keys, fname, f):
    """Identity/Complement/Modulo PBS over the full message domain
    (params/uint_params_test.go:17-127)."""
    p, sk, ck = pbs_keys
    m = p.message_modulus
    msgs = np.arange(m)
    ct = cipher.lwe_encrypt_message(jax.random.PRNGKey(1), msgs, m,
                                    p.lwe_alpha, sk.lv0)
    out = lut.bootstrap_func(ck, ct, f, m)
    dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
    np.testing.assert_array_equal(dec, [f(x) % m for x in msgs], err_msg=fname)


def test_lut_reuse(pbs_keys):
    """One generated LUT applied to many ciphertexts
    (evaluator/programmable_bootstrap_test.go LUT-reuse demo)."""
    p, sk, ck = pbs_keys
    m = p.message_modulus
    gen = lut.Generator(p, m)
    table = gen.gen_lut(lambda x: (x + 1) % m)
    msgs = np.array([0, 3, 7, 5])
    ct = cipher.lwe_encrypt_message(jax.random.PRNGKey(2), msgs, m,
                                    p.lwe_alpha, sk.lv0)
    out = lut.bootstrap_lut(ck, ct, table)
    dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
    np.testing.assert_array_equal(dec, (msgs + 1) % m)


def test_per_ciphertext_luts(pbs_keys):
    """A batch of DIFFERENT LUTs in one call — beyond the reference's API."""
    p, sk, ck = pbs_keys
    m = p.message_modulus
    gen = lut.Generator(p, m)
    t_inc = gen.gen_lut(lambda x: (x + 1) % m)
    t_dbl = gen.gen_lut(lambda x: (2 * x) % m)
    tables = jnp.stack([t_inc, t_dbl])          # (2, 2, N)
    msgs = np.array([3, 3])
    ct = cipher.lwe_encrypt_message(jax.random.PRNGKey(3), msgs, m,
                                    p.lwe_alpha, sk.lv0)
    out = lut.bootstrap_lut(ck, ct, tables)
    dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
    np.testing.assert_array_equal(dec, [4, 6])


def test_bootstrap_is_idempotent_noise_reset(pbs_keys):
    """Chained PBS: f(f(x)) via two bootstraps."""
    p, sk, ck = pbs_keys
    m = p.message_modulus
    msgs = np.array([0, 1, 2, 3])
    ct = cipher.lwe_encrypt_message(jax.random.PRNGKey(4), msgs, m,
                                    p.lwe_alpha, sk.lv0)
    inc = lambda x: (x + 1) % m
    out = lut.bootstrap_func(ck, lut.bootstrap_func(ck, ct, inc, m), inc, m)
    dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
    np.testing.assert_array_equal(dec, (msgs + 2) % m)
