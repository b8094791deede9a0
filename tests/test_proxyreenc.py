"""Proxy re-encryption (proxyreenc/proxyreenc_test.go:27-167).

Statistical thresholds mirror the reference: >=90-95% accuracy over 100
ciphertexts, 3-hop chains."""

import jax
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, proxyreenc

P = tfhe.TEST_FAST


@pytest.fixture(scope="module")
def users():
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    return [tfhe.gen_secret_key(k, P) for k in ks]


def test_public_key_encrypt_decrypt(users):
    alice = users[0]
    pk = proxyreenc.gen_public_key(jax.random.PRNGKey(1), alice.lv0, P)
    bits = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(2), 0.5, (100,)))
    ct = proxyreenc.pk_encrypt_bool(jax.random.PRNGKey(3), pk, bits,
                                    P.lwe_alpha)
    dec = np.asarray(cipher.lwe_decrypt_bool(ct, alice.lv0))
    assert (dec == bits).mean() >= 0.95


def test_symmetric_reencryption(users):
    alice, bob = users[0], users[1]
    rk = proxyreenc.gen_reencryption_key_symmetric(
        jax.random.PRNGKey(4), alice.lv0, bob.lv0, P)
    bits = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(5), 0.5, (100,)))
    ct = cipher.lwe_encrypt_bool(jax.random.PRNGKey(6), bits, P.lwe_alpha,
                                 alice.lv0)
    ct_bob = proxyreenc.reencrypt(rk, ct)
    dec = np.asarray(cipher.lwe_decrypt_bool(ct_bob, bob.lv0))
    assert (dec == bits).mean() >= 0.95
    # Alice can no longer decrypt reliably is NOT guaranteed; but Bob must.


def test_asymmetric_reencryption(users):
    """Re-encryption key generated from Bob's PUBLIC key only
    (proxyreenc.go:180-232)."""
    alice, bob = users[0], users[1]
    pk_bob = proxyreenc.gen_public_key(jax.random.PRNGKey(7), bob.lv0, P)
    rk = proxyreenc.gen_reencryption_key_asymmetric(
        jax.random.PRNGKey(8), alice.lv0, pk_bob, P)
    bits = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(9), 0.5, (100,)))
    ct = cipher.lwe_encrypt_bool(jax.random.PRNGKey(10), bits, P.lwe_alpha,
                                 alice.lv0)
    ct_bob = proxyreenc.reencrypt(rk, ct)
    dec = np.asarray(cipher.lwe_decrypt_bool(ct_bob, bob.lv0))
    assert (dec == bits).mean() >= 0.90


def test_three_hop_chain(users):
    """alice -> bob -> carol (proxyreenc_test.go:140-167)."""
    alice, bob, carol = users
    rk_ab = proxyreenc.gen_reencryption_key_symmetric(
        jax.random.PRNGKey(11), alice.lv0, bob.lv0, P)
    rk_bc = proxyreenc.gen_reencryption_key_symmetric(
        jax.random.PRNGKey(12), bob.lv0, carol.lv0, P)
    bits = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(13), 0.5, (100,)))
    ct = cipher.lwe_encrypt_bool(jax.random.PRNGKey(14), bits, P.lwe_alpha,
                                 alice.lv0)
    ct2 = proxyreenc.reencrypt(rk_bc, proxyreenc.reencrypt(rk_ab, ct))
    dec = np.asarray(cipher.lwe_decrypt_bool(ct2, carol.lv0))
    assert (dec == bits).mean() >= 0.90


def test_reencryption_batched_shapes(users):
    alice, bob = users[0], users[1]
    rk = proxyreenc.gen_reencryption_key_symmetric(
        jax.random.PRNGKey(15), alice.lv0, bob.lv0, P)
    bits = np.zeros((2, 3), bool)
    ct = cipher.lwe_encrypt_bool(jax.random.PRNGKey(16), bits, P.lwe_alpha,
                                 alice.lv0)
    out = proxyreenc.reencrypt(rk, ct)
    assert out.shape == (2, 3, P.lwe_n + 1)


def test_proxy_key_serialization_roundtrip(tmp_path, users):
    """The proxy role persists ONLY its re-encryption key (new capability
    vs. the reference, which keeps keys in process memory only); a loaded
    rekey must re-encrypt identically to the in-memory one."""
    alice, bob = users[0], users[1]
    rk = proxyreenc.gen_reencryption_key_symmetric(
        jax.random.PRNGKey(21), alice.lv0, bob.lv0, P)
    path = str(tmp_path / "rk.npz")
    proxyreenc.save_reencryption_key(path, rk)
    rk2 = proxyreenc.load_reencryption_key(path)
    assert rk2.basebit == rk.basebit and rk2.t == rk.t
    bits = np.asarray([True, False, True, True])
    ct = cipher.lwe_encrypt_bool(jax.random.PRNGKey(22), bits, P.lwe_alpha,
                                 alice.lv0)
    np.testing.assert_array_equal(np.asarray(proxyreenc.reencrypt(rk2, ct)),
                                  np.asarray(proxyreenc.reencrypt(rk, ct)))

    pk = proxyreenc.gen_public_key(jax.random.PRNGKey(23), bob.lv0, P)
    pkp = str(tmp_path / "pk.npz")
    proxyreenc.save_public_key(pkp, pk)
    pk2 = proxyreenc.load_public_key(pkp)
    np.testing.assert_array_equal(np.asarray(pk2.encryptions),
                                  np.asarray(pk.encryptions))
