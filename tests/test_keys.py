"""Key generation structure + serialization round-trips (new capability —
the reference never persists keys, SURVEY.md §5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher

P = tfhe.TEST_FAST


def test_secret_key_binary():
    sk = tfhe.gen_secret_key(jax.random.PRNGKey(0), P)
    assert sk.lv0.shape == (P.lwe_n,)
    assert sk.lv1.shape == (P.n,)
    for k in (np.asarray(sk.lv0), np.asarray(sk.lv1)):
        assert set(np.unique(k)) <= {0, 1}


def test_cloud_key_shapes(fast_keys):
    p, sk, ck = fast_keys
    assert ck.testvec.shape == (2, p.n)
    assert ck.ksk.shape == (p.n, p.iks_t, p.base, p.lwe_n + 1)
    assert ck.bsk.shape == (p.lwe_n, 2 * p.l, 2, p.n)
    nl = 4 - p.kernel_limb_drop
    assert ck.bsk_limbs.shape == (nl, p.lwe_n, 2 * p.l, 2, 2 * p.n)
    assert ck.bsk_limbs.dtype == np.int8


def test_testvec_constant_eighth(fast_keys):
    p, sk, ck = fast_keys
    tv = np.asarray(ck.testvec)
    np.testing.assert_array_equal(tv[0], 0)
    np.testing.assert_array_equal(tv[1], np.full(p.n, 1 << 29, np.uint32))


def test_ksk_zero_digit_rows(fast_keys):
    """k==0 entries must be all-zero ciphertexts (cloudkey.go:106-108)."""
    p, sk, ck = fast_keys
    np.testing.assert_array_equal(np.asarray(ck.ksk[:, :, 0, :]), 0)


def test_ksk_entries_decrypt(fast_keys):
    """KSK[i,j,k] encrypts k*s1[i] << (32-(j+1)*basebit)."""
    p, sk, ck = fast_keys
    i, j, k = 3, 1, 2
    want = (np.uint64(k) * np.uint64(np.asarray(sk.lv1)[i])
            << np.uint64(32 - (j + 1) * p.basebit)) & np.uint64(0xFFFFFFFF)
    phase = int(cipher.lwe_phase(ck.ksk[i, j, k], sk.lv0))
    err = (phase - int(want)) % (1 << 32)
    err = min(err, (1 << 32) - err)
    assert err < 1 << 26


def test_bsk_rows_encrypt_key_bits(fast_keys):
    """BSK[i] is a TRGSW encryption of s0[i]: its L-th row (first B-gadget
    row) decrypts to s0[i] * 2^(32-BGBIT) within noise."""
    p, sk, ck = fast_keys
    s0 = np.asarray(sk.lv0)
    for i in [0, 1, p.lwe_n - 1]:
        row = ck.bsk[i, p.l]          # first B-side row: B poly gets p*g[0]
        phase = np.asarray(cipher.trlwe_phase(row, sk.lv1)).astype(np.int64)
        want = int(s0[i]) << (32 - p.bgbit)
        err = (phase[0] - want) % (1 << 32)
        err = min(err, (1 << 32) - err)
        assert err < 1 << 26


def test_dummy_cloud_key():
    ck = tfhe.gen_cloud_key_no_ksk(P)
    assert not np.asarray(ck.bsk).any()
    assert not np.asarray(ck.ksk).any()


def test_serialization_roundtrip(tmp_path, fast_keys):
    p, sk, ck = fast_keys
    skp = os.path.join(tmp_path, "sk.npz")
    ckp = os.path.join(tmp_path, "ck.npz")
    tfhe.save_secret_key(skp, sk)
    tfhe.save_cloud_key(ckp, ck)
    sk2 = tfhe.load_secret_key(skp)
    ck2 = tfhe.load_cloud_key(ckp)
    np.testing.assert_array_equal(np.asarray(sk.lv0), np.asarray(sk2.lv0))
    np.testing.assert_array_equal(np.asarray(ck.bsk), np.asarray(ck2.bsk))
    np.testing.assert_array_equal(np.asarray(ck.bsk_limbs),
                                  np.asarray(ck2.bsk_limbs))
    assert ck2.params is p

    # The reloaded key still bootstraps correctly.
    from go_tfhe_jax import gates
    bits = np.array([True, False])
    ct = cipher.lwe_encrypt_bool(jax.random.PRNGKey(1), bits, p.lwe_alpha,
                                 sk2.lv0)
    out = gates.AND(ck2, ct, ct)
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_decrypt_bool(out, sk2.lv0)), bits)
