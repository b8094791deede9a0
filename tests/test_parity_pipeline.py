"""Full-pipeline scalar parity oracle.

``tests/vectors/pipeline_oracle.py`` is a pure-Python-int transcription of
the reference's COMPLETE composed bootstrap
(evaluator/evaluator.go:110-148: blind rotate -> sample extract @0 -> key
switch; external product per trgsw/trgsw.go:108-134, key switch per
trgsw/keyswitch.go:10-37).  Here the JAX engine runs the same keys and
ciphertexts and must reproduce, BIT-EXACTLY,

* the blind-rotate accumulator,
* the extracted level-1 ciphertext,
* the final key-switched level-0 ciphertext,

on a TEST_FAST-size key and on an N=256, l=3 key — closing the last seam
where a
systematic composition error could hide between the sub-kernel parity
vectors (test_parity_vectors.py) and the end-to-end truth tables.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "vectors"))
import pipeline_oracle as oracle  # noqa: E402

import go_tfhe_jax as tfhe  # noqa: E402
from go_tfhe_jax import cipher, engine  # noqa: E402
from go_tfhe_jax.ops.blindrotate import blind_rotate  # noqa: E402
from go_tfhe_jax.ops.keyswitch import identity_key_switch  # noqa: E402
from go_tfhe_jax.ops.sample_extract import sample_extract  # noqa: E402
from go_tfhe_jax.params import TFHEParams  # noqa: E402

# A second toy shape: N=256 and a three-level gadget (six digit rows).
TEST_N256 = TFHEParams(
    name="test_n256",
    lwe_n=8, lwe_alpha=1.0 / (1 << 24),
    n=256, lv1_alpha=1.0 / (1 << 30), nbit=8,
    bgbit=8, l=3, basebit=4, iks_t=6, block_size=1,
)


def _keys(p, seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    return sk, ck


def _oracle_inputs(ck):
    """Raw key arrays -> plain Python ints for the scalar oracle."""
    p = ck.params
    bsk = np.asarray(ck.bsk).astype(np.int64)          # (n0, 2L, 2, N)
    bsk_py = [[(row[0].tolist(), row[1].tolist()) for row in bit]
              for bit in bsk]
    ksk = np.asarray(ck.ksk).astype(np.int64)          # (N, t, base, n0+1)
    ksk_py = ksk.tolist()
    tv = np.asarray(ck.testvec).astype(np.int64)
    return bsk_py, ksk_py, (tv[0].tolist(), tv[1].tolist())


def _run_oracle(ck, ct_row):
    p = ck.params
    bsk_py, ksk_py, tv = _oracle_inputs(ck)
    acc, lv1, lv0 = oracle.bootstrap(
        np.asarray(ct_row).astype(np.int64).tolist(), tv, bsk_py, ksk_py,
        n=p.n, nbit=p.nbit, lwe_n=p.lwe_n, bgbit=p.bgbit, l=p.l,
        basebit=p.basebit, iks_t=p.iks_t, offset=p.decomposition_offset)
    return (np.asarray(acc, np.uint32), np.asarray(lv1, np.uint32),
            np.asarray(lv0, np.uint32))


def test_pipeline_portable_matches_oracle():
    """TEST_FAST key, two NAND-prepared ciphertexts: every stage of the
    portable engine == the scalar transcription, bit for bit; the public
    engine.bootstrap output too; and the result decrypts to NAND."""
    p = tfhe.TEST_FAST
    sk, ck = _keys(p, 0)
    bits_a = np.array([False, True])
    bits_b = np.array([True, True])
    k3, k4 = jax.random.split(jax.random.PRNGKey(3))
    ct_a = cipher.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0)
    prepared = engine.prepare_nand(ct_a, ct_b)         # (2, lwe_n+1)

    acc_eng = np.asarray(blind_rotate(p, ck.bsk_limbs, prepared,
                                      ck.testvec))
    lv1_eng = np.asarray(sample_extract(jnp.asarray(acc_eng), 0))
    lv0_eng = np.asarray(identity_key_switch(p, ck.ksk,
                                             jnp.asarray(lv1_eng)))
    public = np.asarray(engine.bootstrap(ck, prepared))

    for row in range(prepared.shape[0]):
        acc_o, lv1_o, lv0_o = _run_oracle(ck, np.asarray(prepared)[row])
        np.testing.assert_array_equal(acc_eng[row], acc_o,
                                      err_msg=f"accumulator row {row}")
        np.testing.assert_array_equal(lv1_eng[row], lv1_o,
                                      err_msg=f"extracted lv1 row {row}")
        np.testing.assert_array_equal(lv0_eng[row], lv0_o,
                                      err_msg=f"key-switched lv0 row {row}")
        np.testing.assert_array_equal(public[row], lv0_o,
                                      err_msg=f"engine.bootstrap row {row}")

    dec = np.asarray(cipher.lwe_decrypt_bool(jnp.asarray(lv0_eng), sk.lv0))
    np.testing.assert_array_equal(dec, ~(bits_a & bits_b))


def test_pipeline_n256_matches_oracle():
    """N=256, l=3 key: blind rotate -> extract -> key switch reproduce the
    scalar oracle's composed pipeline bit for bit."""
    p = TEST_N256
    sk, ck = _keys(p, 1)
    k3 = jax.random.PRNGKey(5)
    ct = cipher.lwe_encrypt_bool(k3, np.array([True]), p.lwe_alpha, sk.lv0)
    prepared = engine.prepare_and(ct, ct)              # (1, lwe_n+1)

    acc_o, lv1_o, lv0_o = _run_oracle(ck, np.asarray(prepared)[0])

    acc = np.asarray(blind_rotate(p, ck.bsk_limbs, prepared, ck.testvec))
    np.testing.assert_array_equal(acc[0], acc_o, err_msg="accumulator")
    lv1 = np.asarray(sample_extract(jnp.asarray(acc), 0))
    np.testing.assert_array_equal(lv1[0], lv1_o, err_msg="lv1")
    lv0 = np.asarray(identity_key_switch(p, ck.ksk, jnp.asarray(lv1)))
    np.testing.assert_array_equal(lv0[0], lv0_o, err_msg="lv0")

    dec = bool(np.asarray(cipher.lwe_decrypt_bool(jnp.asarray(lv0_o)[None],
                                                  sk.lv0))[0])
    assert dec is True
