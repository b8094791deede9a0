"""Block blind rotation (BlockSize > 1) — the algorithm the reference's
parameters advertise (TRGSWLv1Params.BlockSize, params/params.go:77,110
"3-4x faster") but never implement (SURVEY.md #13: buffers allocated, no
code).  Here it is real: block-binary lv0 keys (Hamming weight <= 1 per
block) + a fused per-block external-product contraction.

TEST_BLOCK has block_size=2 and lwe_n=17, so 8 fused block steps plus a
ragged per-bit tail step are both exercised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine, gates
from go_tfhe_jax.utils.rng import block_binary_key

A = np.array([False, False, True, True])
B = np.array([False, True, False, True])


def test_block_binary_key_weight():
    """Every block (including the ragged tail) has Hamming weight <= 1, and
    nonzero blocks actually occur."""
    for n, bs, seed in [(17, 2, 0), (700, 3, 1), (1071, 7, 2)]:
        bits = np.asarray(block_binary_key(jax.random.PRNGKey(seed), n, bs))
        assert bits.shape == (n,) and set(np.unique(bits)) <= {0, 1}
        full = n // bs
        head = bits[:full * bs].reshape(full, bs)
        assert head.sum(axis=1).max() <= 1
        assert bits[full * bs:].sum() <= 1
        assert bits.sum() > 0


def test_gen_secret_key_defaults_uniform():
    """Default key distribution is uniform binary — matching the reference
    (key/key.go:25-39); block-binary is an explicit opt-in."""
    sk_def = tfhe.gen_secret_key(jax.random.PRNGKey(0), tfhe.TEST_BLOCK)
    assert not sk_def.block_binary
    sk_128 = tfhe.gen_secret_key(jax.random.PRNGKey(0), tfhe.P128)
    assert not sk_128.block_binary
    sk_blk = tfhe.gen_secret_key(jax.random.PRNGKey(0), tfhe.TEST_BLOCK,
                                 block_binary=True)
    assert sk_blk.block_binary
    with pytest.raises(ValueError):
        tfhe.gen_secret_key(jax.random.PRNGKey(0), tfhe.TEST_FAST,
                            block_binary=True)


@pytest.fixture(scope="module")
def block_keys():
    p = tfhe.TEST_BLOCK
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    sk = tfhe.gen_secret_key(k1, p, block_binary=True)
    assert sk.block_binary
    ck = tfhe.gen_cloud_key(k2, sk, p)
    assert ck.block_binary
    return p, sk, ck


def test_block_gate_truth_tables(block_keys):
    """Every 2-input gate through the fused block engine."""
    p, sk, ck = block_keys
    ka, kb = jax.random.split(jax.random.PRNGKey(100))
    ca = cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    truth = {
        "NAND": ~(A & B), "AND": A & B, "OR": A | B, "XOR": A ^ B,
        "XNOR": ~(A ^ B), "NOR": ~(A | B),
    }
    for name, want in sorted(truth.items()):
        out = getattr(gates, name)(ck, ca, cb)
        dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
        np.testing.assert_array_equal(dec, want, err_msg=name)


def test_block_path_actually_dispatched(block_keys):
    """The engine must route block-binary keys to the block core."""
    p, sk, ck = block_keys
    assert ck.block_binary and p.block_size > 1
    # Standard-key cloud key on the same profile routes to the per-bit core.
    sk2 = tfhe.gen_secret_key(jax.random.PRNGKey(3), p, block_binary=False)
    ck2 = tfhe.gen_cloud_key(jax.random.PRNGKey(4), sk2, p)
    assert not ck2.block_binary
    ka, kb = jax.random.split(jax.random.PRNGKey(5))
    ca = cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk2.lv0)
    cb = cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk2.lv0)
    out = gates.AND(ck2, ca, cb)
    dec = np.asarray(cipher.lwe_decrypt_bool(out, sk2.lv0))
    np.testing.assert_array_equal(dec, A & B)


def test_block_vs_perbit_same_key(block_keys):
    """With the SAME block-binary key, the per-bit engine and the block
    engine must agree on every decrypted gate output (they differ only in
    noise arrangement)."""
    p, sk, ck = block_keys
    ka, kb = jax.random.split(jax.random.PRNGKey(200))
    ca = cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    prepared = engine.prepare_nand(ca, cb)
    out_blk = engine._bootstrap_core_block(
        p, True, ck.bsk_limbs, ck.ksk, prepared, ck.testvec)
    out_std = engine._bootstrap_core(
        p, True, ck.bsk_limbs, ck.ksk, prepared, ck.testvec)
    want = ~(A & B)
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_decrypt_bool(out_blk, sk.lv0)), want)
    np.testing.assert_array_equal(
        np.asarray(cipher.lwe_decrypt_bool(out_std, sk.lv0)), want)


def test_block_pbs(block_keys):
    """Programmable bootstrap through the block engine (LUT testvec)."""
    from go_tfhe_jax import lut
    p, sk, ck = block_keys
    ct = cipher.lwe_encrypt_message(jax.random.PRNGKey(10),
                                    np.array([0, 1, 0, 1]), 2,
                                    p.lwe_alpha, sk.lv0)
    out = lut.bootstrap_func(ck, ct, lambda x: 1 - x, 2)
    dec = np.asarray(cipher.lwe_decrypt_message(out, 2, sk.lv0))
    np.testing.assert_array_equal(dec, [1, 0, 1, 0])


def test_key_serialization_roundtrip_block(tmp_path, block_keys):
    p, sk, ck = block_keys
    sp = str(tmp_path / "sk.npz")
    cp = str(tmp_path / "ck.npz")
    tfhe.save_secret_key(sp, sk)
    tfhe.save_cloud_key(cp, ck)
    sk2 = tfhe.load_secret_key(sp)
    ck2 = tfhe.load_cloud_key(cp)
    assert sk2.block_binary and ck2.block_binary
    np.testing.assert_array_equal(np.asarray(sk2.lv0), np.asarray(sk.lv0))
    np.testing.assert_array_equal(np.asarray(ck2.bsk), np.asarray(ck.bsk))
