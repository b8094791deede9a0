"""Bit packing round-trips, LSB-first (bitutils/bitutils_test.go:9-77)."""

import jax
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import bitutils


def test_lsb_first_order():
    bits = bitutils.u8_to_bits(0b00000001)
    assert bits[0] and not bits[1:].any()
    bits = bitutils.u8_to_bits(0b10000000)
    assert bits[7] and not bits[:7].any()


def test_u8_roundtrip():
    for v in [0, 1, 0x55, 0xAA, 0xFF, 42]:
        assert bitutils.bits_to_u8(bitutils.u8_to_bits(v)) == v


def test_u16_u32_u64_roundtrips():
    assert bitutils.bits_to_u16(bitutils.u16_to_bits(0xBEEF)) == 0xBEEF
    assert bitutils.bits_to_u32(bitutils.u32_to_bits(0xDEADBEEF)) == 0xDEADBEEF
    v = 0x0123456789ABCDEF
    assert bitutils.bits_to_u64(bitutils.u64_to_bits(v)) == v


def test_from_bits_partial():
    assert bitutils.from_bits([True, False, True]) == 5


def test_encrypt_decrypt_bits():
    p = tfhe.TEST_FAST
    sk = tfhe.gen_secret_key(jax.random.PRNGKey(0), p)
    bits = bitutils.u8_to_bits(0xA7)
    ct = bitutils.encrypt_bits(jax.random.PRNGKey(1), bits, p.lwe_alpha,
                               sk.lv0)
    assert ct.shape == (8, p.lwe_n + 1)
    dec = np.asarray(bitutils.decrypt_bits(ct, sk.lv0))
    assert bitutils.bits_to_u8(dec) == 0xA7


def test_message_bit_roundtrip():
    """Modulus-8 bit encoding (the many-LUT adder encoding) round-trips
    and feeds ripple_add_manylut end-to-end."""
    import jax
    import numpy as np
    import go_tfhe_jax as tfhe
    from go_tfhe_jax import bitutils
    from go_tfhe_jax.models import adders

    p = tfhe.TEST_NIBBLE
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(41), 3)
    sk = tfhe.gen_secret_key(k1, p)
    bits = np.array([True, False, True, True])
    ct = bitutils.encrypt_bits_messages(k3, bits, p.lwe_alpha, sk.lv0)
    got = np.asarray(bitutils.decrypt_bits_messages(ct, sk.lv0))
    np.testing.assert_array_equal(got, bits)

    ck = tfhe.gen_cloud_key(k2, sk, p)
    kb = jax.random.fold_in(k3, 1)
    other = np.array([False, True, True, False])        # 13 + 6 = 19
    ct_b = bitutils.encrypt_bits_messages(kb, other, p.lwe_alpha, sk.lv0)
    s_bits, carry = adders.ripple_add_manylut(ck, ct, ct_b)
    s = np.asarray(bitutils.decrypt_bits_messages(s_bits, sk.lv0))
    cout = bool(np.asarray(bitutils.decrypt_bits_messages(
        carry[None], sk.lv0))[0])
    total = bitutils.from_bits(s) | (int(cout) << 4)
    assert total == 13 + 6, (s.tolist(), cout)
