"""Extended look-up tables (LookUpTableSize = polyExtendFactor * N).

The reference advertises this for Uint6-8 but never implemented it
(params/UINT_STATUS.md:20-31, lut/generator.go:19-21); here it is real.
These tests validate the block-rotation algebra against a big-polynomial
oracle and run full PBS over extended domains, including a non-power-of-two
extend factor (Uint8's k=9 shape)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from conftest import monomial_mul_oracle
from go_tfhe_jax import cipher, lut
from go_tfhe_jax.ops.blindrotate import mod_switch_general
from go_tfhe_jax.ops.rotate import monomial_mul_blocks


def _interleave(big, k):
    """big (kN,) -> blocks (k, N): big[j] == blocks[j % k][j // k]."""
    return big.reshape(-1, k).T.copy()


def _deinterleave(blocks):
    return blocks.T.reshape(-1).copy()


@pytest.mark.parametrize("k", [2, 3, 4])
def test_block_rotation_matches_big_poly_oracle(k):
    n = 64
    rng = np.random.default_rng(k)
    big = rng.integers(0, 1 << 32, size=(k * n,), dtype=np.uint64).astype(
        np.uint32)
    blocks = _interleave(big, k)                       # (k, n)
    acc = jnp.asarray(blocks)[:, None, :]              # (k, 1, n) "C"=1
    for t in [0, 1, k - 1, k, k + 1, n, k * n - 1, k * n, k * n + 7,
              2 * k * n - 1]:
        out = np.asarray(monomial_mul_blocks(acc, jnp.int32(t), k))[:, 0, :]
        want = _interleave(monomial_mul_oracle(big, t), k)
        np.testing.assert_array_equal(out, want, err_msg=f"k={k} t={t}")


def test_block_rotation_batched():
    k, n = 3, 32
    rng = np.random.default_rng(0)
    big = rng.integers(0, 1 << 32, size=(2, k * n), dtype=np.uint64).astype(
        np.uint32)
    acc = jnp.asarray(np.stack([_interleave(b, k) for b in big]))[:, :, None]
    ts = np.array([5, 2 * k * n - 3], np.int32)
    out = np.asarray(monomial_mul_blocks(acc, jnp.asarray(ts), k))
    for b in range(2):
        want = _interleave(monomial_mul_oracle(big[b], int(ts[b])), k)
        np.testing.assert_array_equal(out[b, :, 0], want)


@pytest.mark.parametrize("k", [2, 3, 9])
def test_block_rotation_every_shift(k):
    """The block rotation equals the big-polynomial Go rotation for every
    t in [0, 2kN) — including non-power-of-two k."""
    n = 16
    rng = np.random.default_rng(100 + k)
    big = rng.integers(0, 1 << 32, size=(k * n,), dtype=np.uint64).astype(
        np.uint32)
    acc = jnp.asarray(np.stack([_interleave(big, k)] * 2, axis=-2))
    ts = np.arange(2 * k * n, dtype=np.int32)
    got = np.asarray(jax.vmap(
        lambda t: monomial_mul_blocks(acc, t, k))(jnp.asarray(ts)))
    for t in ts:
        want = _interleave(monomial_mul_oracle(big, int(t)), k)
        np.testing.assert_array_equal(got[t, :, 0], want, err_msg=f"t={t}")


def test_mod_switch_general_exact():
    rng = np.random.default_rng(1)
    xs = np.concatenate([
        rng.integers(0, 1 << 32, size=(100,), dtype=np.uint64),
        np.array([0, 1, (1 << 32) - 1, 1 << 31], np.uint64)]).astype(
        np.uint32)
    for m in [512, 1024, 1536, 36864, 3 << 8]:
        got = np.asarray(mod_switch_general(jnp.asarray(xs), m))
        want = ((xs.astype(np.uint64) * m + (1 << 31)) >> 32).astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=f"M={m}")


def test_mod_switch_general_matches_shift_form():
    from go_tfhe_jax.ops.blindrotate import mod_switch_2n
    p = tfhe.TEST_FAST
    rng = np.random.default_rng(2)
    xs = rng.integers(0, 1 << 32, size=(50,), dtype=np.uint64).astype(
        np.uint32)
    got = np.asarray(mod_switch_general(jnp.asarray(xs), 2 * p.n))
    want = np.asarray(mod_switch_2n(jnp.asarray(xs), p))
    np.testing.assert_array_equal(got, want)


def test_extended_lut_structure():
    p = tfhe.TEST_EXT2
    gen = lut.Generator(p)
    assert gen.lut_size == 2 * p.n
    table = np.asarray(gen.gen_lut(lambda x: x))
    assert table.shape == (2, 2, p.n)
    np.testing.assert_array_equal(table[:, 0, :], 0)   # trivial TRLWE blocks


@pytest.mark.parametrize("profile", ["test_ext2", "test_ext3"])
def test_extended_pbs_full_domain(profile):
    """Identity/increment/complement PBS over the whole message space
    through extended blind rotation — k=2 (power of two) and k=3 (general
    mod switch, the Uint8 k=9 shape)."""
    p = tfhe.get_params(profile)
    m = p.message_modulus
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    assert ck.testvec.shape == (p.poly_extend_factor, 2, p.n)

    msgs = np.arange(m)
    ct = cipher.lwe_encrypt_message(k3, msgs, m, p.lwe_alpha, sk.lv0)
    for f in (lambda x: x, lambda x: (x + 1) % m, lambda x: (m - 1) - x):
        out = lut.bootstrap_func(ck, ct, f, m)
        dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
        np.testing.assert_array_equal(dec, [f(x) % m for x in msgs])
