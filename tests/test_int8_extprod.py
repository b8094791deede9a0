"""The int8 limb external product (the bootstrap's only contraction) against
the plain int32 Toeplitz reference, bit for bit, at every shipped profile's
real width; the prepared key limbs; and the path the engine compiles."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import engine, keys
from go_tfhe_jax.ops.decompose import gadget_decompose
from go_tfhe_jax.ops.extprod import (assert_i8_exact, decompose_i8,
                                     external_product)
from go_tfhe_jax.ops.polymul import (ext_band_from_trgsw, matmul_i8_u32,
                                     negacyclic_extprod_i8,
                                     negacyclic_extprod_toeplitz,
                                     negacyclic_mul_binary,
                                     prepare_band_limbs)
from go_tfhe_jax.params import PROFILES
from go_tfhe_jax.utils.profiling import dot_operand_types
from go_tfhe_jax.utils.torus import to_signed

from conftest import negacyclic_mul_oracle

SHIPPED = sorted({p.name for p in PROFILES.values()})
FAST = sorted(n for n in SHIPPED if n.endswith("_fast"))
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _rand_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _on_grid(x, p):
    """Keep a TRGSW on the profile's keygen grid (low key_grid_bits zero),
    the condition that makes kernel_limb_drop exact."""
    return x & np.uint32((0xFFFFFFFF << p.key_grid_bits) & 0xFFFFFFFF)


def _reference(p, trgsw, x):
    band = ext_band_from_trgsw(jnp.asarray(trgsw))
    return np.asarray(negacyclic_extprod_toeplitz(
        gadget_decompose(jnp.asarray(x), p), band))


@pytest.mark.parametrize("name", SHIPPED)
def test_i8_extprod_matches_reference(name):
    """One CMUX step's external product, batch 2, at the profile's real N:
    int8 limbs x int8 digits == int32 Toeplitz einsum, every word."""
    p = tfhe.get_params(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    trgsw = _on_grid(_rand_u32(rng, (2 * p.l, 2, p.n)), p)
    x = _rand_u32(rng, (2, 2, p.n))
    limbs = prepare_band_limbs(jnp.asarray(trgsw), p.kernel_limb_drop)
    assert limbs.shape == (4 - p.kernel_limb_drop, 2 * p.l, 2, 2 * p.n)
    got = np.asarray(external_product(p, limbs, jnp.asarray(x)))
    np.testing.assert_array_equal(got, _reference(p, trgsw, x))


@pytest.mark.parametrize("name", ["128bit_fast", "128bit", "uint5",
                                  "test_fast"])
@pytest.mark.parametrize("extreme", ["min", "max"])
def test_i8_extprod_extreme_magnitudes(name, extreme):
    """Every digit at -half_bg (the largest magnitude) against a band at
    INT32_MIN or INT32_MAX (the largest on the keygen grid for the limb-drop
    profiles): the int32 partials are at their bound and must not wrap."""
    p = tfhe.get_params(name)
    x = np.full((2, 2, p.n), (-p.decomposition_offset) % (1 << 32),
                np.uint32)
    digits = np.asarray(gadget_decompose(jnp.asarray(x), p))
    assert (digits == -p.half_bg).all()
    if extreme == "min":
        k = np.uint32(1 << 31)                   # D = [-K, K] = INT32_MIN
    else:
        k = np.uint32(INT32_MAX & ((0xFFFFFFFF << p.key_grid_bits)
                                   & 0xFFFFFFFF))
    trgsw = np.full((2 * p.l, 2, p.n), k, np.uint32)
    band = np.asarray(ext_band_from_trgsw(jnp.asarray(trgsw)))
    assert band.max() == (INT32_MIN if extreme == "min" else int(k))
    limbs = prepare_band_limbs(jnp.asarray(trgsw), p.kernel_limb_drop)
    got = np.asarray(external_product(p, limbs, jnp.asarray(x)))
    np.testing.assert_array_equal(got, _reference(p, trgsw, x))


def _real_bsk_rows(p, rows=2, seed=0):
    pr = dataclasses.replace(p, name=f"{p.name}_rows", lwe_n=rows)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    sk = tfhe.gen_secret_key(k1, pr)
    return keys._gen_bsk(k2, pr, sk)


@pytest.mark.parametrize("name", FAST + ["128bit", "uint5"])
def test_prepared_limbs_reconstruct_band(name):
    """The int8 key limbs of real keygen rows recombine to the int32 band
    mod 2^32; for the *_fast profiles the dropped low limb is identically
    zero (the on-grid keygen), so dropping it is exact."""
    p = tfhe.get_params(name)
    bsk = _real_bsk_rows(p)
    band = np.asarray(ext_band_from_trgsw(bsk)).astype(np.int64)
    full = np.asarray(prepare_band_limbs(bsk, 0)).astype(np.int64)
    kept = np.asarray(keys.prepare_bsk_limbs(bsk, p))
    assert kept.dtype == np.int8
    assert kept.shape == (4 - p.kernel_limb_drop,) + band.shape
    np.testing.assert_array_equal(kept, full[p.kernel_limb_drop:])
    recon = sum(full[j] << (8 * j) for j in range(4))
    np.testing.assert_array_equal(recon % (1 << 32), band % (1 << 32))
    if p.kernel_limb_drop:
        assert not full[:p.kernel_limb_drop].any()


@pytest.mark.parametrize("name", ["test_fast", "uint5"])
def test_decompose_i8_recombines(name):
    """int8 digit planes recombine to the gadget digits exactly (one plane
    for BGBIT <= 8, exact base-256 limbs for the wide Uint gadgets)."""
    p = tfhe.get_params(name)
    x = jnp.asarray(_rand_u32(np.random.default_rng(3), (3, 2, p.n)))
    planes = np.asarray(decompose_i8(x, p)).astype(np.int64)
    assert planes.shape[0] == p.digit_limbs
    recon = sum(planes[i] << (8 * i) for i in range(p.digit_limbs))
    np.testing.assert_array_equal(recon, np.asarray(gadget_decompose(x, p)))


def test_block_rows_match_reference():
    """The block rotation's contraction (block_size*2L rows in one matmul)
    equals the sum of per-row-group references."""
    p = tfhe.get_params("128bit_fast")
    rng = np.random.default_rng(5)
    bs = p.block_size
    trgsw = _on_grid(_rand_u32(rng, (bs * 2 * p.l, 2, p.n)), p)
    x = _rand_u32(rng, (2, bs, 2, p.n))
    digits = decompose_i8(jnp.asarray(x), p).reshape(1, 2, bs * 2 * p.l, p.n)
    limbs = prepare_band_limbs(jnp.asarray(trgsw), p.kernel_limb_drop)
    assert_i8_exact(p, bs * 2 * p.l)
    got = np.asarray(negacyclic_extprod_i8(digits, limbs, p.kernel_limb_drop))
    want = sum(_reference(p, trgsw[2 * p.l * g:2 * p.l * (g + 1)],
                          x[:, g]).astype(np.uint64) for g in range(bs))
    np.testing.assert_array_equal(got, (want % (1 << 32)).astype(np.uint32))


def test_exactness_bound_is_enforced():
    """A contraction too deep for exact int32 partials is refused."""
    p = tfhe.get_params("128bit_fast")
    assert_i8_exact(p, 2 * p.l)
    with pytest.raises(AssertionError):
        assert_i8_exact(p, 1 << 10)


def test_engine_path_is_int8_matmul():
    """The one engine path contracts only in int8 x int8 (the external
    product and the key switch): no s32, f32 or bf16 matmul is left."""
    p = tfhe.TEST_FAST
    ck = tfhe.gen_cloud_key_no_ksk(p)
    ct = jnp.zeros((4, p.lwe_n + 1), jnp.uint32)
    types = dot_operand_types(engine._bootstrap_core, p, True, ck.bsk_limbs,
                              ck.ksk, ct, ck.testvec)
    assert types == {("int8", "int8")}


def test_key_holds_only_int8_limbs(fast_keys):
    """The CloudKey carries the raw BSK (for serialization) and the int8
    limbs the path reads — no other layout."""
    p, _, ck = fast_keys
    fields = {f.name for f in dataclasses.fields(ck)}
    assert fields == {"testvec", "ksk", "bsk", "bsk_limbs", "params",
                      "block_binary"}
    np.testing.assert_array_equal(
        np.asarray(ck.bsk_limbs),
        np.asarray(prepare_band_limbs(ck.bsk, p.kernel_limb_drop)))
    assert to_signed(ck.bsk).dtype == jnp.int32


@pytest.mark.parametrize("kind", ["onehot", "signs"])
def test_matmul_i8_u32_exact(kind):
    """int8 x uint32 -> uint32 mod 2^32 (the key switch's one-hot and the
    public-key encryption's sign vector), extreme words included."""
    rng = np.random.default_rng(11)
    k, w = 96, 7
    rhs = _rand_u32(rng, (k, w))
    rhs[0] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x80, 0xFF]
    if kind == "onehot":
        lhs = (rng.integers(0, 4, (5, k)) == 0).astype(np.int8)
    else:
        lhs = rng.integers(-1, 2, (5, k)).astype(np.int8)
    got = np.asarray(matmul_i8_u32(jnp.asarray(lhs), jnp.asarray(rhs)))
    want = (lhs.astype(np.int64) @ rhs.astype(np.int64)) % (1 << 32)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_mul_binary_matches_oracle():
    """The keygen product a * s (binary ring key) as an int8 matmul equals
    the schoolbook negacyclic product, extreme coefficients included."""
    rng = np.random.default_rng(12)
    n = 64
    a = _rand_u32(rng, (3, n))
    a[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    key = rng.integers(0, 2, n).astype(np.uint32)
    got = np.asarray(negacyclic_mul_binary(jnp.asarray(a), jnp.asarray(key)))
    for row in range(3):
        np.testing.assert_array_equal(got[row],
                                      negacyclic_mul_oracle(a[row], key))
