"""Blind rotation — the bootstrap hot loop, batched over ciphertexts.

Reference: evaluator/evaluator.go:110-135 (and the legacy allocating engine at
trgsw/trgsw.go:197-224).  Per input LWE coefficient the accumulator is rotated
by the mod-switched coefficient and CMUXed with the corresponding
bootstrapping-key row.  The n_lwe iterations are inherently sequential (each
CMUX feeds the next), so the loop is a ``lax.fori_loop`` inside one jit and
*throughput* comes from the batch axis: every step is a batched rotation +
one int8 matmul over all B ciphertexts at once (this replaces the
reference's goroutine-per-ciphertext fan-out, trgsw/trgsw.go:227-252).

Mod switch (evaluator/evaluator.go:116,122):
    b~ = 2N - ((b + 2^(31-NBIT-1)) >> (32-NBIT-1))
    a~ =      ((a + 2^(31-NBIT-1)) >> (32-NBIT-1))
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..params import TFHEParams
from .extprod import assert_i8_exact, cmux, decompose_i8, external_product
from .polymul import negacyclic_extprod_i8
from .rotate import monomial_mul, monomial_mul_blocks

Array = jax.Array


def mod_switch_2n(x_u32: Array, p: TFHEParams, theta: int = 0) -> Array:
    """Torus -> [0, 2N] rounding mod-switch; returns int32.

    ``theta > 0`` rounds to MULTIPLES of 2^theta (the PBSmanyLUT coarse
    mod-switch): the blind rotation then lands on a 2^theta-aligned
    position, so accumulator coefficients 0..2^theta-1 read an
    interleaved multi-function test vector (lut.Generator.gen_multi_lut)
    and one rotation yields up to 2^theta function outputs via
    sample extraction at those indices.  Costs 2^theta x the mod-switch
    rounding noise (engine.bootstrap_many docstring)."""
    shift = p.mod_switch_shift + theta
    off = 1 << (shift - 1)
    coarse = (x_u32 + jnp.uint32(off)) >> jnp.uint32(shift)
    return (coarse << jnp.uint32(theta)).astype(jnp.int32)


def mod_switch_general(x_u32: Array, modulus: int) -> Array:
    """Torus -> [0, modulus] rounding mod-switch for ANY modulus <= 2^17.

    ms(x) = floor((x*M + 2^31) / 2^32), computed exactly in uint32 by
    splitting x into 16-bit halves (needed for non-power-of-two extended
    LUT sizes, e.g. Uint8's polyExtendFactor=9 -> 2kN = 36864).
    Coincides bit-exactly with the shift form when M is a power of two.
    """
    assert modulus <= 1 << 17
    m = jnp.uint32(modulus)
    a_hi = x_u32 >> jnp.uint32(16)
    a_lo = x_u32 & jnp.uint32(0xFFFF)
    acc = a_hi * m + ((a_lo * m) >> jnp.uint32(16)) + jnp.uint32(1 << 15)
    return (acc >> jnp.uint32(16)).astype(jnp.int32)


def blind_rotate(p: TFHEParams, bsk_limbs: Array, ct: Array,
                 testvec: Array, theta: int = 0) -> Array:
    """Blind-rotate a batch of LWE ciphertexts.
    ``theta``: coarse mod-switch exponent for multi-LUT extraction
    (mod_switch_2n).

    bsk_limbs: (4-drop, n_lwe, 2L, 2, 2N) int8 key limbs (CloudKey.bsk_limbs).
    ct:        (..., n_lwe+1) uint32 LWE ciphertexts (last word = b).
    testvec:   (2, N) or (..., 2, N) uint32 test vector (shared or per-ct,
               the latter for per-ciphertext PBS LUTs).

    Returns (..., 2, N) uint32 TRLWE accumulators.
    """
    n_lwe = p.lwe_n
    lead = ct.shape[:-1]

    b_tilda = 2 * p.n - mod_switch_2n(ct[..., n_lwe], p, theta)   # (...,)
    acc = monomial_mul(
        jnp.broadcast_to(testvec, lead + (2, p.n)), b_tilda[..., None])

    a_tilda = mod_switch_2n(ct[..., :n_lwe], p, theta)         # (..., n_lwe)

    def body(i, acc):
        rotated = monomial_mul(acc, a_tilda[..., i][..., None])
        band = lax.dynamic_index_in_dim(bsk_limbs, i, axis=1, keepdims=False)
        return cmux(p, band, acc, rotated)

    return lax.fori_loop(0, n_lwe, body, acc)


def blind_rotate_extended(p: TFHEParams, bsk_limbs: Array, ct: Array,
                          lut_blocks: Array) -> Array:
    """Blind rotation over an EXTENDED look-up table of size k*N.

    Implements the polyExtendFactor mechanism the reference advertises for
    Uint6-8 but never built (params/UINT_STATUS.md:20-31,
    lut/generator.go:19-21): the accumulator is a vector of k TRLWE blocks
    storing the interleaved big polynomial (see monomial_mul_blocks); each
    CMUX applies the same TRGSW external product block-wise; the mod switch
    targets [0, 2kN).

    bsk_limbs:  (4-drop, n_lwe, 2L, 2, 2N) int8 key limbs.
    ct:         (..., n_lwe+1) uint32.
    lut_blocks: (k, 2, N) or (..., k, 2, N) uint32 trivial TRLWE blocks.

    Returns (..., k, 2, N) uint32; the bootstrap result is block 0's
    sample extraction at index 0 (big-poly coefficient 0 lives there).
    """
    n_lwe = p.lwe_n
    k = p.poly_extend_factor
    big_mod = 2 * k * p.n
    lead = ct.shape[:-1]

    b_tilda = big_mod - mod_switch_general(ct[..., n_lwe], big_mod)
    acc = monomial_mul_blocks(
        jnp.broadcast_to(lut_blocks, lead + (k, 2, p.n)), b_tilda, k)

    a_tilda = mod_switch_general(ct[..., :n_lwe], big_mod)   # (..., n_lwe)

    def body(i, acc):
        rotated = monomial_mul_blocks(acc, a_tilda[..., i], k)
        band = lax.dynamic_index_in_dim(bsk_limbs, i, axis=1, keepdims=False)
        # Block-wise CMUX: k is just another batch axis for the contraction.
        return acc + external_product(p, band, rotated - acc)

    return lax.fori_loop(0, n_lwe, body, acc)


def blind_rotate_block(p: TFHEParams, bsk_limbs: Array, ct: Array,
                       testvec: Array) -> Array:
    """Block blind rotation — requires a block-binary lv0 key.

    The mechanism the reference's parameters advertise but never implement
    (TRGSWLv1Params.BlockSize, params/params.go:77,110; SURVEY.md #13).  With
    at most one key bit set per block, X^(sum_j s_j a_j) = 1 + sum_j
    s_j (X^(a_j) - 1), so one block step is

        acc' = acc + sum_j BSK[j] (x) (X^(a_j) acc - acc)

    — ``block_size`` *independent* external products of rotations of the
    same accumulator, folded into ONE contraction with block_size*2L rows.
    The sequential chain shrinks from n_lwe to ceil(n_lwe/block_size) steps
    of proportionally deeper matmuls (total MACs unchanged, latency /
    launch overhead divided by block_size).  A ragged tail of
    n_lwe mod block_size bits falls back to per-bit CMUX steps.

    bsk_limbs: (4-drop, n_lwe, 2L, 2, 2N) int8 key limbs.
    ct:        (..., n_lwe+1) uint32;  testvec: (2, N) or (..., 2, N).
    Returns (..., 2, N) uint32.
    """
    bs = p.block_size
    full, rem = divmod(p.lwe_n, bs)
    l2 = 2 * p.l
    lead = ct.shape[:-1]
    nl = bsk_limbs.shape[0]
    assert_i8_exact(p, bs * l2)

    b_tilda = 2 * p.n - mod_switch_2n(ct[..., p.lwe_n], p)
    acc = monomial_mul(
        jnp.broadcast_to(testvec, lead + (2, p.n)), b_tilda[..., None])

    a_tilda = mod_switch_2n(ct[..., :p.lwe_n], p)              # (..., n_lwe)
    a_blk = a_tilda[..., :full * bs].reshape(lead + (full, bs))
    band_blk = bsk_limbs[:, :full * bs].reshape(
        nl, full, bs * l2, 2, 2 * p.n)

    def body(i, acc):
        a_i = lax.dynamic_index_in_dim(a_blk, i, axis=-2, keepdims=False)
        rotated = monomial_mul(acc[..., None, :, :], a_i[..., :, None])
        diff = rotated - acc[..., None, :, :]                  # (...,bs,2,N)
        digits = decompose_i8(diff, p)                     # (ND,...,bs,2L,N)
        digits = digits.reshape(digits.shape[:1] + lead + (bs * l2, p.n))
        band = lax.dynamic_index_in_dim(band_blk, i, axis=1, keepdims=False)
        return acc + negacyclic_extprod_i8(digits, band, p.kernel_limb_drop)

    acc = lax.fori_loop(0, full, body, acc)
    for j in range(rem):                      # ragged tail, static indices
        idx = full * bs + j
        rotated = monomial_mul(acc, a_tilda[..., idx][..., None])
        acc = cmux(p, bsk_limbs[:, idx], acc, rotated)
    return acc
