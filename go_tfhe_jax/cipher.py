"""Ciphertext types and encrypt/decrypt/linear operations (batched pytrees).

The reference wraps torus slices in structs (tlwe/tlwe.go:11-13,
trlwe/trlwe.go:13-16, trgsw/trgsw.go:15-17).  Here a ciphertext is
just an array with a documented layout and arbitrary leading batch axes —
every function here broadcasts over them, which subsumes the reference's
entire ``Batch*`` API (gates/gates.go:151-312):

* TLWE  level 0: ``(..., lwe_n+1)`` uint32, last word = b  (tlwe/tlwe.go:11)
* TLWE  level 1: ``(..., n+1)``     uint32
* TRLWE level 1: ``(..., 2, N)``    uint32, [0]=A poly, [1]=B poly
* TRGSW level 1: ``(..., 2L, 2, N)`` uint32, rows [A-gadget x L, B-gadget x L]

Randomness is explicit: every encrypt takes a ``jax.random`` key.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .params import TFHEParams
from .ops.polymul import negacyclic_mul_binary
from .utils.rng import gaussian_torus, uniform_torus
from .utils.torus import TORUS, f64_to_torus, to_signed

Array = jax.Array

BOOL_TRUE_MU = int(f64_to_torus(0.125))    # tlwe/tlwe.go:56
BOOL_FALSE_MU = int(f64_to_torus(-0.125))  # tlwe/tlwe.go:58


# ---------------------------------------------------------------------------
# LWE (TLWE level 0 / level 1 share the same layout and code).
# ---------------------------------------------------------------------------

def _lwe_inner(a_u32: Array, key_u32: Array) -> Array:
    """sum_i a[i]*key[i] mod 2^32: a uint32 multiply-and-sum, exact in any
    order because it wraps mod 2^32 (no s32 matmul, which GPUs do not
    run exactly on every route)."""
    return jnp.sum(a_u32 * key_u32, axis=-1, dtype=jnp.uint32)


def lwe_encrypt_torus(rng: Array, mu_torus, alpha: float,
                      key_u32: Array) -> Array:
    """Encrypt torus plaintext(s) under a binary LWE key.

    mu_torus: uint32, any shape S.  Returns (S, n+1) uint32.
    (tlwe/tlwe.go:36-50 — uniform mask a, b = <a,s> + mu + e.)
    """
    mu = jnp.asarray(mu_torus, TORUS)
    n = key_u32.shape[0]
    k_a, k_e = jax.random.split(rng)
    a = uniform_torus(k_a, mu.shape + (n,))
    b = gaussian_torus(k_e, mu, alpha, mu.shape) + _lwe_inner(a, key_u32)
    return jnp.concatenate([a, b[..., None]], axis=-1)


def lwe_phase(ct: Array, key_u32: Array) -> Array:
    """b - <a, s>  (the noisy plaintext), uint32."""
    n = key_u32.shape[0]
    return ct[..., n] - _lwe_inner(ct[..., :n], key_u32)


def lwe_encrypt_bool(rng: Array, bits, alpha: float, key_u32: Array) -> Array:
    """Boolean encoding +-1/8 (tlwe/tlwe.go:52-61)."""
    bits = jnp.asarray(bits, bool)
    mu = jnp.where(bits, jnp.uint32(BOOL_TRUE_MU), jnp.uint32(BOOL_FALSE_MU))
    return lwe_encrypt_torus(rng, mu, alpha, key_u32)


def lwe_decrypt_bool(ct: Array, key_u32: Array) -> Array:
    """sign of the phase (tlwe/tlwe.go:64-73)."""
    return to_signed(lwe_phase(ct, key_u32)) >= 0


def bool_phase_deviation(ct: Array, want, key_u32: Array) -> np.ndarray:
    """Signed deviation of each phase from its ideal +-1/8 encoding, as
    int64 torus units: the noise a boolean gate output carries.  The
    decision margin is 2^29 (the distance from +-1/8 to 0 or +-1/4)."""
    ideal = np.where(np.asarray(want, bool), BOOL_TRUE_MU,
                     BOOL_FALSE_MU).astype(np.int64)
    ph = np.asarray(lwe_phase(ct, key_u32)).astype(np.int64)
    return ((ph - ideal + 2 ** 31) % 2 ** 32) - 2 ** 31


def encode_message(message, modulus: int) -> np.uint32:
    """LWE message encoding m -> m * 2^31/modulus
    (tlwe/programmable_encrypt.go:12-26, computed exactly)."""
    m = np.mod(np.asarray(message, np.int64), modulus)
    scale = float(1 << 31) / float(modulus)
    return f64_to_torus(m.astype(np.float64) * scale / float(1 << 32))


def lwe_encrypt_message(rng: Array, message, modulus: int, alpha: float,
                        key_u32: Array) -> Array:
    return lwe_encrypt_torus(rng, jnp.asarray(encode_message(message, modulus)),
                             alpha, key_u32)


def lwe_decrypt_message(ct: Array, modulus: int, key_u32: Array) -> Array:
    """DivRound decode (tlwe/programmable_encrypt.go:32-54):
    scale = 2^31 / modulus (integer div);  msg = ((phase+scale/2)/scale) % m."""
    phase = lwe_phase(ct, key_u32)
    scale = jnp.uint32((1 << 31) // modulus)
    decoded = (phase + scale // jnp.uint32(2)) // scale
    return (decoded % jnp.uint32(modulus)).astype(jnp.int32)


# Linear ops (tlwe/tlwe.go:76-134) — plain jnp arithmetic on uint32 arrays:
def lwe_add(a, b):
    return a + b


def lwe_sub(a, b):
    return a - b


def lwe_neg(a):
    return jnp.zeros_like(a) - a


def lwe_add_mul(a, b, multiplier: int):
    return a + b * jnp.uint32(multiplier)


def lwe_sub_mul(a, b, multiplier: int):
    return a - b * jnp.uint32(multiplier)


# ---------------------------------------------------------------------------
# TRLWE (ring ciphertexts).
# ---------------------------------------------------------------------------

def trlwe_encrypt_torus(rng: Array, mu_torus: Array, alpha: float,
                        key_u32: Array, grid_bits: int = 0) -> Array:
    """mu_torus: (..., N) uint32 -> (..., 2, N) uint32.

    a uniform; b = Gaussian(mu) + a * s (negacyclic)  (trlwe/trlwe.go:28-50).

    ``grid_bits`` > 0 produces the ciphertext ON the 2^grid_bits torus
    subgrid — i.e. an RLWE sample at ciphertext modulus 2^(32-grid_bits)
    scaled into the top bits (params.TFHEParams.key_grid_bits): the mask is
    sampled uniformly on the grid (so a*s stays on-grid exactly — binary
    key, integer convolution) and only the b-side noise is rounded to the
    grid.  ``mu`` must already lie on the grid.
    """
    mu = jnp.asarray(mu_torus, TORUS)
    k_a, k_e = jax.random.split(rng)
    a = uniform_torus(k_a, mu.shape)
    noisy_mu = gaussian_torus(k_e, mu, alpha, mu.shape)
    if grid_bits:
        grid_mask = jnp.uint32(((1 << grid_bits) - 1))
        a = a & ~grid_mask
        # round-to-nearest grid multiple (wraps mod 2^32)
        noisy_mu = (noisy_mu + jnp.uint32(1 << (grid_bits - 1))) & ~grid_mask
    b = noisy_mu + negacyclic_mul_binary(a, key_u32)
    return jnp.stack([a, b], axis=-2)


def trlwe_phase(ct: Array, key_u32: Array) -> Array:
    return ct[..., 1, :] - negacyclic_mul_binary(ct[..., 0, :], key_u32)


def trlwe_encrypt_bool(rng: Array, bits, alpha: float, key_u32: Array) -> Array:
    bits = jnp.asarray(bits, bool)
    mu = jnp.where(bits, jnp.uint32(BOOL_TRUE_MU), jnp.uint32(BOOL_FALSE_MU))
    return trlwe_encrypt_torus(rng, mu, alpha, key_u32)


def trlwe_decrypt_bool(ct: Array, key_u32: Array) -> Array:
    """(trlwe/trlwe.go:66-81)."""
    return to_signed(trlwe_phase(ct, key_u32)) >= 0


# ---------------------------------------------------------------------------
# TRGSW.
# ---------------------------------------------------------------------------

def trgsw_encrypt_torus(rng: Array, p_torus, alpha: float, key_u32: Array,
                        prm: TFHEParams) -> Array:
    """Encrypt torus scalar(s) as TRGSW: 2L zero-TRLWEs + gadget on the
    diagonal (trgsw/trgsw.go:32-57).

    p_torus: uint32, shape S (typically scalar key bits).
    Returns (S, 2L, 2, N) uint32.  Honors ``prm.key_grid_bits`` (the
    gadget powers 2^(32-(i+1)*BGBIT) lie on the grid because
    key_grid_bits <= tail_bits, asserted in params).
    """
    p_t = jnp.asarray(p_torus, TORUS)
    shape = p_t.shape
    zeros = jnp.zeros(shape + (2 * prm.l, prm.n), TORUS)
    ct = trlwe_encrypt_torus(rng, zeros, alpha, key_u32,
                             grid_bits=prm.key_grid_bits)  # (S, 2L, 2, N)
    g = jnp.asarray(prm.gadget_powers, TORUS)              # (L,)
    add = p_t[..., None] * g                               # (S, L)
    # rows i < L: A[i][0] += p*g[i];  rows L+i: B[L+i][0] += p*g[i]
    ct = ct.at[..., :prm.l, 0, 0].add(add)
    ct = ct.at[..., prm.l:, 1, 0].add(add)
    return ct
