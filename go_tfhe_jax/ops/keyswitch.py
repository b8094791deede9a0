"""Identity key switching: TLWE level 1 (dim N) -> level 0 (dim n_lwe).

Reference: trgsw/trgsw.go:285-311 / trgsw/keyswitch.go:10-37.  There, per
coefficient and per level, a data-dependent digit indexes into the KSK table
and the selected ciphertext is subtracted.  Here the digit lookup becomes a
one-hot contraction, so the KSK streams through one matmul per batch:

    out = [0,...,0, b]  -  sum_{i,j} KSK[i, j, digit(i,j)]
        = [0,...,0, b]  -  onehot(digits) . KSK            (mod 2^32)

The contraction runs as int8 x int8 -> int32 (polymul.matmul_i8_u32): the
one-hot is int8 and the KSK is split into 4 balanced int8 limbs folded into
the output columns.  Exact: products are |limb| <= 128 and at most N*t of
the N*t*base one-hot entries are nonzero, so every int32 partial sum is
below 2^21; limbs recombine with shifts mod 2^32.  (An int32 one-hot would
move 4x the bytes and needs an s32 matmul, which no tensor core takes.)

Digits (trgsw/keyswitch.go:26-29):
    aBar       = a[i] + 2^(32-(1+basebit*t))
    digit(i,j) = (aBar >> (32-(j+1)*basebit)) & (base-1)

The reference skips digit==0; equivalently our keygen leaves KSK[..., 0, :]
as all-zero rows (cloudkey/cloudkey.go:106-108 skips k==0, leaving the zero
ciphertexts from initialization), so the unconditional contraction is
identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import TFHEParams
from .polymul import matmul_i8_u32

Array = jax.Array


def ks_digits(p: TFHEParams, a_u32: Array) -> Array:
    """a_u32: (..., N) -> (..., N, t) int32 digits in [0, base)."""
    shifts = jnp.asarray(
        [32 - (j + 1) * p.basebit for j in range(p.iks_t)], dtype=jnp.uint32)
    a_bar = a_u32 + jnp.uint32(p.ks_prec_offset)
    d = (a_bar[..., None] >> shifts) & jnp.uint32(p.base - 1)
    return d.astype(jnp.int32)


def identity_key_switch(p: TFHEParams, ksk_u32: Array, ct_lv1: Array) -> Array:
    """ksk_u32: (N, t, base, n_lwe+1) uint32;  ct_lv1: (..., N+1) uint32.

    Returns (..., n_lwe+1) uint32 level-0 ciphertexts.
    """
    n = p.n
    digits = ks_digits(p, ct_lv1[..., :n])                  # (..., N, t)
    onehot = (digits[..., None]
              == jnp.arange(p.base, dtype=jnp.int32)).astype(jnp.int8)
    lead = ct_lv1.shape[:-1]
    oh = onehot.reshape(lead + (n * p.iks_t * p.base,))
    tot = matmul_i8_u32(
        oh, ksk_u32.reshape((n * p.iks_t * p.base, p.lwe_n + 1)))
    out = jnp.zeros_like(tot) - tot
    # out[..., lwe_n] += b  (trgsw/keyswitch.go:21: output b starts at src b).
    b = jnp.zeros(lead + (p.lwe_n + 1,), jnp.uint32).at[..., p.lwe_n].set(
        ct_lv1[..., n])
    return out + b
