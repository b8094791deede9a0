"""LWE proxy re-encryption (reference: proxyreenc/proxyreenc.go).

* Public keys = collections of zero-encryptions (proxyreenc.go:56-92).
* Public-key encryption = random +-1 subset-sum of the zero-encryptions plus
  the plaintext and fresh noise (proxyreenc.go:104-135) — here one wraparound
  int32 matvec instead of a loop.
* Re-encryption keys (asymmetric via the target's public key, symmetric via
  the target's secret key) are KSK-style digit tables
  (proxyreenc.go:180-300).
* Re-encryption itself is the same one-hot digit contraction as identity key
  switching (proxyreenc.go:321-366), batched over ciphertexts.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import cipher
from .ops.polymul import matmul_i8_u32
from .params import TFHEParams
from .utils.rng import gaussian_torus
from .utils.torus import TORUS

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PublicKeyLv0:
    """Encryptions of zero (proxyreenc.go:56-58)."""
    encryptions: Array  # (size, lwe_n+1) uint32


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ProxyReencryptionKey:
    """Digit table for key switching between user keys
    (proxyreenc.go:159-163).  table[i, j, 0, :] rows are zero."""
    table: Array  # (lwe_n, t, base, lwe_n+1) uint32
    basebit: int = dataclasses.field(metadata=dict(static=True))
    t: int = dataclasses.field(metadata=dict(static=True))

    @property
    def base(self) -> int:
        return 1 << self.basebit


def gen_public_key(rng: Array, secret_key_lv0: Array, p: TFHEParams,
                   size: int | None = None,
                   alpha: float | None = None) -> PublicKeyLv0:
    """proxyreenc.go:69-92: `size` zero-encryptions (default 2n)."""
    size = 2 * p.lwe_n if size is None else size
    alpha = p.lwe_alpha if alpha is None else alpha
    zeros = jnp.zeros((size,), TORUS)
    return PublicKeyLv0(
        encryptions=cipher.lwe_encrypt_torus(rng, zeros, alpha, secret_key_lv0))


def pk_encrypt_torus(rng: Array, pk: PublicKeyLv0, mu_torus,
                     alpha: float) -> Array:
    """Public-key encryption (proxyreenc.go:104-135).

    Each zero-encryption is added with prob 1/4, subtracted with prob 1/4,
    skipped with prob 1/2 (two Intn(2) draws in the reference), then the
    plaintext and fresh noise are added to b.
    mu_torus: uint32 scalar or batch shape S -> (S, lwe_n+1).
    """
    mu = jnp.asarray(mu_torus, TORUS)
    size = pk.encryptions.shape[0]
    k_use, k_sign, k_e = jax.random.split(rng, 3)
    use = jax.random.bernoulli(k_use, 0.5, mu.shape + (size,))
    sign = jax.random.bernoulli(k_sign, 0.5, mu.shape + (size,))
    coeff = jnp.where(use, jnp.where(sign, 1, -1), 0).astype(jnp.int8)
    out = matmul_i8_u32(coeff, pk.encryptions)
    b = gaussian_torus(k_e, mu, alpha, mu.shape)
    return out.at[..., -1].add(b)


def pk_encrypt_bool(rng: Array, pk: PublicKeyLv0, bits, alpha: float) -> Array:
    """proxyreenc.go:144-152."""
    bits = jnp.asarray(bits, bool)
    mu = jnp.where(bits, jnp.uint32(cipher.BOOL_TRUE_MU),
                   jnp.uint32(cipher.BOOL_FALSE_MU))
    return pk_encrypt_torus(rng, pk, mu, alpha)


def _digit_plaintexts(key_from: Array, basebit: int, t: int) -> Array:
    """mu[i,j,k] = T(k * key_from[i] / 2^((j+1)*basebit)), exactly
    (proxyreenc.go:216-218 — dyadic, so integer shifts are bit-exact)."""
    base = 1 << basebit
    ks = jnp.arange(base, dtype=jnp.uint32)
    shifts = jnp.asarray([32 - (j + 1) * basebit for j in range(t)],
                         dtype=jnp.uint32)
    return (ks[None, None, :] * key_from[:, None, None]) << shifts[None, :, None]


def _mask_k0(table: Array, base: int) -> Array:
    mask = (jnp.arange(base) > 0)[None, None, :, None]
    return jnp.where(mask, table, jnp.uint32(0))


def gen_reencryption_key_symmetric(
        rng: Array, key_from: Array, key_to: Array, p: TFHEParams,
        alpha: float | None = None, basebit: int | None = None,
        t: int | None = None) -> ProxyReencryptionKey:
    """proxyreenc.go:249-300 (defaults: KSKAlpha, BASEBIT, IKS_T)."""
    alpha = p.ksk_alpha if alpha is None else alpha
    basebit = p.basebit if basebit is None else basebit
    t = p.iks_t if t is None else t
    mu = _digit_plaintexts(key_from, basebit, t)
    table = cipher.lwe_encrypt_torus(rng, mu, alpha, key_to)
    return ProxyReencryptionKey(table=_mask_k0(table, 1 << basebit),
                                basebit=basebit, t=t)


def gen_reencryption_key_asymmetric(
        rng: Array, key_from: Array, public_key_to: PublicKeyLv0,
        p: TFHEParams, alpha: float | None = None, basebit: int | None = None,
        t: int | None = None) -> ProxyReencryptionKey:
    """proxyreenc.go:180-232 — encrypt the digit table under Bob's PUBLIC key."""
    alpha = p.ksk_alpha if alpha is None else alpha
    basebit = p.basebit if basebit is None else basebit
    t = p.iks_t if t is None else t
    mu = _digit_plaintexts(key_from, basebit, t)
    table = pk_encrypt_torus(rng, public_key_to, mu, alpha)
    return ProxyReencryptionKey(table=_mask_k0(table, 1 << basebit),
                                basebit=basebit, t=t)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _reencrypt_core(table: Array, ct: Array, basebit: int, t: int) -> Array:
    n = table.shape[0]
    base = 1 << basebit
    prec_offset = jnp.uint32(1 << (32 - (1 + basebit * t)))
    shifts = jnp.asarray([32 - (j + 1) * basebit for j in range(t)],
                         dtype=jnp.uint32)
    a_bar = ct[..., :n] + prec_offset
    digits = ((a_bar[..., None] >> shifts) & jnp.uint32(base - 1)
              ).astype(jnp.int32)                               # (..., n, t)
    # int8 one-hot x int8 limb table as one matmul — exact (ops.keyswitch).
    onehot = (digits[..., None]
              == jnp.arange(base, dtype=jnp.int32)).astype(jnp.int8)
    lead = ct.shape[:-1]
    oh = onehot.reshape(lead + (n * t * base,))
    tot = matmul_i8_u32(oh, table.reshape((n * t * base, table.shape[-1])))
    out = jnp.zeros_like(tot) - tot
    return out.at[..., -1].add(ct[..., n])


def reencrypt(rk: ProxyReencryptionKey, ct: Array) -> Array:
    """Transform ciphertext(s) to the target key (proxyreenc.go:321-366).
    Supports multi-hop chains by repeated application.  Batched."""
    return _reencrypt_core(rk.table, ct, rk.basebit, rk.t)


# ---------------------------------------------------------------------------
# Serialization (new capability vs. the reference, like keys.save_cloud_key):
# the proxy role holds ONLY a re-encryption key, so a deployable proxy needs
# it persistable — asymmetric rekey generation costs seconds (CHANGELOG.md:27).
# ---------------------------------------------------------------------------

def save_reencryption_key(path: str, rk: ProxyReencryptionKey) -> None:
    np.savez_compressed(path, table=np.asarray(rk.table),
                        basebit=np.asarray(rk.basebit),
                        t=np.asarray(rk.t))


def load_reencryption_key(path: str) -> ProxyReencryptionKey:
    z = np.load(path)
    return ProxyReencryptionKey(table=jnp.asarray(z["table"]),
                                basebit=int(z["basebit"]),
                                t=int(z["t"]))


def save_public_key(path: str, pk: PublicKeyLv0) -> None:
    np.savez_compressed(path, encryptions=np.asarray(pk.encryptions))


def load_public_key(path: str) -> PublicKeyLv0:
    z = np.load(path)
    return PublicKeyLv0(encryptions=jnp.asarray(z["encryptions"]))
