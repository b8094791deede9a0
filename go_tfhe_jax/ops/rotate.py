"""Negacyclic monomial multiplication  p(X) -> X^k * p(X).

Batched replacement for ``polyMulWithXKInPlace`` (trgsw/trgsw.go:254-282,
poly/buffer_methods.go:133-164).  The rotation amount ``k`` is a traced value
(it comes from mod-switched ciphertext coefficients) and differs per batch
element, so this is a per-row gather plus a sign mask, which XLA fuses with
the decomposition that follows.  (A gather-free form composing static
shifts by the bits of ``k`` was 1.5x slower end to end on the H100: see
PERF.md.)

Faithful to the reference, the wrapped coefficients use the cheap negation
``^Torus(0) - a`` (bitwise NOT, i.e. -a-1 mod 2^32) rather than exact -a; the
1-ulp offset is far below the noise floor and keeping it preserves bit-exact
parity with Go on deterministic sub-kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.torus import torus_not

Array = jax.Array


def monomial_mul(poly: Array, k: Array) -> Array:
    """Multiply polynomials by X^k (negacyclic, NOT-negation).

    poly: (..., N) uint32.
    k:    int32, broadcastable to poly.shape[:-1]; interpreted mod 2N.

    For k in [0, N):   out[i] = p[i-k]        for i >= k
                       out[i] = ~p[i-k+N]     for i <  k
    For k in [N, 2N):  signs flipped (trgsw/trgsw.go:262-281).
    """
    n = poly.shape[-1]
    k = jnp.asarray(k, jnp.int32)
    k2 = jnp.mod(k, 2 * n)
    r = jnp.mod(k2, n)[..., None]                       # (..., 1)
    flip = (k2 >= n)[..., None]                         # (..., 1)
    i = jnp.arange(n, dtype=jnp.int32)
    src = jnp.mod(i - r, n)                             # (..., N)
    shape = jnp.broadcast_shapes(poly.shape, src.shape)
    gathered = jnp.take_along_axis(
        jnp.broadcast_to(poly, shape), jnp.broadcast_to(src, shape), axis=-1)
    neg = (i < r) ^ flip
    return jnp.where(neg, torus_not(gathered), gathered)


def monomial_mul_blocks(acc: Array, t: Array, k: int) -> Array:
    """Rotate an *extended* (degree k*N) negacyclic polynomial by X^t.

    The big polynomial P(X) mod X^(kN)+1 is stored interleaved as k blocks
    P_r(Y) with Y = X^k:  P(X) = sum_r X^r P_r(X^k), i.e.
    big[j] == block[j % k][j // k].  Rotation by X^t is then a block
    permutation plus per-block negacyclic Y-rotations:

        out_block[r'] = Y^q * block[r],  r = (r'-t) mod k,  q = (t+r-r')/k

    (q >= 0 because t >= 0 and t+r-r' is a multiple of k greater than -k).
    This is the mechanism behind LookUpTableSize = polyExtendFactor * N —
    the feature the reference's params advertise for Uint6-8 but never
    implement (lut/generator.go:19-21, params/UINT_STATUS.md:20-31).

    acc: (..., k, C, N) uint32 (C = 2 for TRLWE blocks).
    t:   int32, broadcastable to acc.shape[:-3]; interpreted mod 2kN.
    """
    n = acc.shape[-1]
    t = jnp.mod(jnp.asarray(t, jnp.int32), 2 * k * n)
    r_out = jnp.arange(k, dtype=jnp.int32)                      # (k,)
    r_src = jnp.mod(r_out - t[..., None], k)                    # (..., k)
    q = (t[..., None] + r_src - r_out) // k                     # (..., k)
    idx = jnp.broadcast_to(r_src[..., None, None],
                           acc.shape[:-3] + (k,) + acc.shape[-2:])
    gathered = jnp.take_along_axis(acc, idx, axis=-3)
    return monomial_mul(gathered, q[..., None])                 # over (C, N)
