"""Nussbaumer polynomial transform: exact sub-quadratic negacyclic
convolution mod 2^32 — the algorithmic lever behind the fast external
product.

The dense Toeplitz external product (ops/polymul.py) costs
(2L*N) x (2ch*limbs*N) int8 MACs per ciphertext per blind-rotate step.  The
Nussbaumer transform [Nussbaumer 1980] factors the length-N negacyclic
convolution through Z[Z]/(Z^(2r)+1):

    N = m*r  (m | 2r),   S = Z[Z]/(Z^(2r)+1),   zeta = Z^(2r/m)

* split a(X) into m chunks of r coefficients (a = sum_u a_u(X) * X^(r*u)),
  embed each chunk in S (upper half zero);
* twist chunk u by zeta^u, then a length-m CYCLIC NTT over S whose
  twiddles are POWERS OF Z — i.e. negacyclic array rotations, additions
  only, no multiplications (this is what makes it work over Z_2^32, where
  no root of unity exists);
* m pointwise products in S (size-2r negacyclic convolutions — these are
  the only multiplications, and become the matmul contractions);
* unnormalized inverse NTT, untwist by zeta^(-w), overlap-add the chunks.

Matmul work drops by m/8 (4x at N=1024, 8x at N=2048) at the price of O(N
log m) vector additions/rotations.

Division by m (the inverse NTT's 1/m) does not exist mod 2^32.  For the
external product we absorb it into the OTHER operand at keygen: the fast
profiles generate the BSK on the 2^key_grid_bits torus subgrid
(params.key_grid_bits >= log2(m)), so J = K/m is exact and

    INTT'(NTT(d) . NTT(J)) = m * INTT(...) = d (x) K   (mod 2^32, exact)

with INTT' the unnormalized inverse.  Everything below is integer
arithmetic wrapping mod 2^32 — bit-exact with the dense path
(tests/test_nussbaumer.py), zero rounding error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.torus import to_signed, to_unsigned
from ..ops.polymul import ext_band_from_trgsw, toeplitz_from_band

Array = jax.Array


def nuss_shape(n: int) -> tuple[int, int, int]:
    """(m, r, e) for degree n: m the largest power of two with m | 2*(n/m)
    (i.e. m <= sqrt(2n)), r = n/m chunk size, e = 2r/m the twist stride."""
    assert n & (n - 1) == 0 and n >= 4, n
    nbit = n.bit_length() - 1
    mbit = (nbit + 1) // 2
    m = 1 << mbit
    r = n // m
    return m, r, 2 * r // m


def neg_rot(v: Array, k: int) -> Array:
    """Multiply by Z^k in Z[Z]/(Z^s+1) along the last axis (static k).

    Z^s = -1: out[z] = v[z-k] for z >= k, -v[s+z-k] for z < k."""
    s = v.shape[-1]
    k %= 2 * s
    if k >= s:
        v = -v
        k -= s
    if k == 0:
        return v
    rolled = jnp.roll(v, k, axis=-1)
    idx = jnp.arange(s)
    return jnp.where(idx < k, -rolled, rolled)


def _bitrev(m: int) -> list[int]:
    bits = m.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) for i in range(m)]


def ntt_slots(x: Array, we: int, inverse: bool = False) -> Array:
    """Length-m cyclic NTT over S on the second-to-last axis.

    x: (..., m, s) int32;  the m-th root of unity is Z^we (we = 2e forward).
    Returns X[t] = sum_u Z^(we*t*u) x[u]  (sign flipped for inverse; the
    inverse is UNNORMALIZED — it returns m times the true INTT).
    Cooley-Tukey DIT with monomial twiddles (additions and rotations only).
    """
    m = x.shape[-2]
    x = jnp.take(x, jnp.asarray(_bitrev(m)), axis=-2)
    size = 2
    sgn = -1 if inverse else 1
    while size <= m:
        half = size // 2
        wstep = sgn * we * (m // size)
        shape = x.shape
        x = x.reshape(shape[:-2] + (m // size, size, shape[-1]))
        lo = x[..., :half, :]
        hi = x[..., half:, :]
        hi = jnp.stack(
            [neg_rot(hi[..., j, :], wstep * j) for j in range(half)],
            axis=-2)
        x = jnp.concatenate([lo + hi, lo - hi], axis=-2).reshape(shape)
        size *= 2
    return x


def _twist(c: Array, e: int, sign: int) -> Array:
    """Multiply chunk u by Z^(sign*e*u); c: (..., m, 2r)."""
    m = c.shape[-2]
    return jnp.stack(
        [neg_rot(c[..., u, :], sign * e * u) for u in range(m)], axis=-2)


def forward(a_i32: Array, n: int | None = None) -> Array:
    """Forward Nussbaumer transform: (..., N) int32 -> (..., m, 2r) int32.

    Values grow by at most a factor of m (sums of m inputs)."""
    n = a_i32.shape[-1] if n is None else n
    m, r, e = nuss_shape(n)
    c = a_i32.reshape(a_i32.shape[:-1] + (m, r))
    c = jnp.concatenate([c, jnp.zeros_like(c)], axis=-1)       # embed in S
    return ntt_slots(_twist(c, e, +1), 2 * e)


def inverse_unnormalized(c_hat: Array, n: int) -> Array:
    """Unnormalized inverse: (..., m, 2r) -> (..., N) int32, equal to
    m * (true inverse) mod 2^32.  Untwists and overlap-adds the chunks."""
    m, r, e = nuss_shape(n)
    c = _twist(ntt_slots(c_hat, 2 * e, inverse=True), e, -1)
    low = c[..., :, :r]
    high = c[..., :, r:]
    high = jnp.concatenate([-high[..., -1:, :], high[..., :-1, :]], axis=-2)
    return (low + high).reshape(c.shape[:-2] + (m * r,))


# ---------------------------------------------------------------------------
# External product through the transform (reference implementation).
# ---------------------------------------------------------------------------

def bsk_nuss_hat(bsk_rows_u32: Array, n: int) -> Array:
    """Keygen-side operand transform with the 1/m absorbed.

    bsk_rows_u32: (..., N) uint32 TRGSW row polynomials, every value
    divisible by m (on-grid keys, params.key_grid_bits >= log2 m).
    Returns (..., m, 2r) int32 = forward(K/m)."""
    m, _, _ = nuss_shape(n)
    k = jnp.asarray(bsk_rows_u32)
    # exact division: K is a multiple of m
    j = (k >> jnp.uint32(m.bit_length() - 1)).astype(jnp.int32)
    return forward(j, n)


def extprod_nuss_ref(digits_i32: Array, bsk_u32: Array) -> Array:
    """Reference (pure-jnp) Nussbaumer external product, exact mod 2^32.

    digits_i32: (..., 2L, N) int32 gadget digits.
    bsk_u32:    (2L, 2, N) uint32 TRGSW rows, values divisible by m.
    Returns (..., 2, N) uint32 == negacyclic_extprod_toeplitz(digits, band).
    """
    n = digits_i32.shape[-1]
    j_hat = bsk_nuss_hat(bsk_u32, n)                  # (2L, 2, m, 2r)
    d_hat = forward(digits_i32, n)                    # (..., 2L, m, 2r)
    # Slot-wise negacyclic 2r-convolutions, contracted over the 2L rows.
    t = toeplitz_from_band(
        ext_band_from_trgsw(to_unsigned(j_hat)))      # (2L,2,m,2r,2r)
    c_hat = jnp.einsum("...rtz,rctzy->...cty", d_hat, t,
                       preferred_element_type=jnp.int32)
    return to_unsigned(inverse_unnormalized(c_hat, n))


def negacyclic_mul_nuss_ref(a_i32: Array, k_u32: Array) -> Array:
    """Single negacyclic product a (x) K via the transform (K divisible by
    m); reference for tests."""
    n = a_i32.shape[-1]
    j_hat = bsk_nuss_hat(k_u32, n)                    # (m, 2r)
    a_hat = forward(a_i32, n)                         # (..., m, 2r)
    t = toeplitz_from_band(ext_band_from_trgsw(to_unsigned(j_hat)))
    c_hat = jnp.einsum("...tz,tzy->...ty", a_hat, t,
                       preferred_element_type=jnp.int32)
    return to_unsigned(inverse_unnormalized(c_hat, n))
