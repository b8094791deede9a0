"""Exact negacyclic polynomial arithmetic mod 2^32 as integer matmuls.

This module replaces the reference's float64 negacyclic FFT kernel
(``poly/fourier_transform.go``, ``poly/fourier_ops.go``, ``poly/poly_mul.go``)
with *exact integer* products:

* A float32 FFT provides ~22-23 effective mantissa bits, while the external
  product needs ~27-28 bits of relative precision (conv results reach ~2^41
  against a per-step error budget of ~2^13), so a float32 FFT — with or
  without limb splitting — corrupts ciphertexts.
* XLA integer matmuls/convolutions wrap mod 2^32 in two's complement, which is
  *precisely* torus arithmetic.  A negacyclic product expressed as an int32
  (or limb-decomposed int8) contraction is exact: zero FFT noise, which
  strictly improves on the reference's float64 rounding.

The key identity: with D = concat([-K mod 2^32, K]) of length 2N,

    (a (*) K)[n]  =  sum_j a[j] * D[N + n - j]          (X^N = -1)

so the negacyclic product is a contraction against the Toeplitz matrix
T[j, n] = D[N + n - j].  The external product (trgsw/trgsw.go:108-134,
evaluator/evaluator.go:50-81) sums 2L such products, i.e. one matmul

    out[b, c, n] = sum_r sum_j digits[b, r, j] * D[r, c, N + n - j]

with contraction depth 2L*N.  Two forms:

* :func:`negacyclic_extprod_toeplitz` — int32 x int32, exact for any digit
  magnitude.  The plain reference; no accelerator has int32 tensor cores.
* :func:`negacyclic_extprod_i8` — the bootstrap's path.  The key's D band is
  split at keygen into balanced int8 limbs (:func:`prepare_band_limbs`), the
  digits are int8 (or exact int8 limb planes for BGBIT > 8), and the
  contraction is one int8 x int8 -> int32 matmul per digit limb with the key
  limbs folded into the output columns, recombined by shifts mod 2^32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.torus import TORUS, to_signed, to_unsigned

Array = jax.Array


# ---------------------------------------------------------------------------
# Kernel construction (keygen-time).
# ---------------------------------------------------------------------------

def _neg_ext(k_u32: Array) -> Array:
    """D = concat([-K mod 2^32, K]) along the last axis, as uint32."""
    return jnp.concatenate([jnp.zeros_like(k_u32) - k_u32, k_u32], axis=-1)


def conv_kernel_from_poly(k_u32: Array) -> Array:
    """Build the width-(2N-1) correlation kernel for one polynomial.

    k_u32: (..., N) uint32  ->  (..., 2N-1) int32 such that
    negacyclic_conv(a, k)[n] = sum_kw a[n + kw - (N-1)] * kernel[kw].
    kernel[kw] = D[2N-1-kw]  (reverse of D dropping D[0], which is unused).
    """
    d = _neg_ext(k_u32)
    return to_signed(d[..., 1:][..., ::-1])


def extprod_kernel_from_trgsw(trgsw_u32: Array) -> Array:
    """TRGSW ciphertext(s) -> conv kernel for the external product.

    trgsw_u32: (..., 2L, 2, N) uint32 (rows ordered [A-gadget rows, B-gadget
    rows] as in trgsw/trgsw.go:51-54; each row is a TRLWE (A, B) pair).

    Returns (..., 2, 2L, 2N-1) int32 arranged as (C_out=A/B, C_in=row, width)
    for ``lax.conv_general_dilated`` with 'OIH' kernel layout.
    """
    k = conv_kernel_from_poly(trgsw_u32)           # (..., 2L, 2, 2N-1)
    return jnp.swapaxes(k, -3, -2)                 # (..., 2, 2L, 2N-1)


def split_signed_limbs_i8(x_i32: Array, num_limbs: int) -> Array:
    """Split SIGNED int32 values into base-256 int8 limbs that reconstruct
    exactly:  sum_i limb[i] * 2^(8i) == x  (as integers, no wraparound).

    The first num_limbs-1 limbs are balanced in [-128, 127]; the last limb
    carries the signed remainder and must fit int8 — guaranteed when
    |x| <= 2^(8*num_limbs - 2) (true for gadget digits: |d| <= half_bg and
    num_limbs = ceil(bgbit/8)).  Unlike :func:`split_balanced_limbs_i8`,
    which reconstructs only mod 2^(8*num_limbs), exactness here is required
    so that digit-limb x kernel-limb products recombine to d*K mod 2^32.
    """
    x = x_i32.astype(jnp.int32)
    limbs = []
    for _ in range(num_limbs - 1):
        l = ((x + 128) & 255) - 128                 # balanced, [-128, 127]
        limbs.append(l.astype(jnp.int8))
        x = (x - l) >> 8                            # arithmetic shift, exact
    limbs.append(x.astype(jnp.int8))
    return jnp.stack(limbs, axis=0)


def split_balanced_limbs_i8(x_i32: Array, num_limbs: int = 4) -> Array:
    """Split int32 values into ``num_limbs`` base-256 balanced int8 limbs.

    Returns (num_limbs, ...) int8 with  sum_i limb[i] * 2^(8i) == x (mod 2^32)
    — the top limb wraps mod 256, which is harmless because its weight is
    2^(8*(num_limbs-1)) and all downstream arithmetic is mod 2^32.
    """
    x = to_unsigned(x_i32)
    limbs = []
    for _ in range(num_limbs):
        lu = (x + jnp.uint32(128)) & jnp.uint32(255)
        l = lu.astype(jnp.int32) - 128              # [-128, 127]
        limbs.append(l.astype(jnp.int8))
        x = (x - to_unsigned(l)) >> jnp.uint32(8)   # exact: x == l (mod 256)
    return jnp.stack(limbs, axis=0)


# ---------------------------------------------------------------------------
# Convolution cores.
# ---------------------------------------------------------------------------

def _conv_nch(lhs: Array, kernel: Array) -> Array:
    """conv: lhs (B, C_in, N) x kernel (C_out, C_in, 2N-1) -> (B, C_out, N),
    int32 accumulation (wraps mod 2^32 — exactly torus arithmetic)."""
    n = lhs.shape[-1]
    return lax.conv_general_dilated(
        lhs, kernel,
        window_strides=(1,),
        padding=[(n - 1, n - 1)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.int32,
    )


def negacyclic_extprod_i32(digits_i32: Array, kernel_i32: Array) -> Array:
    """Generic exact external-product convolution.

    digits_i32: (..., 2L, N) int32 gadget digits.
    kernel_i32: (2, 2L, 2N-1) int32 from :func:`extprod_kernel_from_trgsw`.
    Returns (..., 2, N) uint32 — the TRLWE result mod 2^32.
    """
    lead = digits_i32.shape[:-2]
    c_in, n = digits_i32.shape[-2:]
    lhs = digits_i32.reshape((-1, c_in, n))
    out = _conv_nch(lhs, kernel_i32)
    return to_unsigned(out.reshape(lead + (2, n)))


def ext_band_from_trgsw(trgsw_u32: Array) -> Array:
    """TRGSW ciphertext(s) -> signed D bands for the Toeplitz-einsum path.

    trgsw_u32: (..., 2L, 2, N) uint32  ->  (..., 2L, 2, 2N) int32 with
    D = concat([-K mod 2^32, K]).
    """
    return to_signed(_neg_ext(trgsw_u32))


def prepare_band_limbs(trgsw_u32: Array, drop: int = 0) -> Array:
    """TRGSW ciphertext(s) -> the int8 limb bands the external product reads.

    trgsw_u32: (..., 2L, 2, N) uint32  ->  (4-drop, ..., 2L, 2, 2N) int8:
    the balanced base-256 limbs of the signed D band, limb j weighing
    2^(8*(j+drop)).  ``drop`` low limbs are omitted; the caller guarantees
    they are zero (params.kernel_limb_drop / key_grid_bits).
    """
    return split_balanced_limbs_i8(ext_band_from_trgsw(trgsw_u32), 4)[drop:]


def _toeplitz_minor(y: Array) -> Array:
    """Band (..., 2N, Q) -> (..., N, N, Q) with T[j, n, q] = D[N+n-j, q].

    Built with pad + tile + reshape + slice only (no gathers): with
    y = [D, 0_N] of 3N rows flattened, rows tiled at stride (3N-1)*Q satisfy
    R[j, t] = y[(t - j*Q) mod 3NQ], and t = (N+n)*Q + q never wraps for
    valid (j, n).  XLA compiles this to plain copies, which keeps it usable
    inside loops on every backend (convolutions inside loops trigger a
    pathological XLA:CPU compile blow-up).
    """
    lead = y.shape[:-2]
    n2, q = y.shape[-2:]
    n = n2 // 2
    y = jnp.concatenate([y, jnp.zeros(lead + (n, q), y.dtype)], axis=-2)
    flat = y.reshape(lead + (3 * n * q,))
    tiled = jnp.tile(flat, (1,) * len(lead) + (n,))
    r = tiled[..., :n * (3 * n - 1) * q].reshape(lead + (n, (3 * n - 1) * q))
    return r[..., n * q:2 * n * q].reshape(lead + (n, n, q))


def toeplitz_from_band(d_band: Array) -> Array:
    """Band (..., 2N) -> negacyclic Toeplitz (..., N, N), T[j, n] = D[N+n-j]."""
    return _toeplitz_minor(d_band[..., None])[..., 0]


def negacyclic_extprod_toeplitz(digits_i32: Array, band_i32: Array) -> Array:
    """Plain exact external product: int32 Toeplitz + int32 einsum.

    The reference the int8 path is checked against (tests, chip_smoke.py);
    never on the bootstrap's path.

    digits_i32: (..., 2L, N) int32 gadget digits (any magnitude).
    band_i32:   (2L, 2, 2N) int32 from :func:`ext_band_from_trgsw`.
    Returns (..., 2, N) uint32 — exact mod 2^32 (int32 wraparound dot).
    """
    t = toeplitz_from_band(band_i32)                  # (2L, 2, N, N)
    out = jnp.einsum("...rj,rcjn->...cn", digits_i32, t,
                     preferred_element_type=jnp.int32)
    return to_unsigned(out)


def negacyclic_extprod_i8(digits_i8: Array, band_limbs: Array,
                          drop: int = 0) -> Array:
    """Exact external product as int8 x int8 -> int32 matmuls.

    digits_i8:  (ND, ..., R, N) int8 digit limbs, limb i weighing 2^(8i)
                (ND = 1 when the gadget digits fit int8).
    band_limbs: (NL, R, 2, 2N) int8 from :func:`prepare_band_limbs`, limb j
                weighing 2^(8*(j+drop)).
    Returns (..., 2, N) uint32, equal to negacyclic_extprod_toeplitz of the
    recombined digits and band, mod 2^32.

    Per digit limb i one matmul (M, R*N) x (R*N, N*NJ*2) with the NJ key
    limbs that still matter mod 2^32 (i + j + drop <= 3) folded into the
    output columns; each int32 partial is exact while R*N*128*128 < 2^31
    (the caller asserts the profile's bound, extprod.assert_i8_exact).
    """
    nd, nl = digits_i8.shape[0], band_limbs.shape[0]
    lead = digits_i8.shape[1:-2]
    rows, n = digits_i8.shape[-2:]
    # (NL, R, 2, 2N) -> (R, 2N, NL*2): key limbs and channels are the minor
    # axis, so each Toeplitz row (r, k) is one contiguous matmul row.
    y = jnp.transpose(band_limbs, (1, 3, 0, 2)).reshape(rows, 2 * n, nl * 2)
    t = _toeplitz_minor(y).reshape(rows * n, n, nl, 2)
    lhs = digits_i8.reshape((nd, -1, rows * n))
    acc = None
    for i in range(nd):
        nj = min(nl, 4 - drop - i)
        rhs = t[:, :, :nj].reshape(rows * n, n * nj * 2)
        out = jnp.dot(lhs[i], rhs, preferred_element_type=jnp.int32)
        out = to_unsigned(out.reshape(-1, n, nj, 2))
        for j in range(nj):
            part = out[:, :, j] << jnp.uint32(8 * (i + j + drop))
            acc = part if acc is None else acc + part
    return jnp.swapaxes(acc, -1, -2).reshape(lead + (2, n))


def _recombine_limb_columns(acc_i32: Array, width: int) -> Array:
    """(..., 4*W) int32 partials of limb l in columns [l*W, (l+1)*W) ->
    (..., W) uint32 sum_l partial_l * 2^(8l) mod 2^32."""
    tot = to_unsigned(acc_i32[..., :width])
    for l in range(1, 4):
        tot = tot + (to_unsigned(acc_i32[..., l * width:(l + 1) * width])
                     << jnp.uint32(8 * l))
    return tot


def matmul_i8_u32(lhs_i8: Array, rhs_u32: Array) -> Array:
    """(..., K) int8 x (K, W) uint32 -> (..., W) uint32, exact mod 2^32.

    The uint32 operand splits into 4 balanced int8 limbs folded into the
    output columns: one int8 x int8 -> int32 matmul, whose partials are
    exact while K*|lhs|*128 < 2^31 (asserted for |lhs| <= 1, the one-hot
    and sign-vector callers), recombined by shifts.
    """
    k, w = rhs_u32.shape
    assert k * 128 < 1 << 31, k
    limbs = split_balanced_limbs_i8(to_signed(rhs_u32), 4)     # (4, K, W)
    rhs = jnp.concatenate([limbs[l] for l in range(4)], axis=-1)
    acc = jnp.matmul(lhs_i8, rhs, preferred_element_type=jnp.int32)
    return _recombine_limb_columns(acc, w)


def negacyclic_mul_binary(a_u32: Array, key_u32: Array) -> Array:
    """Negacyclic product with a BINARY polynomial (a ring secret key),
    exact mod 2^32, as one int8 matmul.

    a_u32: (..., N) uint32;  key_u32: (N,) uint32 in {0, 1}.

    The signed band of a binary key has entries in {-1, 0, 1}, so its
    Toeplitz matrix is int8; ``a`` splits into 4 balanced int8 limbs, each
    int32 partial sum is <= N*128 < 2^31 — integer-exact, recombined mod
    2^32.  (A bf16 form with f32 accumulation is exact on paper, but XLA's
    GPU compiler miscomputed dot(bf16)->f32->s32 at some batch shapes.)

    This is the keygen hot path (TRGSW encryption of every LWE key bit,
    cloudkey/cloudkey.go:123-145): the general int32-convolution form
    (:func:`negacyclic_mul_fixed`) is a convolution, which no matmul unit
    takes; this form is one batched int8 matmul.
    """
    lead = a_u32.shape[:-1]
    n = a_u32.shape[-1]
    t = toeplitz_from_band(ext_band_from_trgsw(key_u32)).astype(jnp.int8)
    limbs = split_balanced_limbs_i8(to_signed(a_u32), 4)       # (4, ..., N)
    lhs = jnp.moveaxis(limbs.reshape((4, -1, n)), 0, 1)         # (M, 4, N)
    outs = jnp.einsum("blj,jn->bln", lhs, t,
                      preferred_element_type=jnp.int32)
    return _recombine_limb_columns(outs.reshape(-1, 4 * n), n).reshape(
        lead + (n,))


def negacyclic_mul_fixed(a_u32: Array, k_u32: Array) -> Array:
    """Negacyclic product of batched polynomials with one fixed polynomial.

    a_u32: (..., N) uint32;  k_u32: (N,) uint32.  Exact mod 2^32.
    Replaces poly.Evaluator.MulPoly (poly/poly_mul.go:12-22) for the
    encrypt/decrypt path (a * secret_key with binary key).
    """
    lead = a_u32.shape[:-1]
    n = a_u32.shape[-1]
    lhs = to_signed(a_u32).reshape((-1, 1, n))
    kernel = conv_kernel_from_poly(k_u32)[None, None, :]   # (1, 1, 2N-1)
    out = _conv_nch(lhs, kernel)
    return to_unsigned(out.reshape(lead + (n,)))
