"""External product and CMUX on TRLWE ciphertexts (batched, exact).

external_product: decompose -> one integer matmul per digit limb ->
accumulate (reference: trgsw/trgsw.go:108-134, evaluator/evaluator.go:50-81 —
there it is decompose -> 2L FFTs -> pointwise FMA -> 2 IFFTs; here the whole
contraction is an int8 matmul, see :mod:`.polymul`).

CMUX(cond, ct0, ct1) = ct0 + cond (x) (ct1 - ct0)
(trgsw/trgsw.go:173-194, evaluator/evaluator.go:85-106).

The TRGSW operand is prepared once at keygen as int8 limbs of its signed D
band (the analogue of the reference storing the bootstrapping key in FFT
form, trgsw/trgsw.go:71-82): one step's slice is (4-drop, 2L, 2, 2N) int8.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import TFHEParams
from .decompose import gadget_decompose
from .polymul import negacyclic_extprod_i8, split_signed_limbs_i8

Array = jax.Array


def assert_i8_exact(p: TFHEParams, rows: int) -> None:
    """Static check that every int32 partial of the int8 contraction is
    exact: |sum| <= rows*N*128*|digit limb| must stay below 2^31."""
    bound = rows * p.n * 128 * min(p.half_bg, 128)
    assert bound < 1 << 31, (p.name, rows, bound)


def decompose_i8(x_u32: Array, p: TFHEParams) -> Array:
    """(..., C, N) uint32 -> (ND, ..., C*L, N) int8 digit limbs.

    ND = 1 when the gadget digits fit int8 (BGBIT <= 8); otherwise the exact
    signed base-256 limb planes of :func:`split_signed_limbs_i8`."""
    digits = gadget_decompose(x_u32, p)
    if p.digit_limbs == 1:
        return digits.astype(jnp.int8)[None]
    return split_signed_limbs_i8(digits, p.digit_limbs)


def external_product(p: TFHEParams, band_limbs: Array,
                     trlwe_u32: Array) -> Array:
    """band (x) trlwe: (..., 2, N) uint32 -> (..., 2, N) uint32.

    band_limbs: (4-drop, 2L, 2, 2N) int8, one step of CloudKey.bsk_limbs."""
    assert_i8_exact(p, band_limbs.shape[1])
    return negacyclic_extprod_i8(decompose_i8(trlwe_u32, p), band_limbs,
                                 p.kernel_limb_drop)


def cmux(p: TFHEParams, band_limbs: Array, ct0: Array, ct1: Array) -> Array:
    """if cond==0: ct0 else ct1 (homomorphically):
    ct0 + cond (x) (ct1 - ct0)."""
    return ct0 + external_product(p, band_limbs, ct1 - ct0)
