"""The bootstrap engine: one jitted, batched function per pipeline.

Reference: evaluator/evaluator.go:110-157 (blind rotate -> sample extract ->
key switch) and evaluator/gates_helper.go (affine gate preparations).  The
reference maintains two engines (legacy trgsw/ and zero-alloc evaluator/);
this framework has exactly one (SURVEY.md layering note).

Everything below the public functions is traced once per (profile, batch
shape) and compiled by XLA; throughput comes from the leading batch axes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .keys import CloudKey
from .ops.blindrotate import (blind_rotate, blind_rotate_block,
                              blind_rotate_extended)
from .ops.keyswitch import identity_key_switch
from .ops.sample_extract import sample_extract
from .params import TFHEParams
from .utils.torus import f64_to_torus

Array = jax.Array

# Affine-preparation bias constants (evaluator/gates_helper.go, gates/gates.go).
_T_EIGHTH = int(f64_to_torus(0.125))
_T_NEG_EIGHTH = int(f64_to_torus(-0.125))
_T_QUARTER = int(f64_to_torus(0.25))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _bootstrap_core(p: TFHEParams, key_switch: bool, bsk_limbs: Array,
                    ksk: Array, ct: Array, testvec: Array) -> Array:
    rotated = blind_rotate(p, bsk_limbs, ct, testvec)
    lv1 = sample_extract(rotated, 0)
    return identity_key_switch(p, ksk, lv1) if key_switch else lv1


@functools.partial(jax.jit, static_argnums=(0, 1))
def _bootstrap_core_ext(p: TFHEParams, key_switch: bool, bsk_limbs: Array,
                        ksk: Array, ct: Array, lut_blocks: Array) -> Array:
    """Extended-LUT bootstrap (LookUpTableSize = polyExtendFactor * N) —
    the Uint6-8 capability the reference never implemented."""
    rotated = blind_rotate_extended(p, bsk_limbs, ct, lut_blocks)
    lv1 = sample_extract(rotated[..., 0, :, :], 0)   # big-poly coeff 0
    return identity_key_switch(p, ksk, lv1) if key_switch else lv1


@functools.partial(jax.jit, static_argnums=(0, 1))
def _bootstrap_core_block(p: TFHEParams, key_switch: bool, bsk_limbs: Array,
                          ksk: Array, ct: Array, testvec: Array) -> Array:
    """Block blind rotation — block-binary lv0 keys only."""
    rotated = blind_rotate_block(p, bsk_limbs, ct, testvec)
    lv1 = sample_extract(rotated, 0)
    return identity_key_switch(p, ksk, lv1) if key_switch else lv1


def _bootstrap(ck: CloudKey, ct: Array, testvec: Array | None,
               key_switch: bool) -> Array:
    p = ck.params
    tv = ck.testvec if testvec is None else testvec
    if p.poly_extend_factor > 1:
        core = _bootstrap_core_ext
    elif ck.block_binary and p.block_size > 1:
        core = _bootstrap_core_block
    else:
        core = _bootstrap_core
    return core(p, key_switch, ck.bsk_limbs, ck.ksk, ct, tv)


def bootstrap(ck: CloudKey, ct: Array, testvec: Array | None = None) -> Array:
    """Full gate bootstrap: (..., lwe_n+1) -> (..., lwe_n+1)
    (evaluator/evaluator.go:139-148)."""
    return _bootstrap(ck, ct, testvec, key_switch=True)


# ---------------------------------------------------------------------------
# Multi-LUT bootstrapping (PBSmanyLUT) — beyond-reference capability.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _bootstrap_core_many(p: TFHEParams, key_switch: bool, k: int, theta: int,
                         bsk_limbs: Array, ksk: Array, ct: Array,
                         testvec: Array) -> Array:
    rotated = blind_rotate(p, bsk_limbs, ct, testvec, theta=theta)
    lv1 = jnp.stack([sample_extract(rotated, t) for t in range(k)])
    return identity_key_switch(p, ksk, lv1) if key_switch else lv1


def bootstrap_many(ck: CloudKey, ct: Array, multi_lut: Array, k: int,
                   theta: int = 1, key_switch: bool = True) -> Array:
    """k function outputs from ONE blind rotation (PBSmanyLUT).

    The mod switch rounds to multiples of 2^theta (mod_switch_2n), the
    test vector interleaves the k functions by residue
    (lut.Generator.gen_multi_lut), and sample extraction at indices
    0..k-1 reads them out.  The reference has no equivalent — a circuit
    needing several functions of the same linear combination (e.g. a full
    adder's sum AND carry bits) pays ONE bootstrap instead of k.

    Noise: the coarse mod switch multiplies the mod-switch ROUNDING term
    by 2^theta.  ``tools/noise_many.py`` measures the phase margin per
    theta (margin = the 2^27 half-segment at messageModulus=8); the
    full adder (k=2, theta=1) is decrypt-checked at 128bit_fast by
    ``chip_smoke.py`` phase (c).  Measure before using theta >= 2, or
    theta > 0 on the floor-gadget reference profiles.

    ct: (..., lwe_n+1); multi_lut: (2, N) shared, or (..., 2, N)
    per-ciphertext multi-LUTs (heterogeneous function sets in one batch).
    Returns (k, ..., lwe_n+1) — output t is f_t of the common phase.
    """
    p = ck.params
    assert p.poly_extend_factor == 1, "many-LUT needs a plain (N) profile"
    assert 1 <= k <= 1 << theta
    return _bootstrap_core_many(p, key_switch, k, theta, ck.bsk_limbs,
                                ck.ksk, ct, multi_lut)


def bootstrap_without_key_switch(ck: CloudKey, ct: Array,
                                 testvec: Array | None = None) -> Array:
    """Blind rotate + sample extract only; result is under the level-1 key
    (gates/gates.go:145-149).  Like the reference's SampleExtractIndex2
    (trlwe/trlwe.go:133-154), reading it as a level-0 ciphertext is only
    valid when n == lwe_n."""
    return _bootstrap(ck, ct, testvec, key_switch=False)


# ---------------------------------------------------------------------------
# Gate preparations (affine pre-bootstrap combos).
# ---------------------------------------------------------------------------

def _with_bias(x: Array, bias: int) -> Array:
    return x.at[..., -1].add(jnp.uint32(bias))


def prepare_nand(a: Array, b: Array) -> Array:
    """-(a+b) + 1/8  (evaluator/gates_helper.go:10-21)."""
    return _with_bias(jnp.zeros_like(a) - (a + b), _T_EIGHTH)


def prepare_and(a: Array, b: Array) -> Array:
    """(a+b) - 1/8  (evaluator/gates_helper.go:24-35)."""
    return _with_bias(a + b, _T_NEG_EIGHTH)


def prepare_or(a: Array, b: Array) -> Array:
    """(a+b) + 1/8  (evaluator/gates_helper.go:38-49)."""
    return _with_bias(a + b, _T_EIGHTH)


def prepare_xor(a: Array, b: Array) -> Array:
    """(a+2b) + 1/4  (evaluator/gates_helper.go:52-63)."""
    return _with_bias(a + b * jnp.uint32(2), _T_QUARTER)


def prepare_xnor(a: Array, b: Array) -> Array:
    """(a-2b) + 1/4  (gates/gates.go:52-58; the batch variant upstream uses
    -1/4, which fails its own truth table — we keep the correct sign)."""
    return _with_bias(a - b * jnp.uint32(2), _T_QUARTER)


def prepare_nor(a: Array, b: Array) -> Array:
    """-(a+b) - 1/8  (gates/gates.go:72-76)."""
    return _with_bias(jnp.zeros_like(a) - (a + b), _T_NEG_EIGHTH)


def prepare_andny(a: Array, b: Array) -> Array:
    """(-a+b) - 1/8: NOT(a) AND b  (gates/gates.go:79-83)."""
    return _with_bias(b - a, _T_NEG_EIGHTH)


def prepare_andyn(a: Array, b: Array) -> Array:
    """(a-b) - 1/8: a AND NOT(b)  (gates/gates.go:86-90)."""
    return _with_bias(a - b, _T_NEG_EIGHTH)


def prepare_orny(a: Array, b: Array) -> Array:
    """(-a+b) + 1/8: NOT(a) OR b  (gates/gates.go:93-97)."""
    return _with_bias(b - a, _T_EIGHTH)


def prepare_oryn(a: Array, b: Array) -> Array:
    """(a-b) + 1/8: a OR NOT(b)  (gates/gates.go:100-104)."""
    return _with_bias(a - b, _T_EIGHTH)
