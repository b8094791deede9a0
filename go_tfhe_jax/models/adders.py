"""Homomorphic adders.

* Ripple-carry adder over encrypted bit vectors (the reference documents this
  as README code only, README.md:78-115; the batched gate engine makes it a
  library function here).
* PBS nibble adder: 8-bit addition in 3 programmable bootstraps using a
  messageModulus-32 profile (examples/add_two_numbers/main.go:44-136).

All functions broadcast over leading batch axes: `a_bits`/`b_bits` of shape
(..., nbits, lwe_n+1) add (...) independent pairs of numbers at once.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .. import gates, lut
from ..keys import CloudKey

Array = jax.Array


def half_adder(ck: CloudKey, a: Array, b: Array) -> Tuple[Array, Array]:
    """(sum, carry) = (a XOR b, a AND b)."""
    return gates.XOR(ck, a, b), gates.AND(ck, a, b)


def full_adder(ck: CloudKey, a: Array, b: Array,
               carry_in: Array) -> Tuple[Array, Array]:
    """One-bit full adder (README.md:78-115):
    s = (a^b)^cin;  cout = (a&b) | (cin & (a^b))."""
    axb = gates.XOR(ck, a, b)
    s = gates.XOR(ck, axb, carry_in)
    c1 = gates.AND(ck, a, b)
    c2 = gates.AND(ck, carry_in, axb)
    carry_out = gates.OR(ck, c1, c2)
    return s, carry_out


def ripple_carry_add(ck: CloudKey, a_bits: Array,
                     b_bits: Array) -> Tuple[Array, Array]:
    """Add two little-endian encrypted bit vectors.

    a_bits, b_bits: (..., nbits, lwe_n+1).  Returns (sum_bits, carry_out).
    5 bootstraps per bit position (the bit chain is sequential; the batch
    axes are where the parallelism comes from).
    """
    nbits = a_bits.shape[-2]
    batch = a_bits.shape[:-2]
    carry = gates.constant(ck.params, False, batch)
    outs = []
    for i in range(nbits):
        s, carry = full_adder(ck, a_bits[..., i, :], b_bits[..., i, :], carry)
        outs.append(s)
    return jnp.stack(outs, axis=-2), carry


# ---------------------------------------------------------------------------
# PBS nibble adder (examples/add_two_numbers/main.go).
# ---------------------------------------------------------------------------

def full_adder_manylut(ck: CloudKey, a: Array, b: Array,
                       carry_in: Array) -> Tuple[Array, Array]:
    """One-bit full adder in ONE bootstrap via multi-LUT extraction
    (engine.bootstrap_many) — vs 5 bootstraps for the boolean-gate form.

    Inputs are bits encrypted as MESSAGES in the modulus-8 space
    (cipher.lwe_encrypt_message(bit, 8, ...)): the linear sum a+b+cin has
    phase (a+b+cin)/16 in [0, 1/4] — entirely inside the first torus
    half, so both output functions (sum = s&1, carry = s>>1) avoid the
    negacyclic antisymmetry constraint that blocks XOR in the +-1/8
    boolean encoding.  One coarse (theta=1) blind rotation; extraction
    index 0 is the sum bit, index 1 the carry, both re-encoded in the
    same modulus-8 space so stages chain.
    """
    from .. import engine

    gen = lut.Generator(ck.params, 8)
    mlut = gen.gen_multi_lut(
        [lambda x: x & 1, lambda x: (x >> 1) & 1], theta=1)
    t = a + b + carry_in
    out = engine.bootstrap_many(ck, t, mlut, k=2, theta=1)
    return out[0], out[1]


def ripple_add_manylut(ck: CloudKey, a_bits: Array,
                       b_bits: Array) -> Tuple[Array, Array]:
    """Ripple-carry addition at ONE bootstrap per bit position (vs 5 for
    :func:`ripple_carry_add`) using the many-LUT full adder.

    a_bits, b_bits: (..., nbits, lwe_n+1), bits encrypted as modulus-8
    messages.  Returns (sum_bits, carry_out) in the same encoding.
    """
    from .. import engine

    gen = lut.Generator(ck.params, 8)
    mlut = gen.gen_multi_lut(
        [lambda x: x & 1, lambda x: (x >> 1) & 1], theta=1)
    nbits = a_bits.shape[-2]
    batch = a_bits.shape[:-2]
    carry = jnp.zeros(batch + (ck.params.lwe_n + 1,), jnp.uint32)
    outs = []
    for i in range(nbits):
        t = a_bits[..., i, :] + b_bits[..., i, :] + carry
        res = engine.bootstrap_many(ck, t, mlut, k=2, theta=1)
        outs.append(res[0])
        carry = res[1]
    return jnp.stack(outs, axis=-2), carry


def make_adder_luts(ck: CloudKey):
    """The three LUTs of the nibble method
    (examples/add_two_numbers/main.go:54-76): low-sum mod 16, carry, high-sum
    mod 16.  Requires message_modulus >= 32 (e.g. the uint5 profile)."""
    gen = lut.Generator(ck.params, 32)
    lut_sum = gen.gen_lut(lambda x: x % 16)
    lut_carry = gen.gen_lut(lambda x: 1 if x >= 16 else 0)
    return lut_sum, lut_carry


def add8_pbs(ck: CloudKey, ct_a_low: Array, ct_a_high: Array,
             ct_b_low: Array, ct_b_high: Array) -> Tuple[Array, Array]:
    """8-bit addition with 3 bootstraps (examples/add_two_numbers/main.go:98-136).

    Nibbles are LWE-message encryptions with modulus 32 (Uint5 encoding).
    Returns (ct_sum_low, ct_sum_high) — message encryptions of the result
    nibbles.  Batched over leading axes.
    """
    lut_sum, lut_carry = make_adder_luts(ck)
    temp_low = ct_a_low + ct_b_low                   # homomorphic add
    sum_low = lut.bootstrap_lut(ck, temp_low, lut_sum)      # PBS 1
    carry = lut.bootstrap_lut(ck, temp_low, lut_carry)      # PBS 2
    temp_high = ct_a_high + ct_b_high + carry
    sum_high = lut.bootstrap_lut(ck, temp_high, lut_sum)    # PBS 3
    return sum_low, sum_high
