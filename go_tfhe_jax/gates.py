"""Boolean gate API — batched natively.

Reference: gates/gates.go.  Every gate here accepts ciphertexts with arbitrary
leading batch axes, so the reference's ``Batch*`` functions
(gates/gates.go:151-312) are just these same functions called on batches; no
separate API is needed.  Gate = affine preparation + bootstrap
(gates/gates.go:26-114).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import engine
from .keys import CloudKey
from .params import TFHEParams
from .utils.torus import TORUS, f64_to_torus

Array = jax.Array


def NAND(ck: CloudKey, a: Array, b: Array) -> Array:
    return engine.bootstrap(ck, engine.prepare_nand(a, b))


def AND(ck: CloudKey, a: Array, b: Array) -> Array:
    return engine.bootstrap(ck, engine.prepare_and(a, b))


def OR(ck: CloudKey, a: Array, b: Array) -> Array:
    return engine.bootstrap(ck, engine.prepare_or(a, b))


def XOR(ck: CloudKey, a: Array, b: Array) -> Array:
    return engine.bootstrap(ck, engine.prepare_xor(a, b))


def XNOR(ck: CloudKey, a: Array, b: Array) -> Array:
    return engine.bootstrap(ck, engine.prepare_xnor(a, b))


def NOR(ck: CloudKey, a: Array, b: Array) -> Array:
    return engine.bootstrap(ck, engine.prepare_nor(a, b))


def ANDNY(ck: CloudKey, a: Array, b: Array) -> Array:
    """NOT(a) AND b."""
    return engine.bootstrap(ck, engine.prepare_andny(a, b))


def ANDYN(ck: CloudKey, a: Array, b: Array) -> Array:
    """a AND NOT(b)."""
    return engine.bootstrap(ck, engine.prepare_andyn(a, b))


def ORNY(ck: CloudKey, a: Array, b: Array) -> Array:
    """NOT(a) OR b."""
    return engine.bootstrap(ck, engine.prepare_orny(a, b))


def ORYN(ck: CloudKey, a: Array, b: Array) -> Array:
    """a OR NOT(b)."""
    return engine.bootstrap(ck, engine.prepare_oryn(a, b))


def AND_OR(ck: CloudKey, a: Array, b: Array) -> tuple[Array, Array]:
    """(a AND b, a OR b) from ONE bootstrap via multi-LUT extraction
    (engine.bootstrap_many) — no reference equivalent.

    Both gates are sign-threshold functions of the SAME linear phase
    t = a + b in {-1/4, 0, +1/4} (thresholds +-1/8), so unlike XOR they
    satisfy the negacyclic antisymmetry the shared rotation requires.  On
    the modulus-8 message grid t lands exactly on message centers 0 / 4 /
    "virtual 12" (whose readout is the negated message-4 entry — which is
    exactly the False encoding both functions need there).  Outputs are
    standard +-1/8 booleans, so results compose with every other gate.
    Noise: theta=1 coarse mod switch (engine.bootstrap_many; measure the
    margin with tools/noise_many.py).
    """
    from . import lut as _lut

    gen = _lut.Generator(ck.params, 8)
    out_enc = _lut.Encoder(8, 1.0 / 8)        # 1 -> +1/8, 7 -> -1/8
    mlut = gen.gen_multi_lut(
        [lambda x: 1 if x == 4 else 7,         # AND: only t = +1/4
         lambda x: 1 if x in (0, 4) else 7],   # OR: t = 0 or +1/4
        theta=1, encoders=[out_enc, out_enc])
    out = engine.bootstrap_many(ck, a + b, mlut, k=2, theta=1)
    return out[0], out[1]


def NOT(a: Array) -> Array:
    """Negation — no bootstrap needed (gates/gates.go:117-119)."""
    return jnp.zeros_like(a) - a


def COPY(a: Array) -> Array:
    """gates/gates.go:122-126."""
    return jnp.array(a)


def MUX(ck: CloudKey, sel: Array, then_ct: Array, else_ct: Array) -> Array:
    """sel ? then : else in TWO bootstraps (the original TFHE gate-
    bootstrapping MUX; the reference composes 3 full gates instead,
    gates/gates.go:107-114, despite shipping the needed
    bootstrapWithoutKeySwitch helper, gates.go:145-149).

    The branches u1 = sel AND then, u2 = NOT(sel) AND else are DISJOINT
    (never both true), so their OR is exact linear algebra: u1 + u2 + 1/8
    maps {one true: 0, none: -1/4} to +-1/8.  Both branch bootstraps skip
    the key switch; the sum gets ONE key switch at the end — 2 bootstraps
    + 1 key switch vs 3 + 3.  Output noise is sqrt(2) x a single
    bootstrap's (two fresh outputs summed) — far inside the 2^29 margin
    at every shipped profile (NOISE_r05: sigma_b ~ 2^23.9 at
    128bit_fast)."""
    from .ops.keyswitch import identity_key_switch

    u1 = engine.bootstrap_without_key_switch(
        ck, engine.prepare_and(sel, then_ct))
    u2 = engine.bootstrap_without_key_switch(
        ck, engine.prepare_andny(sel, else_ct))
    summed = (u1 + u2).at[..., -1].add(jnp.uint32(f64_to_torus(0.125)))
    return identity_key_switch(ck.params, ck.ksk, summed)


def MUX_3GATE(ck: CloudKey, sel: Array, then_ct: Array,
              else_ct: Array) -> Array:
    """The reference's 3-gate MUX composition (gates/gates.go:107-114),
    kept for parity comparison."""
    and_ab = AND(ck, sel, then_ct)
    and_nac = AND(ck, NOT(sel), else_ct)
    return OR(ck, and_ab, and_nac)


def constant(p: TFHEParams, value, batch_shape=()) -> Array:
    """Trivial (noiseless) ciphertext of a constant boolean
    (gates/gates.go:61-69: mu = T(1/8) if true else 1 - T(1/8))."""
    t = int(f64_to_torus(0.125))
    f = (1 - t) % (1 << 32)
    value = jnp.broadcast_to(jnp.asarray(value, bool), batch_shape)
    mu = jnp.where(value, jnp.uint32(t), jnp.uint32(f))
    ct = jnp.zeros(value.shape + (p.lwe_n + 1,), TORUS)
    return ct.at[..., p.lwe_n].set(mu)
