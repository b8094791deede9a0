"""Look-up tables and programmable bootstrapping (PBS).

Reference: lut/encoder.go, lut/generator.go, lut/lut.go,
evaluator/programmable_bootstrap.go.

A LookUpTable is a *trivial* TRLWE ciphertext (A = 0) whose B polynomial
encodes the function (lut/lut.go:14-17, lut/generator.go:94-99).  LUT
generation is host-side precompute (numpy, float64-exact like the Go code);
the PBS itself is the same jitted blind-rotate engine with the LUT as the
test vector (evaluator/programmable_bootstrap.go:93-115).

Because the engine is batched, a *batch of different LUTs* can be applied to
a batch of ciphertexts in one call (testvec shape (..., 2, N)) — a capability
the reference's scalar loop cannot express.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import engine
from .keys import CloudKey
from .params import TFHEParams
from .utils.torus import f64_to_torus, torus_to_f64

Array = jax.Array


def _div_round(a: int, b: int) -> int:
    """lut/generator.go:171-173."""
    return (a + b // 2) // b


class Encoder:
    """Message-space encoder (lut/encoder.go:9-37): scale = 1/(2m)."""

    def __init__(self, message_modulus: int, scale: float | None = None):
        self.message_modulus = message_modulus
        self.scale = (1.0 / (2 * message_modulus)) if scale is None else scale

    def encode(self, message: int) -> np.uint32:
        """message -> T(message * scale)  (lut/encoder.go:47-75)."""
        message = message % self.message_modulus
        return f64_to_torus(float(message) * self.scale)

    def encode_with_custom_scale(self, message: int, scale: float) -> np.uint32:
        message = message % self.message_modulus
        return f64_to_torus(float(message) * scale)

    def decode(self, value) -> int:
        """lut/encoder.go:88-102: round(f/scale) to nearest message."""
        f = float(torus_to_f64(np.uint32(value)))
        return int(f / self.scale + 0.5) % self.message_modulus

    def decode_bool(self, value) -> bool:
        return self.decode(value) != 0


class Generator:
    """LUT generator (lut/generator.go:10-28).

    Unlike the reference — where LookUpTableSize == PolyDegree always and
    the extended LUTs promised for Uint6-8 are unimplemented
    (lut/generator.go:19-21, params/UINT_STATUS.md:20-31) — this generator
    builds real extended tables when ``poly_extend_factor > 1``: the
    size-kN table is interleaved into k trivial TRLWE blocks consumed by
    :func:`go_tfhe_jax.ops.blindrotate.blind_rotate_extended`.
    """

    def __init__(self, p: TFHEParams, message_modulus: int | None = None,
                 scale: float | None = None):
        m = p.message_modulus if message_modulus is None else message_modulus
        self.params = p
        self.encoder = Encoder(m, scale)
        self.poly_degree = p.n
        self.extend_factor = p.poly_extend_factor
        self.lut_size = p.lut_size

    # -- core table construction (lut/generator.go:56-100) ------------------

    def _build(self, values_torus: np.ndarray) -> Array:
        """values_torus: per-message torus encodings, shape (m,)."""
        m = len(values_torus)
        size = self.lut_size
        raw = np.zeros((size,), np.uint32)
        for x in range(m):
            start = _div_round(x * size, m)
            end = _div_round((x + 1) * size, m)
            raw[start:end] = values_torus[x]
        offset = _div_round(size, 2 * m)
        rotated = np.roll(raw, -offset)          # rotated[i] = raw[i+offset]
        rotated[size - offset:] = (-rotated[size - offset:].astype(np.int64)
                                   ).astype(np.uint32)
        k = self.extend_factor
        if k == 1:
            lut = np.zeros((2, size), np.uint32)
            lut[1] = rotated
        else:
            # Interleave big[j] -> block[j % k][j // k] (monomial_mul_blocks
            # layout): blocks = (k, N).
            lut = np.zeros((k, 2, self.poly_degree), np.uint32)
            lut[:, 1, :] = rotated.reshape(self.poly_degree, k).T
        return jnp.asarray(lut)

    def gen_lut(self, f: Callable[[int], int]) -> Array:
        """f: message -> message; returns a trivial TRLWE (2, N) uint32."""
        vals = np.asarray([self.encoder.encode(f(x))
                           for x in range(self.encoder.message_modulus)],
                          np.uint32)
        return self._build(vals)

    def gen_lut_full(self, f: Callable[[int], int]) -> Array:
        """f: message -> raw torus value (lut/generator.go:102-141)."""
        vals = np.asarray([np.uint32(f(x))
                           for x in range(self.encoder.message_modulus)],
                          np.uint32)
        return self._build(vals)

    def gen_lut_custom(self, f: Callable[[int], int], message_modulus: int,
                       scale: float) -> Array:
        """lut/generator.go:143-155.

        Uses a throwaway local Encoder — ``self.encoder`` is never touched,
        so a shared Generator stays reentrant."""
        enc = Encoder(message_modulus, scale)
        vals = np.asarray([enc.encode(f(x)) for x in range(message_modulus)],
                          np.uint32)
        return self._build(vals)

    def gen_multi_lut(self, fns, theta: int,
                      encoders=None) -> Array:
        """Interleaved multi-function table for PBSmanyLUT
        (engine.bootstrap_many): ONE coarse blind rotation evaluates up to
        2^theta functions, read out by sample extraction at indices
        0..len(fns)-1.

        The blind rotation with a 2^theta-coarse mod switch
        (ops.blindrotate.mod_switch_2n) always lands on a 2^theta-aligned
        position r; accumulator coefficient t then reads position r + t of
        the test vector.  Interleaving the k single-function tables by
        residue — table[s*2^theta + t] = table_t[s*2^theta] — makes
        extraction index t return f_t of the COMMON input phase.  Each
        f_t's geometry (region fill, half-segment rotation, negacyclic
        tail) is inherited from its own complete single-LUT table, so the
        anti-periodicity the extraction sign-flip relies on is preserved
        position-wise.

        Beyond-reference capability (the reference has no many-LUT); the
        mechanism requires the single-LUT half-segment rotation offset to
        be 2^theta-aligned (asserted) and costs 2^theta x the mod-switch
        rounding noise.  ``encoders``: optional per-function Encoder list
        (e.g. different output scales); defaults to ``self.encoder``.

        fns: k <= 2^theta functions message -> message.
        Returns a (2, N) trivial TRLWE test vector.
        """
        k = len(fns)
        assert 1 <= k <= (1 << theta), (k, theta)
        assert self.extend_factor == 1, \
            "many-LUT is not supported on extended (k*N) profiles"
        n = self.poly_degree
        m = self.encoder.message_modulus
        offset = _div_round(n, 2 * m)
        assert offset % (1 << theta) == 0, (
            f"half-segment rotation {offset} not 2^{theta}-aligned; "
            f"need (N/(2m)) % 2^theta == 0")
        encs = [self.encoder] * k if encoders is None else list(encoders)
        assert len(encs) == k
        tables = []
        for f, enc in zip(fns, encs):
            vals = np.asarray([enc.encode(f(x)) for x in range(m)],
                              np.uint32)
            tables.append(np.asarray(self._build(vals))[1])    # B row (n,)
        idx = np.arange(n)
        base = (idx >> theta) << theta
        res = idx & ((1 << theta) - 1)
        raw = np.zeros((n,), np.uint32)
        for t in range(1 << theta):
            src = tables[min(t, k - 1)]
            sel = res == t
            raw[sel] = src[base[sel]]
        lut = np.zeros((2, n), np.uint32)
        lut[1] = raw
        return jnp.asarray(lut)

    def mod_switch(self, x) -> int:
        """Torus -> [0, lut_size) with rounding (lut/generator.go:157-168).

        Go's math.Round rounds half AWAY from zero (x >= 0 here, so
        floor(x+0.5)) — Python's round() would banker's-round exact halves
        the other way and break bit parity.
        """
        import math
        scaled = float(np.uint32(x)) / float(1 << 32) * self.lut_size
        return int(math.floor(scaled + 0.5)) % self.lut_size


# ---------------------------------------------------------------------------
# Programmable bootstrapping.
# ---------------------------------------------------------------------------

def bootstrap_lut(ck: CloudKey, ct: Array, lut: Array) -> Array:
    """PBS with a precomputed LUT (evaluator/programmable_bootstrap.go:50-115).

    lut: (2, N) shared, or (..., 2, N) per-ciphertext.
    """
    return engine.bootstrap(ck, ct, testvec=lut)


def bootstrap_func(ck: CloudKey, ct: Array, f: Callable[[int], int],
                   message_modulus: int) -> Array:
    """PBS evaluating f on the message space
    (evaluator/programmable_bootstrap.go:16-30)."""
    gen = Generator(ck.params, message_modulus)
    return bootstrap_lut(ck, ct, gen.gen_lut(f))
