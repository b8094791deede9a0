"""Generate bit-exact parity vectors for the reference's deterministic
sub-kernels.

This script is a LITERAL SCALAR TRANSCRIPTION of the Go reference's code
paths (file:line cited per function) into plain Python loops over Python
ints / IEEE-754 doubles — the same semantics Go has.  It deliberately shares
NO code with go_tfhe_jax (no imports from the package, no numpy
vectorization of the core loops), so a systematic misreading would have to
be made twice, in two different programming styles, to go unnoticed.

Why not vectors dumped by `go test` itself: this build environment has no Go
toolchain (checked: no go/gccgo/tinygo binaries), so the reference cannot be
executed here.  The transcription below is the closest achievable
approximation; each function cites the exact reference lines it mirrors so a
reviewer can diff them side by side.

Deterministic inputs come from numpy's PCG64 with fixed seeds — recorded in
the .npz so the test re-derives them identically.

Run:  python tests/vectors/gen_vectors.py   (rewrites parity_vectors.npz)
"""

from __future__ import annotations

import math
import os

import numpy as np

MOD32 = 1 << 32
MASK32 = MOD32 - 1


# ---------------------------------------------------------------------------
# utils/utils.go
# ---------------------------------------------------------------------------

def f64_to_torus(d: float) -> int:
    """utils/utils.go:11-14: Torus(int64(math.Mod(d, 1.0) * 2^32)).

    Go math.Mod(d, 1.0) == C fmod: result has the sign of d; int64()
    truncates toward zero; uint32 conversion wraps mod 2^32.
    """
    t = math.fmod(d, 1.0) * float(MOD32)
    return int(t) & MASK32           # int() truncates toward zero, like int64()


# ---------------------------------------------------------------------------
# poly/decomposer.go
# ---------------------------------------------------------------------------

def decomposition_offset(bgbit: int, l: int) -> int:
    """cloudkey/cloudkey.go:60-71: offset = sum_i (Bg/2) * 2^(32-(i+1)*BGBIT)."""
    bg = 1 << bgbit
    off = 0
    for i in range(l):
        off = (off + (bg // 2) * (1 << (32 - (i + 1) * bgbit))) & MASK32
    return off


def decompose_poly(p_coeffs, bgbit: int, level: int, offset: int):
    """poly/decomposer.go:55-66 (DecomposePolyAssign), scalar loop."""
    mask = (1 << bgbit) - 1
    half_bg = 1 << (bgbit - 1)
    n = len(p_coeffs)
    out = [[0] * n for _ in range(level)]
    for j in range(n):
        tmp = (int(p_coeffs[j]) + offset) & MASK32
        for i in range(level):
            d = ((tmp >> (32 - (i + 1) * bgbit)) & mask) - half_bg
            out[i][j] = d
    return np.asarray(out, np.int32)


# ---------------------------------------------------------------------------
# poly/buffer_methods.go
# ---------------------------------------------------------------------------

def poly_mul_with_xk(a, k: int):
    """poly/buffer_methods.go:133-164 (PolyMulWithXKInPlace), scalar loop.

    Negation of wrapped coefficients is ^Torus(0) - a == (2^32-1) - a.
    """
    n = len(a)
    k = k % (2 * n)
    if k < 0:
        k += 2 * n
    result = [0] * n
    if k == 0:
        return np.asarray([int(x) for x in a], np.uint32)
    if k < n:
        for i in range(n - k):
            result[i + k] = int(a[i])
        for i in range(n - k, n):
            result[i + k - n] = (MASK32 - int(a[i])) & MASK32
    else:
        k -= n
        for i in range(n - k):
            result[i + k] = (MASK32 - int(a[i])) & MASK32
        for i in range(n - k, n):
            result[i + k - n] = int(a[i])
    return np.asarray(result, np.uint32)


# ---------------------------------------------------------------------------
# trlwe/trlwe.go
# ---------------------------------------------------------------------------

def sample_extract_index(a, b, k: int):
    """trlwe/trlwe.go:114-128 (SampleExtractIndex), scalar loop."""
    n = len(a)
    out = [0] * (n + 1)
    for i in range(n):
        if i <= k:
            out[i] = int(a[k - i])
        else:
            out[i] = (MASK32 - int(a[n + k - i])) & MASK32
    out[n] = int(b[k])
    return np.asarray(out, np.uint32)


# ---------------------------------------------------------------------------
# evaluator/evaluator.go mod switch
# ---------------------------------------------------------------------------

def mod_switch_a(x: int, nbit: int) -> int:
    """evaluator/evaluator.go:122: aTilda = int((P[i] + 1<<(31-nBit-1)) >>
    (32-nBit-1)) — the add is uint32 (wraps), the shift is logical."""
    return ((x + (1 << (31 - nbit - 1))) & MASK32) >> (32 - nbit - 1)


def mod_switch_b(x: int, nbit: int, n: int) -> int:
    """evaluator/evaluator.go:116: bTilda = 2n - ((int(B()) + 1<<(31-nBit-1))
    >> (32-nBit-1)) — int() is int64: the add does NOT wrap."""
    return 2 * n - ((x + (1 << (31 - nbit - 1))) >> (32 - nbit - 1))


# ---------------------------------------------------------------------------
# lut/encoder.go + lut/generator.go
# ---------------------------------------------------------------------------

def encode(message: int, message_modulus: int, scale: float) -> int:
    """lut/encoder.go:47-75: message normalized, then F64ToTorus(m*scale)."""
    message = message % message_modulus
    if message < 0:
        message += message_modulus
    return f64_to_torus(float(message) * scale)


def div_round(a: int, b: int) -> int:
    """lut/generator.go:171-173."""
    return (a + b // 2) // b


def gen_lookup_table(f_table, message_modulus: int, lut_size: int,
                     scale: float):
    """lut/generator.go:56-100 (GenLookUpTableAssign), scalar loops.

    f_table: precomputed [f(0), ..., f(m-1)] (plain ints).
    Returns the B polynomial (A is all zero, lut/generator.go:98).
    """
    lut_raw = [0] * lut_size
    for x in range(message_modulus):
        start = div_round(x * lut_size, message_modulus)
        end = div_round((x + 1) * lut_size, message_modulus)
        encoded_y = encode(f_table[x], message_modulus, scale)
        for xx in range(start, end):
            lut_raw[xx] = encoded_y
    offset = div_round(lut_size, 2 * message_modulus)
    rotated = [0] * lut_size
    for i in range(lut_size):
        rotated[i] = lut_raw[(i + offset) % lut_size]
    for i in range(lut_size - offset, lut_size):
        rotated[i] = (-rotated[i]) & MASK32
    return np.asarray(rotated, np.uint32)


def lut_mod_switch(x: int, lut_size: int) -> int:
    """lut/generator.go:159-168: float64 scaling + math.Round (half away
    from zero) + non-negative mod."""
    scaled = float(x) / float(MOD32) * float(lut_size)
    result = int(math.floor(scaled + 0.5)) % lut_size   # math.Round, x >= 0
    if result < 0:
        result += lut_size
    return result


# ---------------------------------------------------------------------------
# cloudkey/cloudkey.go KSK digit plaintexts
# ---------------------------------------------------------------------------

def ksk_plaintext(k: int, s1_bit: int, j: int, basebit: int) -> int:
    """cloudkey/cloudkey.go:106-113: p = float64(k)*float64(s1[i]) /
    2^((j+1)*basebit); the plaintext torus value is F64ToTorus(p)."""
    shift = (j + 1) * basebit
    p = (float(k) * float(s1_bit)) / float(1 << shift)
    return f64_to_torus(p)


# ---------------------------------------------------------------------------
# Profiles used for vectors (numeric values from params/params.go:83-514).
# ---------------------------------------------------------------------------

PROFILES = {
    # name: (lwe_n, n, nbit, bgbit, l, basebit, iks_t)
    "80bit":  (550, 1024, 10, 6, 3, 2, 7),
    "110bit": (630, 1024, 10, 6, 3, 2, 8),
    "128bit": (700, 1024, 10, 6, 3, 2, 9),
    "uint5":  (1071, 2048, 11, 22, 1, 6, 3),
}


def main() -> None:
    out = {}
    rng = np.random.default_rng(20260819)

    # --- torus conversions (utils/utils_test.go:10-46 exact values) --------
    f64_in = np.asarray([0.0, 0.125, -0.125, 0.25, 0.5, 0.875, 1.0, -1.0,
                         1.125, -0.0625, 0.3333333333333333,
                         0.9999999999999999, 1e-12, -1e-12], np.float64)
    out["f64_in"] = f64_in
    out["f64_torus"] = np.asarray([f64_to_torus(float(d)) for d in f64_in],
                                  np.uint32)

    for name, (lwe_n, n, nbit, bgbit, l, basebit, iks_t) in PROFILES.items():
        off = decomposition_offset(bgbit, l)
        out[f"{name}/offset"] = np.uint32(off)

        # decomposition on random torus polys
        x = rng.integers(0, MOD32, size=n, dtype=np.uint64).astype(np.uint32)
        out[f"{name}/dec_in"] = x
        out[f"{name}/dec_out"] = decompose_poly(x, bgbit, l, off)

        # rotation: k sweep incl. boundaries
        a = rng.integers(0, MOD32, size=n, dtype=np.uint64).astype(np.uint32)
        ks = [0, 1, 2, n - 1, n, n + 1, 2 * n - 1, 7, 513]
        out[f"{name}/rot_in"] = a
        out[f"{name}/rot_ks"] = np.asarray(ks, np.int64)
        out[f"{name}/rot_out"] = np.stack(
            [poly_mul_with_xk(a, k) for k in ks])

        # sample extraction at several indices
        ta = rng.integers(0, MOD32, size=n, dtype=np.uint64).astype(np.uint32)
        tb = rng.integers(0, MOD32, size=n, dtype=np.uint64).astype(np.uint32)
        idxs = [0, 1, n // 2, n - 1]
        out[f"{name}/se_a"] = ta
        out[f"{name}/se_b"] = tb
        out[f"{name}/se_ks"] = np.asarray(idxs, np.int64)
        out[f"{name}/se_out"] = np.stack(
            [sample_extract_index(ta, tb, k) for k in idxs])

        # blind-rotate mod switch (a path wraps uint32, b path does not)
        xs = np.concatenate([
            np.asarray([0, 1, MOD32 - 1, MOD32 // 2, MOD32 // 2 - 1,
                        (1 << (31 - nbit - 1)) - 1, 1 << (31 - nbit - 1)],
                       np.uint64),
            rng.integers(0, MOD32, size=64, dtype=np.uint64),
        ]).astype(np.uint32)
        out[f"{name}/ms_in"] = xs
        out[f"{name}/ms_a"] = np.asarray(
            [mod_switch_a(int(v), nbit) for v in xs], np.int64)
        out[f"{name}/ms_b"] = np.asarray(
            [mod_switch_b(int(v), nbit, n) for v in xs], np.int64)

        # KSK digit plaintexts: all (j, k) cells for s1 in {0, 1}
        base = 1 << basebit
        tbl = np.zeros((2, iks_t, base), np.uint32)
        for s1 in (0, 1):
            for j in range(iks_t):
                for k in range(base):
                    tbl[s1, j, k] = ksk_plaintext(k, s1, j, basebit)
        out[f"{name}/ksk_plain"] = tbl

    # --- LUT tables (N and m combos used by the reference tests) ----------
    lut_cases = []
    for (n, m) in [(1024, 2), (1024, 4), (1024, 8), (2048, 32), (2048, 16)]:
        scale = 1.0 / (2 * m)
        fns = {
            "identity": list(range(m)),
            "complement": [m - 1 - x for x in range(m)],
            "increment": [(x + 1) % m for x in range(m)],
            "constant1": [1] * m,
        }
        for fname, table in fns.items():
            key = f"lut/{n}/{m}/{fname}"
            out[key] = gen_lookup_table(table, m, n, scale)
            lut_cases.append(key)
    out["lut_cases"] = np.asarray(lut_cases)

    # --- LUT mod switch sweep ----------------------------------------------
    xs = np.concatenate([
        np.asarray([0, 1, MOD32 - 1, MOD32 // 2, 1 << 21, (1 << 21) - 1],
                   np.uint64),
        rng.integers(0, MOD32, size=64, dtype=np.uint64),
    ]).astype(np.uint32)
    for size in (1024, 2048):
        out[f"lutms/{size}/in"] = xs
        out[f"lutms/{size}/out"] = np.asarray(
            [lut_mod_switch(int(v), size) for v in xs], np.int64)

    # --- encoder encodings for every message modulus -----------------------
    for m in (2, 4, 8, 16, 32, 64, 128, 256):
        out[f"enc/{m}"] = np.asarray(
            [encode(x, m, 1.0 / (2 * m)) for x in range(m)], np.uint32)

    # --- gate bias constants (evaluator/gates_helper.go, gates/gates.go) ---
    out["bias/eighth"] = np.uint32(f64_to_torus(0.125))
    out["bias/neg_eighth"] = np.uint32(f64_to_torus(-0.125))
    out["bias/quarter"] = np.uint32(f64_to_torus(0.25))

    path = os.path.join(os.path.dirname(__file__), "parity_vectors.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({len(out)} arrays)")


if __name__ == "__main__":
    main()
