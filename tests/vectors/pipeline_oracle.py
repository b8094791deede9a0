"""Scalar transcription of the reference's COMPLETE bootstrap pipeline.

Bit-exact parity of the sub-kernels alone leaves one seam; this module
closes it — a systematic COMPOSITION
error (rotation order, CMUX formula, key-switch indexing, ...) — by
transcribing the full composed pipeline

    BlindRotateAssign -> SampleExtractIndexAssign -> IdentityKeySwitchingAssign
    (evaluator/evaluator.go:110-148)

into plain Python loops over Python ints, sharing NO code with
go_tfhe_jax.  Key material (raw BSK/KSK/testvec arrays) is plain DATA fed
in from outside; the algorithm here is derived only from the cited Go
lines.  tests/test_parity_pipeline.py runs this oracle against the JAX
engine on the same keys and asserts bit-exact equality of the blind-rotate
accumulator, the extracted level-1 ciphertext, and the final key-switched
ciphertext.

One semantic note: the reference's external product runs through a float64
FFT (trgsw/trgsw.go:108-134) whose *intended* value is the exact negacyclic
integer convolution mod 2^32 (digit magnitudes <= half_bg keep products
within float64's exact range; floatModQInPlace rounds back to the lattice,
poly/fourier_transform.go:87-104).  This oracle computes that exact value
with schoolbook integer arithmetic — the same semantics the engine's int8
limb contraction (and its int32 Toeplitz reference) implement exactly.
"""

from __future__ import annotations

MOD32 = 1 << 32
MASK32 = MOD32 - 1


# ---------------------------------------------------------------------------
# poly/ sub-kernels (scalar; same transcriptions as gen_vectors.py).
# ---------------------------------------------------------------------------

def _decompose_poly(coeffs, bgbit: int, l: int, offset: int):
    """poly/decomposer.go:55-66: signed base-2^BGBIT digits of each coeff."""
    mask = (1 << bgbit) - 1
    half_bg = 1 << (bgbit - 1)
    out = []
    for i in range(l):
        shift = 32 - (i + 1) * bgbit
        row = []
        for c in coeffs:
            tmp = (c + offset) & MASK32
            row.append(((tmp >> shift) & mask) - half_bg)
        out.append(row)
    return out


def _poly_mul_with_xk(a, k: int):
    """poly/buffer_methods.go:133-164: negacyclic monomial multiply X^k;
    wrapped coefficients negate as ^Torus(0) - a == (2^32-1) - a."""
    n = len(a)
    k = k % (2 * n)
    if k == 0:
        return list(a)
    out = [0] * n
    if k < n:
        for i in range(n - k):
            out[i + k] = a[i]
        for i in range(n - k, n):
            out[i + k - n] = (MASK32 - a[i]) & MASK32
    else:
        k -= n
        for i in range(n - k):
            out[i + k] = (MASK32 - a[i]) & MASK32
        for i in range(n - k, n):
            out[i + k - n] = a[i]
    return out


def _negacyclic_mul_add(acc, digits, poly):
    """acc += digits * poly in Z[X]/(X^N+1) mod 2^32, schoolbook.

    The exact-integer semantics of the reference's FFT pointwise
    accumulate (poly/fourier_ops.go:167-191 + fourier_transform.go:87-104).
    ``digits`` are small signed ints; ``poly`` uint32 torus words.
    """
    n = len(poly)
    for i in range(n):
        d = digits[i]
        if d == 0:
            continue
        for j in range(n):
            k = i + j
            prod = d * poly[j]
            if k < n:
                acc[k] = (acc[k] + prod) & MASK32
            else:
                acc[k - n] = (acc[k - n] - prod) & MASK32
    return acc


# ---------------------------------------------------------------------------
# The composed pipeline.
# ---------------------------------------------------------------------------

def external_product(trgsw_rows, trlwe_a, trlwe_b, bgbit: int, l: int,
                     offset: int):
    """evaluator/evaluator.go:50-81 (ExternalProductAssign).

    trgsw_rows: 2L rows, each a pair (A poly, B poly) of uint32 lists —
    rows 0..L-1 multiply the A digits, rows L..2L-1 the B digits.
    Returns (A, B) uint32 lists.
    """
    n = len(trlwe_a)
    dec = (_decompose_poly(trlwe_a, bgbit, l, offset)
           + _decompose_poly(trlwe_b, bgbit, l, offset))
    out_a = [0] * n
    out_b = [0] * n
    for i in range(2 * l):
        row_a, row_b = trgsw_rows[i]
        _negacyclic_mul_add(out_a, dec[i], row_a)
        _negacyclic_mul_add(out_b, dec[i], row_b)
    return out_a, out_b


def cmux(trgsw_rows, ct0, ct1, bgbit: int, l: int, offset: int):
    """evaluator/evaluator.go:85-106: ct0 + C * (ct1 - ct0)."""
    n = len(ct0[0])
    diff_a = [(ct1[0][i] - ct0[0][i]) & MASK32 for i in range(n)]
    diff_b = [(ct1[1][i] - ct0[1][i]) & MASK32 for i in range(n)]
    ep_a, ep_b = external_product(trgsw_rows, diff_a, diff_b, bgbit, l,
                                  offset)
    return ([(ct0[0][i] + ep_a[i]) & MASK32 for i in range(n)],
            [(ct0[1][i] + ep_b[i]) & MASK32 for i in range(n)])


def blind_rotate(ct, testvec, bsk, n: int, nbit: int, lwe_n: int,
                 bgbit: int, l: int, offset: int):
    """evaluator/evaluator.go:110-135 (BlindRotateAssign).

    ct: list of lwe_n+1 uint32 (last = b).  testvec: (A, B) uint32 lists.
    bsk: per LWE bit, 2L rows of (A, B) uint32 lists.
    Returns the final accumulator (A, B).
    """
    # bTilda: int() is int64 — the offset add does NOT wrap (evaluator.go:116)
    b_tilda = 2 * n - ((ct[lwe_n] + (1 << (31 - nbit - 1)))
                       >> (32 - nbit - 1))
    acc = (_poly_mul_with_xk(testvec[0], b_tilda),
           _poly_mul_with_xk(testvec[1], b_tilda))
    for i in range(lwe_n):
        # aTilda: the add is uint32 and wraps (evaluator.go:122)
        a_tilda = (((ct[i] + (1 << (31 - nbit - 1))) & MASK32)
                   >> (32 - nbit - 1))
        rotated = (_poly_mul_with_xk(acc[0], a_tilda),
                   _poly_mul_with_xk(acc[1], a_tilda))
        acc = cmux(bsk[i], acc, rotated, bgbit, l, offset)
    return acc


def sample_extract_index(acc, k: int):
    """trlwe/trlwe.go:114-128: TRLWE -> TLWE Lv1 at index k."""
    a, b = acc
    n = len(a)
    out = [0] * (n + 1)
    for i in range(n):
        if i <= k:
            out[i] = a[k - i]
        else:
            out[i] = (MASK32 - a[n + k - i]) & MASK32
    out[n] = b[k]
    return out


def identity_key_switch(lv1, ksk, n: int, basebit: int, iks_t: int,
                        lwe_n: int):
    """trgsw/keyswitch.go:10-37 (IdentityKeySwitchingAssign).

    lv1: n+1 uint32.  ksk indexed [i][j][k] -> lwe_n+1 uint32 list
    (the reference flattens to base*iks_t*i + base*j + k and skips k==0).
    """
    base = 1 << basebit
    out = [0] * (lwe_n + 1)
    out[lwe_n] = lv1[n]
    prec_offset = 1 << (32 - (1 + basebit * iks_t))
    for i in range(n):
        a_bar = (lv1[i] + prec_offset) & MASK32
        for j in range(iks_t):
            k = (a_bar >> (32 - (j + 1) * basebit)) & (base - 1)
            if k != 0:
                row = ksk[i][j][k]
                for x in range(lwe_n + 1):
                    out[x] = (out[x] - row[x]) & MASK32
    return out


def bootstrap(ct, testvec, bsk, ksk, *, n: int, nbit: int, lwe_n: int,
              bgbit: int, l: int, basebit: int, iks_t: int, offset: int):
    """evaluator/evaluator.go:139-148 (BootstrapAssign): the full pipeline.

    Returns (accumulator, extracted lv1, key-switched lv0) so the test can
    compare every composition stage bit-exactly.
    """
    acc = blind_rotate(ct, testvec, bsk, n, nbit, lwe_n, bgbit, l, offset)
    lv1 = sample_extract_index(acc, 0)
    lv0 = identity_key_switch(lv1, ksk, n, basebit, iks_t, lwe_n)
    return acc, lv1, lv0
