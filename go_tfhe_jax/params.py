"""TFHE security parameters — frozen, hashable parameter objects.

The Go reference (``/root/reference/params/params.go``) exposes a single mutable
global ``CurrentSecurityLevel`` consulted via switch statements on every call
(``params/params.go:517-626``).  That pattern is hostile to JAX: jitted code
must know every shape statically.  Here each profile is an immutable, hashable
:class:`TFHEParams` dataclass that is threaded explicitly through every
function and used as a ``static_argnum`` under ``jax.jit``.

Numeric values replicate the reference bit-for-bit:

* 80-bit      — ``params/params.go:83-112``
* 110-bit     — ``params/params.go:117-146``
* 128-bit     — ``params/params.go:151-180``
* Uint1–Uint8 — ``params/params.go:194-514``

Derived quantities (decomposition offset, gadget powers) mirror
``cloudkey/cloudkey.go:60-71`` and ``trgsw/trgsw.go:38-42``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

MOD32 = 1 << 32


@dataclasses.dataclass(frozen=True)
class TFHEParams:
    """One complete TFHE parameter profile (immutable, hashable).

    Field map to the reference structs (``params/params.go:50-78``):

    ==============  ==========================================
    here            reference
    ==============  ==========================================
    lwe_n           TLWELv0Params.N
    lwe_alpha       TLWELv0Params.ALPHA
    n               TLWELv1Params.N == TRLWELv1Params.N == TRGSWLv1Params.N
    lv1_alpha       TLWELv1Params.ALPHA (== TRGSW ALPHA)
    nbit            TRGSWLv1Params.NBIT
    bgbit           TRGSWLv1Params.BGBIT
    l               TRGSWLv1Params.L
    basebit         TRGSWLv1Params.BASEBIT
    iks_t           TRGSWLv1Params.IKS_T
    block_size      TRGSWLv1Params.BlockSize
    ==============  ==========================================
    """

    name: str
    # TLWE level 0
    lwe_n: int
    lwe_alpha: float
    # TLWE level 1 / TRLWE / TRGSW polynomial degree
    n: int
    lv1_alpha: float
    nbit: int
    # gadget decomposition
    bgbit: int
    l: int
    # identity key switching
    basebit: int
    iks_t: int
    # block blind rotation (config only in the reference; see SURVEY.md #13)
    block_size: int
    # message space for Uint profiles (2 for plain boolean levels)
    message_modulus: int = 2
    # LUT size = poly_extend_factor * n (reference: params/UINT_STATUS.md;
    # extended LUTs are advertised for Uint6-8 but unimplemented upstream)
    poly_extend_factor: int = 1
    # Kernel-limb truncation for the int8 external product
    # (ops/polymul.py): drop this many of the 4 bootstrapping-key
    # base-256 limbs, cutting matmul columns proportionally.  Requires
    # ``key_grid_bits >= 8*kernel_limb_drop`` (enforced in __post_init__),
    # which makes the dropped limbs IDENTICALLY ZERO — the truncation is
    # bit-exact, not approximate.  (Round 2 shipped a lossy drop; its error
    # lands on the accumulator's A polynomial, which the phase multiplies
    # by the ring key — a sqrt(N/2) ~ 23x amplification that put the
    # headline profile 4 sigma from the decision margin.  Measured-unsound;
    # removed.)
    kernel_limb_drop: int = 0
    # Generate all level-1 ring material (BSK rows) on the 2^key_grid_bits
    # torus subgrid — i.e. run the TRLWE world at ciphertext modulus
    # q = 2^(32-key_grid_bits), scaled into the top bits of uint32.  This
    # is standard LWE modulus switching *applied at keygen*: the mask A is
    # sampled uniformly ON the grid and B computed exactly on-grid (binary
    # s keeps A*s on-grid), so no post-hoc rounding of A ever happens (that
    # WOULD add a ring-key-amplified q_A*s phase error).  Security is
    # preserved: the scaled instance is RLWE mod 2^24 with the same
    # noise-to-modulus ratio (alpha*2^32/2^8 over 2^24) — quantified in
    # SECURITY.md (primal uSVP, tools/security_estimate.py): beta 336 vs
    # the base profile's 329, i.e. ~+2 classical bits from the extra
    # grid-rounding noise, and no algebraic shortcut (~37% of coefficients
    # keep nonzero rounded noise).  The only cost is
    # rounding the B-side noise to the grid: sigma grows from alpha*2^32
    # (~86 at 128-bit) to sqrt((alpha*2^32)^2 + (2^8)^2/12) ~ 113,
    # raising the bootstrap's BSK-noise term to ~2^23.7 — below the
    # mod-switch floor (~2^24.2).  Why: the int8 matmul contracts K in
    # base-256 limbs; a 24-bit K needs 3 limbs instead of 4 — 25% fewer
    # MACs with ZERO truncation error (see kernel_limb_drop).
    key_grid_bits: int = 0
    # Use a round-to-nearest (centered) gadget decomposition instead of the
    # reference's floor form.  The reference offset
    # (cloudkey/cloudkey.go:60-71) floors to the 2^(32-L*BGBIT) tail grid:
    # representation error in (-grid, 0], DETERMINISTIC mean -grid/2.
    # That bias costs real noise: the A-channel bias convolves with the
    # ring key's coefficient random walk (values up to ~N/2), giving a
    # per-step phase term of std ~(grid/2)*(N/(2*sqrt(3))) that
    # sqrt-accumulates over ~n/2 active steps — measured 2^27.4 at the
    # bgbit=8/l=2 gadget (tools/_exp_gadget2.py), the dominant error by
    # far.  Centering the offset by -grid/2 makes the error zero-mean
    # (-grid/2, grid/2], killing the bias walk; the remaining fluctuation
    # term is sqrt(N/2)-amplified but sqrt-accumulates to ~2^22.9.
    # Centered decomposition changes ciphertext bits (not just noise), so
    # the reference-parity profiles keep floor semantics.
    centered_decomposition: bool = False

    # ---- derived quantities -------------------------------------------------

    @property
    def bg(self) -> int:
        """Gadget base  Bg = 2^BGBIT  (params/params.go:72)."""
        return 1 << self.bgbit

    @property
    def half_bg(self) -> int:
        return 1 << (self.bgbit - 1)

    @property
    def base(self) -> int:
        """Key-switching base  2^BASEBIT  (trgsw/trgsw.go:288)."""
        return 1 << self.basebit

    @property
    def ksk_alpha(self) -> float:
        """params/params.go:629-631."""
        return self.lwe_alpha

    @property
    def bsk_alpha(self) -> float:
        """params/params.go:634-636."""
        return self.lv1_alpha

    @property
    def tail_bits(self) -> int:
        """Bits below the gadget's reach: 32 - L*BGBIT (the decomposition
        grid is 2^tail_bits)."""
        return 32 - self.l * self.bgbit

    @property
    def decomposition_offset(self) -> int:
        """Offset added before digit extraction.

        offset = sum_i (Bg/2) * 2^(32-(i+1)*BGBIT)  mod 2^32
        (cloudkey/cloudkey.go:60-71) — a FLOOR to the 2^tail_bits grid:
        representation error -((x+offset) mod grid) in (-grid, 0].
        With ``centered_decomposition`` the offset shifts by +grid/2,
        making the error (-grid/2, grid/2] — round-to-nearest (numerically
        verified in tests/test_ops.py::test_centered_decomposition_error).
        """
        off = 0
        for i in range(self.l):
            off += (self.bg // 2) * (1 << (32 - (i + 1) * self.bgbit))
        if self.centered_decomposition and self.tail_bits > 0:
            off += 1 << (self.tail_bits - 1)
        return off % MOD32

    @property
    def gadget_powers(self) -> Tuple[int, ...]:
        """Torus encodings of 1/Bg^(i+1), i.e. 2^(32-(i+1)*BGBIT).

        Matches utils.F64ToTorus(1/Bg^(i+1)) exactly (trgsw/trgsw.go:38-42)
        because the values are dyadic.
        """
        return tuple((1 << (32 - (i + 1) * self.bgbit)) % MOD32
                     for i in range(self.l))

    @property
    def ks_prec_offset(self) -> int:
        """Rounding offset for key switching: 2^(32-(1+basebit*iks_t))
        (trgsw/keyswitch.go:23)."""
        return 1 << (32 - (1 + self.basebit * self.iks_t))

    @property
    def mod_switch_offset(self) -> int:
        """Rounding offset for the 2N mod switch: 2^(31-NBIT-1)
        (evaluator/evaluator.go:116)."""
        return 1 << (31 - self.nbit - 1)

    @property
    def mod_switch_shift(self) -> int:
        """Right shift for the 2N mod switch: 32-NBIT-1
        (evaluator/evaluator.go:116)."""
        return 32 - self.nbit - 1

    @property
    def lut_size(self) -> int:
        """LookUpTableSize (lut/generator.go:19-21): poly_extend_factor * N."""
        return self.poly_extend_factor * self.n

    @property
    def block_count(self) -> int:
        """params/params.go:669-676."""
        if self.block_size <= 1:
            return self.lwe_n
        return (self.lwe_n + self.block_size - 1) // self.block_size

    @property
    def use_block_blind_rotation(self) -> bool:
        """params/params.go:679-681 (advertised; the reference never uses it)."""
        return self.block_size > 1

    @property
    def digit_limbs(self) -> int:
        """Number of base-256 signed limbs needed to represent a gadget
        digit exactly (see ops.polymul.split_signed_limbs_i8): 1 for
        BGBIT <= 8, 3 for the Uint profiles (BGBIT 18-23).

        For nd > 1 the final limb is the signed remainder after nd-1
        balanced extractions; |final| <= half_bg/256^(nd-1) + 129/255, so
        half_bg <= 64*256^(nd-1) keeps it safely inside int8."""
        if self.half_bg <= 128:
            return 1
        nd = 2
        while self.half_bg > 64 * (256 ** (nd - 1)):
            nd += 1
        return nd

    def __post_init__(self):
        assert self.n == 1 << self.nbit, (self.name, self.n, self.nbit)
        assert self.l * self.bgbit <= 32
        assert self.basebit * self.iks_t < 32
        # limb truncation must be exact: the dropped limbs must be zero by
        # key construction (see kernel_limb_drop / key_grid_bits).
        assert self.key_grid_bits >= 8 * self.kernel_limb_drop, (
            self.name, self.kernel_limb_drop, self.key_grid_bits)
        # the gadget must reach every key bit above the grid
        assert self.key_grid_bits <= self.tail_bits or self.tail_bits == 0


# ---------------------------------------------------------------------------
# Profile registry — numeric values copied from params/params.go:83-514.
# ---------------------------------------------------------------------------

P80 = TFHEParams(
    name="80bit",
    lwe_n=550, lwe_alpha=5.0e-5,
    n=1024, lv1_alpha=3.73e-8, nbit=10,
    bgbit=6, l=3, basebit=2, iks_t=7, block_size=3,
)

P110 = TFHEParams(
    name="110bit",
    lwe_n=630, lwe_alpha=3.0517578125e-05,
    n=1024, lv1_alpha=2.980232238769531e-8, nbit=10,
    bgbit=6, l=3, basebit=2, iks_t=8, block_size=3,
)

P128 = TFHEParams(
    name="128bit",
    lwe_n=700, lwe_alpha=2.0e-5,
    n=1024, lv1_alpha=2.0e-8, nbit=10,
    bgbit=6, l=3, basebit=2, iks_t=9, block_size=3,
)

UINT1 = TFHEParams(
    name="uint1",
    lwe_n=700, lwe_alpha=2.0e-05,
    n=1024, lv1_alpha=2.0e-08, nbit=10,
    bgbit=10, l=2, basebit=2, iks_t=8, block_size=3,
    message_modulus=2,
)

UINT2 = TFHEParams(
    name="uint2",
    lwe_n=687, lwe_alpha=0.00002120846893069971872305794214,
    n=512, lv1_alpha=0.00000000000231841227527049948463, nbit=9,
    bgbit=18, l=1, basebit=4, iks_t=3, block_size=3,
    message_modulus=4,
)

UINT3 = TFHEParams(
    name="uint3",
    lwe_n=820, lwe_alpha=0.00000251676160959795544987084234,
    n=1024, lv1_alpha=0.00000000000000022204460492503131, nbit=10,
    bgbit=23, l=1, basebit=6, iks_t=2, block_size=4,
    message_modulus=8,
)

UINT4 = TFHEParams(
    name="uint4",
    lwe_n=820, lwe_alpha=0.00000251676160959795544987084234,
    n=2048, lv1_alpha=0.00000000000000022204460492503131, nbit=11,
    bgbit=22, l=1, basebit=5, iks_t=3, block_size=4,
    message_modulus=16,
)

UINT5 = TFHEParams(
    name="uint5",
    lwe_n=1071, lwe_alpha=7.088226765410429399593757e-08,
    n=2048, lv1_alpha=2.2204460492503131e-17, nbit=11,
    bgbit=22, l=1, basebit=6, iks_t=3, block_size=7,
    message_modulus=32,
)

UINT6 = TFHEParams(
    name="uint6",
    lwe_n=1071, lwe_alpha=7.088226765410429399593757e-08,
    n=2048, lv1_alpha=2.2204460492503131e-17, nbit=11,
    bgbit=22, l=1, basebit=6, iks_t=3, block_size=7,
    message_modulus=64, poly_extend_factor=2,
)

UINT7 = TFHEParams(
    name="uint7",
    lwe_n=1160, lwe_alpha=1.966220007498402695211596e-08,
    n=2048, lv1_alpha=2.2204460492503131e-17, nbit=11,
    bgbit=22, l=1, basebit=7, iks_t=3, block_size=8,
    message_modulus=128, poly_extend_factor=4,
)

UINT8 = TFHEParams(
    name="uint8",
    lwe_n=1160, lwe_alpha=1.966220007498402695211596e-08,
    n=2048, lv1_alpha=2.2204460492503131e-17, nbit=11,
    bgbit=22, l=1, basebit=7, iks_t=3, block_size=8,
    message_modulus=256, poly_extend_factor=9,
)

# Small profile for fast CPU tests of the full bootstrap pipeline.  Not secure;
# noise/rounding margins chosen so boolean gates decrypt correctly:
# mod-switch error <= (lwe_n+1)/(4N) = 17/512 << 1/8.
TEST_FAST = TFHEParams(
    name="test_fast",
    lwe_n=16, lwe_alpha=1.0 / (1 << 20),
    n=128, lv1_alpha=1.0 / (1 << 28), nbit=7,
    bgbit=8, l=2, basebit=4, iks_t=6, block_size=1,
    message_modulus=2,
)

# Block-blind-rotation test profile: block_size=2 with a ragged tail
# (lwe_n=17 = 8 blocks + 1), exercising both the fused block step and the
# per-bit tail in blind_rotate_block.  Margins as TEST_FAST.
TEST_BLOCK = TFHEParams(
    name="test_block",
    lwe_n=17, lwe_alpha=1.0 / (1 << 20),
    n=128, lv1_alpha=1.0 / (1 << 28), nbit=7,
    bgbit=8, l=2, basebit=4, iks_t=6, block_size=2,
    message_modulus=2,
)

# Slightly larger test profile with a multi-bit message space for PBS tests.
TEST_PBS = TFHEParams(
    name="test_pbs",
    lwe_n=32, lwe_alpha=1.0 / (1 << 26),
    n=512, lv1_alpha=1.0 / (1 << 30), nbit=9,
    bgbit=8, l=3, basebit=4, iks_t=7, block_size=1,
    message_modulus=8,
)

# messageModulus=32 test profile (the Uint5 shape at toy sizes) for the PBS
# nibble adder.  Error budget: half-segment 1/128; mod-switch error
# (lwe_n+1)/(4N) ~= 0.0042 + decomposition tail lwe_n*N*2^-(l*bgbit+1)
# ~= 0.0005 stays well inside.
TEST_NIBBLE = TFHEParams(
    name="test_nibble",
    lwe_n=16, lwe_alpha=1.0 / (1 << 28),
    n=1024, lv1_alpha=1.0 / (1 << 32), nbit=10,
    bgbit=8, l=3, basebit=4, iks_t=7, block_size=1,
    message_modulus=32,
)

# Extended-LUT toy profiles (poly_extend_factor > 1): k=2 exercises the
# power-of-two mod switch, k=3 the general multiply-based one (the Uint8
# production profile has k=9, also non-power-of-two).
TEST_EXT2 = TFHEParams(
    name="test_ext2",
    lwe_n=16, lwe_alpha=1.0 / (1 << 28),
    n=256, lv1_alpha=1.0 / (1 << 31), nbit=8,
    bgbit=8, l=3, basebit=4, iks_t=6, block_size=1,
    message_modulus=16, poly_extend_factor=2,
)

TEST_EXT3 = TFHEParams(
    name="test_ext3",
    lwe_n=16, lwe_alpha=1.0 / (1 << 28),
    n=256, lv1_alpha=1.0 / (1 << 31), nbit=8,
    bgbit=8, l=3, basebit=4, iks_t=6, block_size=1,
    message_modulus=12, poly_extend_factor=3,
)

# Throughput-tuned variants: identical CRYPTO parameters (lwe_n, N, alphas
# — so SecretKeys and level-0 ciphertexts are interchangeable with the
# base profiles; only the CloudKey differs) with three implementation
# choices, each an established lattice-crypto technique re-targeted at an
# int8 matmul:
#
# * GADGET bgbit=8, l=2 instead of the reference's 6/3: contraction rows
#   2l*N = 4N — 2/3 of the reference gadget's 6N.  The gadget base is an
#   implementation knob, not a security parameter; the reference's 6/3
#   keeps float64-FFT products small, while the integer kernel is exact
#   for any half_bg <= 128.  Larger digits raise the BSK-noise term 4x to
#   ~2^23.7 — still below the mod-switch floor (~2^24.2).
# * CENTERED decomposition (see centered_decomposition): kills the floor
#   bias whose ring-key walk measured 2^27.4 of phase error at this
#   gadget; the remaining tail fluctuation sqrt-accumulates to ~2^22.9.
# * KEYGEN MODULUS SWITCH to q = 2^24 (see key_grid_bits): the BSK's low
#   limb is zero by construction, so kernel_limb_drop=1 removes 25% of
#   the matmul columns bit-exactly.
#
# Noise budget vs the 2^29 boolean margin: mod-switch 2^24.2 + tail 2^22.9
# + BSK 2^23.7 + KSK 2^23 => total ~2^25.0, >15 sigma, error/gate < 1e-50.
# Measured end to end by tools/noise_margin.py (committed margins in
# NOISE_r03.json — exact integer arithmetic, so any device reproduces them
# bit for bit); enforced by chip_smoke.py phase (b) and
# tests/test_noise_margin.py on the card.
P80_FAST = dataclasses.replace(
    P80, name="80bit_fast", bgbit=8, l=2, kernel_limb_drop=1,
    key_grid_bits=8, centered_decomposition=True)
P110_FAST = dataclasses.replace(
    P110, name="110bit_fast", bgbit=8, l=2, kernel_limb_drop=1,
    key_grid_bits=8, centered_decomposition=True)
P128_FAST = dataclasses.replace(
    P128, name="128bit_fast", bgbit=8, l=2, kernel_limb_drop=1,
    key_grid_bits=8, centered_decomposition=True)

# Centered-decomposition variants of the extended Uint profiles.  At
# BGBIT=22/l=1 the reference's floor offset leaves a DETERMINISTIC
# -2^9/2-per-coefficient representation bias whose ring-key random walk
# accumulates to ~2^23.3 of phase error over ~1100 steps — right at the
# Uint6 half-segment tolerance (2^24), so a share of PBS outputs decode
# wrong (NOISE_PBS_r04.json, below).  The reference never
# ran these profiles (params/UINT_STATUS.md), so the marginality is
# inherited, not introduced.  Centering the offset (same mechanism as the
# `*_fast` boolean profiles) makes the representation error zero-mean.
# Measured (NOISE_PBS_r04.json, batch 2048, tools/noise_margin_pbs.py):
# uint6 floor phase std 2^22.7 = 2.5 sigma from the 2^24 PBS margin
# (1.2% error/PBS); uint6_centered 2^18.0 = 64.5 sigma (zero errors);
# uint7_centered 36.8 sigma.  Same crypto parameters; ciphertext bits
# differ from reference-parity floor semantics.
UINT6_CENTERED = dataclasses.replace(
    UINT6, name="uint6_centered", centered_decomposition=True)
UINT7_CENTERED = dataclasses.replace(
    UINT7, name="uint7_centered", centered_decomposition=True)
UINT8_CENTERED = dataclasses.replace(
    UINT8, name="uint8_centered", centered_decomposition=True)

PROFILES: Dict[str, TFHEParams] = {
    p.name: p
    for p in (P80, P110, P128, P80_FAST, P110_FAST, P128_FAST,
              UINT1, UINT2, UINT3, UINT4, UINT5, UINT6,
              UINT7, UINT8, UINT6_CENTERED, UINT7_CENTERED, UINT8_CENTERED,
              TEST_FAST, TEST_BLOCK, TEST_PBS, TEST_NIBBLE,
              TEST_EXT2, TEST_EXT3)
}

# Aliases mirroring the reference enum names (params/params.go:32-44).
PROFILES["Security80Bit"] = P80
PROFILES["Security110Bit"] = P110
PROFILES["Security128Bit"] = P128
for _i in range(1, 9):
    PROFILES[f"SecurityUint{_i}"] = PROFILES[f"uint{_i}"]

DEFAULT = P128


def get_params(name: str) -> TFHEParams:
    """Look a profile up by name ('128bit', 'uint5', 'Security80Bit', ...)."""
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(
            f"unknown parameter profile {name!r}; available: "
            f"{sorted(set(p.name for p in PROFILES.values()))}") from None


def security_info(p: TFHEParams) -> str:
    """Human-readable description (params/params.go:639-666)."""
    descs = {
        "80bit": "80-bit security (performance-optimized)",
        "110bit": "110-bit security (balanced, original TFHE)",
        "128bit": "128-bit security (high security, quantum-resistant)",
    }
    base = p.name
    suffix = ""
    if base.endswith("_fast"):
        base = base[:-5]
        suffix = (" [throughput CloudKey: bgbit=8/l=2 gadget, centered "
                  "decomposition, on-grid q=2^24 BSK — same crypto "
                  "parameters as the base profile, see SECURITY.md]")
    elif base.endswith("_centered"):
        base = base[:-9]
        suffix = (" [centered gadget decomposition: zero-mean "
                  "representation error, same crypto parameters]")
    if base.startswith("uint"):
        bits = base[4:]
        return (f"Uint{bits} parameters ({bits}-bit messages, "
                f"messageModulus={p.message_modulus}, N={p.n})" + suffix)
    if base in descs:
        return descs[base] + suffix
    return f"{p.name} (custom profile)"
