"""Parameter-table invariants (mirrors params/params_test.go:35-72)."""

import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax.params import PROFILES, get_params


REFERENCE_VALUES = {
    # name: (lwe_n, n, nbit, bgbit, l, basebit, iks_t, message_modulus)
    # from /root/reference/params/params.go:83-514
    "80bit": (550, 1024, 10, 6, 3, 2, 7, 2),
    "110bit": (630, 1024, 10, 6, 3, 2, 8, 2),
    "128bit": (700, 1024, 10, 6, 3, 2, 9, 2),
    "uint1": (700, 1024, 10, 10, 2, 2, 8, 2),
    "uint2": (687, 512, 9, 18, 1, 4, 3, 4),
    "uint3": (820, 1024, 10, 23, 1, 6, 2, 8),
    "uint4": (820, 2048, 11, 22, 1, 5, 3, 16),
    "uint5": (1071, 2048, 11, 22, 1, 6, 3, 32),
    "uint6": (1071, 2048, 11, 22, 1, 6, 3, 64),
    "uint7": (1160, 2048, 11, 22, 1, 7, 3, 128),
    "uint8": (1160, 2048, 11, 22, 1, 7, 3, 256),
}


@pytest.mark.parametrize("name", sorted(REFERENCE_VALUES))
def test_profile_values(name):
    p = get_params(name)
    lwe_n, n, nbit, bgbit, l, basebit, iks_t, mm = REFERENCE_VALUES[name]
    assert p.lwe_n == lwe_n
    assert p.n == n
    assert p.nbit == nbit
    assert p.bgbit == bgbit
    assert p.l == l
    assert p.basebit == basebit
    assert p.iks_t == iks_t
    assert p.message_modulus == mm


@pytest.mark.parametrize("name", sorted(REFERENCE_VALUES))
def test_derived_invariants(name):
    p = get_params(name)
    assert p.bg == 1 << p.bgbit            # params/params.go:72
    assert p.n == 1 << p.nbit
    assert p.half_bg * 2 == p.bg
    assert p.base == 1 << p.basebit
    # offset = sum (Bg/2) * 2^(32-(i+1)BGBIT)  (cloudkey/cloudkey.go:60-71)
    off = sum((p.bg // 2) * (1 << (32 - (i + 1) * p.bgbit))
              for i in range(p.l)) % (1 << 32)
    assert p.decomposition_offset == off
    assert p.ksk_alpha == p.lwe_alpha       # params/params.go:629-631
    assert p.bsk_alpha == p.lv1_alpha       # params/params.go:634-636


def test_registry_aliases():
    assert get_params("Security128Bit") is get_params("128bit")
    assert get_params("SecurityUint5") is get_params("uint5")
    with pytest.raises(KeyError):
        get_params("nonsense")


def test_decomposition_offset_128bit_exact():
    # 128-bit: Bg=64, BGBIT=6, L=3
    p = get_params("128bit")
    expected = (32 * (1 << 26) + 32 * (1 << 20) + 32 * (1 << 14)) % (1 << 32)
    assert p.decomposition_offset == expected


def test_params_hashable_and_frozen():
    p = tfhe.P128
    hash(p)  # usable as jit static arg
    with pytest.raises(Exception):
        p.n = 2048
