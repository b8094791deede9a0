"""Torus conversion exact values (mirrors utils/utils_test.go:10-46)."""

import numpy as np

from go_tfhe_jax.utils.torus import (f64_to_torus, f64_to_torus_vec,
                                     torus_to_f64)


def test_f64_to_torus_exact_values():
    # utils/utils_test.go: T(0.5) = 2^31, T(0.25) = 2^30, T(0.125) = 2^29
    assert f64_to_torus(0.5) == 1 << 31
    assert f64_to_torus(0.25) == 1 << 30
    assert f64_to_torus(0.125) == 1 << 29
    assert f64_to_torus(0.0) == 0


def test_f64_to_torus_negative():
    # fmod keeps sign: T(-0.125) = -2^29 mod 2^32
    assert f64_to_torus(-0.125) == (1 << 32) - (1 << 29)
    assert f64_to_torus(-0.5) == 1 << 31


def test_f64_to_torus_wraps_mod_1():
    assert f64_to_torus(1.25) == f64_to_torus(0.25)
    assert f64_to_torus(42.5) == f64_to_torus(0.5)


def test_torus_to_f64_roundtrip():
    for v in [0, 1, 1 << 29, 1 << 31, (1 << 32) - 1]:
        f = torus_to_f64(np.uint32(v))
        assert 0.0 <= f < 1.0
        assert f64_to_torus(f) == v


def test_vec():
    out = f64_to_torus_vec([0.5, 0.25, -0.125])
    np.testing.assert_array_equal(
        out, np.array([1 << 31, 1 << 30, (1 << 32) - (1 << 29)], np.uint32))
