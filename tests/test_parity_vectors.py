"""Bit-exact parity against transcribed reference vectors.

``tests/vectors/parity_vectors.npz`` is produced by
``tests/vectors/gen_vectors.py`` — a literal scalar transcription of the Go
reference's deterministic sub-kernels (no Go toolchain exists in this build
image, so the vectors cannot be dumped by `go test` directly; the generator
cites the exact reference lines and shares no code with go_tfhe_jax).

Every assertion here is exact equality: a failing vector fails CI.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import engine, lut
from go_tfhe_jax.ops.blindrotate import mod_switch_2n
from go_tfhe_jax.ops.decompose import gadget_decompose
from go_tfhe_jax.ops.rotate import monomial_mul
from go_tfhe_jax.ops.sample_extract import sample_extract
from go_tfhe_jax.utils.torus import f64_to_torus

V = np.load(os.path.join(os.path.dirname(__file__), "vectors",
                         "parity_vectors.npz"))

PROFILES = {
    "80bit": tfhe.P80,
    "110bit": tfhe.P110,
    "128bit": tfhe.P128,
    "uint5": tfhe.get_params("uint5"),
}


def test_f64_to_torus_vectors():
    got = f64_to_torus(V["f64_in"])
    np.testing.assert_array_equal(got, V["f64_torus"])


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_decomposition_offset(name):
    assert PROFILES[name].decomposition_offset == int(V[f"{name}/offset"])


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_gadget_decompose_vectors(name):
    p = PROFILES[name]
    x = jnp.asarray(V[f"{name}/dec_in"])[None, :]      # (C=1, N)
    got = np.asarray(gadget_decompose(x, p))           # (L, N)
    np.testing.assert_array_equal(got, V[f"{name}/dec_out"])


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_rotation_vectors(name):
    a = jnp.asarray(V[f"{name}/rot_in"])
    ks = V[f"{name}/rot_ks"]
    want = V[f"{name}/rot_out"]
    got_gather = np.asarray(monomial_mul(
        jnp.broadcast_to(a, (len(ks), a.shape[0])),
        jnp.asarray(ks, jnp.int32)))
    np.testing.assert_array_equal(got_gather, want)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_sample_extract_vectors(name):
    trlwe = jnp.stack([jnp.asarray(V[f"{name}/se_a"]),
                       jnp.asarray(V[f"{name}/se_b"])])
    for k, want in zip(V[f"{name}/se_ks"], V[f"{name}/se_out"]):
        got = np.asarray(sample_extract(trlwe, int(k)))
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_mod_switch_vectors(name):
    p = PROFILES[name]
    xs = jnp.asarray(V[f"{name}/ms_in"])
    got_a = np.asarray(mod_switch_2n(xs, p)).astype(np.int64)
    np.testing.assert_array_equal(got_a, V[f"{name}/ms_a"])
    # b path: the reference adds in int64 (no uint32 wrap); ours wraps.
    # Both are used only as rotation amounts mod 2N, so compare mod 2N.
    got_b = (2 * p.n - got_a) % (2 * p.n)
    np.testing.assert_array_equal(got_b, V[f"{name}/ms_b"] % (2 * p.n))


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_ksk_plaintext_vectors(name):
    """KSK digit plaintexts: (k * s1) << (32-(j+1)*basebit) must equal the
    reference's F64ToTorus(k*s1/2^((j+1)bb)) for every (s1, j, k) cell."""
    p = PROFILES[name]
    want = V[f"{name}/ksk_plain"]                 # (2, t, base)
    ks = np.arange(p.base, dtype=np.uint64)
    for s1 in (0, 1):
        for j in range(p.iks_t):
            got = ((ks * s1) << (32 - (j + 1) * p.basebit)) & 0xFFFFFFFF
            np.testing.assert_array_equal(
                got.astype(np.uint32), want[s1, j],
                err_msg=f"s1={s1} j={j}")


def test_lut_table_vectors():
    for key in V["lut_cases"]:
        key = str(key)
        _, n, m, fname = key.split("/")
        n, m = int(n), int(m)
        table = {
            "identity": lambda x: x,
            "complement": lambda x: m - 1 - x,
            "increment": lambda x: (x + 1) % m,
            "constant1": lambda x: 1,
        }[fname]
        p = next(q for q in PROFILES.values() if q.n == n)
        gen = lut.Generator(p, message_modulus=m)
        got = np.asarray(gen.gen_lut(table))
        np.testing.assert_array_equal(got[0], 0, err_msg=key)  # A == 0
        np.testing.assert_array_equal(got[1], V[key], err_msg=key)


def test_lut_mod_switch_vectors():
    for size in (1024, 2048):
        p = next(q for q in PROFILES.values() if q.n == size)
        gen = lut.Generator(p, message_modulus=2)
        xs = V[f"lutms/{size}/in"]
        want = V[f"lutms/{size}/out"]
        got = np.asarray([gen.mod_switch(int(x)) for x in xs], np.int64)
        np.testing.assert_array_equal(got, want)


def test_encoder_vectors():
    for m in (2, 4, 8, 16, 32, 64, 128, 256):
        enc = lut.Encoder(m)
        got = np.asarray([enc.encode(x) for x in range(m)], np.uint32)
        np.testing.assert_array_equal(got, V[f"enc/{m}"])


def test_gate_bias_vectors():
    assert engine._T_EIGHTH == int(V["bias/eighth"])
    assert engine._T_NEG_EIGHTH == int(V["bias/neg_eighth"])
    assert engine._T_QUARTER == int(V["bias/quarter"])
