"""Test configuration: the CPU backend with 8 virtual devices by default.

Multi-device sharding is validated on a virtual CPU mesh
(``xla_force_host_platform_device_count=8``) — the mechanism SURVEY.md §4
prescribes for testing multi-node behavior without a real cluster.

Tests marked ``gpu`` need the card and skip elsewhere; run them there with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/ --override-ini addopts=
"""

import os

# Must precede first backend initialization.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import go_tfhe_jax as tfhe  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU as the default JAX device "
        "(skips elsewhere)")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_card(request):
    """Decided per test, at run time: gpu-marked tests skip without a card."""
    if (request.node.get_closest_marker("gpu")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU as the default JAX device; on the "
                    "card run: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/ --override-ini addopts=")


@pytest.fixture(scope="session")
def fast_keys():
    """SecretKey/CloudKey for the small boolean test profile."""
    p = tfhe.TEST_FAST
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    return p, sk, ck


@pytest.fixture(scope="session")
def pbs_keys():
    """SecretKey/CloudKey for the multi-bit (messageModulus=8) test profile."""
    p = tfhe.TEST_PBS
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    return p, sk, ck


# ---------------------------------------------------------------------------
# NumPy oracles (independent re-derivations of the reference's math, used to
# check the JAX kernels bit-exactly; see SURVEY.md §4 "Implication").
# ---------------------------------------------------------------------------

def negacyclic_mul_oracle(a, b):
    """Exact schoolbook negacyclic product mod 2^32 of uint32 polys."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    n = a.shape[-1]
    out = np.zeros(n, np.uint64)
    for i in range(n):
        for j in range(n):
            k = i + j
            prod = (a[i] * b[j]) & 0xFFFFFFFF
            if k < n:
                out[k] = (out[k] + prod) & 0xFFFFFFFF
            else:
                out[k - n] = (out[k - n] + (1 << 32) - prod) & 0xFFFFFFFF
    return out.astype(np.uint32)


def monomial_mul_oracle(a, k):
    """Go polyMulWithXKInPlace (trgsw/trgsw.go:254-282) ported verbatim."""
    a = np.asarray(a, np.uint32)
    n = a.shape[-1]
    k = int(k) % (2 * n)
    out = np.empty_like(a)
    if k == 0:
        return a.copy()
    if k < n:
        out[k:] = a[: n - k]
        out[: k] = (0xFFFFFFFF - a[n - k:].astype(np.uint64)).astype(np.uint32)
    else:
        k -= n
        out[k:] = (0xFFFFFFFF - a[: n - k].astype(np.uint64)).astype(np.uint32)
        out[: k] = a[n - k:]
    return out


def decompose_oracle(x, p):
    """Signed gadget decomposition (poly/decomposer.go:55-66)."""
    x = np.asarray(x, np.uint32)
    tmp = (x.astype(np.uint64) + p.decomposition_offset) & 0xFFFFFFFF
    digits = []
    for i in range(p.l):
        shift = 32 - (i + 1) * p.bgbit
        d = ((tmp >> shift) & (p.bg - 1)).astype(np.int64) - p.half_bg
        digits.append(d.astype(np.int32))
    return np.stack(digits)


def sample_extract_oracle(trlwe, k=0):
    """trlwe/trlwe.go:114-128."""
    a, b = np.asarray(trlwe[0], np.uint32), np.asarray(trlwe[1], np.uint32)
    n = a.shape[0]
    out = np.empty(n + 1, np.uint32)
    for i in range(n):
        if i <= k:
            out[i] = a[k - i]
        else:
            out[i] = (0xFFFFFFFF - np.uint64(a[n + k - i])) & 0xFFFFFFFF
    out[n] = b[k]
    return out
