"""Production-scale noise-margin tests for every shipped fast-path knob.

The lesson of an earlier lossy knob: a throughput knob without an
end-to-end margin measurement at production parameters is a latent
correctness bug.  The shipped knobs are now

* the bgbit=8/l=2 gadget of the *_fast profiles (params.P128_FAST), and
* ``kernel_limb_drop=1`` (ops/polymul.negacyclic_extprod_i8),

and each must keep the measured output-phase deviation far inside the 2^29
boolean decision margin (|±1/8| phase to the 0 / ±1/4 boundaries — the
margin the reference's decrypt uses, tlwe/tlwe.go:64-73).

The real-parameter tests run at production size, so they are marked
``gpu`` and skip on the CPU test mesh; run them on the card with
``make test-gpu``.  chip_smoke.py phase (b) applies the same 8-sigma gate
at batch 4096.  Committed margins live in NOISE_r03.json at the repo root
(tools/noise_margin.py); the arithmetic is exact, so every device
reproduces them bit for bit.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine

MARGIN = 2 ** 29


def _measure(p, batch=512, seed=123):
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    bits_a = np.resize([False, True], batch)
    bits_b = np.resize([False, False, True, True], batch)
    ct_a = tfhe.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = tfhe.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0)
    out = engine.bootstrap(ck, engine.prepare_nand(ct_a, ct_b))
    want = ~(bits_a & bits_b)
    dev = cipher.bool_phase_deviation(out, want, sk.lv0)
    dec = np.asarray(tfhe.lwe_decrypt_bool(out, sk.lv0))
    return dev, int((dec != want).sum())


@pytest.mark.gpu
@pytest.mark.production
def test_margin_128bit_fast():
    """The headline profile: bgbit=8/l=2 gadget + kernel_limb_drop=1.

    Predicted phase std ~2^24.5 (params.py analysis); the assert leaves
    ~1.5 bits of slack.  >= 8 sigma of margin means an error/gate below
    1e-15 — no 4096-batch bench will ever flake on it."""
    dev, wrong = _measure(tfhe.get_params("128bit_fast"))
    assert wrong == 0
    std = dev.std()
    assert std < 2 ** 26, f"phase std 2^{math.log2(std):.2f}"
    assert abs(dev).max() < 2 ** 28
    assert MARGIN / std > 8.0


@pytest.mark.gpu
@pytest.mark.production
def test_margin_128bit_fast_exact_kernel():
    """Isolate the gadget contribution: bgbit=8/l=2 WITHOUT limb drop."""
    import dataclasses
    p = dataclasses.replace(tfhe.get_params("128bit_fast"),
                            name="128bit_fast_drop0", kernel_limb_drop=0)
    dev, wrong = _measure(p)
    assert wrong == 0
    assert dev.std() < 2 ** 26


@pytest.mark.gpu
@pytest.mark.production
def test_margin_128bit_reference_gadget():
    """The bit-exact parity profile (bgbit=6/l=3, no knobs) as a control.

    Measured 2^25.45 (tools/_exp_gadget2.py): the reference's own floor
    decomposition carries a bias-x-ringkey-walk term of ~2^25.4 at its
    2^14 tail grid — present upstream too, and ~11 sigma inside the
    margin."""
    dev, wrong = _measure(tfhe.P128)
    assert wrong == 0
    assert dev.std() < 2 ** 26.2
