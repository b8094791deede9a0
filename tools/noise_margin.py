"""Production-scale noise-margin measurement for the shipped profiles.

Runs a batch of NAND gate bootstraps at real keys/parameters, measures the
phase deviation of the outputs from the ideal ±1/8 encoding, and reports
std / max / estimated error-per-gate against the 2^29 boolean decision
margin (the distance from the ±1/8 phase to the 0 / 1/4 decision
boundaries).  This is the evidence behind every *_fast profile knob
(params.TFHEParams.kernel_limb_drop and the bgbit=8/l=2 fast gadget); the
reference's implicit standard is its float64 path never producing a wrong
gate over 100+ trials (gates/gates_test.go:23-366).

Usage:  python tools/noise_margin.py [--batch 512] [--profiles a,b,c]
Prints one JSON line per profile.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import jax
import numpy as np

sys.path.insert(0, ".")  # repo root

import go_tfhe_jax as tfhe  # noqa: E402
from go_tfhe_jax import cipher, engine  # noqa: E402
from go_tfhe_jax.utils.cache import enable_compilation_cache  # noqa: E402

MARGIN = 2 ** 29  # |ideal phase| 2^32/8, decision boundary at 0 and 2^31/2


def measure(profile: str, batch: int) -> dict:
    p = tfhe.get_params(profile)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(123), 4)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)

    bits_a = np.resize([False, True], batch)
    bits_b = np.resize([False, False, True, True], batch)
    ct_a = tfhe.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = tfhe.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0)
    out = engine.bootstrap(ck, engine.prepare_nand(ct_a, ct_b))

    want = ~(bits_a & bits_b)
    ideal = np.where(want, 1 / 8, -1 / 8) * 2 ** 32
    ph = np.asarray(cipher.lwe_phase(out, sk.lv0)).astype(np.int64)
    dev = ((ph - ideal.astype(np.int64) + 2 ** 31) % 2 ** 32) - 2 ** 31
    dec = np.asarray(tfhe.lwe_decrypt_bool(out, sk.lv0))

    std = float(dev.std())
    sigmas = MARGIN / std if std else float("inf")
    # Gaussian tail estimate of P(|dev| > margin) per gate.
    err_gate = math.erfc(sigmas / math.sqrt(2.0))
    return {
        "profile": p.name,
        "batch": batch,
        "phase_std_log2": round(math.log2(std), 2) if std else None,
        "phase_max_log2": round(math.log2(abs(dev).max() + 1), 2),
        "margin_log2": 29,
        "margin_sigmas": round(sigmas, 1),
        "est_error_per_gate": float(f"{err_gate:.2e}"),
        "wrong_answers": int((dec != want).sum()),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--profiles", type=str,
                    default="128bit_fast,128bit,80bit_fast")
    args = ap.parse_args()
    enable_compilation_cache()
    for name in args.profiles.split(","):
        print(json.dumps(measure(name.strip(), args.batch)), flush=True)


if __name__ == "__main__":
    main()
