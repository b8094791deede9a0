"""PBS phase-margin measurement for the multi-bit (Uint) profiles.

Same methodology as tools/noise_margin.py but for programmable
bootstrapping: run an identity LUT over a batch of encrypted messages,
measure the output phase deviation from the ideal x/(2m) encoding, and
report it against the PBS decision margin 2^32/(4m) (half the message
segment).  This quantifies the floor-vs-centered gadget split
(NOISE_PBS_r04.json; params.py UINT6_CENTERED comment: the floor offset's
bias walk sits right at Uint6's margin).

Usage: python tools/noise_margin_pbs.py [--batch 1024]
       [--profiles uint5,uint6,uint6_centered]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import jax
import numpy as np

sys.path.insert(0, ".")

import go_tfhe_jax as tfhe  # noqa: E402
from go_tfhe_jax import cipher, lut  # noqa: E402
from go_tfhe_jax.utils.cache import enable_compilation_cache  # noqa: E402


def measure(profile: str, batch: int) -> dict:
    p = tfhe.get_params(profile)
    m = p.message_modulus
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(321), 3)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)

    msgs = np.arange(batch) % m
    ct = cipher.lwe_encrypt_message(k3, msgs, m, p.lwe_alpha, sk.lv0)
    table = lut.Generator(p, m).gen_lut(lambda x: x)        # identity
    out = lut.bootstrap_lut(ck, ct, table)

    dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
    wrong = int((dec != msgs).sum())
    ideal = (msgs.astype(np.int64) << 32) // (2 * m)
    ph = np.asarray(cipher.lwe_phase(out, sk.lv0)).astype(np.int64)
    dev = ((ph - ideal + 2 ** 31) % 2 ** 32) - 2 ** 31
    std = float(dev.std())
    margin = 2 ** 32 // (4 * m)
    sigmas = margin / std if std else float("inf")
    return {
        "profile": p.name, "message_modulus": m, "batch": batch,
        "phase_std_log2": round(math.log2(std), 2) if std else None,
        "phase_max_log2": round(math.log2(abs(dev).max() + 1), 2),
        "margin_log2": round(math.log2(margin), 1),
        "margin_sigmas": round(sigmas, 1),
        "est_error_per_pbs": float(
            f"{math.erfc(sigmas / math.sqrt(2.0)):.2e}"),
        "wrong_answers": wrong,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--profiles", default="uint6,uint6_centered")
    args = ap.parse_args()
    enable_compilation_cache()
    for name in args.profiles.split(","):
        print(json.dumps(measure(name.strip(), args.batch)), flush=True)


if __name__ == "__main__":
    main()
