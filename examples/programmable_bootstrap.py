"""Programmable bootstrapping: arbitrary functions on encrypted integers.

Batched take on the reference's examples/programmable_bootstrap/main.go:
identity / negation / constant / mod-4-increment LUTs, plus LUT reuse across
a batch and per-ciphertext LUT batching (beyond the reference's API).

Run:  python examples/programmable_bootstrap.py [--profile test_pbs]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import time

import jax
import jax.numpy as jnp
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax.utils.cache import enable_compilation_cache
from go_tfhe_jax import cipher, lut


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="test_pbs")
    args = ap.parse_args()
    p = tfhe.get_params(args.profile)
    enable_compilation_cache()
    print(f"device: {jax.devices()[0].device_kind}")
    m = p.message_modulus
    print(f"profile: {tfhe.security_info(p)}; messageModulus={m}")

    k_sk, k_ck, k_m = jax.random.split(jax.random.PRNGKey(0), 3)
    t0 = time.time()
    sk = tfhe.gen_secret_key(k_sk, p)
    ck = tfhe.gen_cloud_key(k_ck, sk, p)
    print(f"keygen: {time.time() - t0:.2f}s")

    msgs = np.arange(m)
    ct = cipher.lwe_encrypt_message(k_m, msgs, m, p.lwe_alpha, sk.lv0)

    cases = [
        ("identity", lambda x: x),
        ("increment mod m", lambda x: (x + 1) % m),
        ("complement", lambda x: (m - 1) - x),
        ("mod 4", lambda x: x % 4),
        ("constant 3", lambda x: 3),
    ]
    for name, f in cases:
        t0 = time.time()
        out = lut.bootstrap_func(ck, ct, f, m)
        dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
        want = np.array([f(x) % m for x in msgs])
        ok = "ok " if (dec == want).all() else "FAIL"
        print(f"{name:>16}: {dec}  [{ok}] "
              f"({time.time() - t0:.3f}s for {m} ciphertexts)")

    # LUT reuse: generate once, apply to many fresh ciphertexts.
    gen = lut.Generator(p, m)
    table = gen.gen_lut(lambda x: (3 * x) % m)
    out = lut.bootstrap_lut(ck, ct, table)
    dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
    print(f"{'reused 3x-LUT':>16}: {dec}  "
          f"[{'ok' if (dec == (3 * msgs) % m).all() else 'FAIL'}]")

    # Per-ciphertext LUTs: DIFFERENT functions on each lane, one call.
    tables = jnp.stack([gen.gen_lut(lambda x, i=i: (x + i) % m)
                        for i in range(m)])
    out = lut.bootstrap_lut(ck, ct, tables)
    dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
    want = (msgs + np.arange(m)) % m
    print(f"{'per-ct LUT batch':>16}: {dec}  "
          f"[{'ok' if (dec == want).all() else 'FAIL'}]")


if __name__ == "__main__":
    main()
