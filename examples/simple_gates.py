"""Homomorphic boolean gates over all input combinations.

Batched take on the reference's examples/simple_gates/main.go: instead of
looping over the 4 (a, b) combos gate by gate, every gate evaluates all
combos in ONE batched bootstrap.

Run:  python examples/simple_gates.py [--profile 128bit]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import time

import jax
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax.utils.cache import enable_compilation_cache
from go_tfhe_jax import cipher, gates


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="test_fast",
                    help="parameter profile (e.g. 128bit, 80bit, test_fast)")
    args = ap.parse_args()
    p = tfhe.get_params(args.profile)
    enable_compilation_cache()
    print(f"device: {jax.devices()[0].device_kind}")
    print(f"profile: {tfhe.security_info(p)}")

    k_sk, k_ck, ka, kb = jax.random.split(jax.random.PRNGKey(0), 4)
    t0 = time.time()
    sk = tfhe.gen_secret_key(k_sk, p)
    ck = tfhe.gen_cloud_key(k_ck, sk, p)
    print(f"keygen: {time.time() - t0:.2f}s")

    a = np.array([False, False, True, True])
    b = np.array([False, True, False, True])
    ct_a = cipher.lwe_encrypt_bool(ka, a, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(kb, b, p.lwe_alpha, sk.lv0)

    table = {
        "AND": (gates.AND, a & b), "OR": (gates.OR, a | b),
        "NAND": (gates.NAND, ~(a & b)), "NOR": (gates.NOR, ~(a | b)),
        "XOR": (gates.XOR, a ^ b), "XNOR": (gates.XNOR, ~(a ^ b)),
    }
    for name, (fn, want) in table.items():
        t0 = time.time()
        out = fn(ck, ct_a, ct_b)
        dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
        ok = "ok " if (dec == want).all() else "FAIL"
        print(f"{name:>5}: {dec.astype(int)}  [{ok}] "
              f"({time.time() - t0:.3f}s for all 4 combos)")

    # MUX over encrypted selector
    ks = jax.random.PRNGKey(9)
    sel = np.array([True, False, True, False])
    ct_s = cipher.lwe_encrypt_bool(ks, sel, p.lwe_alpha, sk.lv0)
    out = gates.MUX(ck, ct_s, ct_a, ct_b)
    dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
    print(f"  MUX: {dec.astype(int)}  "
          f"[{'ok' if (dec == np.where(sel, a, b)).all() else 'FAIL'}]")


if __name__ == "__main__":
    main()
