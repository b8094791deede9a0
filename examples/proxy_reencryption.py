"""LWE proxy re-encryption walkthrough.

Batched take on the reference's examples/proxy_reencryption/main.go:
Alice encrypts; a proxy transforms her ciphertexts to Bob's key (symmetric
and asymmetric re-encryption keys); a 3-hop chain Alice -> Bob -> Carol.
All re-encryptions are batched.

Run:  python examples/proxy_reencryption.py [--profile 128bit] [--batch 64]
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
from go_tfhe_jax import cipher, proxyreenc


def acc(dec, bits):
    return 100.0 * (np.asarray(dec) == bits).mean()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="test_fast")
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    p = tfhe.get_params(args.profile)
    enable_compilation_cache()
    print(f"device: {jax.devices()[0].device_kind}")
    print(f"profile: {tfhe.security_info(p)}")

    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    alice = tfhe.gen_secret_key(ks[0], p)
    bob = tfhe.gen_secret_key(ks[1], p)
    carol = tfhe.gen_secret_key(ks[2], p)

    bits = np.asarray(jax.random.bernoulli(ks[3], 0.5, (args.batch,)))
    ct = cipher.lwe_encrypt_bool(ks[4], bits, p.lwe_alpha, alice.lv0)
    print(f"Alice encrypted {args.batch} bits; self-decrypt accuracy "
          f"{acc(cipher.lwe_decrypt_bool(ct, alice.lv0), bits):.0f}%")

    # Symmetric re-encryption key (needs both secret keys).
    t0 = time.time()
    rk_sym = proxyreenc.gen_reencryption_key_symmetric(
        ks[5], alice.lv0, bob.lv0, p)
    print(f"symmetric reenc-key gen: {time.time() - t0:.3f}s")
    t0 = time.time()
    ct_bob = proxyreenc.reencrypt(rk_sym, ct)
    dt = time.time() - t0
    print(f"re-encrypt Alice->Bob ({args.batch} cts, {dt:.3f}s): "
          f"Bob decrypts {acc(cipher.lwe_decrypt_bool(ct_bob, bob.lv0), bits):.0f}%")

    # Asymmetric: key generated from Bob's PUBLIC key only.
    pk_bob = proxyreenc.gen_public_key(ks[6], bob.lv0, p)
    t0 = time.time()
    rk_asym = proxyreenc.gen_reencryption_key_asymmetric(
        ks[7], alice.lv0, pk_bob, p)
    print(f"asymmetric reenc-key gen: {time.time() - t0:.3f}s")
    ct_bob2 = proxyreenc.reencrypt(rk_asym, ct)
    print(f"asymmetric Alice->Bob: Bob decrypts "
          f"{acc(cipher.lwe_decrypt_bool(ct_bob2, bob.lv0), bits):.0f}%")

    # 3-hop chain.
    rk_bc = proxyreenc.gen_reencryption_key_symmetric(
        jax.random.PRNGKey(42), bob.lv0, carol.lv0, p)
    ct_carol = proxyreenc.reencrypt(rk_bc, ct_bob)
    print(f"chain Alice->Bob->Carol: Carol decrypts "
          f"{acc(cipher.lwe_decrypt_bool(ct_carol, carol.lv0), bits):.0f}%")


if __name__ == "__main__":
    main()
