"""8-bit homomorphic addition two ways.

Batched take on the reference's examples/add_two_numbers/main.go:

* PBS nibble method — 3 programmable bootstraps on a messageModulus-32
  profile (low-sum LUT, carry LUT, high-sum LUT).
* Ripple-carry method — 5 gate bootstraps per bit over encrypted bit
  vectors (the reference documents this in README.md:78-115 only).

Both are batched: pass --batch N to add N independent pairs at once.

Run:  python examples/add_two_numbers.py [--profile test_nibble] [--batch 4]
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
from go_tfhe_jax import bitutils, cipher
from go_tfhe_jax.models import adders


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="test_nibble",
                    help="messageModulus>=32 profile (uint5 for production)")
    ap.add_argument("--bool-profile", default="test_fast",
                    help="boolean profile for the ripple-carry variant")
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    va = rng.integers(0, 256, args.batch)
    vb = rng.integers(0, 256, args.batch)

    # ---- PBS nibble method -------------------------------------------------
    p = tfhe.get_params(args.profile)
    enable_compilation_cache()
    print(f"device: {jax.devices()[0].device_kind}")
    assert p.message_modulus >= 32, "nibble adder needs messageModulus >= 32"
    print(f"[PBS nibble] profile: {tfhe.security_info(p)}")
    k_sk, k_ck, k_e = jax.random.split(jax.random.PRNGKey(0), 3)
    t0 = time.time()
    sk = tfhe.gen_secret_key(k_sk, p)
    ck = tfhe.gen_cloud_key(k_ck, sk, p)
    print(f"  keygen: {time.time() - t0:.2f}s")

    keys = jax.random.split(k_e, 4)
    enc = lambda k, v: cipher.lwe_encrypt_message(k, v, 32, p.lwe_alpha,
                                                  sk.lv0)
    ct_al, ct_ah = enc(keys[0], va & 0xF), enc(keys[1], va >> 4)
    ct_bl, ct_bh = enc(keys[2], vb & 0xF), enc(keys[3], vb >> 4)

    t0 = time.time()
    sum_low, sum_high = adders.add8_pbs(ck, ct_al, ct_ah, ct_bl, ct_bh)
    lo = np.asarray(cipher.lwe_decrypt_message(sum_low, 32, sk.lv0)) & 0xF
    hi = np.asarray(cipher.lwe_decrypt_message(sum_high, 32, sk.lv0)) & 0xF
    dt = time.time() - t0
    got = (hi << 4) | lo
    want = (va + vb) & 0xFF
    print(f"  3 bootstraps x {args.batch} adds in {dt:.3f}s "
          f"({dt / 3:.3f}s per batched PBS)")
    for i in range(args.batch):
        ok = "ok " if got[i] == want[i] else "FAIL"
        print(f"  {va[i]:3d} + {vb[i]:3d} = {got[i]:3d} (mod 256)  [{ok}]")

    # ---- Ripple-carry method ----------------------------------------------
    p2 = tfhe.get_params(args.bool_profile)
    print(f"[ripple-carry] profile: {tfhe.security_info(p2)}")
    k_sk2, k_ck2, ka, kb = jax.random.split(jax.random.PRNGKey(1), 4)
    sk2 = tfhe.gen_secret_key(k_sk2, p2)
    ck2 = tfhe.gen_cloud_key(k_ck2, sk2, p2)

    a_bits = np.stack([bitutils.u8_to_bits(int(v)) for v in va])
    b_bits = np.stack([bitutils.u8_to_bits(int(v)) for v in vb])
    ct_a = bitutils.encrypt_bits(ka, a_bits, p2.lwe_alpha, sk2.lv0)
    ct_b = bitutils.encrypt_bits(kb, b_bits, p2.lwe_alpha, sk2.lv0)

    t0 = time.time()
    s_bits, _carry = adders.ripple_carry_add(ck2, ct_a, ct_b)
    dec = np.asarray(bitutils.decrypt_bits(s_bits, sk2.lv0))
    dt = time.time() - t0
    got2 = np.array([bitutils.from_bits(dec[i]) for i in range(args.batch)])
    print(f"  40 gate bootstraps x {args.batch} adds in {dt:.3f}s")
    for i in range(args.batch):
        ok = "ok " if got2[i] == want[i] else "FAIL"
        print(f"  {va[i]:3d} + {vb[i]:3d} = {got2[i]:3d} (mod 256)  [{ok}]")


if __name__ == "__main__":
    main()
