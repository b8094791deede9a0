"""Multi-LUT bootstrapping: a full adder's sum AND carry from ONE bootstrap.

Beyond-reference demo (the Go reference has no many-LUT; its ripple adder
costs 5 gate bootstraps per bit, README.md:78-115): a coarse mod switch
plus an interleaved test vector (engine.bootstrap_many) extracts multiple
function outputs from a single blind rotation — 8-bit addition at 8
bootstraps instead of 40.

Bits are encrypted as modulus-8 LWE messages (cipher.lwe_encrypt_message)
so the sum phase (a+b+cin)/16 stays in the first torus half, where both
the sum (s&1) and carry (s>>1) look-up tables escape the negacyclic
antisymmetry constraint that blocks XOR in the +-1/8 boolean encoding.

Run:  python examples/manylut_adder.py [--profile test_nibble] [--batch 4]
(chip_smoke.py phase (c) runs the same adder at 128bit_fast on the card.)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import time

import jax
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher
from go_tfhe_jax.models import adders
from go_tfhe_jax.utils.cache import enable_compilation_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="test_nibble",
                    help="any plain (poly_extend_factor=1) profile; "
                         "128bit_fast for production")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--bits", type=int, default=8)
    args = ap.parse_args()

    p = tfhe.get_params(args.profile)
    enable_compilation_cache()

    rng = np.random.default_rng(0)
    lim = 1 << args.bits
    va = rng.integers(0, lim, args.batch)
    vb = rng.integers(0, lim, args.batch)

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    t0 = time.time()
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    print(f"[{p.name}] keygen: {time.time() - t0:.2f}s")

    # bits -> modulus-8 message encodings, shape (batch, bits, lwe_n+1)
    def enc(key, vals):
        bits = np.stack([(vals >> i) & 1 for i in range(args.bits)], axis=-1)
        return cipher.lwe_encrypt_message(key, bits, 8, p.lwe_alpha, sk.lv0)

    ka, kb = jax.random.split(k3)
    ct_a, ct_b = enc(ka, va), enc(kb, vb)

    t0 = time.time()
    s_bits, carry = adders.ripple_add_manylut(ck, ct_a, ct_b)
    s = np.asarray(cipher.lwe_decrypt_message(s_bits, 8, sk.lv0))
    cout = np.asarray(cipher.lwe_decrypt_message(carry, 8, sk.lv0))
    dt = time.time() - t0
    got = sum((s[..., i].astype(np.int64) & 1) << i
              for i in range(args.bits)) + (cout.astype(np.int64) << args.bits)
    want = va + vb
    ok = (got == want).all()
    boots = args.bits                       # ONE bootstrap per bit position
    print(f"{args.bits}-bit add x{args.batch}: {boots} bootstraps "
          f"(vs {5 * args.bits} boolean-gate), {dt:.2f}s")
    for i in range(min(args.batch, 4)):
        print(f"  {va[i]:3d} + {vb[i]:3d} = {got[i]:3d} "
              f"{'ok' if got[i] == want[i] else 'WRONG'}")
    if not ok:
        raise SystemExit("MISMATCH")
    print("all results correct")


if __name__ == "__main__":
    main()
