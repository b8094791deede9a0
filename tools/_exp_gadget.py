"""Round-3 experiment: noise margin of a bgbit=8/l=2 gadget vs
the shipped 128bit_fast (bgbit=6, l_used=2) approximate gadget.

Hypothesis: the l_used=2 fast path's 2^27 phase std is dominated by the
incomplete-decomposition tail on the A channel (eps_A multiplied by the
ring key, ~sqrt(N/2) amplification).  A COMPLETE 2-level gadget with
bgbit=8 (16 of 32 bits covered, tail 2^16 grid) has the same contraction
row count (2l*N = 4N) but 16x less tail -> predicted total ~2^24.4
against the 2^29 margin.
"""
import dataclasses
import time

import jax
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine

p0 = tfhe.P128
B = 512
k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(42), 4)

bits_a = np.resize([False, True], B)
bits_b = np.resize([False, False, True, True], B)
want = np.where(~(bits_a & bits_b), 1 / 8, -1 / 8)
ideal = (want * 2 ** 32).astype(np.int64)

configs = {
    # shipped round-2 headline (approximate gadget): expect std ~2^27
    "bg6_l3_used2_drop1": dict(bgbit=6, l=3, decomp_levels_used=2,
                               kernel_limb_drop=1),
    # proposed: complete 2-level bgbit=8 gadget, same row count
    "bg8_l2_drop1": dict(bgbit=8, l=2, kernel_limb_drop=1),
    # proposed, exact kernel (4 limbs)
    "bg8_l2_drop0": dict(bgbit=8, l=2, kernel_limb_drop=0),
}
for name, kw in configs.items():
    p = dataclasses.replace(p0, name="exp_" + name, **kw)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    ct_a = tfhe.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = tfhe.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0)
    prep = engine.prepare_nand(ct_a, ct_b)
    t0 = time.time()
    out = engine.bootstrap(ck, prep)
    ph = np.asarray(cipher.lwe_phase(out, sk.lv0)).astype(np.int64)
    dt = time.time() - t0
    dev = ((ph - ideal + 2 ** 31) % 2 ** 32) - 2 ** 31
    dec = np.asarray(tfhe.lwe_decrypt_bool(out, sk.lv0))
    wrong = int((dec != ~(bits_a & bits_b)).sum())
    print(f"{name:22s} std=2^{np.log2(dev.std()):5.2f} "
          f"max=2^{np.log2(np.abs(dev).max() + 1):5.2f} "
          f"wrong={wrong}/{B} ({dt:.1f}s incl compile)", flush=True)
