"""Isolate the unexplained ~2^27.4 phase-noise term at the bg8/l2 gadget.

Levers:
* keygen_alpha ~ 0  -> removes the BSK-noise term  Sum d (*) e
* l=4 (full 32-bit coverage) -> removes the decomposition tail eps
If alpha~0 keeps std ~2^27.4 the term is tail-coherence; if it drops to
~2^24 the term is BSK-noise accumulating coherently.
"""
import dataclasses
import time

import jax
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax.utils.cache import enable_compilation_cache
enable_compilation_cache()
from go_tfhe_jax import cipher, engine

p0 = tfhe.P128
B = 256
k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(42), 4)

bits_a = np.resize([False, True], B)
bits_b = np.resize([False, False, True, True], B)
want = ~(bits_a & bits_b)
ideal = (np.where(want, 1 / 8, -1 / 8) * 2 ** 32).astype(np.int64)

# (name, profile kwargs, keygen alpha override or None)
configs = [
    ("bg8_l2 baseline", dict(bgbit=8, l=2), None),
    ("bg8_l2 alpha~0", dict(bgbit=8, l=2), 1e-30),
    ("bg8_l4 alpha~0 (no tail)", dict(bgbit=8, l=4), 1e-30),
    ("bg8_l4 baseline (no tail)", dict(bgbit=8, l=4), None),
    ("bg6_l3 reference gadget", dict(bgbit=6, l=3), None),
    ("bg6_l3 alpha~0", dict(bgbit=6, l=3), 1e-30),
]
for name, kw, alpha in configs:
    p = dataclasses.replace(p0, name="exp2_" + name.split()[0] + str(alpha),
                            **kw)
    p_keygen = (p if alpha is None
                else dataclasses.replace(p, lv1_alpha=alpha))
    sk = tfhe.gen_secret_key(k1, p_keygen)
    ck = tfhe.gen_cloud_key(k2, sk, p_keygen)
    ck = dataclasses.replace(ck, params=p)
    ct_a = tfhe.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = tfhe.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0)
    prep = engine.prepare_nand(ct_a, ct_b)
    t0 = time.time()
    out = engine.bootstrap(ck, prep)
    ph = np.asarray(cipher.lwe_phase(out, sk.lv0)).astype(np.int64)
    dt = time.time() - t0
    dev = ((ph - ideal + 2 ** 31) % 2 ** 32) - 2 ** 31
    dec = np.asarray(tfhe.lwe_decrypt_bool(out, sk.lv0))
    wrong = int((dec != want).sum())
    print(f"{name:28s} std=2^{np.log2(dev.std()):5.2f} "
          f"max=2^{np.log2(np.abs(dev).max() + 1):5.2f} "
          f"wrong={wrong}/{B} ({dt:.1f}s)", flush=True)
