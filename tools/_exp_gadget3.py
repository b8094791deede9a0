"""Confirm: centering the decomposition offset (round-to-nearest instead of
floor) removes the bias-x-ringkey-walk term at the bg8/l2 gadget.

Predictions (model calibrated on _exp_gadget2):
* bg8_l2 floor offset:     std ~2^27.4  (bias walk dominates)
* bg8_l2 centered offset:  std ~2^24.9  (mod-switch + sqrt tail + BSK)
* bg8_l2 centered + grid8 keys + drop1: ~2^24.9 (drop is exact on-grid)
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
B = 512
k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(7), 4)

bits_a = np.resize([False, True], B)
bits_b = np.resize([False, False, True, True], B)
want = ~(bits_a & bits_b)
ideal = (np.where(want, 1 / 8, -1 / 8) * 2 ** 32).astype(np.int64)

configs = [
    ("bg8_l2 floor", dict(bgbit=8, l=2)),
    ("bg8_l2 centered", dict(bgbit=8, l=2, centered_decomposition=True)),
    ("bg8_l2 cent+grid8+drop1", dict(bgbit=8, l=2,
                                     centered_decomposition=True,
                                     key_grid_bits=8, kernel_limb_drop=1)),
]
for name, kw in configs:
    p = dataclasses.replace(p0, name="exp3_" + name.replace(" ", "_")
                            .replace("+", "_"), **kw)
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
    wrong = int((dec != want).sum())
    print(f"{name:26s} std=2^{np.log2(dev.std()):5.2f} "
          f"max=2^{np.log2(np.abs(dev).max() + 1):5.2f} "
          f"mean={dev.mean():+.3e} wrong={wrong}/{B} ({dt:.1f}s)", flush=True)
