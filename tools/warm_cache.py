"""Pre-populate the persistent XLA compilation cache (``make warm``).

A fresh checkout pays the full compile cost of keygen and the 700-step
bootstrap loop on first use.  This script runs one batch through keygen +
NAND for the production profiles so every later process start of the same
checkout hits the persistent cache (utils.cache.enable_compilation_cache:
JAX_COMPILATION_CACHE_DIR if set, else <checkout>/.jax_cache).  The batch
is part of the compiled shape: warm the batch you will serve.

Usage: python tools/warm_cache.py [--profiles 128bit_fast,128bit]
                                  [--batch 256]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine
from go_tfhe_jax.utils.cache import enable_compilation_cache


def warm(name: str, batch: int) -> None:
    p = tfhe.get_params(name)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    t0 = time.perf_counter()
    sk = tfhe.gen_secret_key(k1, p)
    ck = jax.block_until_ready(tfhe.gen_cloud_key(k2, sk, p))
    t1 = time.perf_counter()
    bits = np.resize([False, True], batch)
    ct_a = cipher.lwe_encrypt_bool(k3, bits, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(k4, bits, p.lwe_alpha, sk.lv0)
    jax.block_until_ready(engine.bootstrap(ck, engine.prepare_nand(ct_a, ct_b)))
    t2 = time.perf_counter()
    print(f"{name}: keygen {t1 - t0:.1f}s, first batch({batch}) "
          f"{t2 - t1:.1f}s — cache warmed")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiles", default="128bit_fast,128bit")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--pack", metavar="TARBALL", default=None,
                    help="after warming, pack the cache dir into a "
                         "relocatable .tar.gz deployment artifact")
    ap.add_argument("--unpack", metavar="TARBALL", default=None,
                    help="extract a previously packed cache artifact into "
                         "the cache dir and exit (no warming; the target "
                         "host must run the same device model and jax "
                         "build, or entries simply miss)")
    args = ap.parse_args()
    cache_dir = enable_compilation_cache()
    if args.unpack:
        import tarfile
        with tarfile.open(args.unpack) as tf:
            tf.extractall(cache_dir, filter="data")
        print(f"unpacked {args.unpack} -> {cache_dir} "
              f"({len(os.listdir(cache_dir))} entries)")
        return
    on_gpu = jax.devices()[0].platform == "gpu"
    batch = args.batch or (4096 if on_gpu else 16)
    for name in args.profiles.split(","):
        warm(name.strip(), batch)
    if args.pack:
        import tarfile
        with tarfile.open(args.pack, "w:gz") as tf:
            for entry in sorted(os.listdir(cache_dir)):
                tf.add(os.path.join(cache_dir, entry), arcname=entry)
        size = os.path.getsize(args.pack) / 1e6
        print(f"packed {cache_dir} -> {args.pack} ({size:.1f} MB)")


if __name__ == "__main__":
    main()
