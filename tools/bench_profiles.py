"""80/110-bit profile throughput on the default device.

Same methodology as bench.py (correctness-gated, queued steady-state
reps timed with block_until_ready) at the other two reference security
levels; the reference's single-gate numbers are README.md:398.

Usage: python tools/bench_profiles.py [--profiles 80bit_fast,110bit_fast]
"""
import json
import sys
import time

import jax
import numpy as np

sys.path.insert(0, ".")
import go_tfhe_jax as tfhe  # noqa: E402
from go_tfhe_jax import cipher, engine  # noqa: E402
from go_tfhe_jax.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

REF_MS = {"80bit_fast": "60-80", "110bit_fast": "~90"}
profiles = "80bit_fast,110bit_fast"
for i, a in enumerate(sys.argv):
    if a == "--profiles":
        profiles = sys.argv[i + 1]

for name in profiles.split(","):
    p = tfhe.get_params(name)
    batch = 4096
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    bits_a = np.resize([False, True], batch)
    bits_b = np.resize([False, False, True, True], batch)
    ct_a = cipher.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0)

    def nand(a, b):
        return engine.bootstrap(ck, engine.prepare_nand(a, b))

    out = nand(ct_a, ct_b)
    dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
    wrong = int((dec != ~(bits_a & bits_b)).sum())
    assert wrong == 0, f"{name}: {wrong}/{batch} wrong"
    t0 = time.perf_counter()
    for _ in range(5):
        out = nand(ct_a, ct_b)
    out.block_until_ready()
    dt = (time.perf_counter() - t0) / 5
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"gate_bootstraps_per_sec_{name}",
        "value": batch / dt, "unit": "bootstraps/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "reference_single_gate_ms": REF_MS.get(name, "?")}), flush=True)
