"""Phase-margin measurement for multi-LUT bootstrapping (PBSmanyLUT).

The coarse mod switch multiplies the mod-switch rounding noise by
2^theta; this tool measures the end-to-end output phase deviation of an
identity many-LUT bootstrap at theta = 0, 1, 2 on a production profile,
against the message-space half-segment margin (2^32 / (2m) ... the
decode decision boundary is half a segment, 2^32/(2m)/2? — here margin =
2^(32)/(4m), the distance from a segment center to its edge).

Prints one JSON row per theta (phase std, margin in sigma, wrong answers).

Usage: python tools/noise_many.py [--profile 128bit_fast] [--batch 1024]
"""
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
import go_tfhe_jax as tfhe  # noqa: E402
from go_tfhe_jax import cipher, engine, lut  # noqa: E402
from go_tfhe_jax.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

profile, batch, m = "128bit_fast", 1024, 8
for i, a in enumerate(sys.argv):
    if a == "--profile":
        profile = sys.argv[i + 1]
    if a == "--batch":
        batch = int(sys.argv[i + 1])

p = tfhe.get_params(profile)
k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
sk = tfhe.gen_secret_key(k1, p)
ck = tfhe.gen_cloud_key(k2, sk, p)
gen = lut.Generator(p, m)

msgs = np.arange(batch) % (m // 2)            # first torus half
ct = cipher.lwe_encrypt_message(k3, msgs, m, p.lwe_alpha, sk.lv0)
margin = 1 << (32 - int(math.log2(m)) - 2)    # half-segment: 2^32/(4m)

for theta in (0, 1, 2):
    mlut = gen.gen_multi_lut([lambda x: x], theta=theta)
    out = engine.bootstrap_many(ck, ct, mlut, k=1, theta=theta)[0]
    dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
    wrong = int((dec != msgs).sum())
    ideal = (msgs.astype(np.int64) << (32 - int(math.log2(m)) - 1))
    ph = np.asarray(cipher.lwe_phase(out, sk.lv0)).astype(np.int64)
    dev = ((ph - ideal + 2 ** 31) % 2 ** 32) - 2 ** 31
    std = float(dev.std())
    sig = margin / std if std else float("inf")
    print(json.dumps({
        "profile": p.name, "message_modulus": m, "theta": theta,
        "batch": batch, "phase_std_log2": round(math.log2(std), 2),
        "margin_log2": int(math.log2(margin)),
        "margin_sigmas": round(sig, 1),
        "est_error_per_pbs": float(
            f"{math.erfc(sig / math.sqrt(2.0)):.2e}"),
        "wrong_answers": wrong,
    }), flush=True)
