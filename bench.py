"""Headline benchmark: gate bootstraps/sec/chip at 128-bit parameters.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...config,
utilization and measured noise margin}.  Baseline: the Go reference does a
single 128-bit gate bootstrap in ~100-150 ms on a modern CPU core
(README.md:131,398) => ~8 bootstraps/sec.

Headline configuration (every field stated in the JSON):
* profile "128bit_fast" — crypto parameters (lwe_n, N, alphas) identical to
  the 128-bit profile; the CloudKey uses the bgbit=8/l=2 gadget and the
  int8 external product drops the lowest of the 4 bootstrapping-key limbs
  (kernel_limb_drop=1).  Measured noise margin:
  see the "noise" block in the JSON (margin math in params.py and
  tests/test_noise_margin.py; the decision margin is 2^29).
* UNIFORM binary secret keys — the reference's own distribution
  (key/key.go:25-39) — and per-bit blind rotation.
* the public ``engine.bootstrap`` entry (not a private core).

Flags: --exact = parity configuration (the reference's bgbit=6/l=3 gadget,
4-limb key); --batch N.  On the GPU the default batch is 4096; elsewhere
it is 64 and no device rate is reported (a CPU run is a rehearsal).

The correctness gate checks a varying NAND truth table over the whole batch
before any timing, and the JSON reports the measured phase-noise margin —
a benchmark of wrong (or silently marginal) answers is worthless.
"""

from __future__ import annotations

import json
import math
import sys
import time

import jax
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine
from go_tfhe_jax.utils.cache import enable_compilation_cache
from go_tfhe_jax.utils.profiling import bootstrap_utilization

REFERENCE_BOOTSTRAPS_PER_SEC = 8.0   # 1 / 0.125 s (README.md:398 midpoint)
MARGIN = 2 ** 29
# Phase-margin floor for the self-guard: 8 sigma ~= 1e-15 error/gate.  Every
# shipped profile's committed margin is >= 11.8 sigma (NOISE_r03.json);
# anything below 8 means a knob broke the noise budget and the bench must
# fail, not report.
MIN_SIGMAS = 8.0


def main() -> None:
    enable_compilation_cache()
    exact = "--exact" in sys.argv
    dev = jax.devices()[0]
    on_gpu = dev.platform == "gpu"
    batch = 4096 if on_gpu else 64
    for i, a in enumerate(sys.argv):
        if a == "--batch":
            batch = int(sys.argv[i + 1])

    if exact:
        p = tfhe.P128
    else:
        p = tfhe.get_params("128bit_fast")
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    t_key0 = time.perf_counter()
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    jax.block_until_ready(ck)
    t_keygen = time.perf_counter() - t_key0

    if "--selftest-guard" in sys.argv:
        # Forced-bad-knob dry run of the self-guard: zero the top int8 key
        # limb (weight 2^24).  That injects ~2^31-per-coefficient key
        # error — far past the noise budget — so the run MUST exit 1 with
        # value null.
        import dataclasses as _dc
        ck = _dc.replace(ck, bsk_limbs=ck.bsk_limbs.at[-1].set(0))

    bits_a = np.resize([False, True], batch)
    bits_b = np.resize([False, False, True, True], batch)
    ct_a = tfhe.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = tfhe.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0)

    def nand(a, b):
        return engine.bootstrap(ck, engine.prepare_nand(a, b))

    # Warm-up / compile.
    t_c0 = time.perf_counter()
    out = nand(ct_a, ct_b)
    dec = np.asarray(tfhe.lwe_decrypt_bool(out, sk.lv0))
    t_first = time.perf_counter() - t_c0

    # Correctness gate over a varying truth table (both output values).
    want = ~(bits_a & bits_b)
    wrong = int((dec != want).sum())

    # Measured output-phase noise vs the ideal +-1/8 encoding.
    phase_dev = cipher.bool_phase_deviation(out, want, sk.lv0)
    std = float(phase_dev.std())
    sigmas = MARGIN / std if std else float("inf")
    noise = {
        "phase_std_log2": round(math.log2(std), 2) if std else None,
        "phase_max_log2": round(math.log2(abs(phase_dev).max() + 1), 2),
        "margin_log2": 29,
        "margin_sigmas": round(sigmas, 1),
        "est_error_per_gate": float(
            f"{math.erfc(sigmas / math.sqrt(2.0)):.2e}"),
    }

    # Self-guarding gate (round-2 offset_dither lesson): a perf knob that
    # ships wrong answers or a marginal phase distribution must fail the
    # bench loudly, not report a throughput number.  Floor: every answer
    # right AND measured margin >= MIN_SIGMAS (dry-run of the failure path:
    # `python bench.py --selftest-guard`).
    if wrong or sigmas < MIN_SIGMAS:
        print(json.dumps({
            "metric": "gate_bootstraps_per_sec_per_chip_128bit",
            "value": None,
            "unit": "bootstraps/s",
            "error": (f"{wrong}/{batch} truth-table mismatches" if wrong else
                      f"noise margin {sigmas:.1f} sigma below the "
                      f"{MIN_SIGMAS} sigma floor"),
            "profile": p.name,
            "noise": noise,
        }))
        sys.exit(1)

    # Timed steady-state runs; sequential device stream.
    reps = 5 if on_gpu else 2
    t0 = time.perf_counter()
    for _ in range(reps):
        out = nand(ct_a, ct_b)
    out.block_until_ready()
    dt = (time.perf_counter() - t0) / reps

    # A CPU run is a rehearsal of the path: it reports no device rate.
    value = batch / dt if on_gpu else None
    print(json.dumps({
        "metric": "gate_bootstraps_per_sec_per_chip_128bit",
        "value": value,
        "unit": "bootstraps/s",
        "vs_baseline": (value / REFERENCE_BOOTSTRAPS_PER_SEC
                        if on_gpu else None),
        "profile": p.name,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "key_distribution": "uniform_binary",
        "gadget": f"bgbit={p.bgbit},l={p.l}",
        "kernel_limbs": 4 - p.kernel_limb_drop,
        "batch": batch,
        "api": "engine.bootstrap",
        "keygen_s": t_keygen,
        "first_batch_s": t_first,
        "utilization": (bootstrap_utilization(p, value, dev.device_kind)
                        if on_gpu else "not measured"),
        "noise": noise,
    }))


if __name__ == "__main__":
    main()
