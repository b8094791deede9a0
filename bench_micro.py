"""Micro-benchmarks mirroring the reference's benchmark families.

The Go reference has 19 benchmark functions in 4 families:
* keygen / encrypt / decrypt       (gates/gates_test.go:488-640)
* polynomial kernel                 (poly/poly_test.go:64-124)
* PBS incl. Uint5                   (evaluator/programmable_bootstrap_test.go:212-266,
                                     params/uint_params_test.go:150-216)
* proxy re-encryption               (proxyreenc/proxyreenc_test.go:193-238)

This script emits one JSON line PER metric (machine-readable), then a
summary.  Usage:  python bench_micro.py [--quick]

``--quick`` runs the cheap families only (no Uint5 PBS) — useful on CPU.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine, lut, proxyreenc
from go_tfhe_jax.ops.polymul import negacyclic_mul_binary

from go_tfhe_jax.utils.metrics import MetricsLogger

_METRICS = MetricsLogger()


def emit(metric: str, seconds: float, unit_count: float = 1.0,
         unit: str = "ms") -> None:
    _METRICS.emit_seconds(metric, seconds, unit_count, unit)


def timed(fn, *args, reps=3):
    """Compile/warm-up once, then the steady-state mean per call."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _i in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main() -> None:
    from go_tfhe_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    quick = "--quick" in sys.argv
    on_gpu = jax.devices()[0].platform == "gpu"
    p = tfhe.P128 if on_gpu else tfhe.TEST_FAST
    batch = 4096 if on_gpu else 16

    keys = jax.random.split(jax.random.PRNGKey(0), 8)

    # --- keygen family (reference: ~5-10 s at 128-bit, README.md:397) ------
    # The *_cold numbers are first-ever calls in the process: they include
    # backend init + XLA compile (or compilation-cache load) and dominate
    # by orders of magnitude; the plain metrics are steady-state compute,
    # comparable to the reference's numbers.
    t0 = time.perf_counter()
    sk = jax.block_until_ready(tfhe.gen_secret_key(keys[0], p))
    sk_cold = time.perf_counter() - t0
    emit(f"keygen_secret_{p.name}_cold", sk_cold)
    emit(f"keygen_secret_{p.name}",
         timed(lambda: tfhe.gen_secret_key(keys[0], p).lv0))

    t0 = time.perf_counter()
    ck = jax.block_until_ready(tfhe.gen_cloud_key(keys[1], sk, p))
    cold = time.perf_counter() - t0
    emit(f"keygen_cloud_{p.name}_cold", cold)
    steady = timed(lambda: tfhe.gen_cloud_key(keys[1], sk, p))
    emit(f"keygen_cloud_{p.name}", steady)
    # compile-vs-compute split: the cold call is compile (or compilation-
    # cache load) + one compute; steady-state is pure compute.
    emit(f"keygen_cloud_{p.name}_compile_overhead", cold - steady)

    # --- encrypt / decrypt family ------------------------------------------
    bits = np.resize([False, True], batch)
    dt = timed(lambda: cipher.lwe_encrypt_bool(keys[2], bits, p.lwe_alpha,
                                               sk.lv0))
    emit(f"encrypt_bool_{p.name}_per_ct", dt, batch)
    ct = cipher.lwe_encrypt_bool(keys[2], bits, p.lwe_alpha, sk.lv0)
    dt = timed(lambda: cipher.lwe_decrypt_bool(ct, sk.lv0))
    emit(f"decrypt_bool_{p.name}_per_ct", dt, batch)

    # --- polynomial kernel family (poly/poly_test.go:64-124) ----------------
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 2 ** 32, size=(batch, p.n),
                                 dtype=np.uint64).astype(np.uint32))
    dt = timed(negacyclic_mul_binary, a, sk.lv1)
    emit(f"polymul_binary_{p.name}_batch{batch}", dt)

    # --- gate bootstrap (the headline lives in bench.py; here per-gate) ----
    ct_b = cipher.lwe_encrypt_bool(keys[3], ~bits, p.lwe_alpha, sk.lv0)
    t0 = time.perf_counter()
    jax.block_until_ready(engine.bootstrap(ck, engine.prepare_and(ct, ct_b)))
    first_batch = time.perf_counter() - t0
    dt = timed(lambda: engine.bootstrap(ck, engine.prepare_and(ct, ct_b)))
    emit(f"gate_bootstrap_{p.name}_first_batch", first_batch)
    emit(f"gate_bootstrap_{p.name}_compile_overhead", first_batch - dt)
    # Fresh-process SLA (README "Deployment"): process start -> first
    # decrypted batch = secret keygen + cloud keygen + first bootstrap,
    # all cold in THIS process.  With the persistent compilation cache
    # warm (make warm, or an unpacked cache artifact: make warm-pack /
    # warm-unpack) this is mostly cache loads; with an empty cache it is
    # dominated by XLA compilation.
    emit(f"time_to_first_batch_{p.name}", sk_cold + cold + first_batch,
         unit="ms (fresh process)")
    emit(f"gate_bootstrap_{p.name}_batch{batch}", dt)
    emit(f"gate_bootstrap_{p.name}_per_ct", dt, batch)

    # --- single-gate latency (the reference's headline metric: ~100-150 ms
    # per gate at 128-bit, README.md:131,398).  Throughput comes from the
    # batch axis; these rows quantify the sequential-chain cost a batch-1
    # caller pays (each batch size compiles its own shape).
    for lat_b in (1, 128):
        bits_l = np.resize([False, True], lat_b)
        ct_l = cipher.lwe_encrypt_bool(keys[2], bits_l, p.lwe_alpha, sk.lv0)
        ct_lb = cipher.lwe_encrypt_bool(keys[3], ~bits_l, p.lwe_alpha,
                                        sk.lv0)
        dt = timed(lambda: engine.bootstrap(
            ck, engine.prepare_and(ct_l, ct_lb)))
        emit(f"gate_latency_{p.name}_batch{lat_b}", dt)

    if on_gpu:
        # the throughput profile (bgbit=8/l=2 gadget + exact limb drop)
        pf = tfhe.get_params("128bit_fast")
        skf = tfhe.gen_secret_key(keys[0], pf)
        ckf = tfhe.gen_cloud_key(keys[1], skf, pf)
        ctf = cipher.lwe_encrypt_bool(keys[2], bits, pf.lwe_alpha, skf.lv0)
        ctf_b = cipher.lwe_encrypt_bool(keys[3], ~bits, pf.lwe_alpha,
                                        skf.lv0)
        dt = timed(lambda: engine.bootstrap(
            ckf, engine.prepare_and(ctf, ctf_b)))
        emit(f"gate_bootstrap_{pf.name}_batch{batch}", dt)
        emit(f"gate_bootstrap_{pf.name}_per_ct", dt, batch)

    # --- key switch share ----------------------------------------------------
    lv1 = jnp.asarray(rng.integers(0, 2 ** 32, size=(batch, p.n + 1),
                                   dtype=np.uint64).astype(np.uint32))
    from go_tfhe_jax.ops.keyswitch import identity_key_switch
    import functools
    ksj = jax.jit(functools.partial(identity_key_switch, p))
    dt = timed(ksj, ck.ksk, lv1)
    emit(f"key_switch_{p.name}_batch{batch}", dt)

    # --- PBS family ----------------------------------------------------------
    if not quick:
        pu = tfhe.get_params("uint5") if on_gpu else tfhe.TEST_NIBBLE
        sku = tfhe.gen_secret_key(keys[4], pu)
        t0 = time.perf_counter()
        cku = jax.block_until_ready(tfhe.gen_cloud_key(keys[5], sku, pu))
        emit(f"keygen_cloud_{pu.name}", time.perf_counter() - t0)
        msgs = np.arange(batch) % pu.message_modulus
        ctu = cipher.lwe_encrypt_message(keys[6], msgs, pu.message_modulus,
                                         pu.lwe_alpha, sku.lv0)
        m = pu.message_modulus
        dt = timed(lambda: lut.bootstrap_func(cku, ctu, lambda x: (x + 1) % m,
                                              m), reps=2)
        emit(f"pbs_{pu.name}_batch{batch}", dt)
        emit(f"pbs_{pu.name}_per_ct", dt, batch)
        out = lut.bootstrap_func(cku, ctu, lambda x: (x + 1) % m, m)
        dec = np.asarray(cipher.lwe_decrypt_message(out, m, sku.lv0))
        ok = (dec == (msgs + 1) % m).mean()
        print(json.dumps({"metric": f"pbs_{pu.name}_accuracy",
                          "value": float(ok), "unit": "fraction"}),
              flush=True)

    # --- proxy re-encryption family (CHANGELOG.md:26-28) --------------------
    pp = tfhe.P80 if on_gpu else tfhe.TEST_FAST
    alice = tfhe.gen_secret_key(keys[6], pp)
    bob = tfhe.gen_secret_key(keys[7], pp)
    # Steady-state (the reference's ~23 ms / ~21 ms numbers are steady-
    # state too, CHANGELOG.md:26,49); first call pays XLA compile.
    dt = timed(lambda: proxyreenc.gen_public_key(
        jax.random.PRNGKey(11), bob.lv0, pp).encryptions)
    emit(f"proxy_pubkey_{pp.name}", dt)
    pk_bob = proxyreenc.gen_public_key(jax.random.PRNGKey(11), bob.lv0, pp)
    dt = timed(lambda: proxyreenc.gen_reencryption_key_symmetric(
        jax.random.PRNGKey(12), alice.lv0, bob.lv0, pp).table)
    emit(f"proxy_reenc_keygen_sym_{pp.name}", dt)
    # Asymmetric re-encryption keygen (reference: ~4.4 s, CHANGELOG.md:27).
    dt = timed(lambda: proxyreenc.gen_reencryption_key_asymmetric(
        jax.random.PRNGKey(14), alice.lv0, pk_bob, pp).table)
    emit(f"proxy_reenc_keygen_asym_{pp.name}", dt)
    rk = proxyreenc.gen_reencryption_key_symmetric(
        jax.random.PRNGKey(12), alice.lv0, bob.lv0, pp)
    cta = cipher.lwe_encrypt_bool(jax.random.PRNGKey(13), bits, pp.lwe_alpha,
                                  alice.lv0)
    dt = timed(proxyreenc.reencrypt, rk, cta)
    emit(f"proxy_reencrypt_{pp.name}_batch{batch}", dt)

    print(json.dumps({"summary": _METRICS.summary()}))


if __name__ == "__main__":
    main()
