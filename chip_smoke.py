"""Smoke test of the main path on NVIDIA GPUs, against the plain reference.

Usage:
    python chip_smoke.py           # phases (a)-(c) on one card
    python chip_smoke.py --four    # phase (d) alone, on four cards

Phases (each failure exits non-zero; nothing is caught):
  (a) the int8 external product on the card vs the int32 Toeplitz reference
      (ops.polymul.negacyclic_extprod_toeplitz) on the CPU device, at real
      widths with real key rows: 128bit_fast, 128bit, uint5 (multi-limb
      digits), uint6_centered (k=2 blocks); tolerance 0.  Then a 16-step
      blind rotation, the keygen product a*s over one BSK's 2800 masks and
      the key switch at 128bit_fast, card vs CPU, bit-exact; and the
      compiled step's matmuls (int8 tensor-core GEMMs only).
  (b) 128bit_fast: keygen on the card, gates.NAND on 4096 varying truth-table
      pairs, decryption: 0 wrong and a phase margin >= 8 sigma.
  (c) 128bit NAND at batch 1024, lut.bootstrap_lut at uint6_centered batch
      256, the 8-bit many-LUT ripple adder at 128bit_fast batch 1024; all
      decrypt-checked.
  (d) --four: parallel.sharded_bootstrap over four cards at 128bit_fast,
      batch 4 x 4096, bit-for-bit against one card, decrypted.

Every time printed names the card and its power limit.  The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.  The
script refuses to run on anything but a GPU and computes its CPU reference
in process (one JAX process per card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine, gates, keys, lut
from go_tfhe_jax.models import adders
from go_tfhe_jax.ops.blindrotate import blind_rotate
from go_tfhe_jax.ops.decompose import gadget_decompose
from go_tfhe_jax.ops.extprod import external_product
from go_tfhe_jax.ops.keyswitch import identity_key_switch
from go_tfhe_jax.ops.polymul import (ext_band_from_trgsw,
                                     negacyclic_extprod_toeplitz,
                                     negacyclic_mul_binary)
from go_tfhe_jax.utils.cache import enable_compilation_cache
from go_tfhe_jax.utils.profiling import dot_operand_types

MARGIN = 2 ** 29
MIN_SIGMAS = 8.0
CARD = "card not queried"          # set by main(): "name, power limit"


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(x):
    return jax.block_until_ready(x)


def _rand_u32(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _cpu():
    return jax.devices("cpu")[0]


# ---------------------------------------------------------------------------
# (a) external product and blind rotation vs the CPU reference.
# ---------------------------------------------------------------------------

def _bsk_rows(p, seed: int, rows: int):
    """``rows`` real BSK rows (TRGSW encryptions of key bits) at profile p:
    keys._gen_bsk on a key truncated to ``rows`` LWE bits."""
    pr = dataclasses.replace(p, name=f"{p.name}_rows{rows}", lwe_n=rows)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    sk = tfhe.gen_secret_key(k1, pr)
    bsk = keys._gen_bsk(k2, pr, sk)
    return pr, sk, bsk


def check_extprod(p, batch: int = 64, seed: int = 0) -> None:
    """Default-device external product == CPU int32 reference, bit for bit,
    on ``batch`` random TRLWEs (k blocks each for extended profiles)."""
    _, _, bsk = _bsk_rows(p, seed, 2)
    limbs = keys.prepare_bsk_limbs(bsk, p)[:, 1]       # (NL, 2L, 2, 2N)
    k = p.poly_extend_factor
    shape = (batch,) + ((k,) if k > 1 else ()) + (2, p.n)
    x = _rand_u32(np.random.default_rng(seed), shape)
    got = np.asarray(jax.jit(external_product, static_argnums=0)(
        p, limbs, jnp.asarray(x)))
    cpu = _cpu()
    band = jax.device_put(ext_band_from_trgsw(
        jax.device_put(np.asarray(bsk[1]), cpu)), cpu)
    with jax.default_device(cpu):
        want = np.asarray(jax.jit(
            lambda xx, bb: negacyclic_extprod_toeplitz(
                gadget_decompose(xx, p), bb))(jax.device_put(x, cpu), band))
    bad = int((got != want).sum())
    log(f"(a) extprod {p.name}: {want.shape} digit limbs={p.digit_limbs} "
        f"key limbs={limbs.shape[0]}: {bad} of {want.size} words differ")
    assert bad == 0, f"extprod mismatch at {p.name}"


def check_rotation(p, steps: int = 16, batch: int = 8, seed: int = 1) -> None:
    """A ``steps``-step blind rotation with real key rows: default device
    vs the CPU device, bit for bit."""
    pr, sk, bsk = _bsk_rows(p, seed, steps)
    limbs = keys.prepare_bsk_limbs(bsk, pr)
    ct = np.asarray(cipher.lwe_encrypt_bool(
        jax.random.PRNGKey(seed + 1), np.resize([False, True], batch),
        pr.lwe_alpha, sk.lv0))
    tv = np.asarray(keys.gen_testvec(pr))
    fn = jax.jit(blind_rotate, static_argnums=0)
    got = np.asarray(fn(pr, limbs, jnp.asarray(ct), jnp.asarray(tv)))
    cpu = _cpu()
    with jax.default_device(cpu):
        want = np.asarray(fn(pr, jax.device_put(np.asarray(limbs), cpu),
                             jax.device_put(ct, cpu), jax.device_put(tv, cpu)))
    bad = int((got != want).sum())
    log(f"(a) blind rotation {p.name}: {steps} steps x {batch} ct: "
        f"{bad} of {want.size} words differ from the CPU device")
    assert bad == 0, "blind rotation differs between card and CPU"


def check_same_on_cpu(name: str, fn, *args) -> None:
    """``fn`` compiled for the default device == compiled for the CPU, bit
    for bit (the card's compiler is what differs)."""
    got = np.asarray(jax.jit(fn)(*args))
    cpu = _cpu()
    with jax.default_device(cpu):
        want = np.asarray(jax.jit(fn)(
            *[jax.device_put(np.asarray(a), cpu) for a in args]))
    bad = int((got != want).sum())
    log(f"(a) {name}: {bad} of {want.size} words differ from the CPU device")
    assert bad == 0, f"{name} differs between card and CPU"


def check_keygen_and_keyswitch(p, rows: int, batch: int = 64,
                               seed: int = 2) -> None:
    """The keygen product a*s (negacyclic_mul_binary) over ``rows`` TRLWE
    masks — 2L*lwe_n is one BSK's worth — and the key switch on ``batch``
    level-1 ciphertexts, card vs CPU."""
    rng = np.random.default_rng(seed)
    a = _rand_u32(rng, (rows, p.n))
    key = rng.integers(0, 2, p.n).astype(np.uint32)
    check_same_on_cpu(f"keygen a*s {p.name} rows={rows}",
                      negacyclic_mul_binary, a, key)
    ksk = _rand_u32(rng, (p.n, p.iks_t, p.base, p.lwe_n + 1))
    lv1 = _rand_u32(rng, (batch, p.n + 1))
    check_same_on_cpu(f"key switch {p.name} batch={batch}",
                      lambda k, c: identity_key_switch(p, k, c), ksk, lv1)


def check_matmul_types(ck, batch: int) -> None:
    """The bootstrap's matmuls are all int8 x int8 -> int32 (external product
    and key switch): none in s32 x s32 (off the tensor cores), f32 x f32
    (TF32 rounding) or bf16 (f32 accumulation, then a float->int convert)."""
    p = ck.params
    ct = jnp.zeros((batch, p.lwe_n + 1), jnp.uint32)
    args = (p, True, ck.bsk_limbs, ck.ksk, ct, ck.testvec)
    types = dot_operand_types(engine._bootstrap_core, *args)
    log(f"(a) bootstrap dot operand types {p.name}: {sorted(types)}")
    assert types == {("int8", "int8")}, types
    if jax.devices()[0].platform != "gpu":
        return
    hlo = engine._bootstrap_core.lower(*args).compile().as_text()
    gemms = compiled_gemms(hlo)
    for name, target, operands in gemms:
        log(f"(a) compiled matmul {name}: {target} {operands}")
    assert gemms, "no library or Triton GEMM in the compiled bootstrap"
    bad = [g for g in gemms if any(not t.startswith("s8[") for t in g[2])]
    assert not bad, f"GEMMs with operands other than int8: {bad}"


def compiled_gemms(hlo: str):
    """(instruction, target, operand types) of every GEMM in optimized HLO
    text: cuBLAS custom calls and Triton GEMM fusions."""
    types = dict(re.findall(r"%([\w.\-]+) = (\w+\[[\d,]*\])", hlo))
    out = []
    for line in hlo.splitlines():
        m = re.search(r"%([\w.\-]+) = .*?(custom-call|fusion)\(([^)]*)\)",
                      line)
        target = re.search(r'custom_call_target="(__cublas[^"]*)"', line)
        if m and (target or "__triton_gemm" in line):
            ops = [types.get(o.strip().lstrip("%"), "?")
                   for o in m.group(3).split(",") if o.strip()]
            out.append((m.group(1), target.group(1) if target
                        else "__triton_gemm", ops))
    return out


# ---------------------------------------------------------------------------
# (b), (c) the main path and its breadth.
# ---------------------------------------------------------------------------

def run_nand(p, batch: int, reps: int = 5, seed: int = 3):
    """Keygen, gates.NAND on ``batch`` random truth-table pairs, decrypt.
    Requires 0 wrong and a phase margin >= MIN_SIGMAS.  Returns (results,
    CloudKey)."""
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    t0 = time.perf_counter()
    sk = tfhe.gen_secret_key(k1, p)
    ck = _sync(tfhe.gen_cloud_key(k2, sk, p))
    keygen_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    bits_a = rng.integers(0, 2, batch).astype(bool)
    bits_b = rng.integers(0, 2, batch).astype(bool)
    ct_a = tfhe.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = tfhe.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0)
    t0 = time.perf_counter()
    out = _sync(gates.NAND(ck, ct_a, ct_b))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = gates.NAND(ck, ct_a, ct_b)
    _sync(out)
    steady_s = (time.perf_counter() - t0) / reps
    want = ~(bits_a & bits_b)
    wrong = int((np.asarray(tfhe.lwe_decrypt_bool(out, sk.lv0)) != want).sum())
    std = float(cipher.bool_phase_deviation(out, want, sk.lv0).std())
    sigmas = MARGIN / std if std else math.inf
    res = dict(profile=p.name, batch=batch, keygen_s=keygen_s,
               first_batch_s=first_s, steady_s_per_batch=steady_s,
               bootstraps_per_s=batch / steady_s, wrong=wrong,
               phase_std_log2=math.log2(std) if std else None,
               margin_sigmas=sigmas)
    log(f"NAND {p.name} batch {batch} [{CARD}]: keygen {keygen_s:.3f} s, "
        f"first batch {first_s:.3f} s, steady {steady_s:.6f} s/batch = "
        f"{batch / steady_s:.1f} bootstraps/s; {wrong} wrong, margin "
        f"{sigmas:.2f} sigma")
    assert wrong == 0, f"{wrong}/{batch} wrong NAND outputs at {p.name}"
    assert sigmas >= MIN_SIGMAS, f"margin {sigmas:.2f} sigma < {MIN_SIGMAS}"
    return res, ck


def run_pbs(p, batch: int, seed: int = 5) -> None:
    """lut.bootstrap_lut of x -> 3x+1 mod m over random messages."""
    m = p.message_modulus
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    t0 = time.perf_counter()
    sk = tfhe.gen_secret_key(k1, p)
    ck = _sync(tfhe.gen_cloud_key(k2, sk, p))
    keygen_s = time.perf_counter() - t0
    msgs = np.random.default_rng(seed).integers(0, m, batch)
    ct = cipher.lwe_encrypt_message(k3, msgs, m, p.lwe_alpha, sk.lv0)
    table = lut.Generator(p, m).gen_lut(lambda x: (3 * x + 1) % m)
    t0 = time.perf_counter()
    out = _sync(lut.bootstrap_lut(ck, ct, table))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _sync(lut.bootstrap_lut(ck, ct, table))
    steady_s = time.perf_counter() - t0
    dec = np.asarray(cipher.lwe_decrypt_message(out, m, sk.lv0))
    wrong = int((dec != (3 * msgs + 1) % m).sum())
    log(f"PBS {p.name} batch {batch} [{CARD}]: keygen {keygen_s:.3f} s, "
        f"first batch {first_s:.3f} s, steady {steady_s:.6f} s/batch = "
        f"{batch / steady_s:.1f} PBS/s; {wrong} wrong")
    assert wrong == 0, f"{wrong}/{batch} wrong PBS outputs at {p.name}"


def run_manylut_adder(p, batch: int, bits: int = 8, seed: int = 7) -> None:
    """adders.ripple_add_manylut: ``bits``-bit adds, one bootstrap per bit."""
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    t0 = time.perf_counter()
    sk = tfhe.gen_secret_key(k1, p)
    ck = _sync(tfhe.gen_cloud_key(k2, sk, p))
    keygen_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    va, vb = rng.integers(0, 1 << bits, (2, batch))

    def enc(key, vals):
        b = np.stack([(vals >> i) & 1 for i in range(bits)], axis=-1)
        return cipher.lwe_encrypt_message(key, b, 8, p.lwe_alpha, sk.lv0)

    ct_a, ct_b = enc(k3, va), enc(k4, vb)
    t0 = time.perf_counter()
    s_bits, carry = _sync(adders.ripple_add_manylut(ck, ct_a, ct_b))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_bits, carry = _sync(adders.ripple_add_manylut(ck, ct_a, ct_b))
    steady_s = time.perf_counter() - t0
    s = np.asarray(cipher.lwe_decrypt_message(s_bits, 8, sk.lv0))
    cout = np.asarray(cipher.lwe_decrypt_message(carry, 8, sk.lv0))
    got = (s.astype(np.int64) << np.arange(bits)).sum(-1) + (
        cout.astype(np.int64) << bits)
    wrong = int((got != va + vb).sum())
    log(f"many-LUT {bits}-bit add {p.name} batch {batch} [{CARD}]: keygen "
        f"{keygen_s:.3f} s, first {first_s:.3f} s, steady {steady_s:.6f} "
        f"s/batch = {batch * bits / steady_s:.1f} full adders/s; "
        f"{wrong} wrong")
    assert wrong == 0, f"{wrong}/{batch} wrong sums at {p.name}"


# ---------------------------------------------------------------------------
# (d) four cards.
# ---------------------------------------------------------------------------

def run_four(p, per_device: int, seed: int = 9) -> None:
    """sharded_bootstrap over every device vs one device, bit for bit."""
    from go_tfhe_jax.parallel import (make_mesh, replicate_keys,
                                      sharded_bootstrap)

    devs = jax.devices()
    batch = per_device * len(devs)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    sk = tfhe.gen_secret_key(k1, p)
    ck = _sync(tfhe.gen_cloud_key(k2, sk, p))
    rng = np.random.default_rng(seed)
    bits_a = rng.integers(0, 2, batch).astype(bool)
    bits_b = rng.integers(0, 2, batch).astype(bool)
    ct = engine.prepare_nand(
        tfhe.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0),
        tfhe.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0))
    mesh = make_mesh()
    ck_r = _sync(replicate_keys(mesh, ck))
    t0 = time.perf_counter()
    out = _sync(sharded_bootstrap(mesh, ck_r, ct))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _sync(sharded_bootstrap(mesh, ck_r, ct))
    steady_s = time.perf_counter() - t0
    assert len(out.sharding.device_set) == len(devs), out.sharding
    one = _sync(engine.bootstrap(ck, jax.device_put(ct, devs[0])))
    t0 = time.perf_counter()
    one = _sync(engine.bootstrap(ck, jax.device_put(ct, devs[0])))
    one_s = time.perf_counter() - t0
    bad = int((np.asarray(out) != np.asarray(one)).sum())
    want = ~(bits_a & bits_b)
    wrong = int((np.asarray(tfhe.lwe_decrypt_bool(out, sk.lv0)) != want).sum())
    log(f"(d) sharded NAND {p.name} batch {batch} over {len(devs)} devices "
        f"[{CARD}]: first {first_s:.3f} s, steady {steady_s:.6f} s = "
        f"{batch / steady_s:.1f} bootstraps/s; one device {one_s:.6f} s = "
        f"{batch / one_s:.1f} bootstraps/s; {bad} words differ from one "
        f"device, {wrong} wrong")
    assert bad == 0, "sharded result differs from the one-device result"
    assert wrong == 0, f"{wrong}/{batch} wrong sharded NAND outputs"


# ---------------------------------------------------------------------------

def _card() -> str:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return q.stdout.strip()


def main() -> None:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only phase (d): the sharded bootstrap on four "
                         "cards against one card")
    args = ap.parse_args()

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: the default JAX device is "
              f"{devs[0].platform!r}, not a GPU; refusing to run",
              file=sys.stderr)
        sys.exit(2)
    if args.four and len(devs) != 4:
        print(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    rows = _card()
    CARD = rows.splitlines()[0]
    log(f"nvidia-smi name, power.limit:\n{rows}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"devices: {len(devs)} x {devs[0].device_kind}")
    log(f"compilation cache: {enable_compilation_cache()}")

    fast = tfhe.get_params("128bit_fast")
    t_start = time.perf_counter()
    if args.four:
        run_four(fast, per_device=4096)
    else:
        for name in ("128bit_fast", "128bit", "uint5", "uint6_centered"):
            check_extprod(tfhe.get_params(name))
        check_rotation(fast)
        check_keygen_and_keyswitch(fast, rows=2 * fast.l * fast.lwe_n)
        res, ck = run_nand(fast, 4096)                          # (b)
        check_matmul_types(ck, 4096)
        del ck
        run_nand(tfhe.P128, 1024, reps=2)                       # (c)
        run_pbs(tfhe.get_params("uint6_centered"), 256)
        run_manylut_adder(fast, 1024)
        log(f"headline [{CARD}]: {res['bootstraps_per_s']:.1f} NAND "
            f"bootstraps/s at 128bit_fast batch 4096")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s [{CARD}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
