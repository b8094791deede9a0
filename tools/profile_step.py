"""Trace the 128bit_fast gate bootstrap on the GPU and reduce the trace to
device time per kernel and per kernel class.

Usage: python tools/profile_step.py [--profile 128bit_fast] [--batch 4096]
                                    [--out chiprun_out/trace]

Runs keygen and one warm-up NAND batch, then traces ``--reps`` batches.
Prints the device busy time, the idle share of the traced window, and the
kernels that take the device time, largest first, each with the HLO
instruction it runs (the trace's ``hlo_op``), the opcodes inside it and a
class:
  gemm              the external product's int8 GEMM (inside the loop)
  keyswitch         the key switch's int8 GEMM (outside the loop)
  rotate            fusions holding the rotation's gather (and the CMUX
                    difference XLA fuses into them)
  decompose         fusions shifting, masking and casting the digits to int8
  fusion            other XLA fusions: Toeplitz build, limb recombination,
                    CMUX adds, transposes
  other             copies, memsets and the rest
The trace itself stays under --out for TensorBoard/XProf.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import go_tfhe_jax as tfhe
from go_tfhe_jax import engine
from go_tfhe_jax.utils.cache import enable_compilation_cache


def hlo_index(hlo: str):
    """Optimized HLO text -> {kernel name: (opcode set of what it runs,
    inside the blind-rotate loop?)} for fusions and custom calls."""
    comps, cur = {}, None
    for line in hlo.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
        if head:
            cur = comps.setdefault(head.group(1), set())
            continue
        op = re.match(r"\s*(?:ROOT )?%?[\w.\-]+ = \S+ ([\w\-]+)\(", line)
        if op and cur is not None:
            cur.add(op.group(1))
    out = {}
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = .*? (fusion|custom-call)\(",
                     line)
        if not m:
            continue
        calls = re.search(r"calls=%?([\w.\-]+)", line)
        ops = set(comps.get(calls.group(1), ())) if calls else set()
        target = re.search(r'custom_call_target="([^"]+)"', line)
        if target:
            ops.add(target.group(1))
        # kernels are named after their instruction with '.' -> '_'
        out[m.group(1).replace(".", "_")] = (ops, "/while/" in line)
    return out


def kernel_class(name: str, hlo_op: str | None, index, launches: int,
                 batches: int) -> str:
    """The class of one kernel (see the module docstring).

    A fusion kernel carries its HLO instruction's name; library GEMM
    kernels do not, and inside a command buffer ``hlo_op`` names the
    buffer, so a GEMM launched once per step is the external product's and
    one launched once per batch the key switch's."""
    key = hlo_op if hlo_op in index else name
    ops, _ = index.get(key, (set(), False))
    low = name.lower()
    if "gemm" in low or any("cublas" in o for o in ops):
        return "gemm" if launches > batches else "keyswitch"
    if "gather" in ops:
        return "rotate"
    if {"shift-right-logical", "convert"} <= ops and "transpose" not in ops:
        return "decompose"
    if ops or "fusion" in low:
        return "fusion"
    return "other"


def device_events(trace_dir: str):
    """(kernel name, hlo_op or None, start_ns, duration_ns) of every event
    on a GPU device plane."""
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                out.append((ev.name, stats.get("hlo_op"), ev.start_ns,
                            ev.duration_ns))
    return out


def busy_ns(events) -> float:
    """Union of the event intervals."""
    total, end = 0.0, -1.0
    for _, _, s, d in sorted(events, key=lambda e: e[2]):
        if s + d <= end:
            continue
        total += s + d - max(s, end)
        end = s + d
    return total


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="128bit_fast")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/trace")
    args = ap.parse_args()
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"profile_step: default device is {dev.platform}, not a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()

    p = tfhe.get_params(args.profile)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    sk = tfhe.gen_secret_key(k1, p)
    ck = tfhe.gen_cloud_key(k2, sk, p)
    ct = tfhe.lwe_encrypt_bool(k3, np.resize([False, True], args.batch),
                               p.lwe_alpha, sk.lv0)
    prepared = engine.prepare_nand(ct, ct)
    jax.block_until_ready(engine.bootstrap(ck, prepared))

    hlo = engine._bootstrap_core.lower(
        p, True, ck.bsk_limbs, ck.ksk, prepared, ck.testvec).compile().as_text()
    index = hlo_index(hlo)

    t0 = time.perf_counter()
    with jax.profiler.trace(args.out):
        for _ in range(args.reps):
            out = engine.bootstrap(ck, prepared)
        jax.block_until_ready(out)
    wall = time.perf_counter() - t0

    events = device_events(args.out)
    span = (max(s + d for _, _, s, d in events)
            - min(s for _, _, s, _ in events))
    busy = busy_ns(events)
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    for name, op, _, d in events:
        by_kernel[(name, op)][0] += d
        by_kernel[(name, op)][1] += 1
    by_class = collections.defaultdict(float)
    for (name, op), (d, cnt) in by_kernel.items():
        by_class[kernel_class(name, op, index, cnt, args.reps)] += d
    total = sum(by_class.values())
    print(f"{p.name} batch {args.batch} x {args.reps} on [{card}]: "
          f"traced wall {wall:.4f} s, device span {span / 1e9:.4f} s, busy "
          f"{busy / 1e9:.4f} s, idle share {1 - busy / span:.4f}")
    for cls, d in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  class {cls:<16} {d / 1e6:10.3f} ms  {d / total:.4f}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    for (name, op), (d, cnt) in top:
        key = op if op in index else name
        ops = sorted(index.get(key, (set(), False))[0] - {"parameter"})
        print(f"  {d / 1e6:10.3f} ms {cnt:6d}x  "
              f"{kernel_class(name, op, index, cnt, args.reps):<16} "
              f"{name[:60]} {ops[:10]}")


if __name__ == "__main__":
    main()
