"""Profiling, cost modeling and speed-of-light analysis.

The reference has no tracing at all — only ad-hoc wall-clock prints and a
byte-accounting helper (``evaluator/buffers.go:214-240``,
``poly/buffer_manager.go:145-172``); SURVEY.md §5 maps this subsystem to JAX
profiler traces plus analytic per-kernel cost tables.  Everything here is
host-side and dependency-free.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Set, Tuple

import jax

from ..params import TFHEParams

# Published dense peaks per accelerator, keyed by jax.Device.device_kind
# (NVIDIA H100 SXM data sheet and the Hopper architecture white paper; they
# assume the card's full 700 W power limit).  Used only for speed-of-light
# ratios; a device missing here is an error, not a default.
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "int8_tops": 1979.0,
                              "hbm_gbps": 3350.0},
}

NUM_KERNEL_LIMBS = 4  # base-256 limbs of the 32-bit BSK band (ops/polymul.py)


def device_peaks(device_kind: str) -> Dict[str, float]:
    """Peak table entry for ``device_kind``; raises for an unknown device."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}") from None


@dataclasses.dataclass(frozen=True)
class BootstrapCost:
    """Analytic cost of one batched gate/PBS bootstrap."""
    batch: int
    steps: int                  # n_lwe sequential CMUX iterations
    macs_per_ct: float          # int8 matmul MACs per ciphertext
    flops_per_ct: float
    bsk_bytes: int              # resident int8 key limbs (CloudKey.bsk_limbs)
    ksk_bytes: int

    def seconds_at(self, tops: float) -> float:
        """Compute-bound lower bound for the whole batch at ``tops`` T(FL)OP/s."""
        return self.batch * self.flops_per_ct / (tops * 1e12)

    def bootstraps_per_sec_at(self, tops: float) -> float:
        return self.batch / self.seconds_at(tops)


def bootstrap_cost(p: TFHEParams, batch: int = 1) -> BootstrapCost:
    """Cost model of the int8 external product (ops/polymul.py).

    Per step and ciphertext the contraction meets digit limbs (ND, 2L, N)
    with Toeplitz columns; digit limb i hits (NUM_LIMBS - drop - i)
    key-limb column groups of width N, for both output channels:

        MACs/step/ct = (2L*N) * 2 * sum_i (NUM_LIMBS - drop - i) * N
    """
    drop = p.kernel_limb_drop
    col_groups = sum(NUM_KERNEL_LIMBS - drop - i
                     for i in range(p.digit_limbs))
    macs_step = (2 * p.l * p.n) * 2 * col_groups * p.n
    macs = float(macs_step) * p.lwe_n
    bsk_bytes = (NUM_KERNEL_LIMBS - drop) * p.lwe_n * 2 * p.l * 2 * 2 * p.n
    ksk_bytes = p.n * p.iks_t * p.base * (p.lwe_n + 1) * 4
    return BootstrapCost(batch=batch, steps=p.lwe_n, macs_per_ct=macs,
                         flops_per_ct=2 * macs, bsk_bytes=bsk_bytes,
                         ksk_bytes=ksk_bytes)


def speed_of_light_report(p: TFHEParams, measured_bootstraps_per_sec: float,
                          device_kind: str) -> str:
    """Human-readable speed-of-light table for the bootstrap hot loop."""
    peak = device_peaks(device_kind)["int8_tops"]
    c = bootstrap_cost(p)
    sol = c.bootstraps_per_sec_at(peak)
    util = measured_bootstraps_per_sec / sol
    lines = [
        f"profile {p.name}: {c.steps} blind-rotate steps, "
        f"{p.digit_limbs} digit limb(s), int8 matmul",
        f"  compute/ct:      {c.flops_per_ct / 1e9:.2f} GOP",
        f"  BSK limbs:       {c.bsk_bytes / 1e6:.1f} MB resident",
        f"  KSK:             {c.ksk_bytes / 1e6:.1f} MB resident",
        f"  speed of light:  {sol:.0f} bootstraps/s at {peak:.0f} TOP/s "
        f"({device_kind})",
        f"  measured:        {measured_bootstraps_per_sec:.0f} bootstraps/s "
        f"({100 * util:.1f}% of SoL)",
    ]
    return "\n".join(lines)


def bootstrap_utilization(p: TFHEParams, measured_bootstraps_per_sec: float,
                          device_kind: str) -> Dict[str, object]:
    """Machine-readable share of the int8 peak for bench JSON records."""
    c = bootstrap_cost(p)
    sol = c.bootstraps_per_sec_at(device_peaks(device_kind)["int8_tops"])
    return {
        "gop_per_ct": round(c.flops_per_ct / 1e9, 2),
        "sol_bootstraps_per_sec": round(sol, 0),
        "int8_peak_share": round(measured_bootstraps_per_sec / sol, 4),
    }


def dot_operand_types(fn, *args) -> Set[Tuple[str, str]]:
    """(lhs dtype, rhs dtype) of every dot_general in the jaxpr of the
    jitted ``fn`` at ``args``, nested jaxprs (jit, loops, conditionals)
    included.  Shows which matmul
    unit a program asks for: int8 x int8 and bf16 run on tensor cores; an
    s32 x s32 dot does not, and an f32 x f32 dot may round through TF32."""
    found: Set[Tuple[str, str]] = set()

    def walk(jaxpr) -> None:
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                lhs, rhs = eqn.invars[:2]
                found.add((str(lhs.aval.dtype), str(rhs.aval.dtype)))
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        walk(sub)

    walk(fn.trace(*args).jaxpr.jaxpr)
    return found


def key_memory_usage(ck) -> Dict[str, int]:
    """Byte accounting of a CloudKey (the reference's
    BufferPool.MemoryUsage analogue)."""
    out = {}
    for name in ("testvec", "ksk", "bsk", "bsk_limbs"):
        arr = getattr(ck, name)
        out[name] = arr.size * arr.dtype.itemsize
    out["total"] = sum(out.values())
    return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """JAX profiler trace scope; view with TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
