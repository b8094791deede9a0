"""Machine-checkable "zero collectives in the hot loop".

parallel/mesh.py's design claim — batch-sharded ciphertexts + replicated
keys compile to a fully LOCAL per-device program, with no interconnect
traffic inside the 700-step blind-rotate loop.  Here the sharded
bootstrap is compiled on the 8-device virtual mesh and the GSPMD-partitioned
HLO is walked: the module must contain the sequential while loop AND no
collective instruction anywhere (module-wide zero is strictly stronger than
loop-body zero).  chip_smoke.py --four measures the scaling on cards.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_tfhe_jax as tfhe
from go_tfhe_jax import engine
from go_tfhe_jax.parallel import mesh as meshlib

# HLO collective instructions (a match means cross-device communication).
_COLLECTIVES = ("all-reduce", "all-gather", "all-to-all",
                "collective-permute", "collective-broadcast",
                "reduce-scatter", "ragged-all-to-all")
# An HLO instruction line: `%name = type opcode(...)` / `name = type op(...)`.
_OP_RE = re.compile(
    r"=\s*[^\s]+\s+(" + "|".join(_COLLECTIVES) + r")(-start|-done)?\(")


def _partitioned_hlo(mesh, ck, ct):
    """Compile the sharded bootstrap exactly as sharded_bootstrap runs it
    (shardings carried on the arguments) and return the optimized HLO."""
    ck_r = meshlib.replicate_keys(mesh, ck)
    ct_s = meshlib.shard_batch(mesh, ct)
    p = ck.params
    lowered = engine._bootstrap_core.lower(
        p, True, ck_r.bsk_limbs, ck_r.ksk, ct_s, ck_r.testvec)
    return lowered.compile().as_text()


def _partitioned_hlo_many(mesh, ck, ct):
    """Same check for the many-LUT core (engine.bootstrap_many)."""
    ck_r = meshlib.replicate_keys(mesh, ck)
    ct_s = meshlib.shard_batch(mesh, ct)
    p = ck.params
    lowered = engine._bootstrap_core_many.lower(
        p, True, 2, 1, ck_r.bsk_limbs, ck_r.ksk, ct_s, ck_r.testvec)
    return lowered.compile().as_text()


def test_sharded_bootstrap_has_zero_collectives(fast_keys):
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    mesh = meshlib.make_mesh()
    p, sk, ck = fast_keys
    ct = jnp.zeros((16, p.lwe_n + 1), jnp.uint32)

    hlo = _partitioned_hlo(mesh, ck, ct)

    # (a) the program was actually partitioned over 8 devices ...
    assert re.search(r"num_partitions\s*=\s*8", hlo) or "devices=[" in hlo, \
        "expected an 8-way partitioned module"
    # (b) ... the sequential blind-rotate loop is present ...
    assert re.search(r"\bwhile\(", hlo) or " while(" in hlo, \
        "expected the blind-rotate while loop in the compiled module"
    # (c) ... and NOT ONE collective instruction exists anywhere.
    bad = [ln.strip() for ln in hlo.splitlines() if _OP_RE.search(ln)]
    assert not bad, (
        "collectives found in the partitioned bootstrap HLO:\n"
        + "\n".join(bad[:20]))


def test_sharded_bootstrap_many_has_zero_collectives(fast_keys):
    """The multi-LUT bootstrap (k=2 extractions + batched key switch)
    also partitions into a fully local per-chip program."""
    mesh = meshlib.make_mesh()
    p, sk, ck = fast_keys
    ct = jnp.zeros((16, p.lwe_n + 1), jnp.uint32)
    hlo = _partitioned_hlo_many(mesh, ck, ct)
    assert re.search(r"\bwhile\(", hlo) or " while(" in hlo
    bad = [ln.strip() for ln in hlo.splitlines() if _OP_RE.search(ln)]
    assert not bad, (
        "collectives found in the partitioned many-LUT bootstrap HLO:\n"
        + "\n".join(bad[:20]))


def test_detector_catches_a_real_collective(fast_keys):
    """Self-test of the detector: a program that genuinely needs an
    all-reduce must be flagged — guards against the opcode regex rotting
    with an XLA upgrade and the main assertion passing vacuously."""
    mesh = meshlib.make_mesh()
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = jax.device_put(np.ones((8, 128), np.float32),
                       NamedSharding(mesh, P("batch", None)))
    summed = jax.jit(
        lambda v: jnp.sum(v, axis=0),
        out_shardings=NamedSharding(mesh, P()))
    hlo = summed.lower(x).compile().as_text()
    assert any(_OP_RE.search(ln) for ln in hlo.splitlines()), \
        "detector failed to flag a cross-shard reduction"
