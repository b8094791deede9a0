"""Device-mesh sharding for batched TFHE workloads.

Design (SURVEY.md §2 "Parallelism inventory"): the bootstrap is
embarrassingly parallel over independent ciphertexts, so the one production
sharding is

* ciphertext batch axis  -> sharded over the mesh ('batch'),
* keys (BSK/KSK/testvec) -> replicated (~160 MB at 128bit_fast — cheap vs.
  all-gathers inside the 700-step loop).

With these in/out shardings GSPMD compiles the *same* jitted bootstrap into a
fully local per-device program — zero collectives in the hot loop; the
interconnect is only used if a caller reshards.  Every device reaches every
other at the same rate, so the mesh is 1-D.  Scaling to several hosts is
``jax.distributed.initialize`` + the same code (keys replicated per host
once at startup).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import engine
from ..keys import CloudKey

BATCH_AXIS = "batch"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(mesh: Mesh, ct: jax.Array, axis_name: str = BATCH_AXIS):
    """Place ciphertexts with the leading batch dim sharded over the mesh."""
    spec = P(axis_name, *([None] * (ct.ndim - 1)))
    return jax.device_put(ct, NamedSharding(mesh, spec))


def replicate_keys(mesh: Mesh, ck: CloudKey) -> CloudKey:
    """Replicate every key array on all mesh devices."""
    repl = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, repl), ck)


def sharded_bootstrap(mesh: Mesh, ck: CloudKey, ct: jax.Array,
                      testvec: jax.Array | None = None,
                      axis_name: str = BATCH_AXIS) -> jax.Array:
    """Batched bootstrap with the batch axis sharded over the mesh.

    ``ct``: (B, lwe_n+1) with B divisible by the mesh size.  The jitted
    program is identical to the single-chip one; GSPMD partitions it.
    """
    ck = replicate_keys(mesh, ck)
    ct = shard_batch(mesh, ct, axis_name)
    if testvec is not None and testvec.ndim > 2:
        testvec = shard_batch(mesh, testvec, axis_name)
    return engine.bootstrap(ck, ct, testvec)


def multihost_initialize(**kwargs) -> None:
    """Multi-host entry point: wraps jax.distributed.initialize."""
    jax.distributed.initialize(**kwargs)
