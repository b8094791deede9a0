"""Multi-host (multi-process) smoke test on virtual CPU devices.

The reference has no distributed layer at all (SURVEY.md §5: goroutines in
one process).  This repo's multi-host story is ``jax.distributed.initialize``
plus the exact same sharded-bootstrap code (parallel/mesh.py).  Real pods
aren't available in CI, so this test runs the documented mechanism end to
end with TWO OS processes x 4 virtual CPU devices each — a genuine 2-process
GSPMD cluster with a coordinator, global mesh of 8, cross-process
device_puts, and a collective (global sum) — the same machinery a two-host
deployment uses.

Mirrors SURVEY.md §4's "test multi-node without a real cluster" prescription.
"""

import os
import socket
import subprocess
import sys

import pytest

# Runs in each worker process.  argv: [script, coordinator, process_id]
_WORKER = r"""
import sys
coordinator, pid = sys.argv[1], int(sys.argv[2])

import jax
jax.distributed.initialize(coordinator_address=coordinator,
                           num_processes=2, process_id=pid)
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine
from go_tfhe_jax.parallel import make_mesh, replicate_keys

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4, len(jax.local_devices())

mesh = make_mesh()

# 1. A collective across processes: global sum of a batch-sharded array.
local = np.arange(4, dtype=np.float32) + 4 * pid          # global 0..7
garr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("batch")), local, global_shape=(8,))
total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(garr)
np.testing.assert_allclose(np.asarray(total), 28.0)

# 2. The real workload: a batch-sharded gate bootstrap, keys replicated.
p = tfhe.TEST_FAST
k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(11), 4)
sk = tfhe.gen_secret_key(k1, p)          # same seed => same keys everywhere
ck = replicate_keys(mesh, tfhe.gen_cloud_key(k2, sk, p))

bits_a = np.resize([False, True], 8)
bits_b = np.resize([False, False, True, True], 8)
ct_a = np.asarray(cipher.lwe_encrypt_bool(k3, bits_a, p.lwe_alpha, sk.lv0))
ct_b = np.asarray(cipher.lwe_encrypt_bool(k4, bits_b, p.lwe_alpha, sk.lv0))

sharding = NamedSharding(mesh, P("batch", None))
ga = jax.make_array_from_process_local_data(
    sharding, ct_a[4 * pid:4 * pid + 4], global_shape=ct_a.shape)
gb = jax.make_array_from_process_local_data(
    sharding, ct_b[4 * pid:4 * pid + 4], global_shape=ct_b.shape)

out = engine.bootstrap(ck, engine.prepare_nand(ga, gb))
# Each process decrypts ITS local shard and checks the truth table.
local_rows = [s for s in out.addressable_shards]
want = ~(bits_a & bits_b)
for s in local_rows:
    idx = s.index[0].start or 0
    dec = np.asarray(cipher.lwe_decrypt_bool(jnp.asarray(s.data), sk.lv0))
    np.testing.assert_array_equal(dec, want[idx:idx + dec.shape[0]])

jax.distributed.shutdown()
print(f"proc{pid} ok", flush=True)
"""


def test_two_process_cluster(tmp_path):
    with socket.socket() as s:                       # pick a free port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coordinator = f"localhost:{port}"

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    # Import path for the workers; they stay on the CPU even on a host
    # with a card (one JAX process per card).
    env["PYTHONPATH"] = repo_root
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("PYTHONSTARTUP", None)

    procs = [
        subprocess.Popen([sys.executable, str(script), coordinator, str(i)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for i, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=420)
            outs.append(out)
            assert proc.returncode == 0, f"process {i} failed:\n{out}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert "proc0 ok" in outs[0] and "proc1 ok" in outs[1]
