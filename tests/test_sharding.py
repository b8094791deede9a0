"""Multi-chip sharding on a virtual 8-device CPU mesh.

The production parallelism (SURVEY.md §2 parallelism inventory): ciphertext
batch sharded over the mesh, keys replicated, zero collectives in the blind-
rotate loop.  These tests assert (a) sharded == unsharded bit-exactly, and
(b) the jitted program actually runs under explicit NamedShardings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import go_tfhe_jax as tfhe
from go_tfhe_jax import cipher, engine, gates
from go_tfhe_jax.parallel import mesh as meshlib


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return meshlib.make_mesh()


def test_mesh_has_8_devices(mesh8):
    assert mesh8.devices.size == 8


def test_sharded_bootstrap_matches_unsharded(fast_keys, mesh8):
    p, sk, ck = fast_keys
    bits = np.resize([True, False, False, True], 16)
    ct = cipher.lwe_encrypt_bool(jax.random.PRNGKey(0), bits, p.lwe_alpha,
                                 sk.lv0)
    prepared = engine.prepare_and(ct, ct)

    ref = engine.bootstrap(ck, prepared)
    out = meshlib.sharded_bootstrap(mesh8, ck, prepared)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))
    dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
    np.testing.assert_array_equal(dec, bits)     # AND(a, a) == a


def test_output_sharding_preserved(fast_keys, mesh8):
    """The batch axis stays sharded through the jitted bootstrap — no
    accidental all-gather of results."""
    p, sk, ck = fast_keys
    ct = jnp.zeros((8, p.lwe_n + 1), jnp.uint32)
    ct = meshlib.shard_batch(mesh8, ct)
    ck_r = meshlib.replicate_keys(mesh8, ck)
    out = engine.bootstrap(ck_r, ct)
    assert out.sharding.spec[0] == meshlib.BATCH_AXIS


def test_gate_on_sharded_inputs(fast_keys, mesh8):
    p, sk, ck = fast_keys
    a = np.resize([True, False], 8)
    b = np.resize([True, True, False, False], 8)
    ka, kb = jax.random.split(jax.random.PRNGKey(1))
    ca = meshlib.shard_batch(
        mesh8, cipher.lwe_encrypt_bool(ka, a, p.lwe_alpha, sk.lv0))
    cb = meshlib.shard_batch(
        mesh8, cipher.lwe_encrypt_bool(kb, b, p.lwe_alpha, sk.lv0))
    ck_r = meshlib.replicate_keys(mesh8, ck)
    out = gates.XOR(ck_r, ca, cb)
    dec = np.asarray(cipher.lwe_decrypt_bool(out, sk.lv0))
    np.testing.assert_array_equal(dec, a ^ b)


def test_dryrun_multichip_entrypoint():
    """The driver-facing multi-chip dry run must execute on N devices."""
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)
