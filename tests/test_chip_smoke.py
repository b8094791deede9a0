"""chip_smoke.py: refuses anything but a GPU, and its phase functions run
end to end at toy sizes (here the CPU device stands in for the card)."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs
import go_tfhe_jax as tfhe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_non_gpu_device():
    r = _run(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


def test_fails_without_the_repo(tmp_path):
    """Alone in a directory, the script cannot import the system and fails
    without printing a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("name", ["test_fast", "test_ext2", "test_nibble"])
def test_phase_a_extprod(name):
    cs.check_extprod(tfhe.get_params(name), batch=4)


def test_phase_a_rotation():
    cs.check_rotation(tfhe.TEST_FAST, steps=4, batch=2)


def test_phase_a_keygen_and_keyswitch():
    cs.check_keygen_and_keyswitch(tfhe.TEST_FAST, rows=8, batch=4)


def test_phase_b_nand_and_matmul_types():
    res, ck = cs.run_nand(tfhe.TEST_FAST, 16, reps=1)
    assert res["wrong"] == 0 and res["margin_sigmas"] >= cs.MIN_SIGMAS
    cs.check_matmul_types(ck, 16)


def test_phase_c_pbs():
    cs.run_pbs(tfhe.TEST_EXT2, 8)


def test_phase_c_manylut_adder():
    cs.run_manylut_adder(tfhe.TEST_NIBBLE, 2, bits=2)


def test_phase_d_sharded_matches_one_device():
    """Batch-sharded over the 8 virtual CPU devices == one device."""
    cs.run_four(tfhe.TEST_FAST, 2)
