"""Cost model / memory accounting sanity (SURVEY.md §5 tracing subsystem)."""

import go_tfhe_jax as tfhe
import pytest

from go_tfhe_jax.utils.profiling import (DEVICE_PEAKS, bootstrap_cost,
                                         bootstrap_utilization,
                                         key_memory_usage,
                                         speed_of_light_report)

H100 = "NVIDIA H100 80GB HBM3"


def test_bootstrap_cost_p128():
    c = bootstrap_cost(tfhe.P128, batch=4096)
    assert c.steps == 700
    # (2L*N)*2*(4 col groups)*N per step: 6144 * 8192 MACs, x700 steps.
    assert c.macs_per_ct == 6144 * 8192 * 700
    assert c.seconds_at(DEVICE_PEAKS[H100]["int8_tops"]) > 0
    # int8 limbs: 4 limbs x 700 rows x (2L=6) x 2 channels x 2N bytes
    assert c.bsk_bytes == 4 * 700 * 6 * 2 * 2048


def test_cost_scales_with_digit_limbs():
    c1 = bootstrap_cost(tfhe.P128)     # 1 digit limb -> 4 column groups
    c3 = bootstrap_cost(tfhe.get_params("uint5"))  # 3 limbs -> 4+3+2 groups
    assert tfhe.get_params("uint5").digit_limbs == 3
    per_step_1 = c1.macs_per_ct / c1.steps / (2 * tfhe.P128.l * tfhe.P128.n ** 2)
    per_step_3 = c3.macs_per_ct / c3.steps / (
        2 * tfhe.get_params("uint5").l * tfhe.get_params("uint5").n ** 2)
    assert per_step_1 == 2 * 4
    assert per_step_3 == 2 * 9


def test_speed_of_light_report_renders():
    rep = speed_of_light_report(tfhe.P128, 2000.0, H100)
    assert "speed of light" in rep and "2000" in rep and H100 in rep


def test_unknown_device_has_no_peaks():
    """A device missing from the peak table is an error, not a default."""
    with pytest.raises(KeyError, match="no published peaks"):
        bootstrap_utilization(tfhe.P128, 2000.0, "cpu")


def test_key_memory_usage(fast_keys):
    _, _, ck = fast_keys
    mem = key_memory_usage(ck)
    assert mem["bsk"] > 0 and mem["ksk"] > 0
    assert mem["total"] == sum(v for k, v in mem.items() if k != "total")


def test_metrics_logger(tmp_path):
    """Library-level metrics emission (utils/metrics.py): JSON lines to a
    stream and an optional file, records retrievable for summaries."""
    import io
    import json as _json
    from go_tfhe_jax.utils.metrics import MetricsLogger

    path = str(tmp_path / "m.jsonl")
    s = io.StringIO()
    m = MetricsLogger(path=path, stream=s)
    m.emit("throughput", 1234.0, unit="bootstraps/s", profile="128bit_fast")
    m.emit_seconds("latency", 0.5, unit_count=4096)
    m.close()
    recs = [
        _json.loads(ln) for ln in open(path).read().strip().splitlines()]
    assert recs == m.summary()
    assert recs[0]["metric"] == "throughput"
    assert recs[0]["profile"] == "128bit_fast"
    assert recs[1]["value"] == round(0.5 * 1e3 / 4096, 3)
    assert s.getvalue().count("\n") == 2
