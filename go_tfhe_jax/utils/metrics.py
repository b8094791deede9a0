"""Structured metrics emission — the library-level observability hook.

The reference has no logging/metrics at all (SURVEY.md §5: fmt.Printf in
examples only); this framework's de-facto observability subsystem is
JSON-line metric records (the BENCH/MICRO/NOISE/EXT artifacts).  This
module makes that discipline a library facility instead of per-script
boilerplate: one record per metric, machine-parseable, optionally teed to
a file, with the collected records retrievable for a summary artifact.

Usage:
    from go_tfhe_jax.utils.metrics import MetricsLogger
    m = MetricsLogger(path="run_metrics.jsonl")   # path optional
    m.emit("gate_bootstraps_per_sec", 8377.0, unit="bootstraps/s",
           profile="128bit_fast")
    ...
    m.summary()          # -> list of all records
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional


class MetricsLogger:
    """Collects and emits one-line JSON metric records."""

    def __init__(self, path: Optional[str] = None, stream=None):
        self.records: List[Dict[str, Any]] = []
        self._stream = sys.stdout if stream is None else stream
        self._file = open(path, "a") if path else None

    def emit(self, metric: str, value, unit: str = "", **fields) -> dict:
        rec = {"metric": metric, "value": value}
        if unit:
            rec["unit"] = unit
        rec.update(fields)
        self.records.append(rec)
        line = json.dumps(rec)
        print(line, file=self._stream, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        return rec

    def emit_seconds(self, metric: str, seconds: float,
                     unit_count: float = 1.0, unit: str = "ms",
                     **fields) -> dict:
        """Convenience for timings: seconds -> ms (optionally per-unit)."""
        return self.emit(metric, round(seconds * 1e3 / unit_count, 3),
                         unit=unit, **fields)

    def summary(self) -> List[Dict[str, Any]]:
        return list(self.records)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
