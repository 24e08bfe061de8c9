"""The ``ffmetrics/1`` stream: one JSON record per serve window.

Counterpart of ``flexflow_tpu/obs/metrics.py`` as far as the engine's
window records need it: :func:`step_record` builds a record with every
field of the JAX vocabulary (unmeasured ones ``None``) and
:class:`MetricsStream` appends records as JSONL.  A stream written here
reads back through ``flexflow_tpu.obs.read_metrics``.  Stream rotation
(``max_mb``) is not ported yet.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional

from flexflow_tpu_torch.obs.schemas import METRICS_SCHEMA

__all__ = ["METRICS_SCHEMA", "RECORD_FIELDS", "MetricsStream", "json_safe", "step_record"]

# the full record vocabulary, pre-seeded to None in every record
RECORD_FIELDS = (
    "step", "t", "loss", "grad_norm", "param_norm", "samples_per_s",
    "tokens_per_s", "step_wall_s", "host_s", "dispatch_s", "device_s",
    "host_stall_s", "compile_s", "jit_cache", "hbm_peak_bytes",
    "predicted_step_s", "predicted_tok_s", "pipeline_stages",
    "microbatches", "bubble_frac", "analysis_violations", "exposed_comm_s",
)


def json_safe(v):
    """Encode non-finite floats as strings so a record stays strict JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return "NaN" if math.isnan(v) else ("Inf" if v > 0 else "-Inf")
    if isinstance(v, dict):
        return {k: json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    return v


def step_record(
    step: int,
    t: float,
    *,
    step_wall_s: Optional[float] = None,
    host_stall_s: Optional[float] = None,
    samples: Optional[int] = None,
    tokens: Optional[int] = None,
    hbm_peak_bytes: Optional[float] = None,
    metrics: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One schema-conformant record; throughput is derived here from
    ``samples``/``tokens`` over ``step_wall_s``."""
    rec: Dict[str, Any] = {"schema": METRICS_SCHEMA}
    rec.update({k: None for k in RECORD_FIELDS})
    rec["step"] = int(step)
    rec["t"] = float(t)
    for k, v in (("step_wall_s", step_wall_s), ("host_stall_s", host_stall_s),
                 ("hbm_peak_bytes", hbm_peak_bytes)):
        if v is not None:
            rec[k] = float(v)
    if step_wall_s and step_wall_s > 0:
        if samples is not None:
            rec["samples_per_s"] = samples / step_wall_s
        if tokens is not None:
            rec["tokens_per_s"] = tokens / step_wall_s
    rec["counters"] = {}
    rec["metrics"] = dict(metrics) if metrics else {}
    return rec


class MetricsStream:
    """Append-only JSONL writer, opened at the first append (a run that
    never appends leaves no file) and flushed per record."""

    def __init__(self, path: Optional[str]) -> None:
        self.path = path
        self.enabled = bool(path)
        self.records_written = 0
        self._f = None

    def append(self, record: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
        self._f.write(json.dumps(json_safe(record)) + "\n")
        self._f.flush()
        self.records_written += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
