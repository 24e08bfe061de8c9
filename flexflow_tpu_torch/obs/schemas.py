"""Versioned file schemas the port writes.

A copy of the tags the port uses from ``flexflow_tpu/obs/schemas.py``;
the port registers no tag of its own, so every file it writes reads
back through the JAX package's readers.  Adding fields to a record
keeps its version (readers ignore unknown keys).
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["SCHEMAS", "METRICS_SCHEMA"]

METRICS_SCHEMA = "ffmetrics/1"

# tag -> (owning module, one-line description)
SCHEMAS: Dict[str, Tuple[str, str]] = {
    METRICS_SCHEMA: (
        "flexflow_tpu_torch/obs/metrics.py",
        "per-window serve metrics JSONL (--metrics-out)",
    ),
    "ffkv/1": (
        "flexflow_tpu_torch/serve/wire.py",
        "one request's KV handoff frame: .npz bytes, content digest",
    ),
    "ffdrain/1": (
        "flexflow_tpu_torch/serve/engine.py",
        "serve drain file: in-flight KV spills and queues (--serve-drain-file)",
    ),
}
