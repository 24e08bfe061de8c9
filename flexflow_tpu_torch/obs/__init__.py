"""Observability of the port: the ``ffmetrics/1`` window records."""

from flexflow_tpu_torch.obs.metrics import MetricsStream, step_record
from flexflow_tpu_torch.obs.schemas import METRICS_SCHEMA, SCHEMAS

__all__ = ["METRICS_SCHEMA", "SCHEMAS", "MetricsStream", "step_record"]
