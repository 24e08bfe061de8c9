"""Serving: paged KV cache, continuous batching, the serve engine."""

from flexflow_tpu_torch.serve.engine import ServeEngine, ServeReport
from flexflow_tpu_torch.serve.kvcache import KVCacheOOM, PagedKVCache
from flexflow_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestState,
)
from flexflow_tpu_torch.serve.traffic import (
    TrafficSpec,
    multi_tenant_requests,
    synthetic_requests,
)

__all__ = [
    "PagedKVCache",
    "KVCacheOOM",
    "Request",
    "RequestState",
    "ContinuousBatchingScheduler",
    "ServeEngine",
    "ServeReport",
    "TrafficSpec",
    "synthetic_requests",
    "multi_tenant_requests",
]
