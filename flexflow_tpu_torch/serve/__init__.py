"""Serving: paged KV cache, continuous batching, the serve engine,
preemption by spill and restore, drain and resume, the ``ffkv/1`` codec."""

from flexflow_tpu_torch.serve.engine import (
    DRAIN_SCHEMA,
    ServeEngine,
    ServeReport,
    load_drain,
    save_drain,
)
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
from flexflow_tpu_torch.serve.wire import (
    KV_SCHEMA,
    HandoffError,
    decode_handoff,
    encode_handoff,
    kv_payload_nbytes,
)

__all__ = [
    "PagedKVCache",
    "KVCacheOOM",
    "Request",
    "RequestState",
    "ContinuousBatchingScheduler",
    "ServeEngine",
    "ServeReport",
    "DRAIN_SCHEMA",
    "save_drain",
    "load_drain",
    "KV_SCHEMA",
    "HandoffError",
    "encode_handoff",
    "decode_handoff",
    "kv_payload_nbytes",
    "TrafficSpec",
    "synthetic_requests",
    "multi_tenant_requests",
]
