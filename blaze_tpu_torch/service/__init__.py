"""Multi-query serving tier: admission control, priority scheduling,
cancellation, and a plan-fingerprint result cache over the executor.

Code map (details in docs/SERVICE.md):
  query.py     - Query record + lifecycle state machine
  admission.py - bounded priority queue, headroom + concurrency gates
  cache.py     - (fingerprint, partition) result cache, TTL/LRU/spill
  service.py   - QueryService: submit/poll/result/cancel/report, with
                 classified retries / host degradation
                 (blaze_tpu_torch/errors.py taxonomy, docs/ROBUSTNESS.md)
  wire.py      - service verbs over the gateway socket + ServiceClient
                 (reconnect-with-backoff, re-attach by query_id)
"""

from blaze_tpu_torch.service.admission import (
    AdmissionController,
    estimate_plan_device_bytes,
)
from blaze_tpu_torch.service.cache import ResultCache
from blaze_tpu_torch.service.query import (
    Query,
    QueryCancelled,
    QueryRejected,
    QueryState,
)
from blaze_tpu_torch.service.service import QueryService
from blaze_tpu_torch.service.wire import ServiceClient, ServiceError

__all__ = [
    "AdmissionController",
    "estimate_plan_device_bytes",
    "ResultCache",
    "Query",
    "QueryCancelled",
    "QueryRejected",
    "QueryState",
    "QueryService",
    "ServiceClient",
    "ServiceError",
]
