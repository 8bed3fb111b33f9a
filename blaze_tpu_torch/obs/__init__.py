"""blaze_tpu_torch.obs: unified tracing + metrics + runtime history.

Three complementary surfaces over one serving process:

  trace    per-query span trees (obs/trace.py), stitched across
           threads and cluster worker processes, exported as
           Perfetto-loadable Chrome trace JSON via the REPORT verb
           and `python -m blaze_tpu_torch trace <query_id>`;
  metrics  process-wide counters + bounded histograms with Prometheus
           text exposition (obs/metrics.py), folding in the
           `dispatch.*` perf-model counters and live admission/cache
           state, served by the METRICS verb;
  history  per-fingerprint execution-time records (obs/history.py) -
           the estimate feeding predicted-unmeetability shedding and
           (ROADMAP) replica routing;
  phases   per-phase duration rollup keyed by fingerprint class
           (obs/phases.py) - the diffable form behind `python -m
           blaze_tpu_torch regress`, which catches queue-wait creep and
           decode regressions invisible to e2e medians;
  slowlog  one structured JSON log line per over-threshold query
           (obs/slowlog.py).

The disabled path is one module-attribute check per seam
(`trace.ACTIVE`, same discipline as testing/chaos.py): tracing-off
runs add zero dispatches and no per-batch work. docs/OBSERVABILITY.md
has the span taxonomy and export formats.
"""

from blaze_tpu_torch.obs.history import RuntimeHistory
from blaze_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from blaze_tpu_torch.obs.phases import ROLLUP, PhaseRollup
from blaze_tpu_torch.obs.trace import (
    TraceRecorder,
    begin_trace,
    chrome_trace,
    get_trace,
    validate_chrome,
)

__all__ = [
    "REGISTRY",
    "ROLLUP",
    "MetricsRegistry",
    "PhaseRollup",
    "RuntimeHistory",
    "TraceRecorder",
    "begin_trace",
    "chrome_trace",
    "get_trace",
    "validate_chrome",
]
