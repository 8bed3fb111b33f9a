"""Structured slow-query log: one JSON line per offending query.

A query that blows its wall threshold emits a single machine-parseable
log line with everything a human (or a log pipeline) needs to triage
it without replaying: lifecycle phase durations, retry/degradation
flags, the per-phase span rollup from the trace, and the hottest
operators from the mirrored metric tree. One line, not a report -
slow-query logs get grepped and shipped, not read in place.

Threshold: QueryService(slow_query_s=...), default 5s, overridable via
BLAZE_SLOW_QUERY_S. Setting it <= 0 disables the log.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict

log = logging.getLogger("blaze_tpu_torch.slowlog")


def build_payload(q, threshold_s: float) -> Dict[str, Any]:
    """Assemble the slow-query record from a terminal Query (split
    from emit() so tests and the REPORT surface can reuse it)."""
    t = q.timings
    finished = t.get("finished", t["submitted"])
    payload: Dict[str, Any] = {
        "event": "slow_query",
        "query_id": q.query_id,
        "state": q.state.value,
        "wall_s": round(finished - t["submitted"], 6),
        "threshold_s": threshold_s,
        "priority": q.priority,
    }
    if q._fingerprint is not None:
        payload["fingerprint"] = q._fingerprint[:16]
    phases: Dict[str, float] = {}
    if "admitted" in t:
        phases["queue_wait_s"] = round(t["admitted"] - t["submitted"], 6)
    if "run_start" in t and "admitted" in t:
        phases["admission_s"] = round(t["run_start"] - t["admitted"], 6)
    if "run_start" in t:
        phases["execution_s"] = round(finished - t["run_start"], 6)
    if "stream_ns" in t:
        phases["stream_s"] = round(t["stream_ns"] / 1e9, 6)
    payload["phases"] = phases
    retries = sum(1 for a in q.attempts if a.get("action") == "retry")
    if retries:
        payload["retries"] = retries
    if q.degraded:
        payload["degraded"] = True
    if q.error_class:
        payload["error_class"] = q.error_class
    if q.error:
        payload["error"] = str(q.error)[:300]
    tracer = getattr(q, "tracer", None)
    if tracer is not None:
        # per-span-name duration rollup: where inside execution the
        # time went (attempt / parquet_decode / h2d / kernel_dispatch
        # / cache_probe / host_degrade ...)
        rollup: Dict[str, Dict[str, float]] = {}
        for s in list(tracer.spans):
            if s.end_ns is None or s is tracer.root:
                continue
            r = rollup.setdefault(s.name, {"count": 0, "total_ms": 0.0})
            r["count"] += 1
            r["total_ms"] += (s.end_ns - s.start_ns) / 1e6
        payload["spans"] = {
            k: {"count": v["count"],
                "total_ms": round(v["total_ms"], 3)}
            for k, v in sorted(rollup.items())
        }
    try:
        from blaze_tpu_torch.runtime.instrument import operator_summary

        ops = operator_summary(q.metrics_root, limit=5)
        if ops:
            payload["top_operators"] = ops
    except Exception:  # noqa: BLE001 - the log line must still emit
        pass
    return payload


def emit(q, threshold_s: float) -> None:
    try:
        payload = build_payload(q, threshold_s)
    except Exception:  # noqa: BLE001 - observability must not raise
        log.exception("slow-query payload build failed for %s",
                      getattr(q, "query_id", "?"))
        return
    log.warning("%s", json.dumps(payload, sort_keys=True))
