"""Query lifecycle: per-query record + state machine.

The serving tier's unit of work. A Query wraps either a serialized
TaskDefinition (the wire entry - one partition of one stage, the
reference's callNative currency) or a driver-built plan (every
partition), and carries the scheduling metadata the reference inherits
from Spark's scheduler: priority, deadline, admission cost estimate.

State machine (service/service.py drives it):

    QUEUED -> ADMITTED -> RUNNING -> DONE
       |          |          |-----> FAILED
       |          |          |-----> CANCELLED
       |          |          '-----> TIMED_OUT
       |          |-> CANCELLED | TIMED_OUT | FAILED
       |-> CANCELLED | TIMED_OUT
    (submit may also refuse outright: REJECTED_OVERLOADED)

Transitions are validated; an illegal transition is a bug in the
service, not a recoverable condition, so it raises.
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from typing import Dict, List, Optional

from blaze_tpu_torch.obs.contention import TimedLock
from blaze_tpu_torch.ops.base import ExecContext


class QueryState(enum.Enum):
    QUEUED = "QUEUED"
    ADMITTED = "ADMITTED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"
    TIMED_OUT = "TIMED_OUT"
    REJECTED_OVERLOADED = "REJECTED_OVERLOADED"


TERMINAL_STATES = frozenset(
    {
        QueryState.DONE,
        QueryState.FAILED,
        QueryState.CANCELLED,
        QueryState.TIMED_OUT,
        QueryState.REJECTED_OVERLOADED,
    }
)

_ALLOWED = {
    QueryState.QUEUED: {
        QueryState.ADMITTED,
        QueryState.CANCELLED,
        QueryState.TIMED_OUT,
        QueryState.REJECTED_OVERLOADED,
        QueryState.FAILED,  # submit-time decode failure
    },
    QueryState.ADMITTED: {
        QueryState.RUNNING,
        QueryState.CANCELLED,
        QueryState.TIMED_OUT,
        QueryState.FAILED,  # admission-window failure (pre-execution)
    },
    QueryState.RUNNING: {
        QueryState.DONE,
        QueryState.FAILED,
        QueryState.CANCELLED,
        QueryState.TIMED_OUT,
    },
}


class QueryRejected(RuntimeError):
    """Submit-time backpressure: the admission queue is full."""


class QueryCancelled(RuntimeError):
    """Raised inside a query's run loop when its cancel event fires."""


_qid_counter = itertools.count()


def _new_query_id() -> str:
    return f"q-{next(_qid_counter)}-{threading.get_ident():x}"


class Query:
    """One submitted query: payload + scheduling metadata + outcome."""

    def __init__(
        self,
        *,
        task_bytes: Optional[bytes] = None,
        plan=None,
        is_ref: bool = False,
        resources: Optional[dict] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        estimated_bytes: Optional[int] = None,
        use_cache: bool = True,
        query_id: Optional[str] = None,
        tenant: str = "default",
    ):
        assert (task_bytes is None) != (plan is None), \
            "exactly one of task_bytes/plan"
        self.query_id = query_id or _new_query_id()
        # multi-tenant identity (docs/SERVICE.md "Tenancy"): rides
        # SUBMIT meta end to end - admission budgets, weighted-fair
        # ordering, per-tenant metrics and the router's rate limits
        # all key on it; "default" = untagged traffic
        self.tenant = str(tenant or "default")
        self.task_bytes = task_bytes
        self.plan = plan
        self.is_ref = is_ref
        self.resources = resources or {}
        self.priority = int(priority)
        self.submitted_at = time.monotonic()
        self.deadline_at = (
            self.submitted_at + deadline_s if deadline_s else None
        )
        self.estimated_bytes = estimated_bytes
        self.use_cache = use_cache

        self.state = QueryState.QUEUED
        self.error: Optional[str] = None
        # failure taxonomy (blaze_tpu_torch/errors.py): the class of the
        # error that terminated the query, and the per-attempt journal
        # the REPORT/wire surface ({partition, attempt, error_class,
        # error, action: retry|degrade|fail})
        self.error_class: Optional[str] = None
        self.attempts: List[Dict] = []
        # True when any partition re-executed through the host engine
        # after RESOURCE_EXHAUSTED (the native->Spark fallback analog)
        self.degraded = False
        self.result: Optional[List] = None  # pa.RecordBatch list
        # observability (blaze_tpu_torch/obs): the per-query TraceRecorder
        # (service-filled when tracing is on; root span opens at
        # submit, closes at the terminal transition) and a terminal
        # callback the service uses for runtime-history recording,
        # metrics, and the slow-query log
        self.tracer = None
        self.on_terminal = None
        self.ctx = ExecContext(task_id=self.query_id)
        # ONE metric tree per query: the executor adds `dispatch.*`
        # deltas to ctx.metrics' root counters, instrument() mirrors
        # the operator tree under the same root, so render_metrics
        # shows both in one per-query report
        self.metrics_root = self.ctx.metrics
        # wall-clock phase timestamps (monotonic), service-filled:
        # submitted / admitted / run_start / finished (+ stream_ns
        # accumulated by the wire tier)
        self.timings: Dict[str, float] = {"submitted": self.submitted_at}
        # orphan detection (service._sweep_orphans): last client
        # touch (poll/report/fetch) and whether the result was ever
        # streamed - a terminal query nobody polls or fetches past
        # the orphan TTL is reaped (its router died; retention must
        # not pin its result forever)
        self.last_activity = self.submitted_at
        self.fetched = False
        # live FETCH streams against this query: the sweep must never
        # reap under an in-progress collection, no matter how slowly
        # the parts pace out relative to the TTL
        self.fetchers = 0
        # incremental result ring (service/stream.py), service-filled
        # when streaming is enabled: the executor feeds it as batches
        # complete and FETCH drains it while the query is RUNNING.
        # None = pre-streaming materialize-then-stream behavior
        self.stream = None

        self._lock = TimedLock("query_state")
        self._cancel = threading.Event()
        self._cancel_reason: Optional[str] = None
        self._done = threading.Event()
        # service-filled (submit-time decode): the decoded task tuple,
        # plan fingerprint, and whether the fingerprint is
        # content-stable (cacheable)
        self._decoded = None
        self._fingerprint: Optional[str] = None
        self._fingerprint_stable = False
        # zero-copy plan cache (blaze_tpu_torch/zerocopy/plan_cache.py),
        # service-filled: the blob digest, the task's partition when
        # known WITHOUT a decoded tuple (a plan-cache hit skips decode
        # entirely), the cache entry whose tree this query borrowed,
        # and whether the borrowed tree went through
        # prepare_decoded_task (fusion mutates it in place - a
        # consumed tree is never returned to the entry)
        self._plan_key: Optional[str] = None
        self._plan_partition: Optional[int] = None
        self._plan_entry = None
        self._tree_consumed = False

    # -- state machine --------------------------------------------------
    def transition(self, new: QueryState) -> None:
        with self._lock:
            if new not in _ALLOWED.get(self.state, ()):  # terminal too
                raise RuntimeError(
                    f"illegal query transition {self.state.name} -> "
                    f"{new.name} ({self.query_id})"
                )
            self.state = new
            fire = False
            if new in TERMINAL_STATES:
                self.timings.setdefault("finished", time.monotonic())
                fire = not self._done.is_set()
                self._done.set()
        if fire:
            self._fire_terminal(new)

    def try_transition(self, new: QueryState) -> bool:
        """Transition if legal from the current state; False otherwise
        (the racy cancel-vs-finish edges use this)."""
        with self._lock:
            if new not in _ALLOWED.get(self.state, ()):
                return False
            self.state = new
            fire = False
            if new in TERMINAL_STATES:
                self.timings.setdefault("finished", time.monotonic())
                fire = not self._done.is_set()
                self._done.set()
        if fire:
            self._fire_terminal(new)
        return True

    def _fire_terminal(self, new: QueryState) -> None:
        """Exactly-once terminal hook, OUTSIDE the state lock (the
        service's observability callback touches its own locks): close
        the trace root span, then notify the service."""
        if self.tracer is not None:
            try:
                self.tracer.finish(
                    state=new.value, error_class=self.error_class,
                    degraded=self.degraded or None,
                )
            except Exception:  # noqa: BLE001 - obs must not raise
                pass
        cb = self.on_terminal
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 - obs must not raise
                import logging

                logging.getLogger("blaze_tpu_torch.service").exception(
                    "terminal observability hook failed for %s",
                    self.query_id,
                )

    def note_activity(self) -> None:
        """A client touched this query (POLL/REPORT/FETCH): defer the
        orphan sweep. Unlocked monotonic-float store - races only
        jitter the TTL by one touch."""
        self.last_activity = time.monotonic()

    def begin_fetch(self) -> None:
        """Locked, unlike note_activity: fetchers is a counter, and a
        lost increment under two concurrent FETCHes would let the
        orphan sweep reap this query mid-collection."""
        with self._lock:
            self.fetchers += 1

    def end_fetch(self) -> None:
        with self._lock:
            self.fetchers -= 1

    # -- cancellation / deadline ---------------------------------------
    def request_cancel(self, reason: str = "user") -> None:
        """reason: 'user' | 'shutdown' | 'deadline'. The FIRST reason
        wins - it decides whether the terminal state is CANCELLED
        (user/shutdown intent) or TIMED_OUT (the deadline sweep fires
        the same event, and a user cancel that narrowly precedes the
        deadline must still report CANCELLED)."""
        with self._lock:
            first = not self._cancel.is_set()
            if first:
                self._cancel_reason = reason
            self._cancel.set()
        if first and self.tracer is not None:
            # cancellation lands in the trace as a root-span event
            try:
                self.tracer.event("cancel_requested", reason=reason)
            except Exception:  # noqa: BLE001 - obs must not raise
                pass

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    @property
    def cancel_reason(self) -> Optional[str]:
        return self._cancel_reason

    def deadline_exceeded(self, now: Optional[float] = None) -> bool:
        return (
            self.deadline_at is not None
            and (now if now is not None else time.monotonic())
            >= self.deadline_at
        )

    def check_interrupt(self) -> None:
        """Between-batch cooperative check inside the run loop."""
        if self._cancel.is_set():
            raise QueryCancelled(self.query_id)
        if self.deadline_exceeded():
            raise QueryCancelled(f"{self.query_id}: deadline")

    def wait_cancel(self, timeout: float) -> bool:
        """Interruptible sleep (retry backoff): returns True when the
        cancel event fired during the wait."""
        return self._cancel.wait(timeout)

    # -- failure journal ------------------------------------------------
    def record_attempt(self, partition: int, attempt: int,
                       error_class: str, error: BaseException,
                       action: str) -> None:
        """Journal one failed execution attempt; travels the wire in
        status() and renders in the REPORT."""
        with self._lock:
            self.attempts.append({
                "partition": partition,
                "attempt": attempt,
                "error_class": error_class,
                "error": str(error)[:300],
                "action": action,
            })

    # -- completion -----------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    def status(self) -> dict:
        """Poll payload: state + timings + per-query counters."""
        m = self.ctx.metrics.counters
        t = dict(self.timings)
        out = {
            "query_id": self.query_id,
            "state": self.state.value,
            "priority": self.priority,
        }
        if self.tenant != "default":
            # zero-config payloads stay byte-identical: only tagged
            # traffic carries the tenant field back
            out["tenant"] = self.tenant
        if self.error:
            out["error"] = self.error
        if self.error_class:
            out["error_class"] = self.error_class
        if self.degraded:
            out["degraded"] = True
        if self.attempts:
            with self._lock:
                out["attempts"] = list(self.attempts)
            out["retries"] = sum(
                1 for a in out["attempts"] if a["action"] == "retry"
            )
        if "admitted" in t:
            out["queue_wait_s"] = round(t["admitted"] - t["submitted"], 6)
        if "run_start" in t and "admitted" in t:
            out["admission_s"] = round(t["run_start"] - t["admitted"], 6)
        if "finished" in t and "run_start" in t:
            out["execution_s"] = round(t["finished"] - t["run_start"], 6)
        if "stream_ns" in t:
            out["stream_s"] = round(t["stream_ns"] / 1e9, 6)
        if self.stream is not None and self.stream.consumers_seen:
            # in-progress stream visibility (POLL while FETCHing):
            # parts produced vs delivered + the backpressure signal
            out["stream_parts"] = self.stream.total_parts()
            out["stream_consumed"] = self.stream.consumed
        for k in ("output_rows", "output_batches", "cache_hits",
                  "cache_misses", "coalesced"):
            if k in m:
                out[k] = m[k]
        # the port's device work (runtime/dispatch.py kinds): graph
        # replays, hand-written kernel launches (inside graphs too),
        # H2D copies and blocking readbacks; `dispatches`, the
        # counterpart of the JAX package's XLA dispatches, counts the
        # fused operators' batches: one replay each, or one batch run
        # op by op (every batch on the CPU). A full result-cache hit
        # shows zero of each
        launches = sum(v for k, v in m.items()
                       if k.startswith("dispatch.launch."))
        replays = m.get("dispatch.graph_replays", 0)
        out["dispatches"] = (replays
                             + m.get("dispatch.graph_eager_batches", 0))
        out["graph_replays"] = replays
        out["launches"] = launches
        out["h2d_copies"] = m.get("dispatch.h2d_copies", 0)
        out["d2h_syncs"] = m.get("dispatch.d2h_syncs", 0)
        if self._fingerprint is not None and self._fingerprint_stable:
            # stable content fingerprint: the affinity key replica
            # routing and the runtime-history store share
            out["fingerprint"] = self._fingerprint
        return out
