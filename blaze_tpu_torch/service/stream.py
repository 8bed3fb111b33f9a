"""Per-query bounded incremental result buffer (the streaming tentpole).

The execution path used to materialize a whole partition list before
FETCH moved the first byte, and an unbounded retention list was the
only thing between a slow consumer and host OOM. StreamBuffer turns
the result path into a flow-controlled ring:

  * the PRODUCER (service._drain / cache hits / host degradation)
    appends RecordBatches as they come off the executor generator and
    BLOCKS once the un-consumed ("pending") bytes exceed the byte cap
    - backpressure propagates into execution instead of growing host
    memory. Blocking only engages once a consumer has ever attached:
    driver-side `service.result()` users and detached never-fetched
    queries keep today's materialize-everything behavior (nothing
    would ever drain the ring, so blocking on it would deadlock).
  * the CONSUMER (wire-tier FETCH) delivers parts while the query is
    still RUNNING and marks them consumed, which releases pending
    bytes and wakes the producer. Delivered parts are RETAINED (they
    are the same RecordBatch objects that become q.result), so the
    count-based part-skip resume protocol and double-FETCH both work
    on in-progress streams with zero wire changes.
  * a consumer that stops draining for longer than the stall budget
    while the producer sits at the cap aborts the stream with the
    classified STREAM_STALLED outcome: CANCELLED-class (never a
    breaker strike at the router - errors.FATAL_FOR_REPLICA excludes
    CANCELLED by construction), buffer freed, and the query's device
    reservation released by the normal terminal path.

Pending bytes are accounted against the query's admission reservation
(AdmissionController.adjust_reservation) while a consumer is attached,
so buffered-but-undelivered output gates new admissions exactly like
the device bytes it mirrors - the DeviceMemoryTracker headroom check
sees it through the existing `reserved_bytes` path.

Delivered-prefix consistency: a retry/degrade after parts were already
delivered re-produces the partition. `rollback()` truncates only the
UNDELIVERED suffix; re-produced parts overlapping the delivered prefix
are verified batch-equal against what was sent (put() replay mode). A
divergent re-execution poisons the stream with the same
"re-executed result diverged" contract the router's blake2b splice
check enforces across replicas - failing loudly beats silently
splicing inconsistent data.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from blaze_tpu_torch.errors import ErrorClass, PlanInvalidError
from blaze_tpu_torch.obs.contention import TimedLock
from blaze_tpu_torch.service.query import QueryCancelled


class StreamStalled(QueryCancelled):
    """Consumer made no progress past the stall budget with the buffer
    at its cap. QueryCancelled subclass: the run loop's cancel ladder
    surfaces it as terminal CANCELLED (reason 'stream_stalled'), which
    keeps it strike-free for replica circuit breakers."""


class StreamSpliceError(PlanInvalidError):
    """A retried execution diverged from parts already delivered to a
    live consumer. PLAN_INVALID-class: fail fast, zero further retries
    (retrying cannot un-deliver the stale prefix)."""


class StreamBuffer:
    """Bounded, ordered, multi-consumer result ring for one query.

    max_pending_bytes caps PENDING (produced, not yet consumed) bytes;
    consumed parts stay retained for resume/re-FETCH but stop counting
    against the cap. A single part larger than the cap is always
    admitted when the ring is empty (progress beats the bound)."""

    def __init__(
        self,
        max_pending_bytes: int,
        stall_s: float,
        on_pending: Optional[Callable[[int], None]] = None,
        on_event: Optional[Callable[[str, int], None]] = None,
    ):
        self.max_pending = max(1, int(max_pending_bytes))
        self.stall_s = float(stall_s)
        self._on_pending = on_pending
        self._on_event = on_event
        self._cv = threading.Condition(TimedLock("stream_ring"))
        # async-consumer bridge: the event-loop FETCH path
        # (service/wire_async.py) cannot park in self._cv.wait - it
        # registers a waker callback instead, fired on every state
        # change alongside the CV notify. Callbacks must be cheap and
        # thread-safe (loop.call_soon_threadsafe(ev.set)).
        self._wakers: List[Callable[[], None]] = []
        self.parts: List = []  # produced pa.RecordBatch refs, in order
        self._nbytes: List[int] = []
        # producer cursor: == len(parts) normally; behind it while
        # replaying a rolled-back attempt over the delivered prefix
        self._pos = 0
        self.consumed = 0  # delivery floor: max part index sent + 1
        self.finished = False
        self.aborted: Optional[str] = None
        self.consumers_seen = 0
        self.pending_bytes = 0
        self.high_water = 0  # max pending bytes ever observed
        self.backpressure_waits = 0
        self.stalls = 0
        self._held = 0  # bytes currently reported via on_pending
        self._last_progress = time.monotonic()

    # -- accounting (caller holds self._cv) ----------------------------
    def _account_locked(self) -> None:
        """Reconcile the admission hold with pending bytes. Holds are
        only live while a consumer is attached: a never-fetched query
        must keep byte-identical admission behavior with the
        pre-streaming service."""
        want = self.pending_bytes if self.consumers_seen > 0 else 0
        delta, self._held = want - self._held, want
        if delta and self._on_pending is not None:
            try:
                self._on_pending(delta)
            except Exception:  # noqa: BLE001 - accounting best-effort
                pass

    def _event(self, name: str, value: int = 1) -> None:
        if self._on_event is not None:
            try:
                self._on_event(name, value)
            except Exception:  # noqa: BLE001 - obs must not raise
                pass

    def _wake_locked(self) -> None:
        """Wake every waiter: threaded consumers via the CV, async
        consumers via their registered wakers (caller holds _cv)."""
        self._cv.notify_all()
        for w in self._wakers:
            try:
                w()
            except Exception:  # noqa: BLE001 - a dead loop must not
                pass           # poison producer progress

    def add_waker(self, waker: Callable[[], None]) -> None:
        with self._cv:
            self._wakers.append(waker)

    def remove_waker(self, waker: Callable[[], None]) -> None:
        with self._cv:
            try:
                self._wakers.remove(waker)
            except ValueError:
                pass

    # -- producer side --------------------------------------------------
    def position(self) -> int:
        with self._cv:
            return self._pos

    def put(self, q, rb) -> None:
        """Append one produced part, blocking while the ring is over
        its byte cap and a consumer is attached. Raises StreamStalled
        (after cancelling `q`) when the consumer makes no progress for
        stall_s, QueryCancelled on cancel/deadline during the wait,
        StreamSpliceError when a replayed attempt diverges from the
        delivered prefix."""
        nbytes = int(getattr(rb, "nbytes", 0) or 0)
        waited = False
        with self._cv:
            if self.aborted is not None:
                # a stall already killed the stream; the producer is
                # being cancelled - surface the same classified exit
                raise StreamStalled(getattr(q, "query_id", "?"))
            if self._pos < len(self.parts):
                # replay after rollback(): this part was produced by a
                # failed attempt and possibly already delivered -
                # verify the re-execution matches what went out
                prev = self.parts[self._pos]
                if not _batches_equal(prev, rb):
                    self.aborted = "SPLICE_BROKEN"
                    self._clear_locked()
                    self._wake_locked()
                    raise StreamSpliceError(
                        "re-executed result diverged from parts "
                        "already delivered mid-stream; resubmit the "
                        "query"
                    )
                self._pos += 1
                self._wake_locked()
                return
            while (
                self.consumers_seen > 0
                and self.pending_bytes > 0
                and self.pending_bytes + nbytes > self.max_pending
            ):
                if not waited:
                    waited = True
                    self.backpressure_waits += 1
                    self._event("backpressure_wait")
                if q.cancel_requested or q.deadline_exceeded():
                    raise QueryCancelled(q.query_id)
                stalled_for = time.monotonic() - self._last_progress
                if self.stall_s > 0 and stalled_for >= self.stall_s:
                    self._stall_abort_locked(q, stalled_for)
                self._cv.wait(
                    min(0.05, self.stall_s or 0.05)
                    if self.stall_s > 0 else 0.05
                )
            self.parts.append(rb)
            self._nbytes.append(nbytes)
            self._pos = len(self.parts)
            self.pending_bytes += nbytes
            if self.pending_bytes > self.high_water:
                self.high_water = self.pending_bytes
                self._event("high_water", self.high_water)
            self._account_locked()
            self._wake_locked()

    def _stall_abort_locked(self, q, stalled_for: float) -> None:
        """The classified slow-consumer exit: cancel the query with the
        STREAM_STALLED outcome and free the ring."""
        self.stalls += 1
        self._event("stall")
        q.error = (
            f"STREAM_STALLED: consumer made no progress for "
            f"{stalled_for:.2f}s with the stream buffer at its "
            f"{self.max_pending}-byte cap; stream aborted, buffer "
            f"and reservation freed"
        )
        q.error_class = ErrorClass.CANCELLED.value
        q.request_cancel(reason="stream_stalled")
        self.aborted = "STREAM_STALLED"
        self._clear_locked()
        self._wake_locked()
        raise StreamStalled(q.query_id)

    def rollback(self, to_pos: int) -> None:
        """Abandoned-attempt cleanup (service._drain): truncate parts
        the failed attempt produced beyond `to_pos` - except the
        already-delivered prefix, which cannot be un-sent and is
        instead verified against the retry's output (put() replay
        mode)."""
        with self._cv:
            if self.aborted is not None or self.finished:
                return
            keep = max(int(to_pos), self.consumed)
            if len(self.parts) > keep:
                freed = sum(self._nbytes[keep:])
                del self.parts[keep:]
                del self._nbytes[keep:]
                self.pending_bytes -= freed
                self._account_locked()
            self._pos = min(int(to_pos), len(self.parts))
            self._wake_locked()

    def finish(self) -> None:
        with self._cv:
            self.finished = True
            self._wake_locked()

    def abort(self, reason: str) -> None:
        """Terminal non-DONE exit: free the ring (retention keeps
        nothing for a query that has no result to collect)."""
        with self._cv:
            if self.finished:
                return
            if self.aborted is None:
                self.aborted = str(reason)
            self._clear_locked()
            self._wake_locked()

    def _clear_locked(self) -> None:
        self.parts.clear()
        self._nbytes.clear()
        self._pos = 0
        self.consumed = 0
        self.pending_bytes = 0
        self._account_locked()

    # -- consumer side --------------------------------------------------
    def attach(self) -> None:
        """A FETCH opened against this stream. Counts as consumer
        progress (a reconnecting client must not inherit the previous
        connection's stall clock) and arms both backpressure and the
        admission hold for already-pending bytes."""
        with self._cv:
            self.consumers_seen += 1
            self._last_progress = time.monotonic()
            self._account_locked()
            self._wake_locked()

    def next_ready(self, i: int, timeout: float):
        """Wait up to `timeout` for part `i`. Returns one of
        ('part', rb) | ('finished', None) | ('aborted', reason) |
        ('timeout', None). Parts win over terminal markers so a
        finished stream drains completely before the terminator."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if i < len(self.parts):
                    return "part", self.parts[i]
                if self.aborted is not None:
                    return "aborted", self.aborted
                if self.finished:
                    return "finished", None
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return "timeout", None
                self._cv.wait(min(rem, 0.05))

    def mark_consumed(self, i: int) -> None:
        """Part `i` is committed for delivery (called BEFORE the send:
        a part handed to the wire can never be truncated by a rollback,
        so the replay-verify boundary is conservative). Releases its
        pending bytes and resets the stall clock."""
        with self._cv:
            if i + 1 > self.consumed:
                freed = sum(self._nbytes[self.consumed:i + 1])
                self.consumed = i + 1
                self.pending_bytes -= freed
                self._account_locked()
            self._last_progress = time.monotonic()
            self._wake_locked()

    def total_parts(self) -> int:
        with self._cv:
            return len(self.parts)


def _batches_equal(a, b) -> bool:
    try:
        return bool(a.equals(b))
    except Exception:  # noqa: BLE001 - incomparable means divergent
        return False
