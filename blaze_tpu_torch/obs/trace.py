"""Query-lifecycle tracing: a context-propagated span tree per query.

The reference engine's observability stops at per-operator counters
mirrored into the Spark UI (metrics.rs, NativeSupports.scala). This
reproduction outgrew that model: a query now crosses the admission
queue, retry/degradation machinery, the result cache, and cluster
worker processes, and none of those hops were visible in one place.
This module is the span layer that stitches them: one TraceRecorder
per query, opened at SUBMIT and closed at the terminal state, with
child spans for queue-wait, admission, per-attempt partition
execution, parquet decode, H2D staging, per-dispatch kernel
execution, host-engine degradation, cache probes, and result
streaming. Chaos faults and cancellations land as span events.

Design constraints (same discipline as testing/chaos.py):

  * Production pays ~nothing when tracing is off: every seam is
    guarded by `if trace.ACTIVE:` - one module-attribute load and a
    falsy branch. No span objects are built, no clocks read.
    (tests/test_dispatch_budget.py pins that obs-off runs keep the
    exact per-shape dispatch budgets; the seams are pure host-side
    control flow and cannot dispatch by construction.)
  * Context propagation is explicit-or-ambient: a seam may name its
    recorder (`rec=ctx.tracer`) or inherit the thread-current one
    that an enclosing `span(...)` installed; with neither, the seam
    no-ops. Generators inherit whatever their *consumer* thread has
    installed, which is exactly the drain loop's attempt span.
  * Cross-process stitching: cluster workers serialize their span
    subtrees (`to_dicts`) into the task-result/.err payloads; the
    driver grafts them (`attach_subtree`) so one query renders as a
    single trace across processes. time.monotonic_ns is
    CLOCK_MONOTONIC, shared by processes on one host, so worker
    timestamps line up without clock translation.

Export is Chrome-trace-event JSON (`chrome_trace`), loadable in
Perfetto / chrome://tracing: matched B/E duration pairs per
(pid, tid), instant events for faults/cancels, with a minimal
validator (`validate_chrome`) the CI smoke runs against every
exported trace.

Activation: refcounted `enable()`/`disable()` (the serving tier
enables for its lifetime), or the BLAZE_TRACE environment variable -
cluster worker subprocesses inherit it, so cross-process traces need
no RPC.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

# fast gate: seams check this single module attribute and fall through
# when False (the tracing-off production path)
ACTIVE = False
_enable_count = 0
_lock = threading.Lock()

# bounded per-trace span count: a runaway query (or a per-dispatch
# span storm) degrades to a truncated trace, never unbounded memory
MAX_SPANS_PER_TRACE = int(os.environ.get("BLAZE_TRACE_MAX_SPANS",
                                         20000))
_MAX_RETAINED_TRACES = 256

# synthetic tid for lifecycle spans (queue-wait, admission, root):
# they start and finish on different threads, so they get their own
# strictly-sequential track instead of a real thread's
LIFECYCLE_TID = 0


def enable() -> None:
    """Refcounted activation (the serving tier enables on construction
    and disables on close; nested enables compose)."""
    global ACTIVE, _enable_count
    with _lock:
        _enable_count += 1
        ACTIVE = True


def disable() -> None:
    global ACTIVE, _enable_count
    with _lock:
        _enable_count = max(0, _enable_count - 1)
        ACTIVE = _enable_count > 0


def _reset_for_tests() -> None:
    """Restore the import-time activation state (test hygiene: a test
    that enables tracing and fails must not leave it armed)."""
    global ACTIVE, _enable_count
    with _lock:
        _enable_count = 1 if os.environ.get("BLAZE_TRACE") else 0
        ACTIVE = _enable_count > 0


class Span:
    __slots__ = ("name", "span_id", "parent_id", "start_ns", "end_ns",
                 "pid", "tid", "tags", "events")

    def __init__(self, name: str, span_id: int, parent_id: int,
                 start_ns: int, pid: int, tid: int,
                 tags: Optional[Dict[str, Any]] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.pid = pid
        self.tid = tid
        self.tags: Dict[str, Any] = dict(tags) if tags else {}
        self.events: List[Dict[str, Any]] = []

    def tag(self, **tags: Any) -> None:
        self.tags.update(tags)

    def event(self, name: str, **attrs: Any) -> None:
        self.events.append(
            {"name": name, "ts_ns": time.monotonic_ns(),
             "attrs": attrs}
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "pid": self.pid,
            "tid": self.tid,
            "tags": dict(self.tags),
            "events": list(self.events),
        }


class TraceRecorder:
    """One query's span tree (every process appends; the driver owns
    the stitched whole)."""

    def __init__(self, trace_id: str, root_name: str = "query"):
        self.trace_id = trace_id
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.spans: List[Span] = []
        self.dropped = 0
        root = self._new_span(root_name, parent_id=0,
                              tid=LIFECYCLE_TID,
                              start_ns=time.monotonic_ns())
        assert root is not None  # cap cannot trip on the first span
        self.root: Span = root

    # -- recording ------------------------------------------------------
    def _new_span(self, name: str, parent_id: int, tid: int,
                  start_ns: int,
                  tags: Optional[Dict[str, Any]] = None
                  ) -> Optional[Span]:
        with self._lock:
            if len(self.spans) >= MAX_SPANS_PER_TRACE:
                self.dropped += 1
                return None
            s = Span(name, next(self._ids), parent_id, start_ns,
                     os.getpid(), tid, tags)
            self.spans.append(s)
            # invariant: the root contains every span. Retroactive
            # spans (queue_wait starts at SUBMIT, microseconds before
            # begin_trace ran) would otherwise sort ahead of the root
            # on the lifecycle track and truncate it in the export's
            # nesting sweep.
            if (self.spans[0] is not s
                    and start_ns < self.spans[0].start_ns):
                self.spans[0].start_ns = start_ns
            return s

    def begin(self, name: str, parent: Optional[Span] = None,
              **tags: Any) -> Optional[Span]:
        """Open a live span on the calling thread's track. Returns None
        past the per-trace cap (callers treat that as a null span)."""
        p = parent if parent is not None else self.root
        return self._new_span(name, p.span_id, threading.get_ident(),
                              time.monotonic_ns(), tags)

    @staticmethod
    def end(span: Span, **tags: Any) -> None:
        if tags:
            span.tags.update(tags)
        span.end_ns = time.monotonic_ns()

    def record_span(self, name: str, start_s: float, end_s: float,
                    parent: Optional[Span] = None,
                    tid: int = LIFECYCLE_TID, **tags: Any
                    ) -> Optional[Span]:
        """Retroactive span from `time.monotonic()` second timestamps
        (the service's phase timings clock - same CLOCK_MONOTONIC
        basis as monotonic_ns)."""
        p = parent if parent is not None else self.root
        s = self._new_span(name, p.span_id, tid, int(start_s * 1e9),
                           tags)
        if s is not None:
            s.end_ns = int(end_s * 1e9)
        return s

    def event(self, name: str, span: Optional[Span] = None,
              **attrs: Any) -> None:
        (span if span is not None else self.root).event(name, **attrs)

    def finish(self, **tags: Any) -> None:
        """Close the root span (terminal query state)."""
        self.root.tags.update(
            {k: v for k, v in tags.items() if v is not None}
        )
        if self.root.end_ns is None:
            self.root.end_ns = time.monotonic_ns()

    # -- cross-process stitching ---------------------------------------
    def to_dicts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [s.to_dict() for s in self.spans]

    def phase_totals(self, phase_of: Dict[str, Optional[str]]
                     ) -> Dict[str, float]:
        """Sum span durations into phase totals (seconds) keyed by
        `phase_of[span.name]` - the allocation-free form of
        `phases.fold_span_dicts(rec.to_dicts())`. The terminal hook
        folds EVERY finished query through this; to_dicts() would
        materialize a dict (with tag and event copies) per span - for
        a retried multi-partition query that is thousands of
        allocations per query on the serving path, for a result this
        fold immediately throws away. One pass over the live Span
        objects, one small output dict."""
        totals: Dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                phase = phase_of.get(s.name)
                if not phase:
                    continue
                end = s.end_ns
                if end is None or end < s.start_ns:
                    continue
                totals[phase] = (
                    totals.get(phase, 0.0) + (end - s.start_ns) / 1e9
                )
        return totals

    def attach_subtree(self, span_dicts: List[Dict[str, Any]],
                       parent: Optional[Span] = None) -> int:
        """Graft a serialized subtree (a cluster worker's spans) under
        `parent` (default: the root). Span ids are remapped into this
        recorder's id space; parent links inside the subtree are
        preserved, subtree roots re-parent under the graft point.
        Returns the number of spans attached."""
        anchor = parent if parent is not None else self.root
        id_map: Dict[int, int] = {}
        grafted: List[tuple] = []  # (span, old_parent_id)
        with self._lock:
            for d in span_dicts:
                if len(self.spans) >= MAX_SPANS_PER_TRACE:
                    self.dropped += len(span_dicts) - len(grafted)
                    break
                s = Span(
                    str(d.get("name", "span")), next(self._ids),
                    0, int(d.get("start_ns", 0)),
                    int(d.get("pid", 0)), int(d.get("tid", 0)),
                    d.get("tags"),
                )
                end_ns = d.get("end_ns")
                s.end_ns = int(end_ns) if end_ns is not None else None
                s.events = list(d.get("events", ()))
                id_map[int(d.get("span_id", 0))] = s.span_id
                self.spans.append(s)
                grafted.append((s, int(d.get("parent_id", 0))))
            # second pass: remap parents (subtree may arrive in any
            # order); unresolvable parents hang off the graft anchor
            for s, old_parent in grafted:
                s.parent_id = id_map.get(old_parent, anchor.span_id)
                if s.start_ns and s.start_ns < self.spans[0].start_ns:
                    self.spans[0].start_ns = s.start_ns
        return len(grafted)


# ---------------------------------------------------------------------------
# thread-current span stack + context-manager seam API
# ---------------------------------------------------------------------------

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_recorder() -> Optional[TraceRecorder]:
    st = _stack()
    return st[-1][0] if st else None


def current_span() -> Optional[Span]:
    st = _stack()
    return st[-1][1] if st else None


class _NullSpan:
    """No-op span/context manager: what seams get when no recorder is
    in scope (or the per-trace span cap tripped)."""

    __slots__ = ()

    def tag(self, **tags: Any) -> None:
        pass

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _NullSpan()


class _SpanCtx:
    __slots__ = ("_rec", "_name", "_tags", "span", "_pushed")

    def __init__(self, rec: TraceRecorder, name: str,
                 tags: Dict[str, Any]):
        self._rec = rec
        self._name = name
        self._tags = tags
        self.span: Optional[Span] = None
        self._pushed = False

    def __enter__(self):
        st = _stack()
        parent = st[-1][1] if (st and st[-1][0] is self._rec) else None
        sp = self._rec.begin(self._name, parent=parent, **self._tags)
        if sp is None:  # span cap: degrade to a null span
            return NULL
        st.append((self._rec, sp))
        self.span = sp
        self._pushed = True
        return sp

    def __exit__(self, exc_type, exc, tb):
        if not self._pushed:
            return False
        st = _stack()
        if st and st[-1][1] is self.span:
            st.pop()
        else:  # exotic unwind order (generator closed off-stack)
            try:
                st.remove((self._rec, self.span))
            except ValueError:
                pass
        sp = self.span
        if exc_type is not None:
            if exc_type in (GeneratorExit, KeyboardInterrupt):
                sp.tags.setdefault("cancelled", True)
            else:
                sp.tags.setdefault("error", exc_type.__name__)
                try:
                    from blaze_tpu_torch.errors import classify

                    sp.tags.setdefault("error_class",
                                       classify(exc).value)
                except Exception:  # noqa: BLE001 - tagging best-effort
                    pass
        sp.end_ns = time.monotonic_ns()
        return False


def span(name: str, rec: Optional[TraceRecorder] = None, **tags: Any):
    """Seam entry: a context manager recording one span under the
    named (or thread-current) recorder; a no-op with neither. Always
    gate the call site on `trace.ACTIVE` first."""
    r = rec if rec is not None else current_recorder()
    if r is None:
        return NULL
    return _SpanCtx(r, name, tags)


def event(name: str, **attrs: Any) -> None:
    """Attach an instant event to the thread-current span (chaos
    faults, cancellations); no-op outside any span."""
    st = _stack()
    if st:
        st[-1][1].event(name, **attrs)


# ---------------------------------------------------------------------------
# trace registry (export looks traces up by query id)
# ---------------------------------------------------------------------------

_TRACES: "collections.OrderedDict[str, TraceRecorder]" = (
    collections.OrderedDict()
)


def begin_trace(trace_id: str,
                root_name: str = "query") -> TraceRecorder:
    rec = TraceRecorder(trace_id, root_name=root_name)
    with _lock:
        _TRACES[trace_id] = rec
        _TRACES.move_to_end(trace_id)
        while len(_TRACES) > _MAX_RETAINED_TRACES:
            _TRACES.popitem(last=False)
    return rec


def get_trace(trace_id: str) -> Optional[TraceRecorder]:
    with _lock:
        return _TRACES.get(trace_id)


# ---------------------------------------------------------------------------
# Chrome-trace-event export (Perfetto / chrome://tracing loadable)
# ---------------------------------------------------------------------------


def chrome_trace(rec: TraceRecorder) -> Dict[str, Any]:
    """Serialize one recorder as Chrome trace events: matched B/E
    pairs per (pid, tid) track, instant events ('i') for span events,
    process metadata ('M'). Timestamps are microseconds relative to
    the earliest span, so the trace opens at t=0."""
    # deep-enough snapshot under the recorder lock: REPORT may export
    # a still-RUNNING query while worker threads mutate span tags
    with rec._lock:
        spans = []
        for s in rec.spans:
            c = Span(s.name, s.span_id, s.parent_id, s.start_ns,
                     s.pid, s.tid, s.tags)  # Span copies the tags
            c.end_ns = s.end_ns
            c.events = list(s.events)
            spans.append(c)
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    now = time.monotonic_ns()
    t0 = min(s.start_ns for s in spans)

    def us(ns: int) -> float:
        return round((ns - t0) / 1000.0, 3)

    # small per-pid tid indices (raw thread idents are unreadable);
    # the lifecycle track keeps tid 0
    tid_map: Dict[tuple, int] = {}

    def tid_of(s: Span) -> int:
        if s.tid == LIFECYCLE_TID:
            return 0
        key = (s.pid, s.tid)
        if key not in tid_map:
            tid_map[key] = len(tid_map) + 1
        return tid_map[key]

    groups: Dict[tuple, List[Span]] = {}
    for s in spans:
        groups.setdefault((s.pid, tid_of(s)), []).append(s)

    events: List[Dict[str, Any]] = []
    for pid in sorted({s.pid for s in spans}):
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"blaze[{pid}]"},
        })
    for (pid, tid), group in sorted(groups.items()):
        # structural nesting is guaranteed per thread (context
        # managers); the (start, -end) sort + end-clamp turns it into
        # well-nested B/E intervals even with equal timestamps
        group.sort(key=lambda s: (s.start_ns, -((s.end_ns or now))))
        stack: List[tuple] = []  # (span, clamped_end_ns)
        for s in group:
            end = s.end_ns if s.end_ns is not None else now
            while stack and stack[-1][1] <= s.start_ns:
                top, top_end = stack.pop()
                events.append({"ph": "E", "name": top.name,
                               "pid": pid, "tid": tid,
                               "ts": us(top_end)})
            if stack:
                end = min(end, stack[-1][1])  # child within parent
            args = {k: _jsonable(v) for k, v in s.tags.items()}
            if s.end_ns is None:
                args["unfinished"] = True
            b = {"ph": "B", "name": s.name, "pid": pid, "tid": tid,
                 "ts": us(max(s.start_ns, t0))}
            if args:
                b["args"] = args
            events.append(b)
            for ev in s.events:
                ie = {"ph": "i", "name": str(ev.get("name", "event")),
                      "pid": pid, "tid": tid,
                      "ts": us(int(ev.get("ts_ns", s.start_ns))),
                      "s": "t"}
                attrs = ev.get("attrs")
                if attrs:
                    ie["args"] = {k: _jsonable(v)
                                  for k, v in attrs.items()}
                events.append(ie)
            stack.append((s, max(end, s.start_ns)))
        while stack:
            top, top_end = stack.pop()
            events.append({"ph": "E", "name": top.name, "pid": pid,
                           "tid": tid, "ts": us(top_end)})
    out = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": rec.trace_id},
    }
    if rec.dropped:
        out["otherData"]["dropped_spans"] = rec.dropped
    return out


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def validate_chrome(doc: Any) -> List[str]:
    """Minimal Chrome-trace-event schema check (the CI trace smoke):
    every event has ph/pid/tid (+name/ts where applicable), B/E pairs
    match per (pid, tid) in stack order, and no span ends before it
    begins. Returns a list of problems; empty = valid."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["trace is not a JSON object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["no traceEvents"]
    stacks: Dict[tuple, List[tuple]] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("B", "E", "i", "M", "X"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "pid" not in e or "tid" not in e:
            problems.append(f"event {i}: missing pid/tid")
            continue
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(
                f"event {i}: bad ts {ts!r} (want number >= 0)"
            )
            continue
        key = (e["pid"], e["tid"])
        if ph == "B":
            if not e.get("name"):
                problems.append(f"event {i}: B without name")
            stacks.setdefault(key, []).append((e.get("name"), ts, i))
        elif ph == "E":
            st = stacks.get(key)
            if not st:
                problems.append(
                    f"event {i}: E({e.get('name')!r}) without "
                    f"matching B on {key}"
                )
                continue
            bname, bts, bi = st.pop()
            if e.get("name") and e["name"] != bname:
                problems.append(
                    f"event {i}: E name {e['name']!r} != B name "
                    f"{bname!r} (event {bi})"
                )
            if ts < bts:
                problems.append(
                    f"event {i}: span {bname!r} ends at {ts} before "
                    f"it begins at {bts} (non-monotonic)"
                )
    for key, st in stacks.items():
        for bname, _, bi in st:
            problems.append(
                f"unclosed B {bname!r} (event {bi}) on {key}"
            )
    return problems


def _maybe_activate_from_env() -> None:
    if os.environ.get("BLAZE_TRACE"):
        enable()


_maybe_activate_from_env()
