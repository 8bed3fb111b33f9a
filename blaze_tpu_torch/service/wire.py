"""Service wire protocol: multi-query serving over the gateway socket.

The legacy gateway connection (runtime/gateway.py) is one-shot: one
TaskDefinition in, one batch stream out. A serving tier needs verbs -
submit several queries over one connection, poll them, stream results,
cancel mid-flight. The framing extends the gateway's, so one listener
serves both: a connection whose FIRST u64 header has bit 61
(_FLAG_SERVICE) set switches to this protocol; anything else is a
legacy single-task connection.

Service framing (all integers LE):

  hello:    u64 header with _FLAG_SERVICE set (rest of the bits 0)
  verb:     u8   SUBMIT=1 POLL=2 FETCH=3 CANCEL=4 REPORT=5 STATS=6
                 METRICS=7 MEMBER=8 PROFILE=9
  SUBMIT:   u32 meta_len | meta JSON | u64 blob_header | [u32 mlen |
            manifest JSON] | blob
            blob_header reuses the legacy bits: bit 63 = reference wire
            format, bit 62 = resource manifest present, low bits = len.
            meta: {priority, deadline_s, estimated_bytes, use_cache}
            -> JSON frame {query_id, state, ...}
  POLL:     u32 id_len | id   -> JSON frame (Query.status())
  FETCH:    u32 id_len | id | u32 timeout_ms
            -> segmented-IPC parts (u64 len | zstd Arrow IPC) as the
               executor PRODUCES them - delivery starts while the
               query is still RUNNING - then u64 0 once the query is
               DONE and the ring drained (the shuffle/gateway wire
               format, io/ipc.py)
            -> u64 ERR | u32 len | "STATE: detail" utf8 when the
               query is terminal non-DONE before the first part;
               timeout_ms (0 = wait forever) bounds the wait for the
               FIRST part. After parts are on the wire a failure
               aborts the connection (never an in-band frame - it
               would desync the u64 framing); the client resumes by
               re-FETCHing and skipping delivered parts. Producer
               flow control + the slow-consumer stall budget:
               service/stream.py, docs/SERVICE.md.
               Bit 31 of timeout_ms opts INTO the shared-memory arena
               (zerocopy/arena.py): when the finalized result lives in
               an arena segment the server answers u64 ARENA | u32 len
               | handle JSON {path, offsets, lengths, lease, ...}
               INSTEAD of the part stream - the co-located client maps
               the segment and reads the identical frames, then
               RELEASEs the lease. A client that cannot map the path
               (remote, stale lease, chaos) re-FETCHes with the bit
               clear and gets plain bytes - degradation is always
               client-invisible. Without the bit, an arena-resident
               result still skips re-encoding: the frames go out as a
               scatter-gather buffer list, byte-identical to the
               per-batch encode path
  RELEASE:  u32 len | lease-id utf8 | u32 0 -> JSON frame
            {released: bool} - returns a shared-memory arena lease
            (zerocopy/arena.py); an unreleased lease is TTL-reaped
  CANCEL:   u32 id_len | id   -> JSON frame
  REPORT:   u32 id_len | id | u32 flags -> JSON frame {report: text,
            trace?: Chrome-trace-event JSON, trace_spans?: [span
            dicts]} - `trace` included only when flags bit 0 is set
            AND tracing was on for the query (obs/trace.py); it is
            the Perfetto-loadable document `python -m blaze_tpu_torch
            trace` writes out. flags bit 1 requests the RAW span
            dicts (TraceRecorder.to_dicts) instead: the replica
            router grafts those into its own recorder
            (attach_subtree) to render ONE cross-hop trace
  STATS:    u32 0             -> JSON frame (service stats: admission
            headroom/queue depth, cache counters, degradation +
            quarantine counts, runtime-history summary)
  METRICS:  u32 0             -> JSON frame {metrics: text} -
            Prometheus text exposition from the process registry
            (obs/metrics.py), folding dispatch.*, admission, cache,
            and query-lifecycle counters
  MEMBER:   u32 len | JSON    -> JSON frame - fleet membership
            (router/membership.py): {"op": "join"|"leave", "host",
            "port", ...}. A freshly started serve replica JOINs the
            router it fronts for (re-announced periodically, so a
            restarted router re-learns the fleet); a drained replica
            LEAVEs when empty. Only the router tier is a membership
            authority - a serve instance answers with an in-band
            error.
  PROFILE:  u32 len | JSON    -> JSON frame - live contention +
            sampling profiler control (obs/contention.py,
            obs/sampler.py): {"op": "start"|"stop"|"snapshot"|
            "reset", "hz"?, "top"?, "collapsed"?}. `start` arms lock
            accounting and the stack sampler on the receiving
            process; `snapshot` answers {profile: {top, collapsed,
            samples, ...}, contention: {lock: {waits, wait_s,
            hold_s, ...}}} - so a live fleet is profiled without
            restart. Both tiers answer for their own process.
  JSON frame: u32 len | utf8 JSON

Session semantics: queries submitted on a connection belong to it;
when the connection drops (EOF, broken pipe) every non-terminal
session query is cancelled - a vanished client must not keep holding
device admission slots. Poll/cancel/fetch work from ANY connection
(query ids are global), so detached orchestration is still possible
via a second connection. A submit whose meta carries "detach": true
opts OUT of cancel-on-disconnect: the query survives connection loss
so a reconnecting client can re-attach by query_id (the deadline
sweep and result TTL still bound an abandoned detached query's
lifetime).

The port serves these verbs on the threaded gateway plane
(runtime/gateway.py). Two paths of the JAX package's wire stay refused,
each with a classified error that names what it waits for: the fleet
tier's MESH_EXCHANGE (an in-band PLAN_INVALID JSON frame naming
ROADMAP 'Modules to port' item 7) and the event-loop FETCH
(`fetch_async`, service/wire_async.py, which comes with the second half
of item 8). MEMBER answers as the JAX package's serve does: this
endpoint is not a router.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Iterator, List, Optional

from blaze_tpu_torch.errors import ErrorClass
from blaze_tpu_torch.obs import trace as obs_trace
from blaze_tpu_torch.testing import chaos

MESH_EXCHANGE_REFUSAL = (
    "MESH_EXCHANGE: the fleet mesh tier waits for multi-GPU, ROADMAP "
    "'Modules to port' item 7"
)
ASYNC_WIRE_REFUSAL = (
    "the event-loop wire (service/wire_async.py) waits for the second "
    "half of ROADMAP 'Modules to port' item 8; serve on the threaded "
    "wire"
)

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_ERR = 0xFFFFFFFFFFFFFFFF
# arena-handle escape (zero-copy serve path): like _ERR it can never
# collide with a real part length (MAX_TASK_BYTES bounds frames)
_ARENA = 0xFFFFFFFFFFFFFFFE
# FETCH timeout_ms bit 31: client accepts a shared-memory arena handle
# in place of the byte stream (real timeouts are millisecond values,
# so the high bit is free)
_FETCH_ARENA = 1 << 31

VERB_SUBMIT = 1
VERB_POLL = 2
VERB_FETCH = 3
VERB_CANCEL = 4
VERB_REPORT = 5
VERB_STATS = 6
VERB_METRICS = 7
VERB_MEMBER = 8
VERB_PROFILE = 9
VERB_RELEASE = 10
VERB_MESH_EXCHANGE = 11

VERB_NAMES = {
    VERB_SUBMIT: "submit", VERB_POLL: "poll", VERB_FETCH: "fetch",
    VERB_CANCEL: "cancel", VERB_REPORT: "report", VERB_STATS: "stats",
    VERB_METRICS: "metrics", VERB_MEMBER: "member",
    VERB_PROFILE: "profile", VERB_RELEASE: "release",
    VERB_MESH_EXCHANGE: "mesh_exchange",
}

MAX_META_BYTES = 1 << 20
# response JSON frames may carry a whole trace document (REPORT);
# request-side frames keep the tighter MAX_META_BYTES bound
MAX_JSON_BYTES = 8 << 20
# MESH_EXCHANGE part frames carry whole stage boundaries (encoded
# Arrow-IPC segments); bound each frame the same way MAX_TASK_BYTES
# bounds a submitted plan
MAX_EXCHANGE_PART_BYTES = 256 << 20


class ServiceError(RuntimeError):
    """Error frame surfaced client-side; `.state` carries the query's
    terminal state name when the server included one."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.state = msg.split(":", 1)[0] if ":" in msg else ""


def _is_draining_rejection(resp: dict) -> bool:
    """True for the serving tier's DRAINING refusal (the 'DRAINING:'
    error prefix is the wire marker; service._reject_draining)."""
    return (
        resp.get("state") == "REJECTED_OVERLOADED"
        and str(resp.get("error", "")).startswith("DRAINING")
    )


def _is_tenant_budget_rejection(resp: dict) -> bool:
    """True for a tenant-budget refusal (the 'REJECTED_TENANT_BUDGET:'
    error prefix is the wire marker; service._reject_tenant_budget and
    the router's rate limiter both emit it). Mirrors the DRAINING
    contract: TRANSIENT, retried with the same bounded backoff, and a
    router spills it with zero breaker strikes."""
    return (
        resp.get("state") == "REJECTED_OVERLOADED"
        and str(resp.get("error", ""))
        .startswith("REJECTED_TENANT_BUDGET")
    )


# ---------------------------------------------------------------------------
# server side: ONE table-driven verb loop for both tiers
# ---------------------------------------------------------------------------
#
# The replica router re-implemented this loop's whole skeleton (verb
# decode, framing, the error-handling ladder, session teardown) with
# only the object behind the verbs changed. Factoring the skeleton
# around a small backend surface keeps the two protocol speakers
# byte-identical by construction - the same reason decode_submit_frame
# is shared. A backend provides:
#
#   submit(meta, task_bytes, is_ref, manifest_bytes) -> status dict
#   poll(qid) / cancel(qid) -> status dict
#   report_frame(qid, flags) -> REPORT response dict
#   stats() / metrics_frame() -> response dict
#   member_frame(payload) -> membership response dict (router tier)
#   fetch(sock, qid, timeout_ms)   owns its own framing (part stream)
#   abandon(qid)                   session teardown for one query


# POLL/CANCEL/REPORT/RELEASE share one frame shape: u32 id_len | id |
# u32 (RELEASE carries the arena lease id in the string slot)
_ID_VERBS = {
    VERB_POLL: lambda b, qid, flags: b.poll(qid),
    VERB_CANCEL: lambda b, qid, flags: b.cancel(qid),
    VERB_REPORT: lambda b, qid, flags: b.report_frame(qid, flags),
    VERB_RELEASE: lambda b, qid, flags: b.release_lease(qid),
}
# STATS/METRICS share the bare u32-reserved frame
_NOARG_VERBS = {
    VERB_STATS: lambda b: b.stats(),
    VERB_METRICS: lambda b: b.metrics_frame(),
}

# live connection-count gauges per tier, exported through the metrics
# collector surface (open/close only - never per verb)
_CONN_LOCK = threading.Lock()
_CONNECTIONS = {"service": 0, "router": 0}


def _conn_samples():
    with _CONN_LOCK:
        counts = dict(_CONNECTIONS)
    for tier, n in counts.items():
        yield ("blaze_connections", {"tier": tier}, n, "gauge")


def _observe_verb(tier: str, verb: int, t0: float, t_decoded: float,
                  t_dispatched: float, t_done: float) -> None:
    from blaze_tpu_torch.obs.metrics import REGISTRY

    name = VERB_NAMES.get(verb, str(verb))
    REGISTRY.observe("blaze_verb_seconds", t_decoded - t0,
                     tier=tier, verb=name, segment="decode")
    REGISTRY.observe("blaze_verb_seconds", t_dispatched - t_decoded,
                     tier=tier, verb=name, segment="dispatch")
    REGISTRY.observe("blaze_verb_seconds", t_done - t_dispatched,
                     tier=tier, verb=name, segment="reply")


def serve_verb_connection(sock, backend) -> None:
    """Drive one service-protocol connection until EOF against any
    verb backend (the QueryService adapter below, or the router's).
    Owns the shared skeleton: verb dispatch, the error-handling ladder
    (protocol violations close, id misses report in-band),
    cancel-on-disconnect session teardown - and the per-verb wire
    latency surface: every verb round trip records decode / dispatch /
    reply segment histograms (blaze_verb_seconds{tier,verb,segment}),
    the FIRST verb byte records accept-to-first-byte queueing delay,
    and live connections gauge per tier."""
    from blaze_tpu_torch.obs.metrics import REGISTRY
    from blaze_tpu_torch.runtime.transport import _recv_exact

    tier = getattr(backend, "tier", "service")
    # role tag for the sampling profiler (obs/sampler.py): the
    # socketserver default Thread-N name would hide the wire tier
    t = threading.current_thread()
    if not t.name.startswith("blaze-verb"):
        t.name = f"blaze-verb-{tier}"
    with _CONN_LOCK:
        _CONNECTIONS[tier] = _CONNECTIONS.get(tier, 0) + 1
    REGISTRY.register_collector("wire_connections", _conn_samples)
    t_accept = time.perf_counter()
    first_verb = True
    session_qids: List[str] = []
    try:
        while True:
            try:
                verb = _recv_exact(sock, 1)[0]
            except (ConnectionError, OSError):
                return  # clean EOF / client gone
            t0 = time.perf_counter()
            if first_verb:
                # accept-to-first-byte: how long an accepted
                # connection queued before its first request reached
                # this handler (the c16 backlog measure)
                first_verb = False
                REGISTRY.observe("blaze_accept_first_byte_seconds",
                                 t0 - t_accept, tier=tier)
            try:
                if verb == VERB_SUBMIT:
                    meta, blob, is_ref, manifest_bytes = (
                        decode_submit_frame(sock)
                    )
                    t1 = time.perf_counter()
                    resp = backend.submit(
                        meta, blob, is_ref, manifest_bytes
                    )
                    t2 = time.perf_counter()
                    if not meta.get("detach") \
                            and "query_id" in resp:
                        # attached (default): cancel-on-disconnect
                        # session semantics; detached queries survive
                        # connection loss for re-attach
                        session_qids.append(resp["query_id"])
                    _send_json(sock, resp)
                elif verb == VERB_FETCH:
                    qid = _read_str(sock)
                    timeout_ms = _read_u32(sock)
                    t1 = time.perf_counter()
                    # fetch owns its own framing: the part stream is
                    # the dispatch segment, reply is the terminator
                    backend.fetch(sock, qid, timeout_ms)
                    t2 = time.perf_counter()
                elif verb in _ID_VERBS:
                    qid = _read_str(sock)
                    flags = _read_u32(sock)
                    t1 = time.perf_counter()
                    resp = _ID_VERBS[verb](backend, qid, flags)
                    t2 = time.perf_counter()
                    _send_json(sock, resp)
                elif verb == VERB_MEMBER:
                    payload = json.loads(_read_str(sock) or "{}")
                    t1 = time.perf_counter()
                    resp = backend.member_frame(payload)
                    t2 = time.perf_counter()
                    _send_json(sock, resp)
                elif verb == VERB_PROFILE:
                    payload = json.loads(_read_str(sock) or "{}")
                    t1 = time.perf_counter()
                    resp = backend.profile_frame(payload)
                    t2 = time.perf_counter()
                    _send_json(sock, resp)
                elif verb == VERB_MESH_EXCHANGE:
                    # fleet DCN plane: u32 JSON control frame + u64
                    # framed Arrow-IPC parts, zero-terminated. The
                    # parts are drained BEFORE dispatch no matter
                    # what the op is, so a handler error leaves the
                    # connection in sync (in-band error JSON, no
                    # part stream follows it)
                    payload = json.loads(_read_str(sock) or "{}")
                    parts: List[bytes] = []
                    while True:
                        (plen,) = _U64.unpack(
                            _recv_exact(sock, _U64.size)
                        )
                        if plen == 0:
                            break
                        if plen > MAX_EXCHANGE_PART_BYTES:
                            raise ValueError(
                                "oversized exchange part"
                            )
                        parts.append(_recv_exact(sock, plen))
                    t1 = time.perf_counter()
                    resp, out_parts = backend.mesh_exchange_frame(
                        payload, parts
                    )
                    t2 = time.perf_counter()
                    _send_json(sock, resp)
                    for p in out_parts:
                        sock.sendall(_U64.pack(len(p)) + p)
                    sock.sendall(_U64.pack(0))
                elif verb in _NOARG_VERBS:
                    _read_u32(sock)
                    t1 = time.perf_counter()
                    resp = _NOARG_VERBS[verb](backend)
                    t2 = time.perf_counter()
                    _send_json(sock, resp)
                else:
                    raise ValueError(f"unknown service verb {verb}")
                _observe_verb(tier, verb, t0, t1, t2,
                              time.perf_counter())
            except (ConnectionError, BrokenPipeError, OSError):
                return  # mid-verb disconnect: session cleanup below
            except ValueError as e:
                # protocol violation (oversized frame, unknown verb,
                # bad manifest): the connection may hold unread payload
                # bytes that would be misparsed as verbs - report
                # best-effort and CLOSE instead of desyncing
                try:
                    _send_json(
                        sock,
                        {"error": f"protocol error: {e}"[:65536],
                         "fatal": True},
                    )
                except OSError:
                    pass
                return
            except KeyError as e:
                # id lookups fail AFTER their frame is fully read -
                # the connection is still in sync, report in-band
                _send_json(sock, {"error": f"unknown query: {e}"})
            except Exception as e:  # noqa: BLE001 - reported in-band
                _send_json(
                    sock,
                    {"error": f"{type(e).__name__}: {e}"[:65536]},
                )
    finally:
        with _CONN_LOCK:
            _CONNECTIONS[tier] = max(0, _CONNECTIONS.get(tier, 1) - 1)
        # session teardown: a disconnected client's pending queries
        # must not keep occupying the queue or the device
        for qid in session_qids:
            try:
                backend.abandon(qid)
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass


# PROFILE verb ops, shared by both tier backends. `start` enables
# contention accounting + the stack sampler exactly once no matter how
# many starts arrive (the refcount must balance the eventual stop);
# `snapshot` serves both surfaces; `reset` zeroes them between
# measurement windows (the profile CLI's per-concurrency sections).
_PROFILE_LOCK = threading.Lock()
_PROFILE_ARMED = False


def verb_latency_summary() -> dict:
    """Per-verb wire latency from this process's registry, folded as
    {verb: {segment: {count, sum, mean}}} - the profile report's
    per-verb section (decode / dispatch / reply segments)."""
    from blaze_tpu_torch.obs.metrics import REGISTRY

    out: dict = {}
    for labels, summ in REGISTRY.histogram_summaries(
        "blaze_verb_seconds"
    ):
        verb = labels.get("verb", "?")
        seg = labels.get("segment", "?")
        out.setdefault(verb, {})[seg] = summ
    return out


def handle_profile_frame(tier: str, payload: dict) -> dict:
    global _PROFILE_ARMED
    from blaze_tpu_torch.obs import contention, sampler

    op = str(payload.get("op", "snapshot"))
    if op == "start":
        with _PROFILE_LOCK:
            if not _PROFILE_ARMED:
                contention.enable()
                _PROFILE_ARMED = True
        sampler.start(hz=float(payload.get("hz", 67.0)))
        return {"ok": True, "tier": tier, "profiling": True}
    if op == "stop":
        sampler.stop()
        with _PROFILE_LOCK:
            if _PROFILE_ARMED:
                contention.disable()
                _PROFILE_ARMED = False
        return {"ok": True, "tier": tier, "profiling": False}
    if op == "reset":
        contention.reset_stats()
        s = sampler.current()
        if s is not None:
            s.reset()
        return {"ok": True, "tier": tier}
    if op == "snapshot":
        return {
            "ok": True,
            "tier": tier,
            "profile": sampler.snapshot(
                top_n=int(payload.get("top", 20)),
                include_collapsed=bool(
                    payload.get("collapsed", True)
                ),
            ),
            "contention": contention.snapshot(),
            "top_locks": contention.top_locks(
                int(payload.get("top_locks", 3))
            ),
            "verbs": verb_latency_summary(),
        }
    raise ValueError(f"unknown profile op {op!r}")


class ServiceVerbBackend:
    """The QueryService behind the shared verb loop."""

    tier = "service"

    def __init__(self, service):
        self.service = service

    def submit(self, meta: dict, task_bytes: bytes, is_ref: bool,
               manifest_bytes: Optional[bytes]) -> dict:
        from blaze_tpu_torch.runtime.gateway import _manifest_resources

        resources = {}
        if manifest_bytes is not None:
            resources = _manifest_resources(
                json.loads(manifest_bytes)
            )
        q = self.service.submit_task(
            task_bytes,
            is_ref=is_ref,
            resources=resources,
            priority=int(meta.get("priority", 0)),
            deadline_s=meta.get("deadline_s"),
            estimated_bytes=meta.get("estimated_bytes"),
            use_cache=bool(meta.get("use_cache", True)),
            # plan-cache key forwarded by the router (the affinity
            # digest it already computed over these exact bytes) so
            # the replica never re-hashes the blob
            plan_digest=meta.get("plan_digest"),
            tenant=str(meta.get("tenant") or "default"),
        )
        return q.status()

    def poll(self, qid: str) -> dict:
        return self.service.poll(qid)

    def cancel(self, qid: str) -> dict:
        return self.service.cancel(qid)

    def report_frame(self, qid: str, flags: int) -> dict:
        resp = {"report": self.service.report(qid)}
        # trace is OPT-IN (flags bit 0 = rendered Chrome doc, bit 1 =
        # raw span dicts for the router's cross-hop graft):
        # serializing a multi-MB span tree on every text-report poll
        # would tax exactly the hot path observability must not
        trace_of = getattr(self.service, "trace", None)
        if flags & 1 and trace_of is not None:
            doc = trace_of(qid)
            if doc is not None:
                resp["trace"] = doc
        spans_of = getattr(self.service, "trace_spans", None)
        if flags & 2 and spans_of is not None:
            spans = spans_of(qid)
            if spans is not None:
                resp["trace_spans"] = spans
        return resp

    def stats(self) -> dict:
        return self.service.stats()

    def metrics_frame(self) -> dict:
        from blaze_tpu_torch.obs.metrics import REGISTRY

        t0 = time.perf_counter()
        text = REGISTRY.render_prometheus()
        # self-metric: scrape cost is itself observable (lands in the
        # NEXT exposition - the standard self-scrape semantics)
        REGISTRY.observe("blaze_scrape_seconds",
                         time.perf_counter() - t0, tier="service")
        return {"metrics": text}

    def member_frame(self, payload: dict) -> dict:
        # a single serve instance is not a membership authority - the
        # router tier (router/proxy.RouterVerbBackend) owns the fleet
        return {"error": "membership: this endpoint is not a router"}

    def mesh_exchange_frame(self, payload: dict, parts: list):
        """Fleet mesh DCN plane (the JAX package's fleet/exchange.py):
        refused in band, classified, with no part stream after it -
        the fleet tier waits for multi-GPU."""
        return {"error": MESH_EXCHANGE_REFUSAL,
                "error_class": ErrorClass.PLAN_INVALID.value}, []

    def profile_frame(self, payload: dict) -> dict:
        return handle_profile_frame(self.tier, payload)

    def abandon(self, qid: str) -> None:
        try:
            q = self.service.get(qid)
        except KeyError:
            return
        if not q.done:
            self.service.cancel(qid)

    def release_lease(self, lease: str) -> dict:
        arena = getattr(self.service, "arena", None)
        if arena is None:
            return {"released": False}
        try:
            return {"released": arena.release(int(lease))}
        except (TypeError, ValueError):
            return {"released": False}

    async def fetch_async(self, writer, qid: str,
                          timeout_ms: int) -> None:
        """Event-loop FETCH (the JAX package's service/wire_async.py):
        the event-loop wire is not ported yet, so this raises."""
        raise NotImplementedError(ASYNC_WIRE_REFUSAL)

    def fetch(self, sock, qid: str, timeout_ms: int) -> None:
        try:
            q = self.service.get(qid)
        except KeyError:
            # includes queries the orphan sweep reaped: a dead
            # router's abandoned handle answers classified not-found,
            # never a hang
            _send_err(sock, f"UNKNOWN: no query {qid}")
            return
        # bit 31 of timeout_ms: the client accepts an arena handle
        arena_ok = bool(timeout_ms & _FETCH_ARENA)
        timeout_ms &= _FETCH_ARENA - 1
        q.note_activity()  # a FETCH defers the orphan sweep
        # in-progress-fetch guard: the orphan sweep must not reap a
        # query mid-collection (a slow first part or a long DONE-wait
        # could otherwise out-idle a short TTL); released in the
        # finally below
        q.begin_fetch()
        try:
            self._fetch_stream(sock, q, timeout_ms, arena_ok)
        finally:
            q.end_fetch()
            q.note_activity()

    def _fetch_stream(self, sock, q, timeout_ms: int,
                      arena_ok: bool = False) -> None:
        if self._serve_arena(sock, q, arena_ok):
            return
        sb = getattr(q, "stream", None)
        if sb is not None:
            # streaming service (the default): deliver parts as the
            # executor produces them - FETCH no longer waits for DONE
            self._fetch_incremental(sock, q, sb, timeout_ms)
            return
        self._fetch_materialized(sock, q, timeout_ms)

    def _serve_arena(self, sock, q, arena_ok: bool) -> bool:
        """Zero-copy FETCH of a finalized result (zerocopy/arena.py).
        When the query is DONE and its encoded part frames live in an
        arena segment, either lease the segment to the client (arena
        handle escape, `arena_ok`) or stream the frames as a
        scatter-gather buffer list - no Arrow re-encode either way,
        bytes identical to the per-batch path by construction. Returns
        False (and sends NOTHING) whenever the arena does not cover
        the query, so every fallback stays on the ordinary paths."""
        from blaze_tpu_torch.service.query import QueryState

        arena = getattr(self.service, "arena", None)
        if (
            arena is None or not q.done
            or q.state is not QueryState.DONE
            or q._fingerprint is None or not q._fingerprint_stable
            or not q.use_cache or q.degraded
        ):
            return False
        key = q._fingerprint
        stream_start = time.monotonic()
        if arena_ok:
            handle = arena.handle(key)
            if handle is not None:
                data = json.dumps(handle).encode("utf-8")
                sock.sendall(
                    _U64.pack(_ARENA) + _U32.pack(len(data)) + data
                )
                q.fetched = True
                self._note_arena_stream(
                    q, stream_start, len(handle["offsets"]),
                    mode="handle",
                )
                return True
        views = arena.buffers(key)
        if views is None:
            return False
        from blaze_tpu_torch.runtime.transport import sendmsg_all

        if chaos.ACTIVE:
            # mid-stream drop/stall seam: the whole buffer list goes
            # out in one scatter-gather burst, so the seam fires once
            # up front (a DROP aborts the stream before any bytes)
            chaos.fire("gateway.stream", query_id=q.query_id,
                       partition=0)
        sendmsg_all(sock, [*views, _U64.pack(0)])
        q.fetched = True
        q.note_activity()
        self._note_arena_stream(q, stream_start, len(views),
                                mode="sg")
        return True

    def _note_arena_stream(self, q, stream_start: float, parts: int,
                           mode: str) -> None:
        stream_s = time.monotonic() - stream_start
        q.timings["stream_ns"] = (
            q.timings.get("stream_ns", 0) + int(stream_s * 1e9)
        )
        if getattr(self.service, "_fold_phases", True):
            from blaze_tpu_torch.obs import phases as obs_phases

            obs_phases.ROLLUP.observe(
                "stream", stream_s,
                klass=obs_phases.class_key(
                    q._fingerprint, q._fingerprint_stable
                ),
            )
        if obs_trace.ACTIVE and getattr(q, "tracer", None) is not None:
            q.tracer.record_span(
                "result_stream", stream_start, time.monotonic(),
                parts=parts, arena=mode,
            )

    def _fetch_incremental(self, sock, q, sb, timeout_ms: int) -> None:
        """Stream-as-produced FETCH (service/stream.py): drain the
        query's ring while it is still RUNNING. `timeout_ms` bounds
        the wait for the FIRST part (time-to-first-byte); once parts
        flow, production is bounded by the query's own deadline/cancel
        machinery and delivery by the stall budget. The wire format is
        UNCHANGED (u64-framed parts, u64 0 terminator, u64 ERR escape
        before the first part), so clients - and the router relay -
        need no new protocol: the count-based part-skip resume simply
        starts working mid-query."""
        from blaze_tpu_torch.io.ipc import encode_ipc_segment

        service = self.service
        qid = q.query_id
        deadline = (
            time.monotonic() + timeout_ms / 1000.0
            if timeout_ms else None
        )
        sb.attach()
        t0 = time.perf_counter_ns()
        stream_start = time.monotonic()
        sent = 0
        live_parts = 0  # parts shipped while the query was RUNNING
        complete = False
        stall_s = getattr(service, "stream_stall_s", 0.0) or 0.0
        prev_timeout = sock.gettimeout()
        if stall_s > 0:
            # send-side slow-consumer bound: a stalled reader of a
            # DONE query's stream has no producer left to
            # backpressure, so the socket send timeout is the stall
            # budget on this half of the pipe
            sock.settimeout(stall_s)
        try:
            i = 0
            while True:
                if sent == 0 and deadline is not None:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        _send_err(
                            sock, f"{q.state.value}: fetch timed out"
                        )
                        return
                    kind, payload = sb.next_ready(i, min(0.25, rem))
                else:
                    kind, payload = sb.next_ready(i, 0.25)
                if kind == "timeout":
                    continue
                if kind == "part":
                    if chaos.ACTIVE:
                        # chaos seam: drop/stall mid-result-stream,
                        # now covering the IN-PROGRESS window (the
                        # part may ship while the query is RUNNING)
                        chaos.fire("gateway.stream", query_id=qid,
                                   partition=i)
                    if not q.done:
                        live_parts += 1
                    # committed-for-delivery BEFORE the send: a part
                    # on the wire can never be truncated by a retry
                    # rollback (delivered-prefix consistency)
                    sb.mark_consumed(i)
                    try:
                        sock.sendall(encode_ipc_segment(payload))
                    except (socket.timeout, TimeoutError) as e:
                        service._note_stream_event("stall")
                        raise ConnectionError(
                            f"fetch send stalled past {stall_s}s"
                        ) from e
                    sent += 1
                    i += 1
                    # per-part activity: a slow COLLECTING client is
                    # not a dead router (orphan sweep)
                    q.note_activity()
                    continue
                if kind == "finished":
                    # the ring finishes at the DONE transition, so
                    # the terminal state is already set; the
                    # terminator closes the part stream
                    sock.sendall(_U64.pack(0))
                    complete = True
                    q.fetched = True
                    return
                # aborted: terminal (or about to be) with no result.
                # Parts already on the wire -> a JSON/ERR frame would
                # desync the u64 framing: abort the connection and
                # let the client's resume path re-FETCH the
                # classified outcome. Zero parts -> wait out the tiny
                # abort->terminal window so the state prefix the
                # router keys on is the real terminal state, then
                # answer in-band
                if sent:
                    raise ConnectionError(
                        f"fetch stream aborted: {payload}"
                    )
                q.wait(5.0)
                _send_err(
                    sock,
                    f"{q.state.value}: {q.error or 'not completed'}",
                )
                return
        finally:
            if stall_s > 0:
                try:
                    sock.settimeout(prev_timeout)
                except OSError:
                    pass
            stream_s = (time.perf_counter_ns() - t0) / 1e9
            q.timings["stream_ns"] = (
                q.timings.get("stream_ns", 0)
                + (time.perf_counter_ns() - t0)
            )
            if complete and getattr(service, "_fold_phases", True):
                from blaze_tpu_torch.obs import phases as obs_phases

                obs_phases.ROLLUP.observe(
                    "stream", stream_s,
                    klass=obs_phases.class_key(
                        q._fingerprint, q._fingerprint_stable
                    ),
                )
            if obs_trace.ACTIVE \
                    and getattr(q, "tracer", None) is not None:
                # the `stream` span now covers the INCREMENTAL window:
                # it may open while the root span is still live (parts
                # shipping during RUNNING); live_parts says how much
                # of the stream overlapped execution
                tags = {"parts": sent, "total": sb.total_parts(),
                        "live_parts": live_parts}
                if not complete:
                    tags["aborted"] = True
                q.tracer.record_span(
                    "result_stream", stream_start, time.monotonic(),
                    **tags,
                )

    def _fetch_materialized(self, sock, q, timeout_ms: int) -> None:
        """Legacy materialize-then-stream FETCH: only reachable when
        the service runs with streaming disabled
        (stream_buffer_bytes <= 0)."""
        from blaze_tpu_torch.io.ipc import encode_ipc_segment
        from blaze_tpu_torch.service.query import QueryState

        service = self.service
        qid = q.query_id
        if not q.wait(timeout_ms / 1000.0 if timeout_ms else None):
            _send_err(sock, f"{q.state.value}: fetch timed out")
            return
        if q.state is not QueryState.DONE:
            _send_err(
                sock, f"{q.state.value}: {q.error or 'not completed'}"
            )
            return
        t0 = time.perf_counter_ns()
        stream_start = time.monotonic()
        sent = 0
        complete = False
        try:
            for i, rb in enumerate(q.result or ()):
                if chaos.ACTIVE:
                    # chaos seam: connection drop mid-result-stream
                    # (the client's reconnect-and-refetch path covers
                    # it)
                    chaos.fire("gateway.stream", query_id=qid,
                               partition=i)
                sock.sendall(encode_ipc_segment(rb))
                sent += 1
                # per-part activity: a stream slower than the orphan
                # TTL is still a COLLECTING client, not a dead router
                q.note_activity()
            sock.sendall(_U64.pack(0))
            complete = True
            # a fully-streamed result was COLLECTED: it is no orphan
            # candidate no matter how long it then sits in retention
            q.fetched = True
        except Exception as e:
            # once parts are on the wire the client reads u64 frames;
            # a JSON error frame here would desync it - abort the
            # connection (truncated stream surfaces client-side as
            # ConnectionError)
            raise ConnectionError(
                f"fetch stream aborted: {e!r}"
            ) from e
        finally:
            stream_s = (time.perf_counter_ns() - t0) / 1e9
            q.timings["stream_ns"] = (
                q.timings.get("stream_ns", 0)
                + (time.perf_counter_ns() - t0)
            )
            if complete and getattr(service, "_fold_phases", True):
                # stream phase rolls up at FETCH end (it happens
                # after the terminal-hook fold); aborted streams are
                # re-fetched and would double-count. Gated by the
                # same fold_phases switch as the terminal hook (the
                # regress probe must not skew the live rollup)
                from blaze_tpu_torch.obs import phases as obs_phases

                obs_phases.ROLLUP.observe(
                    "stream", stream_s,
                    klass=obs_phases.class_key(
                        q._fingerprint, q._fingerprint_stable
                    ),
                )
            if obs_trace.ACTIVE \
                    and getattr(q, "tracer", None) is not None:
                # result streaming happens AFTER the root span closed
                # (terminal state), so it records as a sibling span on
                # the lifecycle track; `parts` counts what was
                # ACTUALLY sent - an aborted stream (and the client's
                # re-FETCH, which records its own span) must not claim
                # full delivery
                tags = {"parts": sent, "total": len(q.result or ())}
                if not complete:
                    tags["aborted"] = True
                q.tracer.record_span(
                    "result_stream", stream_start, time.monotonic(),
                    **tags,
                )


def handle_service_connection(sock, service) -> None:
    """Drive one service connection until EOF. Called from the gateway
    handler after it consumed the hello header."""
    serve_verb_connection(sock, ServiceVerbBackend(service))


def _read_u32(sock) -> int:
    from blaze_tpu_torch.runtime.transport import _recv_exact

    (v,) = _U32.unpack(_recv_exact(sock, _U32.size))
    return v


def _read_str(sock) -> str:
    from blaze_tpu_torch.runtime.transport import _recv_exact

    n = _read_u32(sock)
    if n > MAX_META_BYTES:
        raise ValueError("string frame too large")
    return _recv_exact(sock, n).decode("utf-8")


def _send_json(sock, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(_U32.pack(len(data)) + data)


def _send_err(sock, msg: str) -> None:
    data = msg.encode("utf-8")[:65536]
    sock.sendall(_U64.pack(_ERR) + _U32.pack(len(data)) + data)


# ---------------------------------------------------------------------------
# frame encoding (shared by ServiceClient and the replica router, which
# forwards a client's SUBMIT downstream byte-compatibly)
# ---------------------------------------------------------------------------


def decode_submit_frame(sock):
    """Read one SUBMIT verb frame off `sock` (verb byte already
    consumed) -> (meta, task_bytes, is_ref, manifest_bytes). The
    single decode used by BOTH the service handler and the replica
    router's proxy, so the frame format (flag bits, bounds) cannot
    drift between tiers; `manifest_bytes` stays un-parsed for
    forwarding."""
    from blaze_tpu_torch.runtime.gateway import (
        MAX_TASK_BYTES,
        _FLAG_MANIFEST,
        _FLAG_REF,
    )
    from blaze_tpu_torch.runtime.transport import _recv_exact

    (meta_len,) = _U32.unpack(_recv_exact(sock, _U32.size))
    if meta_len > MAX_META_BYTES:
        raise ValueError("submit meta too large")
    meta = json.loads(_recv_exact(sock, meta_len) or b"{}")
    (header,) = _U64.unpack(_recv_exact(sock, _U64.size))
    is_ref = bool(header & _FLAG_REF)
    has_manifest = bool(header & _FLAG_MANIFEST)
    blob_len = header & ~(_FLAG_REF | _FLAG_MANIFEST)
    if blob_len > MAX_TASK_BYTES:
        raise ValueError("task too large")
    manifest_bytes = None
    if has_manifest:
        (mlen,) = _U32.unpack(_recv_exact(sock, _U32.size))
        if mlen > MAX_TASK_BYTES:
            raise ValueError("manifest too large")
        manifest_bytes = _recv_exact(sock, mlen)
    return meta, _recv_exact(sock, blob_len), is_ref, manifest_bytes


def encode_submit_frame(
    meta: dict,
    task_bytes: bytes,
    *,
    is_ref: bool = False,
    manifest_bytes: Optional[bytes] = None,
) -> bytes:
    """One SUBMIT verb frame. `meta` is forwarded verbatim (unknown
    keys travel untouched - the router relies on this to stay out of
    the meta schema's way); `manifest_bytes` is the already-encoded
    manifest JSON, so a proxy never re-serializes what it did not
    parse."""
    from blaze_tpu_torch.runtime.gateway import _FLAG_MANIFEST, _FLAG_REF

    meta_b = json.dumps(meta).encode("utf-8")
    header = len(task_bytes)
    if is_ref:
        header |= _FLAG_REF
    payload = b""
    if manifest_bytes is not None:
        header |= _FLAG_MANIFEST
        payload = _U32.pack(len(manifest_bytes)) + manifest_bytes
    return (
        bytes([VERB_SUBMIT])
        + _U32.pack(len(meta_b)) + meta_b
        + _U64.pack(header) + payload + task_bytes
    )


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------


class ServiceClient:
    """Multi-query client for the service protocol. One socket, many
    queries; every call is a synchronous verb round trip.

    Reconnect-with-backoff: on a dropped connection the client
    transparently reconnects (bounded attempts, exponential backoff +
    jitter) and re-attaches by query_id - polls re-issue, and a FETCH
    interrupted mid-stream re-issues and skips the parts already
    delivered (the server streams one materialized part per batch,
    deterministically). What survives the drop server-side: DONE
    results (until retention/TTL) and queries submitted with
    `detach=True`; a default (attached) submit still in flight is
    cancelled by the server's session teardown when it notices the
    disconnect - submit with detach=True when the handle must outlive
    the connection. Submits retry too: a submit whose CONNECTION died
    before the response frame may have registered server-side, but
    re-submitting is safe - the result cache dedupes stable plans and
    a duplicate query is merely wasted work, never a wrong answer.
    Set reconnect_attempts=0 to restore fail-fast behavior."""

    def __init__(self, host: str, port: int, timeout: float = 120.0,
                 reconnect_attempts: int = 4,
                 reconnect_backoff_s: float = 0.05,
                 use_arena: bool = False,
                 tenant: str = "default"):
        self._addr = (host, port)
        self._timeout = timeout
        self._reconnect_attempts = int(reconnect_attempts)
        self._reconnect_backoff_s = float(reconnect_backoff_s)
        # client-level tenant identity: every submit() carries it in
        # SUBMIT meta unless overridden per call (docs/SERVICE.md
        # "Tenancy"); "default" = untagged traffic
        self._tenant = str(tenant or "default")
        # shared-memory FETCH opt-in (zerocopy/arena.py): only a
        # client co-located with the server can map the segment paths
        # a handle names, so the default stays the byte path; a failed
        # map degrades back to bytes transparently either way
        self._use_arena = bool(use_arena)
        self._sock = None
        self._connect()

    def _connect(self) -> None:
        from blaze_tpu_torch.runtime.gateway import _FLAG_SERVICE

        self._sock = socket.create_connection(
            self._addr, timeout=self._timeout
        )
        self._sock.sendall(_U64.pack(_FLAG_SERVICE))

    def _reconnect(self) -> None:
        import random

        self.close()
        last: Optional[Exception] = None
        for attempt in range(self._reconnect_attempts):
            delay = self._reconnect_backoff_s * (2 ** attempt)
            time.sleep(random.uniform(delay * 0.5, delay))
            try:
                self._connect()
                return
            except OSError as e:
                last = e
        raise ServiceError(f"RECONNECT_FAILED: {last!r}")

    def _roundtrip(self, payload: bytes) -> dict:
        """Send one verb frame and read its JSON response, reconnecting
        once on a dropped connection (every verb frame is
        self-contained, so a resend after reconnect is in-sync)."""
        for attempt in (0, 1):
            try:
                if self._sock is None:
                    # closed by close() or a failed reconnect: try a
                    # fresh connection instead of AttributeError-ing
                    self._connect()
                self._sock.sendall(payload)
                return self._read_json()
            except (ConnectionError, OSError):
                if attempt or self._reconnect_attempts <= 0:
                    raise
                self._reconnect()
        raise AssertionError("unreachable")

    # -- verbs ----------------------------------------------------------
    def submit(
        self,
        task_bytes: bytes,
        *,
        is_ref: bool = False,
        manifest: Optional[dict] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        estimated_bytes: Optional[int] = None,
        use_cache: bool = True,
        detach: bool = False,
        tenant: Optional[str] = None,
    ) -> dict:
        """`detach=True` opts the query out of the server's
        cancel-on-disconnect session semantics, so the handle survives
        a connection drop and this client's reconnect can re-attach
        by query_id. `tenant` overrides the client-level tenant for
        this one submit.

        A DRAINING rejection (the replica is mid-rolling-restart) is
        retried with the same bounded backoff as a dropped connection
        - the replica, or its restarted replacement behind the same
        address, comes back - and surfaces as a classified TRANSIENT
        `ReplicaDrainingError` only once the budget is spent
        (`reconnect_attempts=0` restores fail-fast). A tenant-budget
        rejection (REJECTED_TENANT_BUDGET: this tenant is over its
        admission budget or rate limit) follows the exact same
        retry-then-classify contract, surfacing as
        `TenantBudgetError`."""
        import random

        meta = {
            "priority": priority,
            "deadline_s": deadline_s,
            "estimated_bytes": estimated_bytes,
            "use_cache": use_cache,
            "detach": detach,
            "tenant": str(tenant or self._tenant),
        }
        manifest_bytes = (
            json.dumps(manifest).encode("utf-8")
            if manifest is not None else None
        )
        for attempt in range(max(1, self._reconnect_attempts + 1)):
            resp = self.submit_raw(
                task_bytes, meta=meta, is_ref=is_ref,
                manifest_bytes=manifest_bytes,
            )
            if not (_is_draining_rejection(resp)
                    or _is_tenant_budget_rejection(resp)):
                return resp
            if attempt >= self._reconnect_attempts:
                break
            delay = self._reconnect_backoff_s * (2 ** attempt)
            time.sleep(random.uniform(delay * 0.5, delay))
        if _is_tenant_budget_rejection(resp):
            from blaze_tpu_torch.errors import TenantBudgetError

            raise TenantBudgetError(
                resp.get("error",
                         "REJECTED_TENANT_BUDGET: over budget")
            )
        from blaze_tpu_torch.errors import ReplicaDrainingError

        raise ReplicaDrainingError(
            resp.get("error", "DRAINING: replica is draining")
        )

    def submit_raw(
        self,
        task_bytes: bytes,
        *,
        meta: dict,
        is_ref: bool = False,
        manifest_bytes: Optional[bytes] = None,
    ) -> dict:
        """Submit with a caller-built meta dict, forwarded verbatim.
        The router tier uses this to proxy a client's SUBMIT without
        re-interpreting (or dropping) meta keys it does not know."""
        return self._roundtrip(
            encode_submit_frame(
                meta, task_bytes, is_ref=is_ref,
                manifest_bytes=manifest_bytes,
            )
        )

    def poll(self, query_id: str) -> dict:
        return self._roundtrip(self._id_verb(VERB_POLL, query_id))

    def cancel(self, query_id: str) -> dict:
        return self._roundtrip(self._id_verb(VERB_CANCEL, query_id))

    def report(self, query_id: str) -> str:
        return self._roundtrip(
            self._id_verb(VERB_REPORT, query_id)
        )["report"]

    def report_full(self, query_id: str,
                    include_trace: bool = True,
                    include_spans: bool = False) -> dict:
        """The whole REPORT frame: {report: text, trace?: Chrome trace
        JSON, trace_spans?: raw span dicts}. The trace document is
        requested via flags bit 0 (plain `report()` skips it - text
        polling must not pay a multi-MB span-tree serialization);
        `python -m blaze_tpu_torch trace` consumes the trace field. Flags
        bit 1 requests the RAW span dicts instead - the replica
        router's cross-hop graft input (attach_subtree)."""
        flags = (1 if include_trace else 0) \
            | (2 if include_spans else 0)
        return self._roundtrip(
            self._id_verb(VERB_REPORT, query_id, flags)
        )

    def stats(self) -> dict:
        return self._roundtrip(bytes([VERB_STATS]) + _U32.pack(0))

    def metrics(self) -> str:
        """Prometheus text exposition from the server's process
        metrics registry (obs/metrics.py)."""
        return self._roundtrip(
            bytes([VERB_METRICS]) + _U32.pack(0)
        )["metrics"]

    def member(self, payload: dict) -> dict:
        """One membership round trip (MEMBER verb): {"op": "join" |
        "leave", "host", "port", ...} against a router endpoint. The
        announcer (router/membership.py) drives this; a non-router
        endpoint answers with an in-band error."""
        data = json.dumps(payload).encode("utf-8")
        return self._roundtrip(
            bytes([VERB_MEMBER]) + _U32.pack(len(data)) + data
        )

    def mesh_exchange(self, payload: dict, parts=()) -> tuple:
        """One MESH_EXCHANGE round trip (the fleet tier's DCN plane):
        a JSON control frame plus u64-framed encoded Arrow-IPC parts
        each way. Returns (response_dict, out_parts). An in-band
        error response carries NO part stream (the server drained our
        parts before dispatch, so the connection stays in sync). The
        send + JSON read ride the standard one-reconnect retry; a
        drop mid part-stream propagates to the caller (the fleet
        executor's degrade ladder owns that)."""
        from blaze_tpu_torch.runtime.transport import _recv_exact

        data = json.dumps(payload).encode("utf-8")
        buf = bytearray(
            bytes([VERB_MESH_EXCHANGE]) + _U32.pack(len(data)) + data
        )
        for p in parts:
            buf += _U64.pack(len(p))
            buf += p
        buf += _U64.pack(0)
        resp = self._roundtrip(bytes(buf))
        if "error" in resp:
            return resp, []
        out: List[bytes] = []
        while True:
            (n,) = _U64.unpack(_recv_exact(self._sock, _U64.size))
            if n == 0:
                break
            if n > MAX_EXCHANGE_PART_BYTES:
                raise ValueError("oversized exchange part")
            out.append(_recv_exact(self._sock, n))
        return resp, out

    def profile(self, payload: Optional[dict] = None) -> dict:
        """One PROFILE round trip: {"op": "start"|"stop"|"snapshot"|
        "reset", ...} against either tier - arm contention accounting
        + the stack sampler on a LIVE process and pull the folded
        report back, no restart required. Default op is snapshot."""
        data = json.dumps(payload or {}).encode("utf-8")
        return self._roundtrip(
            bytes([VERB_PROFILE]) + _U32.pack(len(data)) + data
        )

    def fetch(self, query_id: str, timeout_ms: int = 0) -> list:
        """Materialize the result stream (list of pa.RecordBatch)."""
        return list(self.fetch_stream(query_id, timeout_ms))

    def fetch_stream(self, query_id: str,
                     timeout_ms: int = 0) -> Iterator:
        """Stream the result parts. Closing the client (or abandoning
        the socket) mid-stream is the wire-level cancel. A connection
        dropped by the SERVER mid-stream triggers reconnect +
        re-FETCH, skipping the parts already yielded (results are
        materialized server-side; the part sequence is stable)."""
        parts_yielded = 0
        refetches = 0
        while True:
            try:
                yield from self._fetch_parts(
                    query_id, timeout_ms, skip=parts_yielded
                )
                return
            except ServiceError:
                raise  # in-band terminal state, not a drop
            except (ConnectionError, OSError):
                if refetches >= max(0, self._reconnect_attempts):
                    raise
                refetches += 1
                self._reconnect()
                parts_yielded = self._parts_done

    def _fetch_parts(self, query_id: str, timeout_ms: int,
                     skip: int) -> Iterator:
        from blaze_tpu_torch.runtime.transport import _recv_exact

        self._parts_done = skip
        arena_ok = self._use_arena
        while True:
            if self._sock is None:
                self._connect()
            self._sock.sendall(
                self._id_verb(
                    VERB_FETCH, query_id,
                    timeout_ms | (_FETCH_ARENA if arena_ok else 0),
                )
            )
            part = 0
            resend = False
            while True:
                (length,) = _U64.unpack(
                    _recv_exact(self._sock, _U64.size)
                )
                if length == 0:
                    return
                if length == _ERR:
                    (mlen,) = _U32.unpack(
                        _recv_exact(self._sock, _U32.size)
                    )
                    msg = _recv_exact(self._sock, mlen).decode("utf-8")
                    raise ServiceError(msg)
                if length == _ARENA:
                    # shared-memory handoff: map the leased segment
                    # and decode the identical frames locally. ANY
                    # failure (not co-located, stale lease, chaos
                    # seams) falls back to a byte-path re-FETCH on the
                    # same connection - the handle replaced the whole
                    # part stream, so the framing is still in sync
                    frames = self._read_arena_handle()
                    if frames is None:
                        arena_ok = False
                        resend = True
                        break
                    for frame in frames:
                        part += 1
                        if part <= skip:
                            continue
                        yield from self._decode_part(frame[8:])
                        self._parts_done = part
                    return
                payload = _recv_exact(self._sock, length)
                if chaos.ACTIVE:
                    # chaos seam `stream.consume`: the CLIENT side of
                    # the pipe - STALL models a slow consumer (the
                    # server's backpressure/stall budget sees it),
                    # DROP a consumer whose connection dies mid-read
                    # (the reconnect + part-skip resume path covers
                    # it). Fired after the payload recv so `part` is
                    # the 0-based index of the part in hand
                    chaos.fire("stream.consume", query_id=query_id,
                               partition=part)
                part += 1
                if part <= skip:
                    continue  # already delivered; drained, not decoded
                yield from self._decode_part(payload)
                self._parts_done = part
            if not resend:
                return

    def _decode_part(self, payload) -> Iterator:
        import pyarrow as pa

        from blaze_tpu_torch.io.ipc import decompress_frame

        raw = decompress_frame(bytes(payload))
        if not raw:
            return
        with pa.ipc.open_stream(raw) as reader:
            for rb in reader:
                if rb.num_rows > 0:
                    yield rb

    def _read_arena_handle(self) -> Optional[list]:
        """Consume the arena-handle JSON off the wire and try the shm
        path: map the segment, copy the frames out, release the lease.
        None means fall back to bytes (the caller re-FETCHes); the
        lease is released (or TTL-reaped) either way."""
        from blaze_tpu_torch.runtime.transport import _recv_exact

        (mlen,) = _U32.unpack(_recv_exact(self._sock, _U32.size))
        if mlen > MAX_JSON_BYTES:
            raise ValueError("oversized arena handle")
        handle = json.loads(
            _recv_exact(self._sock, mlen).decode("utf-8")
        )
        frames = None
        try:
            from blaze_tpu_torch.zerocopy.arena import map_handle_frames

            frames = map_handle_frames(handle)
        except Exception:  # noqa: BLE001 - degrade to byte path
            frames = None
        finally:
            lease = handle.get("lease")
            if lease is not None:
                try:
                    self._roundtrip(
                        self._id_verb(VERB_RELEASE, str(lease))
                    )
                except Exception:  # noqa: BLE001 - TTL reap covers it
                    pass
        return frames

    # -- helpers --------------------------------------------------------
    def run(self, task_bytes: bytes, **submit_kw) -> list:
        """submit + fetch in one call (the single-query convenience)."""
        st = self.submit(task_bytes, **submit_kw)
        if st["state"] not in ("QUEUED", "ADMITTED", "RUNNING", "DONE"):
            raise ServiceError(
                f"{st['state']}: {st.get('error', 'rejected')}"
            )
        return self.fetch(st["query_id"])

    @staticmethod
    def _id_verb(verb: int, query_id: str, extra_u32: int = 0) -> bytes:
        qid = query_id.encode("utf-8")
        return (
            bytes([verb]) + _U32.pack(len(qid)) + qid
            + _U32.pack(extra_u32)
        )

    def _read_json(self) -> dict:
        from blaze_tpu_torch.runtime.transport import _recv_exact

        (n,) = _U32.unpack(_recv_exact(self._sock, _U32.size))
        if n > MAX_JSON_BYTES:
            raise ValueError("oversized JSON frame")
        return json.loads(_recv_exact(self._sock, n).decode("utf-8"))

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
