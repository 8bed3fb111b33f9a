"""QueryService: the multi-query serving tier over the executor.

What the reference inherits from Spark (driver scheduling, task slots,
result handling - SURVEY 2.2), a standalone TPU engine must own. The
service composes the pieces this package provides:

  submit  -> Query (service/query.py state machine), bounded priority
             admission (service/admission.py), or REJECTED_OVERLOADED
  dispatch-> one dispatcher thread admits by priority/FIFO/headroom and
             hands queries to a worker pool sized to max_concurrency
  run     -> the UNCHANGED executor path (prepare_decoded_task ->
             execute_partition), with cooperative cancel/deadline
             checks between batches (the executor's GeneratorExit
             cancellation contract, runtime/executor.py)
  reuse   -> materialized results cached by (plan fingerprint,
             partition) when the fingerprint is stable
             (service/cache.py); a full cache hit dispatches NOTHING
  observe -> per-query queue/admission/execution timings + the
             dispatch.* counters + the mirrored operator metric tree,
             one report via runtime/instrument.render_metrics

Wire surface lives in service/wire.py; `python -m blaze_tpu_torch serve`
starts both.

Queries run on the service's device ("cuda" unless it is made for the
CPU). Where the JAX package differs on the card:
  - RESOURCE_EXHAUSTED degrades to the pandas host engine only on the
    CPU or when the caller passes degrade_to_host=True: on the card a
    failure surfaces with its class instead of moving the work off the
    device unseen (the scheduler's rule, runtime/scheduler.py);
  - there is no mesh or fleet tier (ROADMAP 'Modules to port' item 7):
    mesh_mode "on" and fleet_peers raise, "auto" lowers nothing, and
    STATS' `meshprof` section is empty.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from blaze_tpu_torch.errors import ErrorClass, classify, retry_action
from blaze_tpu_torch.obs import contention as obs_contention
from blaze_tpu_torch.obs import phases as obs_phases
from blaze_tpu_torch.obs import slowlog
from blaze_tpu_torch.obs import trace as obs_trace
from blaze_tpu_torch.obs.history import RuntimeHistory
from blaze_tpu_torch.obs.metrics import REGISTRY
from blaze_tpu_torch.service.admission import (
    AdmissionController,
    estimate_plan_device_bytes,
)
from blaze_tpu_torch.service.cache import ResultCache
from blaze_tpu_torch.service.query import (
    Query,
    QueryCancelled,
    QueryState,
)
from blaze_tpu_torch.testing import chaos

log = logging.getLogger("blaze_tpu_torch.service")

_MAX_RETAINED = 1024  # terminal queries kept for poll/report

# monotonically assigned `service` label values for the process-wide
# metrics registry (see QueryService._collect_metrics)
_service_instance_ids = itertools.count()


class QueryService:
    def __init__(
        self,
        max_concurrency: int = 2,
        max_queue_depth: int = 64,
        cache: Optional[ResultCache] = None,
        enable_cache: bool = True,
        device_tracker=None,
        default_deadline_s: Optional[float] = None,
        max_task_attempts: int = 3,
        retry_backoff_s: float = 0.05,
        degrade_to_host: Optional[bool] = None,
        enable_trace: bool = True,
        slow_query_s: Optional[float] = None,
        history: Optional[RuntimeHistory] = None,
        fold_phases: bool = True,
        mesh_mode: Optional[str] = None,
        orphan_ttl_s: Optional[float] = 900.0,
        stream_buffer_bytes: int = 32 << 20,
        stream_stall_s: float = 30.0,
        plan_cache=None,
        plan_cache_entries: int = 256,
        arena=None,
        arena_bytes: int = 0,
        arena_dir: Optional[str] = None,
        tenant_config: Optional[dict] = None,
        fleet_peers: Optional[list] = None,
        device: Optional[str] = None,
    ):
        import torch

        from blaze_tpu_torch.config import get_config

        # the device every query runs on (None: the config's, "cuda")
        self.device = torch.device(
            device if device is not None else get_config().device)
        if mesh_mode == "on" or fleet_peers:
            raise NotImplementedError(
                "the mesh and fleet tiers wait for multi-GPU, ROADMAP "
                "'Modules to port' item 7 (mesh_mode='on', "
                "fleet_peers)")
        # multi-tenant isolation (docs/SERVICE.md "Tenancy"):
        # per-tenant admission budgets + weighted-fair ordering live
        # in the AdmissionController; None keeps the zero-config
        # single-heap behavior byte-identical
        self.admission = AdmissionController(
            device_tracker=device_tracker,
            max_concurrency=max_concurrency,
            max_queue_depth=max_queue_depth,
            tenant_config=tenant_config,
        )
        # failure policy (blaze_tpu_torch/errors.py taxonomy): TRANSIENT
        # partition failures retry up to max_task_attempts with
        # exponential backoff; RESOURCE_EXHAUSTED degrades to the host
        # engine (on the card only when asked); PLAN_INVALID/INTERNAL
        # fail fast
        self.max_task_attempts = max(1, int(max_task_attempts))
        self.retry_backoff_s = float(retry_backoff_s)
        self.degrade_to_host = (
            self.device.type != "cuda" if degrade_to_host is None
            else bool(degrade_to_host))
        # mesh execution tier (the JAX package's planner/distribute,
        # docs/MESH.md): "on" raised above; "auto" and "off" run every
        # query on the one device until item 7, and STATS reports the
        # mode
        if mesh_mode not in (None, "auto", "on", "off"):
            raise ValueError(
                f"mesh_mode must be auto|on|off, got {mesh_mode!r}"
            )
        self.mesh_mode = mesh_mode
        self.cache = (
            cache if cache is not None
            else (ResultCache() if enable_cache else None)
        )
        # zero-copy serve path (blaze_tpu_torch/zerocopy, docs/SERVICE.md):
        # the decoded-plan cache makes a repeat SUBMIT skip protobuf
        # decode entirely (keyed by the router's affinity digest over
        # the raw blob); the Arrow arena holds finalized ENCODED part
        # frames in mmap segments so FETCH serves them scatter-gather
        # (or as a shm handle to a co-located client) instead of
        # re-encoding per request. plan_cache_entries <= 0 /
        # arena_bytes <= 0 disable each independently
        if plan_cache is not None:
            self.plan_cache = plan_cache
        elif plan_cache_entries and plan_cache_entries > 0:
            from blaze_tpu_torch.zerocopy.plan_cache import DecodedPlanCache

            self.plan_cache = DecodedPlanCache(plan_cache_entries)
        else:
            self.plan_cache = None
        if arena is not None:
            self.arena = arena
        elif arena_bytes and arena_bytes > 0:
            from blaze_tpu_torch.zerocopy.arena import ArrowArena

            self.arena = ArrowArena(directory=arena_dir,
                                    max_bytes=arena_bytes)
        else:
            self.arena = None
        self.default_deadline_s = default_deadline_s
        # observability (blaze_tpu_torch/obs): refcounted tracing for the
        # service lifetime, per-fingerprint runtime history (the
        # deadline-prediction input), slow-query log threshold, and
        # a per-instance collector on the process metrics registry
        self._trace_enabled = bool(enable_trace)
        if self._trace_enabled:
            obs_trace.enable()
        self.history = history if history is not None else RuntimeHistory()
        # threshold precedence: explicit arg > BLAZE_SLOW_QUERY_S env
        # (validated - a typo must not kill serve at startup) > 5s
        if slow_query_s is None:
            env = os.environ.get("BLAZE_SLOW_QUERY_S")
            try:
                slow_query_s = float(env) if env else 5.0
            except ValueError:
                log.warning(
                    "ignoring malformed BLAZE_SLOW_QUERY_S=%r", env
                )
                slow_query_s = 5.0
        self.slow_query_s = float(slow_query_s)
        # fold_phases=False keeps this instance out of the process
        # rollup: the regress probe runs a synthetic workload inside
        # what may be a LIVE serving process, and its samples must
        # not skew the production STATS `phases` payload
        self._fold_phases = bool(fold_phases)
        self.obs_counters = {
            "degraded_queries": 0,
            "retried_queries": 0,
            "slow_queries": 0,
            "orphans_reaped": 0,
            # streaming data plane (service/stream.py): stall aborts
            # and producer backpressure episodes, aggregated across
            # per-query ring buffers by _note_stream_event
            "stream_stalls": 0,
            "stream_backpressure_waits": 0,
            # admission fast path (zero-copy serve path): SUBMITs
            # whose fingerprint the ResultCache fully covers bypass
            # the byte-reservation queue and serve on the dedicated
            # fast-path pool
            "fast_path_serves": 0,
        }
        # end-to-end streaming (service/stream.py, docs/SERVICE.md):
        # per-query bounded result rings FETCH drains while RUNNING.
        # stream_buffer_bytes <= 0 disables streaming (legacy
        # materialize-then-stream); stream_stall_s bounds how long a
        # non-draining consumer may pin a full ring before the query
        # aborts with the classified STREAM_STALLED outcome
        self.stream_buffer_bytes = int(stream_buffer_bytes)
        self.stream_stall_s = float(stream_stall_s)
        self._stream_high_water = 0  # max pending bytes, any query
        # orphan reaping (docs/SERVICE.md): a detach=True query whose
        # ROUTER died holds its result in retention forever - nothing
        # will ever POLL or FETCH it, and _MAX_RETAINED eviction only
        # helps under fresh traffic. The sweep reaps terminal,
        # never-fetched queries with no client activity for
        # orphan_ttl_s (None/<=0 disables); a reaped query's FETCH
        # answers the classified UNKNOWN not-found, never a hang
        self.orphan_ttl_s = (
            float(orphan_ttl_s)
            if orphan_ttl_s and orphan_ttl_s > 0 else None
        )
        self._next_orphan_sweep = 0.0
        # instance label: the registry is process-wide and several
        # services may be alive at once - unlabeled samples would
        # collide into duplicate series and fail the whole scrape
        self._instance = str(next(_service_instance_ids))
        self._collector_key = f"service:{self._instance}"
        REGISTRY.register_collector(
            self._collector_key, self._collect_metrics
        )
        self._closed = False
        # DRAINING (rolling-restart shutdown, docs/ROUTER.md): new
        # SUBMITs are refused with a classified TRANSIENT rejection
        # while in-flight queries run to completion; drain() flips it
        self.draining = False
        self._queries: Dict[str, Query] = {}
        self._order: List[str] = []  # retention ring
        # request coalescing (ROADMAP scan-sharing first step): one
        # event per (fingerprint, partition) currently EXECUTING, so a
        # second identical stable-fingerprint submission waits on the
        # leader and serves from the cache it populates instead of
        # re-executing the same plan concurrently
        self._inflight: Dict = {}
        self._inflight_lock = threading.Lock()
        self._lock = obs_contention.TimedLock("service_state")
        self._cv = threading.Condition(self._lock)
        # admission order journal (query ids, in admission sequence):
        # the load tests assert priority/FIFO semantics from this
        self.admission_log: List[str] = []
        self._stop = False
        # dispatcher wakeup batching: N submit/release events between
        # dispatcher passes collapse into ONE pending flag (and one CV
        # round-trip) instead of N notify_all calls contending the
        # service lock at high concurrency
        self._kick_pending = False
        self._workers = cf.ThreadPoolExecutor(
            max_workers=max(1, max_concurrency),
            thread_name_prefix="blaze-query",
        )
        # fast-path pool: cache-covered repeats run here, NOT inline
        # on the submit thread (a cached result larger than the ring
        # cap would deadlock submit against its own future FETCH) and
        # NOT on _workers (a queued fleet must not starve cached
        # repeats - the whole point of the bypass)
        self._fast_pool = cf.ThreadPoolExecutor(
            max_workers=max(2, max_concurrency),
            thread_name_prefix="blaze-fastpath",
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="blaze-dispatch",
        )
        self._dispatcher.start()

    # -- submission -----------------------------------------------------
    def submit_task(
        self,
        task_bytes: bytes,
        *,
        is_ref: bool = False,
        resources: Optional[dict] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        estimated_bytes: Optional[int] = None,
        use_cache: bool = True,
        plan_digest: Optional[str] = None,
        tenant: str = "default",
    ) -> Query:
        """Wire entry: one serialized TaskDefinition (engine-native or
        reference format), decoded eagerly so admission sees a cost
        estimate and the cache sees a fingerprint - UNLESS the
        decoded-plan cache already knows this blob (zero-copy serve
        path): a hit reuses fingerprint/estimate/partition and defers
        any re-decode to execution time, so a result-cache-covered
        repeat never decodes at all. `plan_digest` is the router's
        precomputed affinity digest over these exact bytes (submit
        meta `plan_digest`); absent, the service hashes locally."""
        q = Query(
            task_bytes=task_bytes,
            is_ref=is_ref,
            resources=resources,
            priority=priority,
            deadline_s=(
                deadline_s if deadline_s is not None
                else self.default_deadline_s
            ),
            estimated_bytes=estimated_bytes,
            use_cache=use_cache,
            tenant=tenant,
        )
        self._attach_obs(q)
        if self.draining:
            return self._reject_draining(q)
        pc = self.plan_cache
        entry = None
        if pc is not None:
            from blaze_tpu_torch.zerocopy.plan_cache import plan_digest as _pd

            q._plan_key = plan_digest or _pd(task_bytes, is_ref)
            entry = pc.get(q._plan_key)
        if entry is not None:
            # plan-cache hit: NO decode (and no plan_decode span). The
            # decoded tree is loaned exclusively (prepare_decoded_task
            # mutates it); when it is already out, metadata still
            # serves and a cache-missing execution re-decodes lazily
            q._plan_entry = entry
            q._decoded = entry.borrow_tree()
            if q._decoded is None:
                pc.note_tree_unavailable()
            q._plan_partition = entry.partition
            if q.estimated_bytes is None:
                q.estimated_bytes = entry.estimated_bytes
            q._fingerprint = entry.fingerprint
            q._fingerprint_stable = entry.fingerprint_stable
            return self._enqueue(q)
        decoded = self._decode_task(q)
        if decoded is None:
            return q  # decode failed: FAILED + registered
        q._decoded = decoded
        op = decoded[0]
        q._plan_partition = decoded[1]
        if q.estimated_bytes is None:
            # a wire task executes ONE partition of its stage - cost
            # only that partition's leaves, or sibling tasks of a
            # partitioned scan would serialize behind each other
            q.estimated_bytes = estimate_plan_device_bytes(
                op, partition=decoded[1]
            )
        q._fingerprint = op.fingerprint()
        q._fingerprint_stable = op.fingerprint_is_stable()
        if pc is not None:
            from blaze_tpu_torch.zerocopy.plan_cache import PlanEntry

            # publish the metadata now; the TREE belongs to THIS query
            # (it may fuse it in place) and returns pristine via the
            # terminal hook only if it never executed
            q._plan_entry = pc.put(q._plan_key, PlanEntry(
                fingerprint=q._fingerprint,
                fingerprint_stable=q._fingerprint_stable,
                estimated_bytes=q.estimated_bytes,
                partition=decoded[1],
            ))
        return self._enqueue(q)

    def _decode_bytes(self, q: Query):
        """Decode q.task_bytes under a `plan_decode` span; raises on
        malformed bytes. Submit-time AND the lazy re-decode a
        plan-cache hit pays when it must execute but its entry's tree
        is loaned out."""
        t0 = time.monotonic()
        if q.is_ref:
            from blaze_tpu_torch.plan.refcompat import (
                task_from_reference_proto,
            )

            decoded = task_from_reference_proto(q.task_bytes)
        else:
            from blaze_tpu_torch.plan.serde import task_from_proto

            decoded = task_from_proto(q.task_bytes)
        if q.tracer is not None:
            q.tracer.record_span("plan_decode", t0, time.monotonic())
        return decoded

    def _decode_task(self, q: Query):
        """Submit-time decode. On failure the query is FAILED +
        registered and None returns."""
        try:
            return self._decode_bytes(q)
        except Exception as e:  # noqa: BLE001 - reported via state
            q.error = f"decode failed: {e!r}"
            # undecodable bytes are a malformed plan by definition
            q.error_class = ErrorClass.PLAN_INVALID.value
            q.transition(QueryState.FAILED)
            self._register(q)
            return None

    def submit_plan(
        self,
        plan,
        *,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        estimated_bytes: Optional[int] = None,
        use_cache: bool = True,
        tenant: str = "default",
    ) -> Query:
        """Driver entry: run every partition of an in-process plan."""
        q = Query(
            plan=plan,
            priority=priority,
            deadline_s=(
                deadline_s if deadline_s is not None
                else self.default_deadline_s
            ),
            estimated_bytes=(
                estimated_bytes if estimated_bytes is not None
                else estimate_plan_device_bytes(plan)
            ),
            use_cache=use_cache,
            tenant=tenant,
        )
        self._attach_obs(q)
        if self.draining:
            return self._reject_draining(q)
        q._decoded = None
        q._fingerprint = plan.fingerprint()
        q._fingerprint_stable = plan.fingerprint_is_stable()
        return self._enqueue(q)

    def _reject_draining(self, q: Query) -> Query:
        """DRAINING rejection: classified TRANSIENT so a bare client
        retries with backoff (the replica or its rolling-restart
        replacement comes back) and a fronting router treats it as a
        placement miss (spill to the next replica, zero breaker
        strikes). The 'DRAINING:' error prefix is the wire marker both
        consumers key on."""
        q.error = (
            "DRAINING: replica is draining (rolling restart); "
            "resubmit elsewhere or retry with backoff"
        )
        q.error_class = ErrorClass.TRANSIENT.value
        q.transition(QueryState.REJECTED_OVERLOADED)
        self._register(q)
        return q

    def _reject_tenant_budget(self, q: Query) -> Query:
        """Tenant-budget rejection (the DRAINING pattern one tenant
        over): classified TRANSIENT so a bare client retries with
        backoff (the tenant's own in-flight work draining frees the
        budget) and a fronting router treats it as a placement miss
        (spill to the next replica, zero breaker strikes - the
        replica is healthy, the TENANT is over budget). The
        'REJECTED_TENANT_BUDGET:' error prefix is the wire marker
        both consumers key on. The query is already registered by
        _enqueue."""
        q.error = (
            f"REJECTED_TENANT_BUDGET: tenant {q.tenant!r} is over "
            "its admission budget; retry with backoff as its own "
            "work drains"
        )
        q.error_class = ErrorClass.TRANSIENT.value
        q.transition(QueryState.REJECTED_OVERLOADED)
        REGISTRY.inc("blaze_tenant_rejections_total", tenant=q.tenant)
        return q

    def drain(self, timeout_s: Optional[float] = None,
              poll_s: float = 0.05) -> bool:
        """Enter DRAINING and block until every live query reached a
        terminal state (True) or `timeout_s` elapsed (False, still
        draining - the caller decides whether to hard-stop). New
        SUBMITs are refused from the moment this is called; POLL /
        FETCH / CANCEL keep working so clients can collect results
        already in flight.

        OPEN STREAMS are live work: a query with an in-progress FETCH
        (fetchers > 0) holds the drain even when it is already
        terminal, so a rolling restart finishes delivering the parts a
        client is actively reading instead of severing the stream. A
        consumer that stops draining cannot pin the drain past the
        grace - the stream stall budget aborts it, and a grace expiry
        hands the stream off to the router's journal/failover resume
        path (the client re-FETCHes the re-placed query and skips the
        delivered prefix)."""
        self.draining = True
        REGISTRY.inc("blaze_service_drains_total")
        log.info("service draining: refusing new submits, waiting "
                 "for in-flight queries and open streams")
        deadline = (
            time.monotonic() + timeout_s
            if timeout_s is not None else None
        )
        while True:
            with self._lock:
                live = sum(
                    1 for q in self._queries.values()
                    if not q.done or q.fetchers > 0
                )
            if not live:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                log.warning(
                    "drain timed out with %d live queries/streams",
                    live,
                )
                return False
            time.sleep(poll_s)

    def _attach_obs(self, q: Query) -> None:
        """Arm per-query observability BEFORE any transition can fire:
        the span tree (root opens at submit) and the terminal hook
        (runtime history / metrics / slow-query log)."""
        q.ctx.device = self.device
        if obs_trace.ACTIVE:
            q.tracer = obs_trace.begin_trace(q.query_id)
            q.ctx.tracer = q.tracer
        if self.stream_buffer_bytes > 0:
            from blaze_tpu_torch.service.stream import StreamBuffer

            q.stream = StreamBuffer(
                self.stream_buffer_bytes,
                self.stream_stall_s,
                on_pending=(
                    lambda delta, _q=q:
                    self.admission.adjust_reservation(_q, delta)
                ),
                on_event=self._note_stream_event,
            )
        q.on_terminal = self._on_query_terminal

    def _note_stream_event(self, name: str, value: int = 1) -> None:
        """StreamBuffer observability fan-in (per-query rings, one
        service-level rollup): stall/backpressure counters + the
        high-water gauge STATS and METRICS expose."""
        with self._lock:
            if name == "stall":
                self.obs_counters["stream_stalls"] += 1
            elif name == "backpressure_wait":
                self.obs_counters["stream_backpressure_waits"] += 1
            elif name == "high_water":
                if value > self._stream_high_water:
                    self._stream_high_water = value

    def _enqueue(self, q: Query) -> Query:
        self._register(q)
        if q.deadline_at is not None and q.deadline_exceeded():
            # deadline shedding: a deadline that has already passed
            # cannot be met - refuse up front instead of queueing work
            # that the sweep will kill anyway
            self.admission.note_shed()
            q.error = "deadline unmeetable at admission (shed)"
            q.transition(QueryState.TIMED_OUT)
            return q
        if self._fast_path_eligible(q):
            # admission fast path (zero-copy serve path): the result
            # cache fully covers this fingerprint, so serving it
            # dispatches nothing and reserves nothing - bypass the
            # byte-reservation queue entirely. A queued fleet cannot
            # starve cached repeats (and past c16 the reservation
            # round-trip itself was the cached-qps wall). The rare
            # eviction between this probe and the execution probe
            # falls through to an unreserved execution - bounded by
            # the fast pool, and the cache re-populates
            if q.try_transition(QueryState.ADMITTED):
                q.timings["admitted"] = time.monotonic()
                if q.tracer is not None:
                    q.tracer.record_span(
                        "queue_wait", q.timings["submitted"],
                        q.timings["admitted"], fast_path=True,
                    )
                with self._lock:
                    self.admission_log.append(q.query_id)
                    self.obs_counters["fast_path_serves"] += 1
                self._fast_pool.submit(self._run_query, q)
            return q
        if chaos.ACTIVE:
            # DROP = the tenant budget check itself fails (fail
            # CLOSED: a broken check must reject, never admit - the
            # rejection is TRANSIENT and spillable, an admit would
            # breach the budget); STALL = a slow budget path
            try:
                chaos.fire("service.tenant", tenant=q.tenant,
                           query=q.query_id)
            except ConnectionError:
                return self._reject_tenant_budget(q)
        verdict = self.admission.offer(q)
        if verdict == "tenant_budget":
            return self._reject_tenant_budget(q)
        if verdict != "ok":
            q.error = (
                f"queue full ({self.admission.max_queue_depth}); "
                "retry with backoff"
            )
            q.transition(QueryState.REJECTED_OVERLOADED)
            return q
        self._kick()
        return q

    def _register(self, q: Query) -> None:
        with self._lock:
            self._queries[q.query_id] = q
            self._order.append(q.query_id)
            while len(self._order) > _MAX_RETAINED:
                old = self._order[0]
                oq = self._queries.get(old)
                if oq is not None and not oq.done:
                    break  # never drop a live query
                self._order.pop(0)
                self._queries.pop(old, None)

    # -- lifecycle API --------------------------------------------------
    def get(self, query_id: str) -> Query:
        with self._lock:
            q = self._queries.get(query_id)
        if q is None:
            raise KeyError(f"unknown query {query_id}")
        return q

    def poll(self, query_id: str) -> dict:
        q = self.get(query_id)
        q.note_activity()  # a polled query has an attentive owner
        return q.status()

    def cancel(self, query_id: str) -> dict:
        """Request cancellation. QUEUED queries die here; ADMITTED and
        RUNNING ones observe the event at the next batch boundary (the
        executor's cancellation pass-through keeps the engine clean)."""
        q = self.get(query_id)
        q.request_cancel()
        if q.state is QueryState.QUEUED:
            q.try_transition(QueryState.CANCELLED)
        self._kick()
        return q.status()

    def result(self, query_id: str, timeout: Optional[float] = None):
        """Block until terminal; return the materialized RecordBatch
        list on DONE, raise on every other terminal state."""
        q = self.get(query_id)
        if not q.wait(timeout):
            raise TimeoutError(f"query {query_id} still {q.state.value}")
        if q.state is QueryState.DONE:
            return q.result
        if q.state is QueryState.CANCELLED:
            raise QueryCancelled(query_id)
        raise RuntimeError(
            f"query {query_id} {q.state.value}: {q.error or ''}"
        )

    def report(self, query_id: str) -> str:
        """Per-query observability rollup: lifecycle timings, cache and
        dispatch counters, and the mirrored operator metric tree."""
        from blaze_tpu_torch.runtime.instrument import render_metrics

        q = self.get(query_id)
        q.note_activity()
        st = q.status()
        head = [
            f"query {q.query_id}: {st['state']} "
            f"(priority={q.priority}, est_bytes={q.estimated_bytes})"
        ]
        if st.get("error_class"):
            head.append(f"  error_class={st['error_class']}")
        if st.get("degraded"):
            head.append("  degraded=True (host-engine fallback)")
        for k in ("queue_wait_s", "admission_s", "execution_s",
                  "stream_s"):
            if k in st:
                head.append(f"  {k}={st[k]}")
        for a in st.get("attempts", ()):
            head.append(
                f"  attempt p{a['partition']}#{a['attempt']}: "
                f"{a['error_class']} -> {a['action']} ({a['error']})"
            )
        body = render_metrics(q.metrics_root, indent="  ")
        return "\n".join(head) + ("\n" + body if body else "")

    def stats(self) -> dict:
        """Structured service snapshot (the STATS verb payload): the
        machine-readable form replica routing consumes - admission
        headroom + queue depth, cache hit/miss/evictions, degradation
        and quarantine counts, and the runtime-history summary."""
        with self._lock:
            by_state: Dict[str, int] = {}
            live = 0
            for q in self._queries.values():
                by_state[q.state.value] = (
                    by_state.get(q.state.value, 0) + 1
                )
                if not q.done:
                    live += 1
        out = {
            "admission": self.admission.stats(),
            "queries": {
                "live": live,
                "by_state": by_state,
                **self.obs_counters,
            },
            "runtime_history": self.history.summary(),
            # per-phase rollup (bounded classes; regress CLI diffs it)
            "phases": obs_phases.ROLLUP.snapshot(max_classes=6),
            "quarantine": {
                # cluster drivers in this process record quarantines
                # on the shared registry (runtime/cluster.py)
                "workers_total": int(
                    REGISTRY.get("blaze_worker_quarantines_total")
                ),
            },
            "service": {
                "max_concurrency": self.admission.max_concurrency,
                "max_queue_depth": self.admission.max_queue_depth,
                "slow_query_s": self.slow_query_s,
                "trace_enabled": self._trace_enabled,
                "mesh_mode": self.mesh_mode or "env",
                # membership signal: the router's registry poller
                # reads this to mark the replica DRAINING (unroutable
                # for NEW placements) before any submit bounces
                "draining": self.draining,
                # orphan sweep (serve --orphan-ttl): retention held
                # by a dead router's abandoned detached queries is
                # reclaimed after this long (null = disabled)
                "orphan_ttl_s": self.orphan_ttl_s,
            },
            # streaming data plane (service/stream.py): the ring cap +
            # stall budget, and the high-water gauge the slow-consumer
            # acceptance pin asserts against
            "streaming": {
                "enabled": self.stream_buffer_bytes > 0,
                "buffer_bytes": self.stream_buffer_bytes,
                "stall_s": self.stream_stall_s,
                "buffer_high_water_bytes": self._stream_high_water,
            },
        }
        tenants = self.admission.tenant_stats()
        if tenants:
            # per-tenant admission view (docs/SERVICE.md "Tenancy"):
            # queued/running/reserved_bytes live gauges + lifetime
            # submit/admit/reject counts; the router sums these
            # fleet-wide. Empty (and absent) until a tenant submits.
            out["tenants"] = tenants
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        # zero-copy serve path (blaze_tpu_torch/zerocopy): decoded-plan
        # cache hit/miss/eviction counters and arena segment/lease
        # accounting - the replica surface the router's plan_cache
        # rollup and the zerocopy tests read
        if self.plan_cache is not None:
            out["plan_cache"] = self.plan_cache.stats()
        if self.arena is not None:
            out["arena"] = self.arena.stats()
        # lock-wait accounting (obs/contention.py): empty dict when
        # the gate is off or nothing contended yet
        out["contention"] = obs_contention.snapshot()
        # mesh stage anatomy (obs/meshprof.py) waits for item 7: no
        # mesh stage runs here, so the snapshot is the empty one
        out["meshprof"] = {}
        # the port's own: the last admissions in order (the admission
        # journal's tail, for a client that checks priority and EDF
        # across the wire), and the CUDA graphs lent out of the
        # process's graph cache (none once every query has ended,
        # cancelled ones included)
        from blaze_tpu_torch.runtime import dispatch

        with self._lock:
            out["admission_order"] = self.admission_log[-64:]
        out["graphs"] = {"lent": dispatch.GRAPHS.lent()}
        return out

    def trace(self, query_id: str) -> Optional[dict]:
        """Chrome-trace-event JSON for one query (Perfetto-loadable),
        or None when tracing was off for it. Served through the
        REPORT verb and `python -m blaze_tpu_torch trace <query_id>`."""
        q = self.get(query_id)
        rec = q.tracer or obs_trace.get_trace(query_id)
        return obs_trace.chrome_trace(rec) if rec is not None else None

    def trace_spans(self, query_id: str) -> Optional[list]:
        """One query's RAW span dicts (TraceRecorder.to_dicts), or
        None when tracing was off for it. The replica router's REPORT
        path requests these (flags bit 1) instead of the rendered
        Chrome document so it can graft the subtree into its OWN
        recorder via attach_subtree - re-parsing an exported trace
        back into spans would lose ids and parent links."""
        q = self.get(query_id)
        rec = q.tracer or obs_trace.get_trace(query_id)
        return rec.to_dicts() if rec is not None else None

    # -- observability hooks -------------------------------------------
    def _on_query_terminal(self, q: Query) -> None:
        """Exactly-once per query (Query._fire_terminal): fold the
        outcome into the process metrics registry, the per-fingerprint
        runtime history, and (over threshold) the slow-query log."""
        if q.stream is not None:
            # stream finalization rides the exactly-once terminal hook
            # so EVERY terminal path (run-loop exits, queued cancels,
            # deadline sweeps, decode failures) resolves the ring:
            # DONE finishes it (fetchers drain the tail and get the
            # terminator), anything else aborts it and frees retained
            # parts - there is no result to collect
            if q.state is QueryState.DONE:
                q.stream.finish()
            else:
                q.stream.abort(q.state.value)
        if q._plan_entry is not None and not q._tree_consumed \
                and q._decoded is not None:
            # zero-copy plan cache: this query borrowed the entry's
            # decoded tree but never executed it (full cache hit /
            # early terminal), so the tree is still pristine - return
            # it for the next repeat. A consumed (fused) tree stays
            # out forever
            q._plan_entry.restore_tree(q._decoded)
            q._decoded = None  # the entry owns it again
        self._maybe_publish_arena(q)
        t = q.timings
        wall = t.get("finished", time.monotonic()) - t["submitted"]
        REGISTRY.inc("blaze_queries_total", state=q.state.value)
        # per-tenant lifecycle counter: a NEW series (not a label on
        # blaze_queries_total) so zero-config dashboards keep their
        # exact pre-tenancy series shape
        REGISTRY.inc("blaze_tenant_queries_total",
                     tenant=q.tenant, state=q.state.value)
        REGISTRY.observe("blaze_query_wall_seconds", wall)
        retried = any(a.get("action") == "retry" for a in q.attempts)
        slow = 0 < self.slow_query_s < wall
        with self._lock:  # concurrent worker threads reach terminal
            if retried:
                self.obs_counters["retried_queries"] += 1
            if q.degraded:
                self.obs_counters["degraded_queries"] += 1
            if slow:
                self.obs_counters["slow_queries"] += 1
        if q.degraded:
            REGISTRY.inc("blaze_degraded_queries_total")
        if (
            q.state is QueryState.DONE
            and q._fingerprint is not None
            and q._fingerprint_stable
            and not q.degraded
            and "run_start" in t and "finished" in t
        ):
            # clean device executions only: degraded runs measure the
            # host fallback, not the plan
            self.history.record(
                q._fingerprint, t["finished"] - t["run_start"]
            )
        if slow:
            REGISTRY.inc("blaze_slow_queries_total")
            slowlog.emit(q, self.slow_query_s)
        # per-phase rollup (obs/phases.py): fold the finished query's
        # lifecycle timings + span tree into the duration rings the
        # regress CLI diffs - terminal-hook time, never the hot path
        if self._fold_phases:
            try:
                obs_phases.ROLLUP.fold_query(q)
            except Exception:  # noqa: BLE001 - obs must not raise
                log.exception("phase rollup fold failed for %s",
                              q.query_id)

    def _maybe_publish_arena(self, q: Query) -> None:
        """Zero-copy arena publish (terminal-hook time, never the hot
        path): a clean DONE with a stable cacheable fingerprint gets
        its result encoded ONCE into an mmap segment; every later
        FETCH of the same fingerprint serves those frames scatter-
        gather (or as a shm handle) instead of re-encoding. Idempotent
        per fingerprint; the membership test keeps repeats free."""
        arena = self.arena
        if (
            arena is None or q.state is not QueryState.DONE
            or q._fingerprint is None or not q._fingerprint_stable
            or not q.use_cache or q.degraded or not q.result
        ):
            return
        if q._fingerprint in arena:
            return
        try:
            from blaze_tpu_torch.io.ipc import encode_ipc_segment

            arena.publish(
                q._fingerprint,
                [encode_ipc_segment(rb) for rb in q.result],
            )
        except Exception:  # noqa: BLE001 - arena is best-effort
            log.exception("arena publish failed for %s", q.query_id)

    def _collect_metrics(self):
        """Scrape-time samples for the process registry (METRICS verb):
        live admission/cache/history state as gauges, cumulative event
        counts as counters. A generator: the registry consumes it
        directly, so no per-scrape sample list is materialized here."""
        sid = {"service": self._instance}  # series-disambiguating
        a = self.admission.stats()
        for k in ("submitted", "admitted", "rejected_overloaded",
                  "shed_deadline", "shed_predicted",
                  "headroom_waits"):
            yield ("blaze_admission_events_total",
                   {"event": k, **sid}, a.get(k, 0), "counter")
        for k in ("queued", "running", "reserved_bytes", "headroom"):
            yield (f"blaze_admission_{k}", sid, a.get(k, 0), "gauge")
        for t, ts in self.admission.tenant_stats().items():
            tl = {"tenant": t, **sid}
            for k in ("queued", "running", "reserved_bytes"):
                yield (f"blaze_tenant_{k}", tl, ts.get(k, 0), "gauge")
            yield ("blaze_tenant_rejections",
                   tl, ts.get("rejected_budget", 0), "counter")
        if self.cache is not None:
            c = self.cache.stats()
            for k in ("hits", "misses", "evictions", "puts", "spills",
                      "restores", "spill_errors", "coalesced"):
                yield ("blaze_result_cache_events_total",
                       {"event": k, **sid}, c.get(k, 0), "counter")
            for k in ("entries", "bytes", "spilled_entries"):
                yield (f"blaze_result_cache_{k}", sid,
                       c.get(k, 0), "gauge")
        if self.plan_cache is not None:
            pc = self.plan_cache.stats()
            for k in ("hits", "misses", "evictions", "puts"):
                yield ("blaze_plan_cache_events_total",
                       {"event": k, **sid}, pc.get(k, 0), "counter")
            yield ("blaze_plan_cache_entries", sid,
                   pc.get("entries", 0), "gauge")
        if self.arena is not None:
            ar = self.arena.stats()
            for k in ("published", "evictions", "handle_hits",
                      "handle_misses", "sg_serves", "lease_releases",
                      "lease_orphans_reaped", "map_failures",
                      "lease_faults"):
                yield ("blaze_arena_events_total",
                       {"event": k, **sid}, ar.get(k, 0), "counter")
            for k in ("segments", "bytes", "active_leases"):
                yield (f"blaze_arena_{k}", sid, ar.get(k, 0), "gauge")
        with self._lock:
            orphans = self.obs_counters["orphans_reaped"]
            stalls = self.obs_counters["stream_stalls"]
            bp_waits = self.obs_counters["stream_backpressure_waits"]
            high_water = self._stream_high_water
            fast_path = self.obs_counters["fast_path_serves"]
        yield ("blaze_service_fast_path_serves_total",
               sid, fast_path, "counter")
        yield ("blaze_service_orphans_reaped_total",
               sid, orphans, "counter")
        yield ("blaze_service_stream_stalls_total",
               sid, stalls, "counter")
        yield ("blaze_service_stream_backpressure_waits_total",
               sid, bp_waits, "counter")
        yield ("blaze_service_stream_buffer_high_water_bytes",
               sid, high_water, "gauge")
        h = self.history.summary(top=0)
        yield ("blaze_runtime_history_fingerprints",
               sid, h["fingerprints"], "gauge")
        yield ("blaze_runtime_history_samples_total",
               sid, h["total_samples"], "counter")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        REGISTRY.unregister_collector(self._collector_key)
        if self._trace_enabled:
            obs_trace.disable()
        self._stop = True
        # shutdown cancels every live query: queued ones die here,
        # running ones observe the event at their next batch boundary -
        # otherwise worker shutdown would wait on them forever
        with self._lock:
            live = [q for q in self._queries.values() if not q.done]
        for q in live:
            q.request_cancel(reason="shutdown")
            if q.state is QueryState.QUEUED:
                q.try_transition(QueryState.CANCELLED)
        with self._cv:
            self._cv.notify_all()
        self._dispatcher.join(timeout=5)
        self._workers.shutdown(wait=True, cancel_futures=True)
        self._fast_pool.shutdown(wait=True, cancel_futures=True)
        if self.cache is not None:
            self.cache.close()
        if self.arena is not None:
            self.arena.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher -----------------------------------------------------
    def _kick(self) -> None:
        """Request a dispatcher pass. Batched: if a kick is already
        pending the dispatcher will see our event on the same pass, so
        skip the lock round-trip entirely (the flag is monotone until
        the dispatcher clears it - a stale read only costs one extra
        notify, never a lost wakeup)."""
        if self._kick_pending:
            return
        with self._cv:
            self._kick_pending = True
            self._cv.notify_all()

    def _dispatch_loop(self) -> None:
        while not self._stop:
            with self._cv:
                if not self._kick_pending:
                    self._cv.wait(timeout=0.05)
                self._kick_pending = False
            if self._stop:
                return
            self._sweep_deadlines()
            self._sweep_orphans()
            while True:
                q = self.admission.next_admissible()
                if q is None:
                    break
                # predicted-unmeetability shedding: queue-wait is
                # already spent; if the fingerprint's p50 runtime
                # (>= 3 samples, obs/history.py) cannot fit the
                # remaining slack, running the query only burns
                # device time to miss the deadline anyway
                reason = self._predicted_unmeetable(q)
                if reason is not None:
                    self.admission.release(q)
                    self.admission.note_shed_predicted()
                    if q.tracer is not None:
                        q.tracer.event("shed_predicted",
                                       reason=reason)
                    prev = q.error
                    q.error = reason
                    if not q.try_transition(QueryState.TIMED_OUT):
                        q.error = prev  # lost the race (cancelled)
                    continue
                if not q.try_transition(QueryState.ADMITTED):
                    # cancelled / timed out between queue and admit
                    self.admission.release(q)
                    continue
                self.admission.note_admitted()
                q.timings["admitted"] = time.monotonic()
                if q.tracer is not None:
                    q.tracer.record_span(
                        "queue_wait", q.timings["submitted"],
                        q.timings["admitted"],
                    )
                with self._lock:
                    self.admission_log.append(q.query_id)
                self._workers.submit(self._run_query, q)

    def _predicted_unmeetable(self, q: Query) -> Optional[str]:
        """Shed message when the runtime-history p50 estimate says the
        deadline cannot be met from here, else None. Conservative by
        construction: needs a deadline, a stable fingerprint, and >= 3
        recorded samples - one cold-compile outlier never sheds."""
        if q.deadline_at is None or q._fingerprint is None:
            return None
        if not q._fingerprint_stable:
            return None
        est = self.history.p50(q._fingerprint, min_samples=3)
        if est is None:
            return None
        if time.monotonic() + est < q.deadline_at:
            return None
        # a fully-cached query serves in milliseconds regardless of
        # its recorded runtime - shedding it on the estimate would
        # refuse work the cache answers inside any deadline (and,
        # since sheds never execute, would pin the slow estimate
        # forever)
        if (
            self.cache is not None and q.use_cache
            and self._cache_covers(q)
        ):
            return None
        return (
            f"predicted unmeetable at admission (shed): p50 runtime "
            f"{est:.3f}s exceeds remaining slack"
        )

    def _fast_path_eligible(self, q: Query) -> bool:
        """Admission-bypass guard: cache-covered stable repeats only,
        and never while draining/closing (the drain path owns live
        accounting) or after a pre-admission cancel."""
        if (
            self.cache is None or not q.use_cache or self.draining
            or self._closed or q.cancel_requested
            or q._fingerprint is None or not q._fingerprint_stable
        ):
            return False
        try:
            return self._cache_covers(q)
        except Exception:  # noqa: BLE001 - fall back to the queue
            return False

    def _cache_covers(self, q: Query) -> bool:
        """True when every partition the query would run is present
        (and fresh) in the result cache."""
        if q.plan is not None:
            partitions = range(q.plan.partition_count)
        elif q._decoded is not None:
            partitions = [q._decoded[1]]
        elif q._plan_partition is not None:
            # plan-cache metadata hit without the decoded tree: the
            # entry's recorded partition stands in for it
            partitions = [q._plan_partition]
        else:
            return False
        return all(
            self.cache.contains((q._fingerprint, p))
            for p in partitions
        )

    def _sweep_deadlines(self) -> None:
        now = time.monotonic()
        with self._lock:
            live = [
                q for q in self._queries.values() if not q.done
            ]
        for q in live:
            if not q.deadline_exceeded(now):
                continue
            if q.state is QueryState.QUEUED:
                # error BEFORE the transition: the exactly-once
                # terminal hook (trace root tags, slow-query log)
                # snapshots the query as the transition fires
                prev = q.error
                q.error = "deadline exceeded while queued"
                if not q.try_transition(QueryState.TIMED_OUT):
                    q.error = prev  # lost the race to another state
            elif q.state in (QueryState.ADMITTED, QueryState.RUNNING):
                # propagate the cancel event so the run loop (or a
                # retry-backoff wait) observes it promptly; the run
                # loop itself performs the TIMED_OUT transition AFTER
                # closing the operator generator, preserving the
                # invariant that a terminal state implies cleaned-up
                # execution resources
                q.request_cancel(reason="deadline")

    def _sweep_orphans(self) -> None:
        """Reap terminal queries no router will ever collect: never
        fetched, no POLL/REPORT activity for orphan_ttl_s. Closes the
        replica-side leak of a permanently-dead router - the detached
        downstream runs it abandoned must not pin retention (and their
        materialized results) forever. Throttled to ~4 sweeps per TTL
        so the dispatcher loop stays cheap."""
        ttl = self.orphan_ttl_s
        if ttl is None:
            return
        now = time.monotonic()
        if now < self._next_orphan_sweep:
            return
        self._next_orphan_sweep = now + max(0.05, ttl / 4.0)
        reaped = []
        with self._lock:
            for qid, q in self._queries.items():
                if not q.done or q.fetched or q.fetchers > 0:
                    continue
                idle_since = max(q.last_activity,
                                 q.timings.get("finished", 0.0))
                if now - idle_since > ttl:
                    reaped.append(qid)
            for qid in reaped:
                self._queries.pop(qid, None)
            if reaped:
                gone = set(reaped)
                self._order = [
                    qid for qid in self._order if qid not in gone
                ]
                self.obs_counters["orphans_reaped"] += len(reaped)
        for qid in reaped:
            log.info("reaped orphaned query %s (terminal, never "
                     "fetched, idle > %.1fs)", qid, ttl)

    # -- execution ------------------------------------------------------
    def _run_query(self, q: Query) -> None:
        try:
            if chaos.ACTIVE:
                # chaos seam (STALL widens the ADMITTED->RUNNING window
                # so cancellation races become deterministic tests); a
                # RAISED fault here goes through the same taxonomy
                # surfacing as any pre-execution failure
                try:
                    with (obs_trace.span("service_admit",
                                         rec=q.tracer)
                          if obs_trace.ACTIVE else obs_trace.NULL):
                        chaos.fire("service.admit",
                                   query_id=q.query_id)
                except Exception as e:  # noqa: BLE001 - classified
                    q.error = f"{type(e).__name__}: {e}"
                    q.error_class = classify(e).value
                    q.try_transition(QueryState.FAILED)
                    return
            # an explicit user/shutdown cancel wins over a deadline
            # that elapsed concurrently; a sweep-fired ('deadline')
            # cancel - or a bare deadline expiry - reports TIMED_OUT
            if q.cancel_requested and q.cancel_reason in (
                "user", "shutdown"
            ):
                if q.try_transition(QueryState.CANCELLED):
                    return
            if q.deadline_exceeded():
                prev = q.error
                q.error = "deadline exceeded before start"
                if q.try_transition(QueryState.TIMED_OUT):
                    return
                q.error = prev
            if q.cancel_requested:
                if q.try_transition(QueryState.CANCELLED):
                    return
            if not q.try_transition(QueryState.RUNNING):
                return
            q.timings["run_start"] = time.monotonic()
            if q.tracer is not None and "admitted" in q.timings:
                q.tracer.record_span(
                    "admission", q.timings["admitted"],
                    q.timings["run_start"],
                )
            try:
                q.result = self._execute(q)
            except QueryCancelled:
                if q.cancel_requested and q.cancel_reason in (
                    "user", "shutdown"
                ):
                    q.try_transition(QueryState.CANCELLED)
                elif q.cancel_requested and q.cancel_reason == (
                    "stream_stalled"
                ):
                    # slow-consumer abort (service/stream.py): the
                    # ring already stamped the classified
                    # STREAM_STALLED error; CANCELLED-class keeps it
                    # strike-free for replica circuit breakers even
                    # when a deadline lapsed during the stall wait
                    q.try_transition(QueryState.CANCELLED)
                elif q.deadline_exceeded():
                    q.error = "deadline exceeded while running"
                    q.try_transition(QueryState.TIMED_OUT)
                else:
                    q.try_transition(QueryState.CANCELLED)
                return
            except Exception as e:  # noqa: BLE001 - reported via state
                q.error = f"{type(e).__name__}: {e}"
                q.error_class = classify(e).value
                q.try_transition(QueryState.FAILED)
                log.warning(
                    "query %s failed [%s]: %s",
                    q.query_id, q.error_class, q.error,
                )
                return
            q.try_transition(QueryState.DONE)
        finally:
            self.admission.release(q)
            self._kick()

    def _execute(self, q: Query) -> List:
        """Run (or reuse) every partition of the query's plan."""
        from blaze_tpu_torch.runtime.executor import prepare_decoded_task
        from blaze_tpu_torch.runtime.instrument import instrument

        # wire-manifest resources first (the gateway's resource
        # registry contract); decoded-task resources setdefault under
        # them in prepare_decoded_task
        q.ctx.resources.update(q.resources)

        cache = (
            self.cache
            if (self.cache is not None and q.use_cache
                and q._fingerprint_stable)
            else None
        )
        if q.plan is not None:
            op = q.plan
            # mesh_mode "auto" lowers nothing until the mesh tier
            # (item 7): driver plans run on the one card as built
            partitions = list(range(op.partition_count))
            exec_op = op  # driver plans run as-built (run_plan parity)
        else:
            op = None
            partitions = [
                q._decoded[1] if q._decoded is not None
                else q._plan_partition
            ]
            exec_op = None  # prepared lazily: a full cache hit must
            # not pay fusion/mesh lowering (and must dispatch nothing)

        def run_one(p):
            nonlocal exec_op
            if exec_op is None:
                if q._decoded is None:
                    # plan-cache metadata hit whose tree was loaned
                    # out AND the result cache missed: the lazy
                    # re-decode (still cheaper than the old world -
                    # only cache-missing repeats pay it)
                    q._decoded = self._decode_bytes(q)
                # the tree is about to be fused/lowered IN PLACE:
                # it can never go back into the plan cache
                q._tree_consumed = True
                prepared, _ = prepare_decoded_task(q._decoded, q.ctx)
                # the per-operator metric tree of the query's report
                exec_op = instrument(prepared, q.metrics_root)
            return self._run_partition(q, exec_op, p)

        out: List = []
        for p in partitions:
            q.check_interrupt()
            key = (q._fingerprint, p)
            if cache is None:
                out.extend(run_one(p)[0])
                continue
            followed = False
            while True:
                probe_cm = (
                    obs_trace.span("cache_probe", rec=q.tracer,
                                   partition=p)
                    if obs_trace.ACTIVE else obs_trace.NULL
                )
                with probe_cm as sp:
                    hit = cache.get(key)
                    sp.tag(hit=hit is not None,
                           coalesced=followed or None)
                if hit is not None:
                    q.ctx.metrics.add("cache_hits", 1)
                    if followed:
                        # the leader populated the entry while we
                        # waited: this execution was COALESCED away
                        cache.note_coalesced()
                        q.ctx.metrics.add("coalesced", 1)
                    for rb in hit:
                        q.ctx.metrics.add("output_rows", rb.num_rows)
                        if q.stream is not None:
                            # cached partitions feed the ring too -
                            # part order must equal q.result order for
                            # the delivered-prefix resume contract
                            q.stream.put(q, rb)
                    out.extend(hit)
                    break
                # miss: claim leadership of this (fingerprint,
                # partition) or wait on whoever holds it
                with self._inflight_lock:
                    ev = self._inflight.get(key)
                    claimed = ev is None
                    if claimed:
                        ev = threading.Event()
                        self._inflight[key] = ev
                if not claimed:
                    followed = True
                    # interruptible wait: a cancel/deadline during the
                    # coalesce wait must still kill THIS query promptly
                    while not ev.wait(0.02):
                        q.check_interrupt()
                    continue  # leader finished (or failed): re-probe
                q.ctx.metrics.add("cache_misses", 1)
                try:
                    part_batches, degraded = run_one(p)
                    if not degraded:
                        # degraded results are correct but host-
                        # produced; keeping them out of the cache
                        # preserves device-result provenance and lets
                        # a healthy re-run repopulate it
                        cache.put(key, part_batches)
                finally:
                    # release followers even on failure - each re-
                    # probes, misses, and applies its OWN retry policy
                    with self._inflight_lock:
                        self._inflight.pop(key, None)
                    ev.set()
                out.extend(part_batches)
                break
        return out

    def _run_partition(self, q: Query, op, partition: int):
        """One partition with CLASSIFIED failure handling
        (blaze_tpu_torch/errors.py): TRANSIENT retries with exponential
        backoff + jitter (cancel-interruptible), RESOURCE_EXHAUSTED
        degrades through the host engine, PLAN_INVALID/INTERNAL fail
        fast with zero retries. Returns (batches, degraded)."""
        from blaze_tpu_torch.runtime.scheduler import backoff_delay

        for attempt in range(self.max_task_attempts):
            q.check_interrupt()
            # obs seam: one span per attempt; a failing attempt is
            # auto-tagged with its error_class by the span exit, so a
            # retried query renders as N attempt spans with N-1 tagged
            # failures
            span_cm = (
                obs_trace.span("attempt", rec=q.tracer,
                               partition=partition, attempt=attempt)
                if obs_trace.ACTIVE else obs_trace.NULL
            )
            try:
                with span_cm:
                    return self._drain(q, op, partition), False
            except QueryCancelled:
                raise
            except Exception as e:  # noqa: BLE001 - classified below
                ec = classify(e)
                action = retry_action(
                    ec, attempt, self.max_task_attempts,
                    self.degrade_to_host,
                )
                if action == "cancel":
                    raise QueryCancelled(q.query_id) from e
                q.record_attempt(partition, attempt, ec.value, e,
                                 action)
                if action == "degrade":
                    batches = self._degrade_partition(q, partition, e)
                    if q.stream is not None:
                        # the failed device attempt's parts were
                        # rolled back in _drain; the host re-run feeds
                        # the ring on success (replay-verified against
                        # any prefix already delivered)
                        for rb in batches:
                            q.stream.put(q, rb)
                    return batches, True
                if action == "fail":
                    raise
                q.ctx.metrics.add("task_retries", 1)
                q.ctx.metrics.add("retries.transient", 1)
                log.warning(
                    "query %s partition %d failed transiently "
                    "(attempt %d), backing off: %s",
                    q.query_id, partition, attempt + 1, e,
                )
                if q.wait_cancel(
                    backoff_delay(attempt, self.retry_backoff_s)
                ):
                    raise QueryCancelled(q.query_id) from e
        raise AssertionError("unreachable: attempt loop fell through")

    def _degrade_partition(self, q: Query, partition: int,
                           cause: BaseException) -> List:
        """RESOURCE_EXHAUSTED degradation: re-execute the partition
        through the pandas host engine against an UNFUSED plan (fused
        pipelines have no host mapping). Wire tasks re-decode from the
        original bytes - prepare_decoded_task fuses the decoded tree
        IN PLACE, so q._decoded is already fused by the time a
        partition fails. Surfaces the ORIGINAL device error when no
        host mapping exists."""
        from blaze_tpu_torch.planner.host_engine import execute_partition_host

        try:
            if q.plan is not None:
                base = q.plan  # driver plans run as-built (never fused)
            elif q.is_ref:
                from blaze_tpu_torch.plan.refcompat import (
                    task_from_reference_proto,
                )

                base = task_from_reference_proto(q.task_bytes)[0]
            else:
                from blaze_tpu_torch.plan.serde import task_from_proto

                base = task_from_proto(q.task_bytes)[0]
            with (obs_trace.span("host_degrade", rec=q.tracer,
                                 partition=partition)
                  if obs_trace.ACTIVE else obs_trace.NULL):
                batches = execute_partition_host(base, partition,
                                                 q.ctx)
        except Exception as host_err:  # noqa: BLE001 - original wins
            log.warning(
                "query %s: host degradation of partition %d "
                "unavailable (%s); surfacing original error",
                q.query_id, partition, host_err,
            )
            raise cause
        q.degraded = True
        q.ctx.metrics.add("degraded_partitions", 1)
        # degradation-aware admission (ROADMAP): THIS partition now
        # runs on the HOST engine - its share of the device-byte
        # reservation gates nothing real anymore, so release it (and
        # wake the dispatcher) to let headroom-waiting device work
        # admit while the host fallback grinds on. Only the share: a
        # multi-partition driver plan's remaining partitions still
        # execute on the device against the rest of the reservation
        nparts = (q.plan.partition_count
                  if q.plan is not None else 1)
        self.admission.release_bytes(q, share_of=max(1, nparts))
        self._kick()
        log.warning(
            "query %s partition %d degraded to host engine after "
            "RESOURCE_EXHAUSTED: %s", q.query_id, partition, cause,
        )
        return batches

    def _drain(self, q: Query, op, partition: int) -> List:
        """Materialize one partition with cooperative interrupt checks
        between batches; closing the generator routes through the
        executor's cancellation pass-through (GeneratorExit), so a
        cancelled query never poisons the engine."""
        from blaze_tpu_torch.runtime.executor import execute_partition

        it = execute_partition(op, partition, q.ctx)
        batches: List = []
        sb = q.stream
        start_pos = sb.position() if sb is not None else 0
        try:
            for rb in it:
                batches.append(rb)
                if sb is not None:
                    # stream-as-produced: the part is visible to an
                    # in-progress FETCH the moment the executor yields
                    # it; put() blocks on the ring's byte cap, so a
                    # slow consumer backpressures THIS loop instead of
                    # growing host memory (StreamStalled/QueryCancelled
                    # propagate through the rollback below)
                    sb.put(q, rb)
                if q.cancel_requested or q.deadline_exceeded():
                    it.close()
                    raise QueryCancelled(q.query_id)
        except BaseException:
            # an abandoned attempt's partial output must not stay in
            # the query counters - a retry (or the host degradation)
            # re-counts the partition from scratch. Same for the ring:
            # undelivered parts truncate; delivered ones stay and the
            # retry replays against them (delivered-prefix verify)
            if sb is not None:
                sb.rollback(start_pos)
            if batches:
                q.ctx.metrics.add(
                    "output_rows", -sum(rb.num_rows for rb in batches)
                )
                q.ctx.metrics.add("output_batches", -len(batches))
            raise
        finally:
            it.close()
        return batches
