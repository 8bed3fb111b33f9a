"""Admission control: who runs next, and whether they fit.

The reference engine never needed this - Spark's scheduler + the
executor's task slots gate concurrency, and MemoryManagerConfig gates
bytes (exec.rs:79-94). A standalone serving tier must grow both knobs:

  * concurrency: at most `max_concurrency` queries RUNNING at once
    (one process shares one device; extra threads buy host/device
    overlap, not compute - runtime/dispatch.task_threads rationale);
  * memory: a query is admitted only when its estimated device bytes
    fit the DeviceMemoryTracker's CURRENT headroom minus what already-
    admitted queries reserved. An over-headroom query WAITS instead of
    OOMing the device; when the device is idle it runs alone (a query
    larger than the whole budget must still be servable - the spill
    ladder, not admission, handles its overflow).

Ordering is strict: priority descending; WITHIN a priority class,
earliest deadline first (EDF - the query with the least slack runs
first, ROADMAP "deadline-aware scheduling"), with deadline-less
queries after deadlined ones, FIFO among themselves (submission
sequence). The head of the queue blocks lower entries even when they
would fit - bypass ("backfill") would starve big queries under a
stream of small ones, and predictable ordering is worth more to a
serving tier than peak packing.

Shedding: a query whose deadline has ALREADY passed at submit time
cannot be met no matter what - the service refuses it up front
(TIMED_OUT with a shed marker) instead of letting it occupy queue
depth only to die in the deadline sweep. The service additionally
sheds at ADMISSION time on PREDICTED unmeetability: when the
runtime-history store (obs/history.py) has >= 3 samples for the
query's fingerprint and now + p50 estimate already overshoots the
deadline, running it would only burn device time to miss anyway
(`shed_predicted` counter; service/service.py drives the check).

Backpressure is explicit: a full queue rejects at submit time
(REJECTED_OVERLOADED) instead of building an unbounded pileup.

Tenancy (docs/SERVICE.md "Tenancy"): with a tenant config - or the
moment a second tenant shows up - the controller switches to
weighted-fair mode: one heap PER TENANT (each keeping the exact
priority/EDF/FIFO entry order above), deficit-round-robin across
tenants WITHIN the top priority class, so no tenant's backlog can
shadow another's, and per-tenant caps on queued entries, RUNNING
slots, and reserved bytes. An over-budget submit is rejected with the
`REJECTED_TENANT_BUDGET` marker (TRANSIENT - the tenant's own
in-flight work draining frees the budget); a tenant at its RUNNING or
byte cap is simply invisible to the scheduler until it drains, so its
backlog never blocks other tenants. With no config and a single
tenant (the default), every path below short-circuits to the exact
single-heap behavior documented above - zero-config ordering is
byte-identical to the pre-tenancy controller.
"""

from __future__ import annotations

import heapq
import itertools
import math
import threading
from typing import Dict, List, Optional, Tuple

from blaze_tpu_torch.obs.contention import TimedLock
from blaze_tpu_torch.service.query import Query


def estimate_plan_device_bytes(op, partition: Optional[int] = None) -> int:
    """Admission cost estimate: bytes the plan plausibly materializes
    on device. Leaf-driven heuristic - parquet scans count file-range
    bytes, memory scans count resident buffer bytes; interior nodes
    take the sum of their children (joins/aggregates hold their inputs
    resident in the worst case). `partition` narrows leaves to ONE
    partition's inputs - a wire TaskDefinition executes a single
    partition of its stage, so costing the whole scan would serialize
    sibling tasks behind each other. Deliberately coarse: admission
    needs a gate, not a cost model, and callers can override per
    query."""
    from blaze_tpu_torch.ops.memory_scan import MemoryScanExec
    from blaze_tpu_torch.ops.parquet_scan import ParquetScanExec

    if isinstance(op, ParquetScanExec):
        import os

        groups = op.file_groups
        if partition is not None and partition < len(groups):
            groups = [groups[partition]]
        total = 0
        for group in groups:
            for fr in group:
                if fr.length:
                    total += fr.length
                else:
                    try:
                        total += os.path.getsize(fr.path)
                    except OSError:
                        pass
        return total
    if isinstance(op, MemoryScanExec):
        from blaze_tpu_torch.runtime.memory import batch_device_bytes

        parts = op.partitions
        if partition is not None and partition < len(parts):
            parts = [parts[partition]]
        return sum(
            batch_device_bytes(cb) for part in parts for cb in part
        )
    return sum(
        estimate_plan_device_bytes(c, partition) for c in op.children
    )


class TenantBudgets:
    """Per-tenant budget config: caps on queued entries, RUNNING
    slots, and reserved bytes, plus the deficit-round-robin weight.
    Config shape (the `serve --tenant-config` JSON):

        {"acme": {"max_queued": 8, "max_running": 1,
                  "max_reserved_bytes": 1 << 28, "weight": 2.0},
         "*":    {"max_queued": 16}}

    `"*"` holds defaults for tenants not named; a named entry's keys
    override the defaults key-by-key. Missing caps are unlimited;
    missing weight is 1.0."""

    _CAPS = ("max_queued", "max_running", "max_reserved_bytes")

    def __init__(self, config: Optional[dict] = None):
        cfg = dict(config or {})
        self._default = dict(cfg.pop("*", {}))
        self._tenants = {str(k): dict(v) for k, v in cfg.items()}
        self.configured = bool(self._default or self._tenants)

    def for_tenant(self, tenant: str) -> dict:
        out = dict(self._default)
        out.update(self._tenants.get(tenant, {}))
        return out

    def cap(self, tenant: str, key: str) -> Optional[int]:
        v = self.for_tenant(tenant).get(key)
        return int(v) if v is not None else None

    def weight(self, tenant: str) -> float:
        try:
            w = float(self.for_tenant(tenant).get("weight", 1.0))
        except (TypeError, ValueError):
            w = 1.0
        return w if w > 0 else 1.0


class AdmissionController:
    """Bounded priority queue + headroom gate for the QueryService."""

    def __init__(
        self,
        device_tracker=None,
        max_concurrency: int = 2,
        max_queue_depth: int = 64,
        tenant_config: Optional[dict] = None,
    ):
        from blaze_tpu_torch.runtime.memory import get_device_tracker

        self._tracker = device_tracker or get_device_tracker()
        self.max_concurrency = max(1, int(max_concurrency))
        self.max_queue_depth = max(1, int(max_queue_depth))
        self._lock = TimedLock("admission")
        self._seq = itertools.count()
        # heap entries: (-priority, deadline, seq, query) -
        # max-priority first; within a priority class earliest
        # deadline first (EDF; no deadline sorts last as +inf), FIFO
        # via the submission sequence among equals
        self._heap: List[Tuple[int, float, int, Query]] = []
        # reservations for admitted-but-not-yet-tracked device bytes
        self._reserved: Dict[str, int] = {}
        self.counters = {
            "submitted": 0,
            "admitted": 0,
            "rejected_overloaded": 0,
            "rejected_tenant_budget": 0,
            "shed_deadline": 0,
            "shed_predicted": 0,
            "headroom_waits": 0,
            "tenant_budget_waits": 0,
            "degraded_released": 0,
        }
        # -- tenancy ----------------------------------------------------
        self.budgets = TenantBudgets(tenant_config)
        # weighted-fair mode: ON from construction when a config
        # exists, flipped (sticky) the moment a SECOND tenant appears.
        # While off, offer/next_admissible run the exact single-heap
        # code path above - zero-config behavior is byte-identical.
        self._fair = self.budgets.configured
        self._tenant_heaps: Dict[str, List[Tuple[int, float, int, Query]]] = {}
        # deficit-round-robin state: tenants in first-seen order, a
        # cyclic pointer, and per-tenant deficit credit (quantum = the
        # tenant's weight per visit, cost = 1 per admitted query; an
        # emptied tenant's deficit resets so idle tenants cannot bank
        # credit - classic DRR)
        self._drr_order: List[str] = []
        self._drr_next = 0
        self._drr_deficit: Dict[str, float] = {}
        # per-tenant live accounting (all modes - O(1) dict bumps):
        # queued entries, RUNNING slots, reserved bytes, and the
        # lifetime counters STATS/metrics export
        self._t_queued: Dict[str, int] = {}
        self._t_running: Dict[str, int] = {}
        self._t_reserved: Dict[str, int] = {}
        self._t_counters: Dict[str, Dict[str, int]] = {}

    # -- tenancy helpers -----------------------------------------------
    def _t_count(self, tenant: str, key: str, n: int = 1) -> None:
        c = self._t_counters.get(tenant)
        if c is None:
            c = self._t_counters[tenant] = {
                "submitted": 0, "admitted": 0,
                "rejected_budget": 0,
            }
        c[key] += n

    def _note_tenant(self, tenant: str) -> None:
        """First-seen bookkeeping; flips weighted-fair mode when a
        second tenant appears (migrating the single heap into
        per-tenant heaps - entry tuples keep their order)."""
        if tenant not in self._drr_deficit:
            self._drr_deficit[tenant] = 0.0
            self._drr_order.append(tenant)
        if not self._fair and len(self._drr_order) > 1:
            self._fair = True
            for e in self._heap:
                q = e[-1]
                if q.done:
                    # migration IS this entry's prune: balance the
                    # per-tenant queued gauge like _prune would
                    self._t_queued[q.tenant] = max(
                        0, self._t_queued.get(q.tenant, 0) - 1
                    )
                    continue
                heapq.heappush(
                    self._tenant_heaps.setdefault(q.tenant, []), e
                )
            self._heap = []

    def _live_depth(self) -> int:
        heaps = ([self._heap] if not self._fair
                 else self._tenant_heaps.values())
        return sum(
            1 for h in heaps for e in h if not e[-1].done
        )

    # ------------------------------------------------------------------
    def offer(self, q: Query) -> str:
        """Enqueue; returns "ok", "overloaded" (queue full - the
        caller marks the query REJECTED_OVERLOADED, explicit
        backpressure), or "tenant_budget" (the tenant is over its
        queued-entries cap - the caller rejects with the
        REJECTED_TENANT_BUDGET marker)."""
        with self._lock:
            self.counters["submitted"] += 1
            tenant = q.tenant
            self._note_tenant(tenant)
            self._t_count(tenant, "submitted")
            mq = self.budgets.cap(tenant, "max_queued")
            if mq is not None and \
                    self._t_queued.get(tenant, 0) >= mq:
                self.counters["rejected_tenant_budget"] += 1
                self._t_count(tenant, "rejected_budget")
                return "tenant_budget"
            if self._live_depth() >= self.max_queue_depth:
                self.counters["rejected_overloaded"] += 1
                return "overloaded"
            deadline = (
                q.deadline_at if q.deadline_at is not None else math.inf
            )
            entry = (-q.priority, deadline, next(self._seq), q)
            if self._fair:
                heapq.heappush(
                    self._tenant_heaps.setdefault(tenant, []), entry
                )
            else:
                heapq.heappush(self._heap, entry)
            self._t_queued[tenant] = (
                self._t_queued.get(tenant, 0) + 1
            )
            return "ok"

    def note_shed(self) -> None:
        """The service shed a query at admission (deadline already
        unmeetable); recorded here so stats() tells the whole story."""
        with self._lock:
            self.counters["submitted"] += 1
            self.counters["shed_deadline"] += 1

    def note_shed_predicted(self) -> None:
        """Predicted-unmeetability shed (ROADMAP deadline item, second
        half): queue-wait already spent + the fingerprint's p50 runtime
        estimate exceed the query's remaining slack. Distinct counter -
        prediction sheds are tunable (history quality), hard-deadline
        sheds are not. The query was already counted `submitted` at
        enqueue; `admitted` is counted only when the ADMITTED
        transition lands (note_admitted), so a shed never touches it
        and completion-rate math (done/admitted) stays honest."""
        with self._lock:
            self.counters["shed_predicted"] += 1

    def queue_depth(self) -> int:
        with self._lock:
            return self._live_depth()

    def running_count(self) -> int:
        with self._lock:
            return len(self._reserved)

    # ------------------------------------------------------------------
    def _prune(self, heap: List[Tuple[int, float, int, Query]]) -> None:
        """Drop already-terminal heads (cancelled/timed out while
        queued), keeping the per-tenant queued gauge honest."""
        while heap and heap[0][-1].done:
            e = heapq.heappop(heap)
            t = e[-1].tenant
            self._t_queued[t] = max(
                0, self._t_queued.get(t, 0) - 1
            )

    def _admit(self, heap: List[Tuple[int, float, int, Query]]
               ) -> Optional[Query]:
        """Headroom-gate + pop the head of `heap`. Strict: a head that
        does not fit while others hold the device WAITS (no backfill -
        see module docstring); an idle device admits anything."""
        q = heap[0][-1]
        est = q.estimated_bytes or 0
        headroom = self._tracker.headroom() - sum(
            self._reserved.values()
        )
        if self._reserved and est > headroom:
            self.counters["headroom_waits"] += 1
            return None
        heapq.heappop(heap)
        t = q.tenant
        self._t_queued[t] = max(0, self._t_queued.get(t, 0) - 1)
        self._reserved[q.query_id] = est
        self._t_running[t] = self._t_running.get(t, 0) + 1
        self._t_reserved[t] = self._t_reserved.get(t, 0) + est
        self._t_count(t, "admitted")
        return q

    def _tenant_eligible(self, tenant: str) -> bool:
        """A tenant at its RUNNING or reserved-bytes cap is invisible
        to the scheduler until its own work drains - its backlog must
        never block other tenants (isolation beats strict global
        head-of-queue across tenants; WITHIN a tenant the policy is
        unchanged)."""
        mr = self.budgets.cap(tenant, "max_running")
        if mr is not None and \
                self._t_running.get(tenant, 0) >= mr:
            self.counters["tenant_budget_waits"] += 1
            return False
        mb = self.budgets.cap(tenant, "max_reserved_bytes")
        if mb is not None:
            head = self._tenant_heaps[tenant][0][-1]
            est = head.estimated_bytes or 0
            if self._t_reserved.get(tenant, 0) + est > mb:
                self.counters["tenant_budget_waits"] += 1
                return False
        return True

    def next_admissible(self) -> Optional[Query]:
        """Pop the query that may start now, or None. Strict head-of-
        queue policy (see module docstring); in weighted-fair mode the
        "head" is chosen by deficit-round-robin across tenants within
        the top priority class among budget-eligible tenants."""
        with self._lock:
            if not self._fair:
                self._prune(self._heap)
                if not self._heap:
                    return None
                if len(self._reserved) >= self.max_concurrency:
                    return None
                return self._admit(self._heap)
            # weighted-fair mode -------------------------------------
            heads: Dict[str, Tuple[int, float, int, Query]] = {}
            for t, h in self._tenant_heaps.items():
                self._prune(h)
                if h:
                    heads[t] = h[0]
                else:
                    # classic DRR: an emptied tenant banks no credit
                    self._drr_deficit[t] = 0.0
            if not heads:
                return None
            if len(self._reserved) >= self.max_concurrency:
                return None
            eligible = {
                t for t in heads if self._tenant_eligible(t)
            }
            if not eligible:
                return None
            # top priority class among ELIGIBLE tenants only: a
            # capped tenant's high-priority backlog must not shadow
            # other tenants' admissible work
            top = min(heads[t][0] for t in eligible)
            cands = [t for t in eligible if heads[t][0] == top]
            if len(cands) == 1:
                return self._admit(self._tenant_heaps[cands[0]])
            # deficit round robin: walk the first-seen tenant order
            # cyclically from the saved pointer. Arriving at a
            # candidate earns its weight in credit (once per arrival:
            # mid-burst revisits - deficit still >= 1 - do not
            # re-credit), one credit unit buys one admission, and the
            # pointer HOLDS on the served tenant while its credit
            # lasts - weighted bursts, classic DRR.
            order = self._drr_order
            n = len(order)
            max_visits = n * (2 + int(math.ceil(
                1.0 / min(self.budgets.weight(t) for t in cands)
            )))
            for _ in range(max_visits):
                t = order[self._drr_next % n]
                if t not in cands:
                    self._drr_next = (self._drr_next + 1) % n
                    continue
                if self._drr_deficit[t] < 1.0:
                    self._drr_deficit[t] += self.budgets.weight(t)
                if self._drr_deficit[t] >= 1.0:
                    got = self._admit(self._tenant_heaps[t])
                    if got is None:
                        # headroom wait: the selected head blocks
                        # (strict policy) - pointer and credit hold,
                        # so the retry serves the SAME head
                        return None
                    self._drr_deficit[t] -= 1.0
                    if self._drr_deficit[t] < 1.0:
                        # credit spent: the next arrival re-credits
                        self._drr_next = (self._drr_next + 1) % n
                    return got
                self._drr_next = (self._drr_next + 1) % n
            return None  # unreachable with positive weights

    def note_admitted(self) -> None:
        """Counted by the SERVICE once the ADMITTED transition lands -
        not at the next_admissible pop - so predicted-unmeetability
        sheds and admit-races never touch it and the counter stays
        monotonic (it is exported with Prometheus TYPE counter; a
        decrement would read as a counter reset and corrupt rate())."""
        with self._lock:
            self.counters["admitted"] += 1

    def release(self, q: Query) -> None:
        with self._lock:
            cur = self._reserved.pop(q.query_id, None)
            if cur is None:
                return
            t = q.tenant
            self._t_running[t] = max(
                0, self._t_running.get(t, 0) - 1
            )
            self._t_reserved[t] = max(
                0, self._t_reserved.get(t, 0) - cur
            )

    def release_bytes(self, q: Query, share_of: int = 1) -> None:
        """Degradation-aware admission (ROADMAP): a partition that fell
        back to the HOST engine holds device bytes for nothing - free
        its share so queued device work admits against the released
        headroom. Degradation is per-PARTITION: with `share_of` = the
        query's partition count, each degraded partition releases only
        ceil(est / share_of) - sound because the estimator SUMS leaf
        inputs across partitions - while the query's OTHER partitions
        still execute on the device against the rest of the
        reservation (wire tasks are single-partition, so the whole
        reservation frees at once). `degraded_released` counts release
        events: one per degraded partition that freed bytes. Idempotent
        at zero; the final release() still clears the slot."""
        with self._lock:
            cur = self._reserved.get(q.query_id)
            if not cur:
                return
            est = q.estimated_bytes or cur
            share = cur if share_of <= 1 else min(
                cur, -(-est // share_of)  # ceil: n shares fully drain
            )
            self._reserved[q.query_id] = cur - share
            self._t_reserved[q.tenant] = max(
                0, self._t_reserved.get(q.tenant, 0) - share
            )
            self.counters["degraded_released"] += 1

    def adjust_reservation(self, q: Query, delta: int) -> None:
        """Stream-buffer accounting (service/stream.py): pending
        (produced-but-undelivered) result bytes of an actively-FETCHed
        query count against its reservation, so a consumer slower than
        the producer gates new admissions exactly like the device
        bytes it mirrors. No-op once the query released its slot -
        post-terminal retention is bounded by the ring's own byte cap,
        not by admission."""
        with self._lock:
            cur = self._reserved.get(q.query_id)
            if cur is None:
                return
            nxt = max(0, cur + int(delta))
            self._reserved[q.query_id] = nxt
            self._t_reserved[q.tenant] = max(
                0, self._t_reserved.get(q.tenant, 0) + (nxt - cur)
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                **self.counters,
                "queued": self._live_depth(),
                "running": len(self._reserved),
                "reserved_bytes": sum(self._reserved.values()),
                "headroom": self._tracker.headroom(),
                "fair": self._fair,
            }

    def tenant_stats(self) -> Dict[str, dict]:
        """{tenant: {queued, running, reserved_bytes, submitted,
        admitted, rejected_budget, weight}} - the STATS `tenants`
        section and the blaze_tenant_* gauge source. Empty until a
        tenant submits."""
        with self._lock:
            out: Dict[str, dict] = {}
            for t in self._drr_order:
                c = self._t_counters.get(t, {})
                out[t] = {
                    "queued": self._t_queued.get(t, 0),
                    "running": self._t_running.get(t, 0),
                    "reserved_bytes": self._t_reserved.get(t, 0),
                    "submitted": c.get("submitted", 0),
                    "admitted": c.get("admitted", 0),
                    "rejected_budget": c.get("rejected_budget", 0),
                    "weight": self.budgets.weight(t),
                }
            return out
