"""Deterministic fault injection: prove the recovery paths work.

The reference engine's robustness story (native->Spark fallback, Spark
task retries - SURVEY 5.3) is exercised by Spark's own chaos: executor
loss, fetch failures, OOM kills. A standalone engine has none of that
ambient chaos, so nothing exercises its retry/degrade/cancel paths
until production does. This module closes that gap: a seeded,
config-activated `FaultPlan` fires named faults at real seams in the
runtime, so every recovery path has a deterministic test.

Design constraints:

  * Production pays ~nothing when chaos is off: every injection point
    is guarded by `if chaos.ACTIVE:` - one module-attribute load and a
    falsy branch. No fault objects are consulted, no strings built.
    (tests/test_dispatch_budget.py pins that chaos-off runs add zero
    dispatches; the hook cannot dispatch by construction.)
  * Determinism: a FaultPlan is seeded; `probability` draws are keyed
    (seed, fault, partition, occurrence) so outcomes do not depend on
    thread interleaving under the parallel scheduler, and the
    fired-fault journal lets tests assert exactly which faults fired
    where.
  * Classification: injected faults raise the same classified
    exceptions (blaze_tpu_torch.errors) the real failures would, so the
    taxonomy path under test is the production path.

Injection sites (each named in docs/ROBUSTNESS.md):

  task.execute      executor.execute_partition entry (any class - the
                    generic "this partition fails" seam)
  parquet.decode    per file-range open in ParquetScanExec.execute
  h2d.transfer      runtime/pack.py put_packed host->device staging
  kernel.dispatch   every compiled-kernel invocation (dispatch.py)
  device.memory     DeviceMemoryTracker.track (HBM accounting)
  gateway.stream    per result part in the service FETCH send loop -
                    with incremental delivery (service/stream.py) the
                    window now covers IN-PROGRESS streams: a fault at
                    partition k can land while the query is still
                    RUNNING, not just on a finished result
  stream.consume    per result part on the CLIENT side of a FETCH
                    (ServiceClient._fetch_parts, after the part is in
                    hand): STALL = a slow consumer holding producer
                    backpressure, DROP = the client connection dying
                    mid-read (resume/re-FETCH paths)
  cache.spill       ResultCache spill-to-disk write
  cluster.heartbeat worker heartbeat tick (STALL silences liveness)
  service.admit     QueryService._run_query before the RUNNING
                    transition (STALL widens the ADMITTED->RUNNING
                    race window for cancellation tests)
  mesh.exchange     before every mesh-tier program launch
                    (parallel/mesh_exec.py): TRANSIENT propagates to
                    the task-retry tier, any other class degrades the
                    op to its single-device fallback plan
  router.membership every MEMBER frame the router handles
                    (router/proxy.py): DROP = a JOIN/LEAVE whose ack
                    never reaches the replica (the announcer's next
                    tick retries), STALL = a slow membership
                    authority widening join/leave race windows
  router.journal    the durable routing journal (router/journal.py)
                    and the recovery pass (router/proxy.py), keyed by
                    the `op` context value: op=append DROP tears the
                    record mid-write (the crash-at-the-worst-moment
                    replay test), op=fsync STALL = slow disk under
                    the batched flusher, op=reconcile_poll DROP = a
                    recovery POLL that never reaches the journaled
                    replica (the pass retries next tick)
  zerocopy.map      every mmap on the zero-copy serve path: arena
                    segment publish (zerocopy/arena.py), client-side
                    handle mapping (map_handle_frames), and the
                    parquet page-buffer mmap (io/object_store.py).
                    Any raise degrades that call to the socket/read
                    byte path - zero client-visible failures
  zerocopy.lease    arena lease grant (ArrowArena.handle) and the
                    client's post-map staleness check: a raise makes
                    the server answer bytes instead of a handle, or
                    the client treat its handle as a stale lease and
                    re-FETCH on the byte path
  service.tenant    the tenant budget check in QueryService._enqueue
                    (ctx: tenant, query): DROP = the budget check
                    itself fails and the submit is rejected
                    REJECTED_TENANT_BUDGET (fail CLOSED - an
                    isolation layer that fails open under stress
                    protects nobody), STALL = a slow budget path
                    widening the admission window (noisy-neighbor
                    chaos in tests/test_tenancy.py)

In the port, `cluster.heartbeat`, `router.membership` and
`router.journal` have no seam yet (the cluster hooks and the router
come with the second half of ROADMAP 'Modules to port' item 8), nor
has `mesh.exchange` (item 7).

Activation: programmatic `install()`/`active()` (tests), or the
BLAZE_CHAOS environment variable carrying the plan as JSON - worker
subprocesses inherit it, so cluster-level faults need no RPC:

  BLAZE_CHAOS='{"seed": 7, "faults": [
      {"site": "task.execute", "klass": "TRANSIENT",
       "partition": 3, "times": 1}]}'
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from contextlib import contextmanager
from random import Random
from typing import Any, Dict, List, Optional

from blaze_tpu_torch.errors import (
    PlanInvalidError,
    ResourceExhaustedError,
    TransientError,
)

# fast gate: injection points check this single module attribute and
# fall through when False (the chaos-off production path)
ACTIVE = False
_PLAN: Optional["FaultPlan"] = None


class InjectedTransient(TransientError):
    pass


class InjectedResourceExhausted(ResourceExhaustedError):
    pass


class InjectedPlanInvalid(PlanInvalidError):
    pass


class InjectedDrop(ConnectionError):
    """Wire-level drop: the socket tier treats it like a peer reset."""


_RAISES = {
    "TRANSIENT": InjectedTransient,
    "RESOURCE_EXHAUSTED": InjectedResourceExhausted,
    "PLAN_INVALID": InjectedPlanInvalid,
    "DROP": InjectedDrop,
}


@dataclasses.dataclass
class Fault:
    """One named fault: where it fires, what it raises, how often.

    klass: TRANSIENT | RESOURCE_EXHAUSTED | PLAN_INVALID | DROP | STALL
    times: fire count (0 = unlimited)
    partition: only fire when the site reports this partition
    match: substring that must appear in one of the site's context
      values (e.g. a file path or query id)
    probability: seeded per-candidate draw (1.0 = always)
    stall_s: sleep duration for STALL faults
    """

    site: str
    klass: str = "TRANSIENT"
    times: int = 1
    partition: Optional[int] = None
    match: Optional[str] = None
    probability: float = 1.0
    stall_s: float = 0.1

    def __post_init__(self):
        if self.klass not in _RAISES and self.klass != "STALL":
            raise ValueError(f"unknown fault class {self.klass!r}")


class FaultPlan:
    """A seeded set of faults plus the journal of what actually fired."""

    def __init__(self, faults: List[Fault], seed: int = 0):
        self.seed = seed
        self.faults = list(faults)
        self._remaining = [f.times for f in self.faults]
        # per-(fault, partition) candidate counters: probability draws
        # are keyed (seed, fault index, partition, occurrence) so the
        # outcome for "the Nth time fault i considers partition p" is
        # stable regardless of thread interleaving under the parallel
        # scheduler
        self._draw_counts: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        self.journal: List[Dict[str, Any]] = []

    def fire(self, site: str, **ctx: Any) -> None:
        """Raise/stall if a fault matches this site+context; no-op
        otherwise. Thread-safe; `times` is consumed exactly once per
        firing even under concurrent sites."""
        chosen: Optional[Fault] = None
        with self._lock:
            for i, f in enumerate(self.faults):
                if f.site != site:
                    continue
                if (
                    f.partition is not None
                    and ctx.get("partition") != f.partition
                ):
                    continue
                if f.match is not None and not any(
                    f.match in str(v) for v in ctx.values()
                ):
                    continue
                if f.times and self._remaining[i] <= 0:
                    continue
                if f.probability < 1.0:
                    part = ctx.get("partition")
                    part = -1 if part is None else int(part)
                    dk = (i, part)
                    n = self._draw_counts.get(dk, 0)
                    self._draw_counts[dk] = n + 1
                    mix = (
                        (self.seed & 0xFFFFFFFF) << 32
                    ) ^ (i << 24) ^ ((part & 0xFFFF) << 8) ^ n
                    if Random(mix).random() > f.probability:
                        continue
                if f.times:
                    self._remaining[i] -= 1
                self.journal.append(
                    {"site": site, "klass": f.klass, **ctx}
                )
                chosen = f
                break
        if chosen is None:
            return
        # observability: a fired fault lands in the active trace as a
        # span event carrying the plan seed, so an exported trace
        # explains WHY an attempt failed (docs/OBSERVABILITY.md)
        from blaze_tpu_torch.obs import trace as obs_trace

        if obs_trace.ACTIVE:
            obs_trace.event(
                "chaos.fault", site=site, klass=chosen.klass,
                seed=self.seed,
                **{k: str(v) for k, v in ctx.items()},
            )
        if chosen.klass == "STALL":
            time.sleep(chosen.stall_s)
            return
        raise _RAISES[chosen.klass](
            f"chaos[{site}] injected {chosen.klass}"
            + (f" (partition {ctx['partition']})"
               if "partition" in ctx else "")
        )

    def fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                1 for j in self.journal
                if site is None or j["site"] == site
            )


def install(plan: FaultPlan) -> None:
    global ACTIVE, _PLAN
    _PLAN = plan
    ACTIVE = True


def uninstall() -> None:
    global ACTIVE, _PLAN
    ACTIVE = False
    _PLAN = None


def current() -> Optional[FaultPlan]:
    return _PLAN


def fire(site: str, **ctx: Any) -> None:
    """Injection-point entry. Callers gate on `chaos.ACTIVE` first so
    the off path never enters this function."""
    p = _PLAN
    if p is not None:
        p.fire(site, **ctx)


@contextmanager
def active(faults: List[Fault], seed: int = 0):
    """Install a FaultPlan for the duration of a `with` block,
    restoring whatever was installed before (nesting-safe). The
    caller's seed is shifted by the BLAZE_CHAOS_SEED_OFFSET sweep
    hook (see seed_offset)."""
    prev = _PLAN
    plan = FaultPlan(faults, seed=seed + seed_offset())
    install(plan)
    try:
        yield plan
    finally:
        if prev is None:
            uninstall()
        else:
            install(prev)


def seed_offset() -> int:
    """Seed-sweep hook (`run_tests.py --chaos --seeds N`): a nonzero
    BLAZE_CHAOS_SEED_OFFSET shifts the seed of every FaultPlan
    installed through `active()`, so the same chaos suite hunts race
    regressions under N different probabilistic firing sequences
    instead of the one fixed seed baked into each test. A UNIFORM
    shift preserves the suite's seed invariants (same seed -> same
    sequence, different seeds -> different sequences). Explicit
    BLAZE_CHAOS env plans are deliberately exempt: their seed is part
    of a cross-process contract the installing test asserts on."""
    try:
        return int(os.environ.get("BLAZE_CHAOS_SEED_OFFSET", "0"))
    except ValueError:
        return 0


def plan_from_json(text: str) -> FaultPlan:
    cfg = json.loads(text)
    faults = [Fault(**f) for f in cfg.get("faults", ())]
    return FaultPlan(faults, seed=int(cfg.get("seed", 0)))


def _maybe_activate_from_env() -> None:
    spec = os.environ.get("BLAZE_CHAOS")
    if spec:
        install(plan_from_json(spec))


_maybe_activate_from_env()
