"""Per-phase duration rollup + regression detection.

BENCH_r*.json tracks end-to-end medians, and the ROADMAP's
"trace-driven regression hunting" note records exactly why that is not
enough: queue-wait creep and decode regressions hide inside a flat e2e
median (a 60ms decode slowdown is 4% of a 1.5s query - inside any
realistic noise band - but 10x the decode phase itself). The span
layer (obs/trace.py) already measures every phase of every query; this
module is the aggregation that makes those measurements diffable:

  * `PhaseRollup` folds each FINISHED query into bounded per-phase
    duration rings (queue_wait, admission, plan_decode, arrow_decode,
    h2d, dispatch, execute, stream, router, e2e) keyed by
    *fingerprint class* - the
    first 12 hex chars of the content-addressed plan fingerprint, the
    same identity the result cache and runtime history key on - plus
    the `_all` aggregate class that survives fingerprint drift across
    hosts. The fold is trace-driven where a trace exists (span-name ->
    phase map) and timings-driven where it does not, so obs-off
    serving still rolls up the lifecycle phases.
  * `compare()` diffs two rollup snapshots phase-by-phase with a
    noise band (relative factor + absolute floor, per-phase
    overridable) and returns the regressions - the machine check
    `python -m blaze_tpu_torch regress` builds on.
  * `run_probe()` executes a small fixed workload through a real
    QueryService with tracing on and returns its rollup snapshot:
    the reproducible measurement behind `regress --against
    PHASE_BASELINE.json` (wired into `run_tests.py --smoke`) and
    `regress --emit-baseline`.

Bounded like obs/history.py: at most `max_classes` classes (LRU), at
most `samples_per_phase` samples per (class, phase) ring. The process-
wide instance is `ROLLUP`; the serving tier feeds it from the
exactly-once terminal hook, the router feeds the `router` phase from
its own hop spans, and STATS serves `snapshot()` so the regress CLI
can also diff a LIVE server.
"""

from __future__ import annotations

import collections
import json
import threading
from typing import Any, Dict, List, Optional

# canonical phase order (rendering + artifact stability)
PHASES = (
    "queue_wait",   # SUBMIT -> ADMITTED (admission queue)
    "admission",    # ADMITTED -> RUNNING (worker pickup)
    "plan_decode",  # SUBMIT protobuf -> decoded plan tree (skipped
                    # entirely on a decoded-plan-cache hit)
    "arrow_decode",  # parquet file-range decode (prefetch threads);
                     # pre-split rollups called this "decode"
    "h2d",          # packed host->device staging
    "dispatch",     # compiled-kernel launches
    "join",         # fused join-probe kernel launches
    "group",        # fused grouped-aggregate kernel launches
    # mesh stage anatomy (obs/meshprof.py): the sub-phases of one
    # mesh_execute stage, folded from its child spans when tracing
    "mesh_lower",     # planner pass (lower_plan_to_mesh)
    "mesh_trace",     # jit/shard_map trace + XLA compile
    "mesh_stage_in",  # stack_partitions host stack + device_put
    "mesh_launch",    # the compiled mesh program call
    "mesh_sync",      # block_until_ready on the outputs
    "mesh_gather",    # batched device_get at the mesh boundary
    "execute",      # RUNNING -> terminal (the whole execution)
    "stream",       # FETCH result streaming
    "router",       # router overhead (placement + submit hops)
    "e2e",          # SUBMIT -> terminal wall
)

# span name -> phase (the trace-driven fold); spans not named here
# (attempt, cache_probe, service_admit, ...) are structure, not phase
# cost - their time is already covered by execute/e2e
SPAN_PHASE = {
    "queue_wait": "queue_wait",
    "admission": "admission",
    "plan_decode": "plan_decode",
    "parquet_decode": "arrow_decode",
    "h2d": "h2d",
    "kernel_dispatch": "dispatch",
    "join_dispatch": "join",
    "group_dispatch": "group",
    "execute_partition": "execute",
    "result_stream": "stream",
    "router_place": "router",
    "router_stream": None,  # passthrough time is downstream-bound
    # mesh sub-phase spans fold under their own names (identity map):
    # the terminal hook's phase_totals sweep carries them into the
    # rollup whenever a traced query ran a mesh stage
    "mesh_lower": "mesh_lower",
    "mesh_trace": "mesh_trace",
    "mesh_stage_in": "mesh_stage_in",
    "mesh_launch": "mesh_launch",
    "mesh_sync": "mesh_sync",
    "mesh_gather": "mesh_gather",
}

ALL_CLASS = "_all"


def class_key(fingerprint: Optional[str],
              stable: bool = True,
              tenant: Optional[str] = None) -> str:
    """Fingerprint class: the rollup key. A short DIGEST of the
    content-addressed plan fingerprint (the fingerprint itself is a
    readable nested expression - its prefix is just the root
    operator's name and would fold every hash-aggregate into one
    class), or 'unstable' for plans without content identity. The
    full fingerprint stays in obs/history.

    Tenancy (docs/SERVICE.md "Tenancy"): a NON-default tenant gets its
    own class dimension - `<digest>@<tenant>` - so one tenant's
    phase-duration drift is attributable without polluting another's
    rings. The default tenant's keys (and therefore
    PHASE_BASELINE.json, the regress probe, and every zero-config
    rollup) are unchanged, and the `_all` aggregate still folds every
    query regardless of tenant."""
    if not fingerprint or not stable:
        base = "unstable"
    else:
        import hashlib

        base = hashlib.blake2b(
            str(fingerprint).encode("utf-8"), digest_size=6
        ).hexdigest()
    if tenant and tenant != "default":
        return f"{base}@{tenant}"
    return base


class PhaseRollup:
    """Bounded per-(class, phase) duration rings with percentile
    snapshots. Thread-safe; folds are O(spans) at query-terminal time,
    never on the execution hot path."""

    def __init__(self, max_classes: int = 64,
                 samples_per_phase: int = 128):
        self.max_classes = int(max_classes)
        self.samples_per_phase = int(samples_per_phase)
        self._lock = threading.Lock()
        # class -> phase -> deque of seconds
        self._rings: "collections.OrderedDict[str, Dict[str, collections.deque]]" = (
            collections.OrderedDict()
        )
        self._folded = 0  # lifetime query count

    # -- write path ------------------------------------------------------
    def observe(self, phase: str, seconds: float,
                klass: str = ALL_CLASS) -> None:
        """Record one phase duration for one query under `klass` AND
        under the `_all` aggregate (unless klass IS the aggregate)."""
        if seconds < 0:
            return
        with self._lock:
            for k in ({klass, ALL_CLASS}):
                rings = self._rings.get(k)
                if rings is None:
                    rings = self._rings[k] = {}
                    while len(self._rings) > self.max_classes:
                        # never evict the aggregate class
                        for old in self._rings:
                            if old != ALL_CLASS:
                                del self._rings[old]
                                break
                self._rings.move_to_end(k)
                dq = rings.get(phase)
                if dq is None:
                    dq = rings[phase] = collections.deque(
                        maxlen=self.samples_per_phase
                    )
                dq.append(float(seconds))

    def fold_phases(self, durations: Dict[str, float],
                    klass: str = ALL_CLASS) -> None:
        """One query's phase durations (seconds), one ring sample per
        phase."""
        for phase, s in durations.items():
            if phase in PHASES and s is not None:
                self.observe(phase, s, klass=klass)
        with self._lock:
            self._folded += 1

    def fold_query(self, q) -> None:
        """Fold one FINISHED service Query: lifecycle phases from its
        monotonic timings, execution-interior phases (decode/h2d/
        dispatch) from its span tree when tracing was on. Called from
        the exactly-once terminal hook."""
        t = q.timings
        durations: Dict[str, float] = {}
        sub = t.get("submitted")
        fin = t.get("finished")
        if sub is not None and fin is not None:
            durations["e2e"] = fin - sub
        if "admitted" in t and sub is not None:
            durations["queue_wait"] = t["admitted"] - sub
        if "run_start" in t and "admitted" in t:
            durations["admission"] = t["run_start"] - t["admitted"]
        if fin is not None and "run_start" in t:
            durations["execute"] = fin - t["run_start"]
        if q.tracer is not None:
            # allocation-free span fold (TraceRecorder.phase_totals):
            # the terminal hook runs for EVERY query, and a
            # to_dicts() round trip here was the obs-overhead creep
            # BENCH_r08 caught (dict + tag/event copies per span,
            # discarded immediately)
            for phase, s in q.tracer.phase_totals(SPAN_PHASE).items():
                # timings stay authoritative for lifecycle phases
                durations.setdefault(phase, s)
        self.fold_phases(
            durations,
            klass=class_key(q._fingerprint, q._fingerprint_stable,
                            tenant=getattr(q, "tenant", None)),
        )

    # -- read path -------------------------------------------------------
    @staticmethod
    def _pct(xs: List[float], quantile: float) -> float:
        idx = min(len(xs) - 1,
                  max(0, int(round(quantile * (len(xs) - 1)))))
        return xs[idx]

    def snapshot(self, max_classes: Optional[int] = None
                 ) -> Dict[str, Any]:
        """{class: {phase: {n, p50, p95, mean}}} - the STATS payload
        and the regress artifact form. `_all` always included; other
        classes most-recently-touched first."""
        with self._lock:
            classes = list(self._rings)
            rings = {
                k: {ph: list(dq) for ph, dq in v.items() if dq}
                for k, v in self._rings.items()
            }
        ordered = [ALL_CLASS] if ALL_CLASS in rings else []
        ordered += [k for k in reversed(classes) if k != ALL_CLASS]
        if max_classes is not None:
            ordered = ordered[:max_classes]
        out: Dict[str, Any] = {}
        for k in ordered:
            phases = {}
            for ph in PHASES:
                xs = sorted(rings[k].get(ph, ()))
                if not xs:
                    continue
                phases[ph] = {
                    "n": len(xs),
                    "p50": round(self._pct(xs, 0.5), 6),
                    "p95": round(self._pct(xs, 0.95), 6),
                    "mean": round(sum(xs) / len(xs), 6),
                }
            if phases:
                out[k] = phases
        return out

    @property
    def folded(self) -> int:
        with self._lock:
            return self._folded

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._rings.clear()
            self._folded = 0


def fold_span_dicts(span_dicts) -> Dict[str, float]:
    """Sum one query's span durations into phase totals (seconds).
    Multiple spans of one phase (per-file decode, per-kernel dispatch)
    sum: the result is 'seconds this query spent in that phase'."""
    totals: Dict[str, float] = {}
    for d in span_dicts:
        phase = SPAN_PHASE.get(str(d.get("name", "")))
        if not phase:
            continue
        start, end = d.get("start_ns"), d.get("end_ns")
        if start is None or end is None or end < start:
            continue
        totals[phase] = totals.get(phase, 0.0) + (end - start) / 1e9
    return totals


# the process-wide rollup every tier feeds (service terminal hook,
# wire FETCH streaming, router hop spans)
ROLLUP = PhaseRollup()


# ---------------------------------------------------------------------------
# regression detection
# ---------------------------------------------------------------------------

# default noise band: live p50 regresses when it exceeds
# base_p50 * (1 + rel_band) + abs_floor_s. The CI smoke passes
# deliberately generous values (hosts differ); tests tighten per-phase
# via `bands`.
DEFAULT_REL_BAND = 0.75
DEFAULT_ABS_FLOOR_S = 0.05
DEFAULT_MIN_SAMPLES = 3

# built-in per-phase band WIDENERS for the hop phases the router-hop
# rollups added: `router` (placement ladder + submit round trips) and
# `stream` (FETCH forwarding) measure single-digit-millisecond p50s
# that wobble by integer factors under CI scheduler load - a 3ms->8ms
# jitter is not a regression the way a 3s->8s execute is. compare()
# takes each as max(caller band, widener), so a generous CLI --noise
# still applies and an EXPLICIT bands={...} entry for the phase wins
# outright.
PHASE_BANDS: Dict[str, tuple] = {
    "router": (2.0, 0.05),
    # stream: with incremental delivery (service/stream.py) the
    # result_stream span now OVERLAPS execution - a FETCH that
    # arrives while the query is RUNNING measures stream-wall that
    # includes producer time (plus any consumer-side backpressure
    # parking), not just the forwarding cost the old materialized
    # path measured. Cross-round p50s therefore shift by integer
    # factors with consumer pacing, never by a few percent - the
    # band is widened accordingly (a real regression here is a
    # multiple of the whole stream, e.g. a lost first-part wakeup)
    "stream": (4.0, 0.25),
    # fused join-probe / grouped-carry dispatch phases: one kernel
    # launch per batch, so small-row probes measure low-millisecond
    # p50s with the same scheduler-load wobble as the hop phases
    "join": (2.0, 0.05),
    "group": (2.0, 0.05),
    # plan_decode: protobuf-walk time, tens of microseconds to
    # low-single-digit milliseconds - and ZERO on a decoded-plan-cache
    # hit, so cross-round p50s swing with the cache hit mix, not with
    # decoder speed
    "plan_decode": (4.0, 0.02),
    # mesh sub-phases: mesh_trace is all-or-nothing (a warm stage pays
    # ~0, a cold one pays XLA compile - the p50 swings with warm/cold
    # mix, not with code speed), mesh_lower/sync/gather are sub-
    # millisecond host calls with scheduler-load wobble, and stage_in/
    # launch wobble with virtual-device contention on the CPU test
    # tier. All get the generous integer-factor band; a real
    # regression here is a multiple, caught by the MESHATTR diff.
    "mesh_lower": (3.0, 0.25),
    "mesh_trace": (3.0, 0.25),
    "mesh_stage_in": (3.0, 0.25),
    "mesh_launch": (3.0, 0.25),
    "mesh_sync": (3.0, 0.25),
    "mesh_gather": (3.0, 0.25),
}


def compare(
    live: Dict[str, Any],
    baseline: Dict[str, Any],
    *,
    rel_band: float = DEFAULT_REL_BAND,
    abs_floor_s: float = DEFAULT_ABS_FLOOR_S,
    min_samples: int = DEFAULT_MIN_SAMPLES,
    bands: Optional[Dict[str, tuple]] = None,
) -> List[Dict[str, Any]]:
    """Diff two rollup snapshots ({class: {phase: {n, p50, ...}}}).
    A (class, phase) present in BOTH with >= min_samples on both sides
    regresses when live p50 exceeds the band. Per-phase overrides via
    `bands`: {phase: (rel_band, abs_floor_s)} - explicit entries
    apply verbatim; phases in the built-in PHASE_BANDS wideners
    (router/stream) otherwise get max(caller band, widener) per
    component. Returns regressions sorted worst-ratio-first; [] =
    clean."""
    out: List[Dict[str, Any]] = []
    for klass, base_phases in (baseline or {}).items():
        live_phases = (live or {}).get(klass)
        if not live_phases:
            continue
        for phase, b in base_phases.items():
            lv = live_phases.get(phase)
            if not lv:
                continue
            if (int(b.get("n", 0)) < min_samples
                    or int(lv.get("n", 0)) < min_samples):
                continue
            base_p50 = float(b.get("p50", 0.0))
            live_p50 = float(lv.get("p50", 0.0))
            if bands and phase in bands:
                rel, floor = bands[phase]
            elif phase in PHASE_BANDS:
                wrel, wfloor = PHASE_BANDS[phase]
                rel = max(rel_band, wrel)
                floor = max(abs_floor_s, wfloor)
            else:
                rel, floor = rel_band, abs_floor_s
            limit = base_p50 * (1.0 + rel) + floor
            if live_p50 > limit:
                out.append({
                    "class": klass,
                    "phase": phase,
                    "base_p50": round(base_p50, 6),
                    "live_p50": round(live_p50, 6),
                    "limit": round(limit, 6),
                    "ratio": round(
                        live_p50 / base_p50, 3
                    ) if base_p50 else float("inf"),
                })
    out.sort(key=lambda r: -r["ratio"])
    return out


# ---------------------------------------------------------------------------
# the probe: a fixed workload whose rollup is the regress measurement
# ---------------------------------------------------------------------------


def run_probe(rounds: int = 6, rows: int = 1 << 18,
              warmup: int = 1,
              data_path: Optional[str] = None,
              device: Optional[str] = None) -> Dict[str, Any]:
    """Execute `rounds` repeats of a fixed scan->filter->aggregate
    plan through a real QueryService with tracing ON and caching OFF
    (a cache hit would zero the decode/h2d/dispatch phases the probe
    exists to measure), and return the resulting rollup snapshot.

    Runs against a PRIVATE PhaseRollup so a probe inside a live server
    process cannot pollute (or be polluted by) production rollup
    state. Warmup rounds pay the kernel compilation and are excluded.
    The parquet file defaults to a fixed path so its scan fingerprint
    - and therefore the rollup class - is stable run-over-run on one
    host; `_all` carries the cross-host comparison. `device` is the
    service's (None: "cuda")."""
    import os
    import tempfile

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.exprs import AggExpr, AggFn, Col
    from blaze_tpu_torch.ops import AggMode, FilterExec, HashAggregateExec
    from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.service import QueryService

    path = data_path or os.path.join(
        tempfile.gettempdir(), f"blaze_phase_probe_{rows}.parquet"
    )
    if not os.path.exists(path):
        # deterministic content per row count (fixed seed), so the
        # cached file is reusable across probe runs on one host
        rng = np.random.default_rng(11)
        pq.write_table(
            pa.table({
                "k": pa.array(
                    rng.integers(0, 64, rows), pa.int32()
                ),
                "v": pa.array(rng.random(rows), pa.float64()),
            }),
            path, compression="zstd",
        )
    # KEYLESS aggregate deliberately (the JAX package's probe): it
    # exercises the decode -> h2d -> dispatch -> execute pipeline
    # through the fused keyless carry, so the probe measures phases,
    # not the keyed path's first-use costs
    plan = HashAggregateExec(
        FilterExec(
            ParquetScanExec([[FileRange(path)]]),
            Col("v") > 0.25,
        ),
        keys=[],
        aggs=[(AggExpr(AggFn.SUM, Col("v")), "s"),
              (AggExpr(AggFn.COUNT_STAR, None), "n")],
        mode=AggMode.COMPLETE,
    )
    blob = task_to_proto(plan, 0)

    probe_rollup = PhaseRollup()
    # fold_phases=False: the probe reads its own private rollup AND
    # keeps its synthetic samples out of the process-global one, so a
    # probe inside a live server cannot skew the STATS `phases` view
    svc = QueryService(max_concurrency=1, enable_cache=False,
                       enable_trace=True, slow_query_s=0.0,
                       fold_phases=False, device=device)
    try:
        for i in range(max(0, warmup) + max(1, rounds)):
            q = svc.submit_task(blob, use_cache=False)
            if not q.wait(120.0):
                raise TimeoutError("phase probe query stuck")
            if q.state.value != "DONE":
                raise RuntimeError(
                    f"phase probe query {q.state.value}: {q.error}"
                )
            if i < warmup:
                continue  # compilation round: not a phase sample
            t = q.timings
            durations = {
                "e2e": t["finished"] - t["submitted"],
                "execute": t["finished"] - t["run_start"],
            }
            if "admitted" in t:
                durations["queue_wait"] = (
                    t["admitted"] - t["submitted"]
                )
                durations["admission"] = (
                    t["run_start"] - t["admitted"]
                )
            if q.tracer is not None:
                for phase, s in q.tracer.phase_totals(
                    SPAN_PHASE
                ).items():
                    durations.setdefault(phase, s)
            probe_rollup.fold_phases(
                durations,
                klass=class_key(q._fingerprint,
                                q._fingerprint_stable),
            )
    finally:
        svc.close()
    return probe_rollup.snapshot()


# ---------------------------------------------------------------------------
# baseline / bench-artifact IO (the regress CLI's file formats)
# ---------------------------------------------------------------------------


def save_baseline(path: str, snapshot: Dict[str, Any],
                  meta: Optional[Dict[str, Any]] = None) -> None:
    doc = {"format": "blaze-phase-baseline-v1",
           "meta": dict(meta or {}),
           "phases": snapshot}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def load_baseline(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "phases" in doc:
        return doc["phases"]
    return doc  # bare snapshot


def phases_from_bench(path: str) -> Optional[Dict[str, Any]]:
    """Extract the per-phase rollup a BENCH_r*.json artifact recorded
    (bench.py's `phases` shape). Handles both the driver wrapper
    ({n, cmd, rc, tail}) and a bare battery result, plus the
    MESHATTR_r*.json mesh-attribution artifacts (obs/meshprof.py),
    which carry their per-sub-phase p50s in the same snapshot shape
    so `regress --bench` diffs consecutive rounds of either family.
    None when the round predates phase recording."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and str(
        doc.get("format", "")
    ).startswith("blaze-meshattr"):
        return (doc.get("phases") or {}).get("snapshot") or None
    if isinstance(doc, dict) and "tail" in doc and "queries" not in doc:
        tail = doc["tail"]
        result = None
        for line in reversed(str(tail).splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    result = json.loads(line)
                    break
                except json.JSONDecodeError:
                    continue
        doc = result or {}
    shape = (doc.get("queries") or {}).get("phases") or {}
    snap = shape.get("snapshot")
    return snap or None
