"""Lock-wait accounting: who is blocking whom on the serving path.

Under many concurrent clients the cached-query latency of a serving
tier spreads, and the per-query surfaces (trace/metrics/phases) cannot
say WHERE that time goes: every surface measures
per-query durations, none measures the time a verb-loop thread spends
parked on the admission lock vs the cache lock vs the stream ring.
This module is that measurement: a named `TimedLock`/`TimedRLock`
wrapper the hot locks adopt (admission controller, result cache,
stream ring, query state, service state, router handle table,
registry snapshot swap, connection pool), recording per-lock-name
WAIT time (acquire entry -> lock held) and HOLD time (held ->
released) into bounded histograms.

Design constraints (the chaos.ACTIVE / trace.ACTIVE discipline):

  * Production pays ~nothing when contention accounting is off: every
    acquire/release checks the single `ACTIVE` module attribute and
    falls through to the bare inner lock - no clocks read, no stats
    touched. tests/test_dispatch_budget.py pins that the off path
    keeps the exact per-shape dispatch budgets.
  * Activation is refcounted `enable()`/`disable()` (the profile CLI
    and `--profile-hz` serving flags enable around a measurement
    window; nested enables compose), or the BLAZE_CONTENTION
    environment variable for whole-process runs.
  * Bounded memory: at most `_MAX_LOCKS` distinct lock names (beyond
    that, samples fold into the `_overflow` stat), fixed histogram
    bucket counts per stat - a misbehaving caller minting lock names
    degrades to a lumped stat, never unbounded growth.

Surfaces: `snapshot()` is the `contention` section in STATS on both
tiers; `metrics_samples()` renders `blaze_lock_wait_seconds{lock}` /
`blaze_lock_hold_seconds{lock}` histogram series for METRICS (the
collector registers on first enable). The wrappers implement the
Condition protocol (`_release_save`/`_acquire_restore`/`_is_owned`),
so `threading.Condition(TimedLock(...))` accounts the ring and
connection-pool waits too: a cv.wait ends the hold (the lock really
is released while parked) and the post-notify reacquire records as
wait - which is exactly the contention it is.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterable, List, Tuple

# fast gate: acquire/release check this single module attribute and
# fall through to the bare inner lock when False
ACTIVE = False
_enable_count = 0
_lock = threading.Lock()

# lock waits and holds live in the us..ms range; the top bucket
# catches pathological multi-second parks (a stuck flusher holding
# the ring)
BUCKETS: Tuple[float, ...] = (
    0.00001, 0.0001, 0.001, 0.01, 0.1, 1.0,
)

_MAX_LOCKS = 64
_OVERFLOW = "_overflow"


class LockStat:
    """Wait/hold accounting for one lock NAME (many wrapper instances
    - e.g. every per-query state lock - share one stat)."""

    __slots__ = ("name", "waits", "wait_total", "wait_max",
                 "holds", "hold_total", "hold_max",
                 "wait_buckets", "hold_buckets", "_mu")

    def __init__(self, name: str):
        self.name = name
        self.waits = 0
        self.wait_total = 0.0
        self.wait_max = 0.0
        self.holds = 0
        self.hold_total = 0.0
        self.hold_max = 0.0
        self.wait_buckets = [0] * (len(BUCKETS) + 1)
        self.hold_buckets = [0] * (len(BUCKETS) + 1)
        # per-stat mutex, held for a handful of int/float updates:
        # cheaper than racing lost increments, and never nested inside
        # the timed lock itself (wait records after acquire, hold
        # records before/after release)
        self._mu = threading.Lock()

    @staticmethod
    def _bucket(v: float) -> int:
        for i, b in enumerate(BUCKETS):
            if v <= b:
                return i
        return len(BUCKETS)

    def record_wait(self, dt: float) -> None:
        i = self._bucket(dt)
        with self._mu:
            self.waits += 1
            self.wait_total += dt
            if dt > self.wait_max:
                self.wait_max = dt
            self.wait_buckets[i] += 1

    def record_hold(self, dt: float) -> None:
        i = self._bucket(dt)
        with self._mu:
            self.holds += 1
            self.hold_total += dt
            if dt > self.hold_max:
                self.hold_max = dt
            self.hold_buckets[i] += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            wait_total = self.wait_total
            hold_total = self.hold_total
            out = {
                "waits": self.waits,
                "wait_s": round(wait_total, 6),
                "wait_max_s": round(self.wait_max, 6),
                "holds": self.holds,
                "hold_s": round(hold_total, 6),
                "hold_max_s": round(self.hold_max, 6),
            }
        out["wait_hold_ratio"] = round(
            wait_total / hold_total, 4
        ) if hold_total > 0 else (float("inf") if wait_total else 0.0)
        return out


_STATS: Dict[str, LockStat] = {}


def stat_for(name: str) -> LockStat:
    """Get-or-create the named stat (bounded: past _MAX_LOCKS names,
    everything folds into the `_overflow` stat)."""
    s = _STATS.get(name)
    if s is not None:
        return s
    with _lock:
        s = _STATS.get(name)
        if s is None:
            if len(_STATS) >= _MAX_LOCKS:
                s = _STATS.get(_OVERFLOW)
                if s is None:
                    s = _STATS[_OVERFLOW] = LockStat(_OVERFLOW)
            else:
                s = _STATS[name] = LockStat(name)
    return s


# ---------------------------------------------------------------------------
# activation (refcounted, trace.py discipline)
# ---------------------------------------------------------------------------


def enable() -> None:
    global ACTIVE, _enable_count
    with _lock:
        _enable_count += 1
        ACTIVE = True
    _register_collector()


def disable() -> None:
    global ACTIVE, _enable_count
    with _lock:
        _enable_count = max(0, _enable_count - 1)
        ACTIVE = _enable_count > 0


def _reset_for_tests() -> None:
    """Restore import-time state AND drop recorded stats (test
    hygiene: a failed test must not leave accounting armed or its
    samples visible to later expositions)."""
    global ACTIVE, _enable_count
    with _lock:
        _enable_count = 1 if os.environ.get("BLAZE_CONTENTION") else 0
        ACTIVE = _enable_count > 0
        _STATS.clear()


def reset_stats() -> None:
    """Zero the recorded stats without touching activation - the
    profile CLI resets between concurrency levels so each report
    section attributes only its own window."""
    with _lock:
        _STATS.clear()


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


class TimedLock:
    """threading.Lock with named wait/hold accounting. Off path is
    one module-attribute check, then the bare inner lock. Implements
    the Condition protocol so `threading.Condition(TimedLock(n))`
    accounts waiter reacquires as lock waits."""

    __slots__ = ("_inner", "_stat", "_t_acquired")

    def __init__(self, name: str):
        self._inner = threading.Lock()
        self._stat = stat_for(name)
        self._t_acquired = 0.0

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if not ACTIVE:
            return self._inner.acquire(blocking, timeout)
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            t1 = time.perf_counter()
            self._stat.record_wait(t1 - t0)
            # owner-private between acquire and release: safe on a
            # mutual-exclusion lock
            self._t_acquired = t1
        return ok

    def release(self) -> None:
        # hold records BEFORE the inner release so the next acquirer
        # cannot overwrite _t_acquired under us
        if ACTIVE and self._t_acquired:
            self._stat.record_hold(
                time.perf_counter() - self._t_acquired
            )
            self._t_acquired = 0.0
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition protocol --------------------------------------------
    # Condition(lock) picks these up; without them it falls back to
    # acquire()/release(), which would also work but pays the timed
    # acquire for its _is_owned() probe on every wait/notify
    def _release_save(self):
        self.release()
        return None

    def _acquire_restore(self, state) -> None:
        self.acquire()

    def _is_owned(self) -> bool:
        # a plain Lock has no owner notion; Condition's own fallback
        # probe, against the UNtimed inner lock
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


class TimedRLock:
    """threading.RLock with named wait/hold accounting: outermost
    acquire records the wait, outermost release the hold; reentrant
    acquires pass straight through (no contention boundary)."""

    __slots__ = ("_inner", "_stat", "_t_acquired", "_depth")

    def __init__(self, name: str):
        self._inner = threading.RLock()
        self._stat = stat_for(name)
        self._t_acquired = 0.0
        # owner-maintained recursion depth (only the holding thread
        # moves it between its outermost acquire and release)
        self._depth = 0

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        inner = self._inner
        if not ACTIVE or (self._depth and inner._is_owned()):
            ok = inner.acquire(blocking, timeout)
            if ok:
                self._depth += 1
            return ok
        t0 = time.perf_counter()
        ok = inner.acquire(blocking, timeout)
        if ok:
            t1 = time.perf_counter()
            self._depth += 1
            if self._depth == 1:
                self._stat.record_wait(t1 - t0)
                self._t_acquired = t1
        return ok

    def release(self) -> None:
        self._depth -= 1
        if ACTIVE and self._depth == 0 and self._t_acquired:
            self._stat.record_hold(
                time.perf_counter() - self._t_acquired
            )
            self._t_acquired = 0.0
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition protocol --------------------------------------------
    def _release_save(self):
        # cv.wait releases ALL recursion levels: close the hold and
        # hand the saved state through
        depth = self._depth
        if ACTIVE and self._t_acquired:
            self._stat.record_hold(
                time.perf_counter() - self._t_acquired
            )
            self._t_acquired = 0.0
        self._depth = 0
        state = self._inner._release_save()
        return (state, depth)

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        if not ACTIVE:
            self._inner._acquire_restore(inner_state)
            self._depth = depth
            return
        t0 = time.perf_counter()
        self._inner._acquire_restore(inner_state)
        t1 = time.perf_counter()
        self._stat.record_wait(t1 - t0)
        self._t_acquired = t1
        self._depth = depth

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


# ---------------------------------------------------------------------------
# surfaces: STATS section + METRICS collector
# ---------------------------------------------------------------------------


def snapshot(top: int = 0) -> Dict[str, Any]:
    """{lock_name: {waits, wait_s, wait_max_s, holds, hold_s,
    hold_max_s, wait_hold_ratio}} - the `contention` STATS section.
    `top` > 0 keeps only the N most wait-dominated locks."""
    with _lock:
        stats = list(_STATS.values())
    out = {s.name: s.snapshot() for s in stats}
    if top and len(out) > top:
        keep = sorted(
            out, key=lambda n: -out[n]["wait_s"]
        )[:top]
        out = {n: out[n] for n in keep}
    return out


def top_locks(n: int = 3) -> List[Dict[str, Any]]:
    """The N most wait-dominated locks, worst first - the profile
    report's headline list."""
    snap = snapshot()
    names = sorted(snap, key=lambda k: -snap[k]["wait_s"])[:n]
    return [{"lock": name, **snap[name]} for name in names]


def metrics_samples() -> Iterable[tuple]:
    """Prometheus samples for the process registry: expanded
    histogram series blaze_lock_wait_seconds{lock=...} /
    blaze_lock_hold_seconds{lock=...} (bucket/sum/count), emitted
    through the collector surface so the per-acquire hot path never
    touches the registry lock."""
    with _lock:
        stats = list(_STATS.values())
    for s in stats:
        with s._mu:
            wb = list(s.wait_buckets)
            hb = list(s.hold_buckets)
            rows = (
                ("blaze_lock_wait_seconds", wb, s.wait_total, s.waits),
                ("blaze_lock_hold_seconds", hb, s.hold_total, s.holds),
            )
        for base, buckets, total, n in rows:
            acc = 0
            for b, c in zip(BUCKETS, buckets):
                acc += c
                yield (f"{base}_bucket",
                       {"lock": s.name, "le": repr(b)}, acc, "counter")
            acc += buckets[-1]
            yield (f"{base}_bucket",
                   {"lock": s.name, "le": "+Inf"}, acc, "counter")
            yield (f"{base}_sum", {"lock": s.name},
                   round(total, 6), "counter")
            yield (f"{base}_count", {"lock": s.name}, n, "counter")


def _register_collector() -> None:
    """Idempotent: the process registry serves the lock histograms
    once accounting has ever been enabled (registered outside the
    module lock - register_collector takes the registry's own)."""
    from blaze_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.register_collector("contention", metrics_samples)


def _maybe_activate_from_env() -> None:
    if os.environ.get("BLAZE_CONTENTION"):
        enable()


_maybe_activate_from_env()
