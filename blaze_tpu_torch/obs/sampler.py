"""Thread-stack sampling profiler: where the serving threads actually are.

Lock accounting (obs/contention.py) says how long threads PARK; this
says what they are DOING the rest of the time - a `sys._current_frames()`
sampler thread at a configurable Hz folds every live thread's stack
into per-(module, function) buckets tagged with the thread's ROLE
(verb-loop / executor / dispatcher / poller / relay / flusher /
other), derived from the thread-name conventions the serving tiers
already use (blaze-dispatch, blaze-query*, blaze-router-poll-*, ...).
Exports: collapsed-stack text (one `role;mod:fn;mod:fn N` line per
distinct stack - flamegraph.pl / speedscope ready) and a top-N
self-time table (leaf-frame sample counts).

Bounded memory: at most `max_stacks` distinct collapsed stacks and
`max_depth` frames per stack; beyond the stack cap samples fold into
a per-role `<overflow>` bucket. The sampler is a daemon thread the
start/stop surface owns; `sys._current_frames()` holds the GIL for
the duration of one sweep, so cost scales with thread count x Hz
(the port has not priced its default 67 Hz on the card).

Start/stop: `serve --profile-hz` / `route --profile-hz` run one for
the process lifetime; the PROFILE wire verb starts/stops/snapshots a
live fleet without restart; the profile CLI drives it per
concurrency level. `_reset_for_tests()` stops the process sampler
and drops its buckets (conftest `_obs_hygiene`).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# thread-name prefix -> role tag (first match wins; the serving tiers
# name every long-lived thread with a blaze- prefix, and
# serve_verb_connection names its handler thread blaze-verb-loop on
# entry so socketserver's default Thread-N never hides the wire tier)
ROLE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("blaze-verb", "verb-loop"),
    ("blaze-dispatch", "dispatcher"),
    ("blaze-query", "executor"),
    ("blaze-router-poll", "poller"),
    ("blaze-router-probe", "poller"),
    ("blaze-router-stream", "relay"),
    ("blaze-router-hot", "replicator"),
    ("blaze-router-recover", "recovery"),
    ("blaze-router-accept", "verb-loop"),
    ("blaze-serve-drain", "drain"),
    ("blaze-journal", "flusher"),
    ("blaze-member", "membership"),
    ("blaze-sampler", "sampler"),
)


def role_of(thread_name: str) -> str:
    for prefix, role in ROLE_PREFIXES:
        if thread_name.startswith(prefix):
            return role
    return "other"


class StackSampler:
    """One sampling session: a daemon thread folding stacks between
    start() and stop(). Instances are cheap; the module-level
    singleton below is the process surface the wire verb drives."""

    def __init__(self, hz: float = 67.0, max_stacks: int = 2048,
                 max_depth: int = 48):
        self.hz = max(1.0, min(997.0, float(hz)))
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self._mu = threading.Lock()
        # (role, (frame, ...)) -> sample count; frame = "module:func"
        self._stacks: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        # (role, frame) -> leaf (self-time) sample count
        self._self: Dict[Tuple[str, str], int] = {}
        self._samples = 0
        self._overflowed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at = 0.0

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "StackSampler":
        with self._mu:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._started_at = time.monotonic()
            self._thread = threading.Thread(
                target=self._loop, name="blaze-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._mu:
            t = self._thread
            self._thread = None
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)

    @property
    def running(self) -> bool:
        return self._thread is not None

    def _loop(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - a torn frame walk
                # (thread exiting mid-sweep) must not kill the sampler
                continue

    # -- sampling -------------------------------------------------------
    def sample_once(self) -> None:
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        folded: List[Tuple[str, Tuple[str, ...]]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue
            role = role_of(names.get(ident, ""))
            stack: List[str] = []
            f = frame
            while f is not None and len(stack) < self.max_depth:
                code = f.f_code
                mod = f.f_globals.get("__name__", "?")
                stack.append(f"{mod}:{code.co_name}")
                f = f.f_back
            if not stack:
                continue
            stack.reverse()
            folded.append((role, tuple(stack)))
        del frames  # drop the frame references promptly
        with self._mu:
            self._samples += 1
            for role, stack in folded:
                key = (role, stack)
                if key not in self._stacks \
                        and len(self._stacks) >= self.max_stacks:
                    key = (role, ("<overflow>",))
                    self._overflowed += 1
                self._stacks[key] = self._stacks.get(key, 0) + 1
                leaf = (role, stack[-1])
                self._self[leaf] = self._self.get(leaf, 0) + 1

    # -- export ---------------------------------------------------------
    def collapsed(self, role: Optional[str] = None) -> str:
        """Flamegraph-ready collapsed-stack text: one
        `role;frame;frame count` line per distinct sampled stack."""
        with self._mu:
            items = sorted(self._stacks.items(),
                           key=lambda kv: -kv[1])
        lines = []
        for (r, stack), n in items:
            if role is not None and r != role:
                continue
            lines.append(";".join((r,) + stack) + f" {n}")
        return "\n".join(lines)

    def top(self, n: int = 20) -> List[Dict[str, Any]]:
        """Top-N self-time frames: where threads were EXECUTING (leaf
        frames), worst first, with role attribution."""
        with self._mu:
            items = sorted(self._self.items(), key=lambda kv: -kv[1])
            total = sum(self._self.values()) or 1
        return [
            {"frame": frame, "role": role, "samples": c,
             "pct": round(100.0 * c / total, 2)}
            for (role, frame), c in items[:n]
        ]

    def snapshot(self, top_n: int = 20,
                 include_collapsed: bool = True,
                 max_collapsed_bytes: int = 1 << 20) -> Dict[str, Any]:
        with self._mu:
            samples = self._samples
            distinct = len(self._stacks)
            overflowed = self._overflowed
            running = self._thread is not None
        out: Dict[str, Any] = {
            "hz": self.hz,
            "running": running,
            "samples": samples,
            "distinct_stacks": distinct,
            "overflowed": overflowed,
            "top": self.top(top_n),
        }
        if include_collapsed:
            # bounded for the wire: the PROFILE response must fit the
            # JSON frame cap, so the collapsed text truncates at a
            # line boundary
            text = self.collapsed()
            if len(text) > max_collapsed_bytes:
                text = text[:max_collapsed_bytes]
                text = text[:text.rfind("\n")]
                out["collapsed_truncated"] = True
            out["collapsed"] = text
        return out

    def reset(self) -> None:
        with self._mu:
            self._stacks.clear()
            self._self.clear()
            self._samples = 0
            self._overflowed = 0


# ---------------------------------------------------------------------------
# process surface: the singleton the PROFILE verb / --profile-hz drive
# ---------------------------------------------------------------------------

_mu = threading.Lock()
_SAMPLER: Optional[StackSampler] = None


def start(hz: float = 67.0) -> StackSampler:
    """Start (or retune) the process sampler. A second start with a
    different hz restarts the thread; same hz is a no-op."""
    global _SAMPLER
    with _mu:
        s = _SAMPLER
        if s is not None and s.running and s.hz == max(
            1.0, min(997.0, float(hz))
        ):
            return s
        if s is not None:
            s.stop()
        s = _SAMPLER = StackSampler(hz=hz)
        s.start()
    return s


def stop() -> None:
    global _SAMPLER
    with _mu:
        s = _SAMPLER
    if s is not None:
        s.stop()


def current() -> Optional[StackSampler]:
    return _SAMPLER


def snapshot(**kw) -> Dict[str, Any]:
    s = _SAMPLER
    if s is None:
        return {"running": False, "samples": 0, "top": []}
    return s.snapshot(**kw)


def _reset_for_tests() -> None:
    global _SAMPLER
    with _mu:
        s = _SAMPLER
        _SAMPLER = None
    if s is not None:
        s.stop()
