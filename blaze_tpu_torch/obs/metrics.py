"""Process-wide metrics registry with Prometheus text exposition.

The per-query metric tree (runtime/instrument.py) answers "where did
THIS query's time go"; this registry answers the fleet question -
"what is this PROCESS doing" - in the form every scraper already
speaks. It folds three sources into one exposition:

  * its own counters and bounded histograms (query terminal states,
    wall-time distribution, degradations, worker quarantines),
  * the process-global `dispatch.*` counters (runtime/dispatch.py -
    dispatch count IS the perf model, so it belongs on the scrape
    surface), rendered as `blaze_dispatch_total{kind=...}`,
  * registered collectors: live components (the QueryService's
    admission controller, result cache, runtime-history store)
    contribute samples at scrape time, so gauges are always current
    and dead components stop reporting when they unregister.

Served through the service METRICS verb (service/wire.py) and
`python -m blaze_tpu_torch metrics`. Label cardinality is deliberately
tiny: fingerprints and query ids never become labels - per-query
detail lives in traces (obs/trace.py) and the runtime-history store
(obs/history.py), not the scrape surface.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# (metric_name, labels_dict, value, type) - what collectors yield
Sample = Tuple[str, Dict[str, str], float, str]

# wall-time buckets: sub-ms serving overhead through minutes-long
# scans (seconds)
DEFAULT_TIME_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _label_str(labels) -> str:
    """Accepts a dict OR an already-sorted tuple of (k, v) pairs -
    the registry stores label sets as tuples, and rendering them
    directly avoids re-materializing a dict per sample at scrape
    time."""
    if not labels:
        return ""
    items = sorted(labels.items()) if isinstance(labels, dict) \
        else labels
    inner = ",".join(
        f'{_sanitize(k)}="{str(v)}"' for k, v in items
    )
    return "{" + inner + "}"


class _Histogram:
    __slots__ = ("bounds", "counts", "total", "n")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +inf bucket last
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(self.bounds):
            if value <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.total += value
        self.n += 1

    def summary(self) -> Dict[str, Any]:
        return {
            "count": self.n,
            "sum": round(self.total, 6),
            "mean": round(self.total / self.n, 6) if self.n else 0.0,
        }


class MetricsRegistry:
    """Counters + bounded histograms + scrape-time collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], _Histogram] = {}
        self._hist_bounds: Dict[str, Tuple[float, ...]] = {}
        self._collectors: Dict[str, Callable[[], Iterable[Sample]]] = {}

    # -- write path -----------------------------------------------------
    def inc(self, name: str, n: float = 1, **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def observe(self, name: str, value: float,
                buckets: Optional[Tuple[float, ...]] = None,
                **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                bounds = self._hist_bounds.setdefault(
                    name, tuple(buckets or DEFAULT_TIME_BUCKETS)
                )
                h = self._hists[key] = _Histogram(bounds)
            h.observe(float(value))

    # -- read path ------------------------------------------------------
    def get(self, name: str, **labels: str) -> float:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._counters.get(key, 0)

    def histogram_summary(self, name: str,
                          **labels: str) -> Optional[Dict[str, Any]]:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            return h.summary() if h is not None else None

    def histogram_summaries(
        self, name: str
    ) -> List[Tuple[Dict[str, str], Dict[str, Any]]]:
        """Every labeled series of one histogram family as
        (labels, summary) pairs - the profile report enumerates
        blaze_verb_seconds through this without parsing expositions."""
        with self._lock:
            return [(dict(labels), h.summary())
                    for (n, labels), h in self._hists.items()
                    if n == name]

    # -- collectors -----------------------------------------------------
    def register_collector(
        self, key: str, fn: Callable[[], Iterable[Sample]]
    ) -> None:
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    # -- exposition -----------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text format v0.0.4. Scrape-time work only: the
        write path never formats strings."""
        samples: List[Sample] = []
        # fold 1: the process-global dispatch counters
        try:
            from blaze_tpu_torch.runtime import dispatch

            for k, v in sorted(dispatch.snapshot().items()):
                samples.append(
                    ("blaze_dispatch_total", {"kind": k}, v, "counter")
                )
        except Exception:  # noqa: BLE001 - exposition is best-effort
            pass
        # fold 2: live-component collectors
        with self._lock:
            collectors = list(self._collectors.items())
        for key, fn in collectors:
            try:
                samples.extend(fn())
            except Exception:  # noqa: BLE001 - one bad collector
                # accumulated (not a literal 1): rate()/increase()
                # over a constant would hide a collector failing on
                # every scrape
                self.inc("blaze_collector_errors_total",
                         collector=key)
        # fold 3: own counters + histograms (snapshotted AFTER the
        # collectors ran, so collector-error increments land in THIS
        # exposition)
        with self._lock:
            counters = sorted(self._counters.items())
            hists = sorted(self._hists.items())
        for (name, labels), v in counters:
            # labels is the stored sorted tuple; _label_str renders
            # it as-is, so no per-sample dict materialization
            samples.append((name, labels, v, "counter"))

        lines: List[str] = []
        seen_types: Dict[str, str] = {}

        def emit(name: str, labels: Dict[str, str], value: float,
                 mtype: str) -> None:
            name = _sanitize(name)
            if name not in seen_types:
                seen_types[name] = mtype
                lines.append(f"# TYPE {name} {mtype}")
            if isinstance(value, float) and (
                math.isnan(value) or math.isinf(value)
            ):
                value = 0.0
            v = int(value) if float(value).is_integer() else value
            lines.append(f"{name}{_label_str(labels)} {v}")

        # stable family grouping: all samples of one metric together.
        # An in-place stable sort by family name replaces the old
        # throwaway dict-of-lists grouping - same output (insertion
        # order preserved within a family), no intermediate
        # allocation proportional to the sample count.
        samples.sort(key=lambda s: s[0])
        for name, labels, value, mtype in samples:
            emit(name, labels, value, mtype)

        for (name, labels), h in hists:
            base = _sanitize(name)
            lines.append(f"# TYPE {base} histogram")
            ld = dict(labels)
            acc = 0
            for b, c in zip(h.bounds, h.counts):
                acc += c
                lines.append(
                    f"{base}_bucket"
                    f"{_label_str({**ld, 'le': repr(b)})} {acc}"
                )
            acc += h.counts[-1]
            lines.append(
                f"{base}_bucket{_label_str({**ld, 'le': '+Inf'})} {acc}"
            )
            lines.append(
                f"{base}_sum{_label_str(ld)} {round(h.total, 6)}"
            )
            lines.append(f"{base}_count{_label_str(ld)} {h.n}")
        return "\n".join(lines) + "\n"

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()
            self._hist_bounds.clear()
            self._collectors.clear()


def merge_expositions(
    base: str,
    per_source: Dict[str, str],
    label: str = "replica",
) -> str:
    """Fold several Prometheus text expositions into one document by
    stamping every sample from `per_source[source_id]` with
    `{label="source_id"}` - the replica router's METRICS verb uses
    this to serve the FLEET view (its own registry plus each replica's
    scrape) without series collisions. `# TYPE` lines are deduplicated
    first-wins; malformed lines are dropped rather than corrupting the
    whole scrape."""
    lines: List[str] = []
    seen_types = set()
    for ln in base.splitlines():
        if ln.startswith("# TYPE "):
            parts = ln.split()
            if len(parts) >= 3:
                seen_types.add(parts[2])
        lines.append(ln)
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$"
    )
    for source_id, text in sorted(per_source.items()):
        stamp = f'{_sanitize(label)}="{source_id}"'
        for ln in (text or "").splitlines():
            if not ln or ln.startswith("#"):
                if ln.startswith("# TYPE "):
                    parts = ln.split()
                    if len(parts) >= 3 and parts[2] not in seen_types:
                        seen_types.add(parts[2])
                        lines.append(ln)
                continue
            m = sample_re.match(ln)
            if m is None:
                continue  # malformed sample: drop, don't corrupt
            name, labels, value = m.groups()
            if labels:
                labels = labels[:-1] + "," + stamp + "}"
            else:
                labels = "{" + stamp + "}"
            lines.append(f"{name}{labels} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


REGISTRY = MetricsRegistry()
