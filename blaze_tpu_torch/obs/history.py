"""Per-fingerprint runtime history: the input deadline prediction and
replica routing need.

The result cache (service/cache.py) already keys materialized results
by content-addressed plan fingerprint; this store records execution
TIME under the same key, so the serving tier can answer "how long does
this plan usually take" before running it. Consumers today:

  * predicted-unmeetability shedding (service/service.py): at
    admission, queue-wait already spent + the fingerprint's p50
    estimate vs the query's remaining slack - a query that cannot
    make its deadline is shed with a distinct `shed_predicted`
    counter instead of burning device time to miss it anyway;
  * STATS: `runtime_history` summary, the machine-readable form the
    ROADMAP's replica-routing item consumes (route big fingerprints
    to the replica with headroom);
  * the slow-query log: "this query was 40x its p50" beats "this
    query took 8s".

Bounded on both axes: at most `max_fingerprints` entries (LRU) and
`samples_per_fp` samples each (ring) - a long-lived server's history
cost is a few hundred KB, forever. Estimates require >= min_samples
(default 3) so one cold-compile outlier never sheds real traffic.
Degraded (host-engine) runs are never recorded: they measure the
fallback, not the plan.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional


class RuntimeHistory:
    """Bounded per-fingerprint execution-time samples + percentiles."""

    def __init__(self, max_fingerprints: int = 512,
                 samples_per_fp: int = 64):
        self.max_fingerprints = int(max_fingerprints)
        self.samples_per_fp = int(samples_per_fp)
        self._lock = threading.Lock()
        self._samples: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict()
        )
        self._totals: Dict[str, int] = {}  # lifetime sample counts

    def record(self, fingerprint: str, seconds: float) -> None:
        if not fingerprint or seconds < 0:
            return
        with self._lock:
            dq = self._samples.get(fingerprint)
            if dq is None:
                dq = collections.deque(maxlen=self.samples_per_fp)
                self._samples[fingerprint] = dq
                while len(self._samples) > self.max_fingerprints:
                    old, _ = self._samples.popitem(last=False)
                    self._totals.pop(old, None)
            dq.append(float(seconds))
            self._samples.move_to_end(fingerprint)
            self._totals[fingerprint] = (
                self._totals.get(fingerprint, 0) + 1
            )

    @staticmethod
    def _percentile(sorted_xs, q: float) -> float:
        if not sorted_xs:
            return 0.0
        idx = min(len(sorted_xs) - 1,
                  max(0, int(round(q * (len(sorted_xs) - 1)))))
        return sorted_xs[idx]

    def estimate(self, fingerprint: str) -> Optional[Dict[str, Any]]:
        """{"n", "p50", "p95", "mean", "last"} or None when unseen."""
        with self._lock:
            dq = self._samples.get(fingerprint)
            if not dq:
                return None
            xs = sorted(dq)
            return {
                "n": len(xs),
                "p50": round(self._percentile(xs, 0.5), 6),
                "p95": round(self._percentile(xs, 0.95), 6),
                "mean": round(sum(xs) / len(xs), 6),
                "last": round(dq[-1], 6),
            }

    def p50(self, fingerprint: str,
            min_samples: int = 3) -> Optional[float]:
        """The shedding estimate: median runtime, or None below the
        sample floor (a single outlier must never shed traffic)."""
        with self._lock:
            dq = self._samples.get(fingerprint)
            if dq is None or len(dq) < max(1, min_samples):
                return None
            xs = sorted(dq)
            return self._percentile(xs, 0.5)

    def summary(self, top: int = 8) -> Dict[str, Any]:
        """STATS payload: store shape + the `top` hottest fingerprints
        (by lifetime samples) with their estimates."""
        with self._lock:
            fps = list(self._samples)
            total = sum(self._totals.get(f, 0) for f in fps)
            hottest = sorted(
                fps, key=lambda f: -self._totals.get(f, 0)
            )[:max(0, top)]
        return {
            "fingerprints": len(fps),
            "total_samples": total,
            "top": [
                # `fingerprint` stays display-truncated; `fp` carries
                # the FULL key so the replica router can join a
                # replica's reported p50s against the fingerprints it
                # learned from submit responses (prefix joins would
                # collide at fleet scale)
                {"fingerprint": f[:16],
                 "fp": f,
                 "samples": self._totals.get(f, 0),
                 **(self.estimate(f) or {})}
                for f in hottest
            ],
        }
