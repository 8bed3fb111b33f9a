"""Device-work accounting: kernel launches, H2D copies and D2H fetches.

The reference engine's hot loop is one native call per task
(exec.rs:196-255). An eager PyTorch engine pays per launch and per
transfer instead, so those counts are the engine's cost model for small
and medium queries. This module keeps them process-wide (GIL-safe
increments under a lock); `counting()` gives the delta attributable to a
block, and the executor files it into each task's metric tree.

Keys in use:
- `h2d_copies`: host -> device buffer copies (batch.from_arrow);
- `d2h_fetches`: device -> host buffer copies (batch.to_arrow);
- `d2h_syncs`: blocking scalar readbacks (`host_int`, `host_bool`);
  the grouped aggregate's are also counted by cause:
  `d2h_syncs.insert_round` (one per probe round of the hash table's
  insert loop), `d2h_syncs.group_branch` (direct or hashed slots) and
  `d2h_syncs.n_groups` (the group-capacity ladder);
- `launch.<kernel>`: launches of a hand-written kernel (ops/kernels).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

_lock = threading.Lock()
_counts: Dict[str, int] = {}


def record(kind: str, n: int = 1) -> None:
    with _lock:
        _counts[kind] = _counts.get(kind, 0) + n


def snapshot() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


class counting:
    """Context manager: `with counting() as c: ...; c.counts` gives the
    launch/transfer counts attributable to the block (delta of the
    global counters; concurrent tasks in other threads also land here)."""

    def __enter__(self):
        self._start = snapshot()
        self.counts: Dict[str, int] = {}
        return self

    def __exit__(self, *exc):
        end = snapshot()
        self.counts = {
            k: v - self._start.get(k, 0)
            for k, v in end.items()
            if v - self._start.get(k, 0)
        }
        return False


def _sync(what: Optional[str]) -> None:
    record("d2h_syncs")
    if what:
        record("d2h_syncs." + what)


def host_int(x, what: Optional[str] = None) -> int:
    """Blocking scalar readback (a full device round trip); `what` names
    it in a second counter, `d2h_syncs.<what>`."""
    _sync(what)
    return int(x)


def host_bool(x, what: Optional[str] = None) -> bool:
    """Blocking readback of a device bool, counted as host_int."""
    _sync(what)
    return bool(x)
