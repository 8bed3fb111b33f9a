"""Memory budget and spill ladder.

A copy of the JAX package's runtime/memory.py, with its chaos seam
(`device.memory`, testing/chaos.py).
Reference counterpart: DataFusion's MemoryConsumer try_grow/spill
protocol under MemoryManagerConfig {max_memory, memory_fraction}
(exec.rs:79-94; spill path shuffle_writer_exec.rs:570-623), with one
more rung: device memory -> host buffers tracked here -> disk.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Hashable, List, Optional

from blaze_tpu_torch.config import EngineConfig, get_config
from blaze_tpu_torch.testing import chaos


class MemoryPool:
    """Tracks host-side buffered bytes; when the budget (max_memory *
    memory_fraction) is exceeded, spills consumers largest first, as
    DataFusion does."""

    def __init__(self, budget: Optional[int] = None):
        cfg = get_config()
        self.budget = budget if budget is not None else int(
            cfg.max_memory * cfg.memory_fraction)
        self._used: Dict[int, int] = {}
        self._spill_fns: Dict[int, Callable[[], int]] = {}
        self._lock = threading.Lock()
        self.spill_count = 0

    def register(self, consumer_id: int, spill: Callable[[], int]) -> None:
        with self._lock:
            self._used.setdefault(consumer_id, 0)
            self._spill_fns[consumer_id] = spill

    def unregister(self, consumer_id: int) -> None:
        with self._lock:
            self._used.pop(consumer_id, None)
            self._spill_fns.pop(consumer_id, None)

    def total_used(self) -> int:
        with self._lock:
            return sum(self._used.values())

    def grow(self, consumer_id: int, nbytes: int) -> None:
        """Account nbytes to the consumer; spill others (or it) if the
        budget is exceeded."""
        with self._lock:
            self._used[consumer_id] = self._used.get(consumer_id, 0) + nbytes
            over = sum(self._used.values()) - self.budget
            victims: List[int] = []
            if over > 0:
                victims = sorted(self._used, key=lambda c: -self._used[c])
        if over <= 0:
            return
        freed = 0
        for v in victims:
            fn = self._spill_fns.get(v)
            if fn is None:
                continue
            released = fn()
            with self._lock:
                if v in self._used:
                    self._used[v] = max(0, self._used[v] - released)
                self.spill_count += 1
            freed += released
            if freed >= over:
                break

    def shrink(self, consumer_id: int, nbytes: int) -> None:
        with self._lock:
            self._used[consumer_id] = max(
                0, self._used.get(consumer_id, 0) - nbytes)


class DeviceMemoryTracker:
    """Live device bytes per operator: what materializing operators hold
    resident. Sizing decisions (grace bucket counts) read the budget's
    headroom from it."""

    def __init__(self, budget: Optional[int] = None):
        self._budget_override = budget
        self._used: Dict[Hashable, int] = {}
        self._lock = threading.Lock()

    @property
    def budget(self) -> int:
        if self._budget_override is not None:
            return self._budget_override
        # read live: the process-wide tracker follows config swaps
        return int(get_config().device_memory_budget)

    def track(self, op_id: Hashable, nbytes: int) -> None:
        if chaos.ACTIVE:
            # chaos seam: device-memory pressure at the accounting
            # boundary (a RESOURCE_EXHAUSTED fault here drives the
            # service's classified failure, or its host degrade where
            # that is allowed)
            chaos.fire("device.memory", op_id=op_id, nbytes=nbytes)
        with self._lock:
            self._used[op_id] = self._used.get(op_id, 0) + nbytes

    def release(self, op_id: Hashable, nbytes: Optional[int] = None) -> None:
        with self._lock:
            if nbytes is None:
                self._used.pop(op_id, None)
            else:
                self._used[op_id] = max(0, self._used.get(op_id, 0) - nbytes)

    def total_used(self) -> int:
        with self._lock:
            return sum(self._used.values())

    def headroom(self) -> int:
        return max(0, self.budget - self.total_used())


def batch_device_bytes(cb) -> int:
    """Bytes a ColumnBatch holds on its device (values + validity)."""
    total = 0
    for c in cb.columns:
        total += c.values.numel() * c.values.element_size()
        if c.validity is not None:
            total += c.validity.numel() * c.validity.element_size()
    return total


def choose_external_bucket_count(est_bytes: int,
                                 config: Optional[EngineConfig] = None,
                                 headroom: Optional[int] = None) -> int:
    """Bucket count for grace execution such that one bucket fits a
    quarter of the device headroom (budget less what other live
    operators track, times memory_fraction): powers of two up from
    `external_buckets`, at most 1024 (past that, per-bucket file
    overhead dominates)."""
    cfg = config or get_config()
    if headroom is None:
        headroom = get_device_tracker().headroom()
    per_bucket = max(1, int(headroom * cfg.memory_fraction) // 4)
    n = max(2, cfg.external_buckets)
    need = max(1, math.ceil(est_bytes / per_bucket))
    while n < need and n < 1024:
        n *= 2
    return n


_POOL: Optional[MemoryPool] = None
_DEVICE_TRACKER: Optional[DeviceMemoryTracker] = None


def get_pool() -> MemoryPool:
    global _POOL
    if _POOL is None:
        _POOL = MemoryPool()
    return _POOL


def get_device_tracker() -> DeviceMemoryTracker:
    global _DEVICE_TRACKER
    if _DEVICE_TRACKER is None:
        _DEVICE_TRACKER = DeviceMemoryTracker()
    return _DEVICE_TRACKER
