"""Plan-fingerprint result cache: serve repeated queries from memory.

Zerrow's argument (PAPERS.md) applied to the serving tier: a repeated
identical plan should cost zero device dispatches - the materialized
Arrow result IS the zero-copy currency, so cache it keyed on plan
identity. Keys are (PhysicalOp.fingerprint(), partition): fingerprints
are content-addressed (ops/base.py), so two independent decodes of the
same TaskDefinition hit the same entry. Plans containing any op that
cannot prove stable identity (the '@' marker) are never cached.

Placement follows the engine's HBM -> host -> disk ladder
(runtime/memory.py): entries hold host-side Arrow batches and register
as a spillable consumer in the MemoryPool - under host-memory pressure
the pool asks the cache to spill, and entries move to disk as
segmented-IPC files (io/ipc.py - the shuffle wire format, so a spilled
entry streams back out through the same decode path). A hit on a
spilled entry restores it transparently.

Freshness: TTL per entry plus explicit `invalidate()` (a scan's file
content can change under an unchanged path - the fingerprint cannot
see that, the TTL bounds the staleness window, invalidation closes it
on demand). Capacity: LRU on logical bytes.
"""

from __future__ import annotations

import collections
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from blaze_tpu_torch.obs.contention import TimedRLock
from blaze_tpu_torch.testing import chaos

CacheKey = Tuple[str, int]  # (plan fingerprint, partition id)


class _Entry:
    __slots__ = ("batches", "path", "nbytes", "expires_at")

    def __init__(self, batches, nbytes: int, expires_at: float):
        self.batches = batches          # list[pa.RecordBatch] | None
        self.path: Optional[str] = None  # spill file when batches None
        self.nbytes = nbytes
        self.expires_at = expires_at


class ResultCache:
    """TTL + LRU cache of materialized partition results, spillable
    through the engine MemoryPool."""

    def __init__(
        self,
        max_bytes: int = 256 << 20,
        ttl_s: float = 300.0,
        pool=None,
        spill_dir: Optional[str] = None,
    ):
        from blaze_tpu_torch.config import get_config
        from blaze_tpu_torch.runtime.memory import get_pool

        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self._pool = pool if pool is not None else get_pool()
        self._dir = spill_dir or tempfile.mkdtemp(
            prefix="blaze_result_cache_",
            dir=get_config().tmp_dirs[0],
        )
        # RLock: put() -> pool.grow() may call back into _spill_some()
        # on the same thread under host-memory pressure
        self._lock = TimedRLock("result_cache")
        self._entries: "collections.OrderedDict[CacheKey, _Entry]" = (
            collections.OrderedDict()
        )
        self._spill_seq = 0
        self.counters: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "evictions": 0,
            "spills": 0,
            "spill_errors": 0,
            "restores": 0,
            "puts": 0,
            # streaming-integrity guard: put(complete=False) attempts
            # refused - a cache entry must never hold a truncated
            # prefix of a partition (a later hit would silently serve
            # a short result)
            "partial_puts_refused": 0,
            # request coalescing (service/service.py, ROADMAP scan-
            # sharing first step): identical in-flight plans that
            # WAITED on the leader instead of re-executing
            "coalesced": 0,
        }
        self._pool.register(id(self), self._spill_some)

    # ------------------------------------------------------------------
    def get(self, key: CacheKey) -> Optional[List]:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.counters["misses"] += 1
                return None
            if time.monotonic() >= e.expires_at:
                self._evict(key, e)
                self.counters["misses"] += 1
                return None
            self._entries.move_to_end(key)
            # hold a local reference: under pool pressure the grow()
            # inside _restore may re-spill this very entry before we
            # return
            batches = (
                self._restore(e) if e.batches is None
                else list(e.batches)
            )
            self.counters["hits"] += 1
            return batches

    def note_coalesced(self) -> None:
        """Recorded by the coalescing layer in front of get(): a
        second identical in-flight submission waited on the first
        instead of re-executing. Lives on the cache's counter surface
        because coalescing IS a cache-population optimization - the
        follower's eventual get() is a hit the leader paid for."""
        with self._lock:
            self.counters["coalesced"] += 1

    def contains(self, key: CacheKey) -> bool:
        """Non-mutating presence probe (no hit/miss counters, no LRU
        touch, no spill restore): admission-time checks (predicted-
        unmeetability shedding) must not distort cache telemetry or
        recency just by asking."""
        with self._lock:
            e = self._entries.get(key)
            return e is not None and time.monotonic() < e.expires_at

    def put(self, key: CacheKey, batches: List,
            complete: bool = True) -> bool:
        """Store one partition's materialized batches. Returns False
        when the entry is larger than the whole cache (never stored).

        `complete` is the streaming-integrity contract: entries are
        finalized only after the partition's LAST part was produced.
        With incremental FETCH delivery (service/stream.py) parts
        leave the building while execution is still running - but the
        cache population point stays after the partition loop drains,
        so a concurrent probe of an in-progress query MISSES (and
        coalesces on the leader) rather than ever seeing a truncated
        prefix. Callers that only hold a partial result must say so;
        the put is refused and counted, never stored."""
        if not complete:
            with self._lock:
                self.counters["partial_puts_refused"] += 1
            return False
        nbytes = sum(rb.nbytes for rb in batches)
        if nbytes > self.max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._release(old)
            while (
                self._entries
                and self._logical_bytes() + nbytes > self.max_bytes
            ):
                k, e = next(iter(self._entries.items()))  # LRU head
                self._evict(k, e)
            entry = _Entry(
                list(batches), nbytes, time.monotonic() + self.ttl_s
            )
            self._entries[key] = entry
            self.counters["puts"] += 1
            # account host bytes AFTER insertion: under pool pressure
            # grow() may immediately spill this very entry to disk
            self._pool.grow(id(self), nbytes)
            return True

    def invalidate(self, fingerprint: Optional[str] = None) -> int:
        """Drop entries whose fingerprint matches (prefix match), or
        everything when None. Returns the number evicted."""
        with self._lock:
            keys = [
                k
                for k in self._entries
                if fingerprint is None or k[0].startswith(fingerprint)
            ]
            for k in keys:
                self._evict(k, self._entries[k])
            return len(keys)

    def stats(self) -> dict:
        with self._lock:
            return {
                **self.counters,
                "entries": len(self._entries),
                "bytes": self._logical_bytes(),
                "spilled_entries": sum(
                    1 for e in self._entries.values()
                    if e.batches is None
                ),
            }

    def close(self) -> None:
        with self._lock:
            for k in list(self._entries):
                self._evict(k, self._entries[k])
            self._pool.unregister(id(self))

    # ------------------------------------------------------------------
    def _logical_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def _release(self, e: _Entry) -> None:
        if e.batches is not None:
            self._pool.shrink(id(self), e.nbytes)
        if e.path:
            try:
                os.unlink(e.path)
            except OSError:
                pass
            e.path = None

    def _evict(self, key: CacheKey, e: _Entry) -> None:
        self._entries.pop(key, None)
        self._release(e)
        self.counters["evictions"] += 1

    def _spill_some(self) -> int:
        """MemoryPool spill callback: move in-memory entries to disk
        LRU-first, stopping once the released bytes cover the pool's
        current overage (spilling the whole cache for a few-byte
        overshoot would cold-start every hot entry). Returns the host
        bytes released; the pool adjusts its accounting from that
        (memory.py grow)."""
        with self._lock:
            need = max(
                0, self._pool.total_used() - self._pool.budget
            )
            freed = 0
            for e in list(self._entries.values()):  # LRU head first
                if freed >= need and freed > 0:
                    break
                if e.batches is None:
                    continue
                try:
                    self._spill_entry(e)
                except Exception as err:  # noqa: BLE001 - degrade
                    # a spill IO failure (disk full, transient FS
                    # error) must not fail the serving path: the entry
                    # simply STAYS in memory and the pool gets less
                    # relief - graceful degradation, observable via
                    # the counter
                    self.counters["spill_errors"] += 1
                    import logging

                    logging.getLogger("blaze_tpu_torch.service").warning(
                        "result-cache spill failed (entry kept in "
                        "memory): %s", err,
                    )
                    continue
                freed += e.nbytes
            return freed

    def _spill_entry(self, e: _Entry) -> None:
        from blaze_tpu_torch.io.ipc import encode_ipc_segment

        if chaos.ACTIVE:
            # chaos seam: spill-file write failure
            chaos.fire("cache.spill", dir=self._dir)
        self._spill_seq += 1
        path = os.path.join(self._dir, f"rc-{self._spill_seq}.seg")
        try:
            with open(path, "wb") as f:
                for rb in e.batches:
                    f.write(encode_ipc_segment(rb))
        except Exception:
            # never leave a truncated spill file behind: a later
            # restore would decode garbage
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        e.path = path
        e.batches = None
        self.counters["spills"] += 1

    def _restore(self, e: _Entry) -> List:
        from blaze_tpu_torch.io.ipc import decode_ipc_parts

        with open(e.path, "rb") as f:
            batches = list(decode_ipc_parts(f.read()))
        try:
            os.unlink(e.path)
        except OSError:
            pass
        e.path = None
        e.batches = batches
        self.counters["restores"] += 1
        self._pool.grow(id(self), e.nbytes)
        return batches
