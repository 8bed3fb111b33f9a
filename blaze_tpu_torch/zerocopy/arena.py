"""Shared-memory Arrow arena (zero-copy serve path).

Finalized result parts are stored ONCE, already encoded in the exact
wire framing FETCH streams (`u64 len | zstd(Arrow IPC)` per part,
io/ipc.encode_ipc_segment), inside mmap'd segment files. Two serve
modes read them:

  scatter-gather -- the socket byte path sends the segment's frames as
                    a buffer list of mmap-backed memoryviews
                    (writev-style, runtime/transport.sendmsg_all): no
                    re-encode, no concatenated reply, bytes identical
                    to the per-batch encode path by construction.
  handle         -- a co-located client receives {path, offsets,
                    lengths, lease} instead of bytes and maps the
                    segment itself. Leases are refcounted with a TTL:
                    an orphaned lease (client crashed before RELEASE)
                    is reaped and the segment becomes evictable again.

Degradation is the contract: every failure inside the arena (mmap or
write failure, stale lease, chaos seams `zerocopy.map` and
`zerocopy.lease`) answers None and the caller falls back to the
socket byte path - zero client-visible failures.
"""

from __future__ import annotations

import itertools
import logging
import mmap
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from blaze_tpu_torch.testing import chaos

log = logging.getLogger("blaze_tpu_torch.zerocopy.arena")


class _Segment:
    __slots__ = ("key", "path", "mm", "file", "offsets", "lengths",
                 "nbytes", "generation", "leases", "last_used")

    def __init__(self, key, path, mm, file, offsets, lengths, nbytes,
                 generation):
        self.key = key
        self.path = path
        self.mm = mm
        self.file = file
        self.offsets = offsets
        self.lengths = lengths
        self.nbytes = nbytes
        self.generation = generation
        self.leases = 0
        self.last_used = time.monotonic()


class ArrowArena:
    """Bounded mmap segment store: result key -> encoded part frames.

    Keys are result-cache fingerprints (content-addressed over the
    plan), so a segment can never serve stale bytes - the same
    determinism assumption the ResultCache already makes. Budget
    eviction is LRU over UNLEASED segments; a leased segment is pinned
    until every lease is released or TTL-reaped."""

    def __init__(self, directory: Optional[str] = None,
                 max_bytes: int = 256 << 20,
                 lease_ttl_s: float = 30.0):
        self.max_bytes = max(0, int(max_bytes))
        self.lease_ttl_s = float(lease_ttl_s)
        self._own_dir = directory is None
        self.directory = (
            directory if directory is not None
            else tempfile.mkdtemp(prefix="blaze-arena-")
        )
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._segments: "OrderedDict[str, _Segment]" = OrderedDict()
        self._leases: Dict[int, Tuple[str, float]] = {}
        self._lease_ids = itertools.count(1)
        self._generations = itertools.count(1)
        self._bytes = 0
        self._closed = False
        self.counters = {
            "published": 0,
            "publish_skipped": 0,
            "evictions": 0,
            "handle_hits": 0,
            "handle_misses": 0,
            "sg_serves": 0,
            "lease_releases": 0,
            "lease_orphans_reaped": 0,
            "map_failures": 0,
            "lease_faults": 0,
        }

    # -- publish --------------------------------------------------------
    def publish(self, key: str, frames: Sequence[bytes]) -> bool:
        """Store one result's encoded part frames under `key`.
        Idempotent (first publish wins); False means the arena
        declined (present, over budget, closed, or the `zerocopy.map`
        seam / a real mmap failure fired) and the caller keeps the
        byte path."""
        if self._closed or self.max_bytes <= 0 or not key:
            return False
        frames = [f for f in frames if f]
        nbytes = sum(len(f) for f in frames)
        if not frames or nbytes > self.max_bytes:
            with self._lock:
                self.counters["publish_skipped"] += 1
            return False
        with self._lock:
            if key in self._segments:
                self.counters["publish_skipped"] += 1
                return False
        gen = next(self._generations)
        path = os.path.join(self.directory, f"seg-{gen}.arena")
        try:
            if chaos.ACTIVE:
                chaos.fire("zerocopy.map", key=key, nbytes=nbytes,
                           path=path)
            with open(path, "wb") as f:
                for frame in frames:
                    f.write(frame)
            file = open(path, "rb")  # noqa: SIM115 - lives in segment
            mm = mmap.mmap(file.fileno(), 0, access=mmap.ACCESS_READ)
        except Exception as e:  # noqa: BLE001 - degrade to byte path
            with self._lock:
                self.counters["map_failures"] += 1
            try:
                os.unlink(path)
            except OSError:
                pass
            log.debug("arena publish degraded for %s: %s", key, e)
            return False
        offsets: List[int] = []
        lengths: List[int] = []
        off = 0
        for frame in frames:
            offsets.append(off)
            lengths.append(len(frame))
            off += len(frame)
        seg = _Segment(key, path, mm, file, offsets, lengths, nbytes,
                       gen)
        drop: List[_Segment] = []
        with self._lock:
            if self._closed or key in self._segments:
                drop.append(seg)
            else:
                self._segments[key] = seg
                self._bytes += nbytes
                self.counters["published"] += 1
                drop.extend(self._evict_locked())
        for s in drop:
            self._destroy(s)
        return not (drop and drop[0] is seg)

    def _evict_locked(self) -> List[_Segment]:
        """LRU-evict unleased segments until under budget. Caller
        holds the lock; actual unmap/unlink happens outside it."""
        out: List[_Segment] = []
        while self._bytes > self.max_bytes:
            victim_key = None
            for k, seg in self._segments.items():
                if seg.leases <= 0:
                    victim_key = k
                    break
            if victim_key is None:
                break  # everything pinned by leases
            seg = self._segments.pop(victim_key)
            self._bytes -= seg.nbytes
            self.counters["evictions"] += 1
            out.append(seg)
        return out

    @staticmethod
    def _destroy(seg: _Segment) -> None:
        try:
            seg.mm.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            seg.file.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            os.unlink(seg.path)
        except OSError:
            pass

    # -- serve ----------------------------------------------------------
    def buffers(self, key: str,
                start_part: int = 0) -> Optional[List[memoryview]]:
        """Scatter-gather source: one mmap-backed memoryview per frame
        from `start_part` on, or None (caller re-encodes). The views
        alias the segment mmap; the GIL plus the fact that segments
        are destroyed only via _destroy AFTER eviction keeps them
        valid for the duration of a send loop - callers must not hold
        them across requests."""
        with self._lock:
            seg = self._segments.get(key)
            if seg is None:
                return None
            if start_part >= len(seg.offsets):
                return []
            seg.last_used = time.monotonic()
            self._segments.move_to_end(key)
            self.counters["sg_serves"] += 1
            view = memoryview(seg.mm)
            return [
                view[seg.offsets[i]:seg.offsets[i] + seg.lengths[i]]
                for i in range(start_part, len(seg.offsets))
            ]

    def handle(self, key: str,
               start_part: int = 0) -> Optional[dict]:
        """Lease the segment to a co-located client: returns the
        JSON-serializable handle (path + frame geometry + lease id) or
        None when the key is absent / the lease seam fired (degrade to
        bytes)."""
        self.reap()
        with self._lock:
            seg = self._segments.get(key)
            if seg is None or self._closed:
                self.counters["handle_misses"] += 1
                return None
        try:
            if chaos.ACTIVE:
                chaos.fire("zerocopy.lease", key=key)
        except Exception:  # noqa: BLE001 - stale-lease seam
            with self._lock:
                self.counters["lease_faults"] += 1
            return None
        with self._lock:
            seg = self._segments.get(key)
            if seg is None:
                self.counters["handle_misses"] += 1
                return None
            lease = next(self._lease_ids)
            seg.leases += 1
            seg.last_used = time.monotonic()
            self._segments.move_to_end(key)
            self._leases[lease] = (
                key, time.monotonic() + self.lease_ttl_s
            )
            self.counters["handle_hits"] += 1
            return {
                "path": seg.path,
                "offsets": list(seg.offsets[start_part:]),
                "lengths": list(seg.lengths[start_part:]),
                "generation": seg.generation,
                "lease": lease,
                "start_part": int(start_part),
            }

    def release(self, lease: int) -> bool:
        with self._lock:
            ent = self._leases.pop(int(lease), None)
            if ent is None:
                return False
            self.counters["lease_releases"] += 1
            seg = self._segments.get(ent[0])
            if seg is not None and seg.leases > 0:
                seg.leases -= 1
        return True

    def reap(self, now: Optional[float] = None) -> int:
        """Expire orphaned leases (client died before RELEASE) so
        their segments become evictable again. Called opportunistically
        from handle() and by the service's periodic sweeps."""
        now = time.monotonic() if now is None else now
        reaped = 0
        with self._lock:
            expired = [lid for lid, (_, exp) in self._leases.items()
                       if exp <= now]
            for lid in expired:
                key, _ = self._leases.pop(lid)
                seg = self._segments.get(key)
                if seg is not None and seg.leases > 0:
                    seg.leases -= 1
                reaped += 1
            self.counters["lease_orphans_reaped"] += reaped
        return reaped

    # -- lifecycle ------------------------------------------------------
    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._segments

    def stats(self) -> dict:
        with self._lock:
            return {
                "segments": len(self._segments),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "active_leases": len(self._leases),
                "lease_ttl_s": self.lease_ttl_s,
                **self.counters,
            }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            segs = list(self._segments.values())
            self._segments.clear()
            self._leases.clear()
            self._bytes = 0
        for seg in segs:
            self._destroy(seg)
        if self._own_dir:
            try:
                os.rmdir(self.directory)
            except OSError:
                pass


def map_handle_frames(handle: dict) -> List[bytes]:
    """Client side of the shm path: map the leased segment and slice
    out the encoded part frames. Raises on ANY problem (missing file,
    truncated segment, chaos seams) - the caller treats every raise as
    a stale lease and falls back to a byte-path FETCH."""
    path = handle["path"]
    offsets = [int(o) for o in handle["offsets"]]
    lengths = [int(n) for n in handle["lengths"]]
    if len(offsets) != len(lengths):
        raise ValueError("malformed arena handle")
    if chaos.ACTIVE:
        chaos.fire("zerocopy.map", path=path)
    with open(path, "rb") as f:
        with mmap.mmap(f.fileno(), 0,
                       access=mmap.ACCESS_READ) as mm:
            if chaos.ACTIVE:
                chaos.fire("zerocopy.lease",
                           lease=handle.get("lease"))
            end = max(
                (o + n for o, n in zip(offsets, lengths)), default=0
            )
            if end > len(mm):
                raise ValueError(
                    f"arena segment truncated: need {end} bytes, "
                    f"have {len(mm)} (stale lease)"
                )
            return [bytes(mm[o:o + n])
                    for o, n in zip(offsets, lengths)]
