"""Pluggable shuffle manager: the embedder-facing shuffle surface.

Reference counterpart: `ArrowShuffleManager301` (shuffle/
ArrowShuffleManager301.scala:39) - the component a HOST system (Spark's
`spark.shuffle.manager` slot) drives to register shuffles, obtain
writers for map tasks, commit their output atomically, and hand reduce
tasks readers. The engine's own ShuffleExchangeExec orchestrates its
shuffles internally (as Spark's exchange does through the manager); this
class exposes the same lifecycle to embedders - the gateway, the C-ABI
embedding, or a future Spark session-extension tier - over the shared
`.data`/`.index` segmented-IPC format, accepting BOTH producers (native
ShuffleWriterExec plans and host-tier pyarrow batches, mirroring the
reference's native + JVM-row writer pair). The JAX package's
parallel/shuffle_manager.py; the native producer runs on the context's
device ("cuda" unless the caller passes an ExecContext for the CPU).

Lifecycle (all paths are manager-owned):
  h = manager.register_shuffle(num_maps, num_partitions, keys=...)
  manager.write_map_native(h, map_id, plan)        # device tier
  manager.write_map_batches(h, map_id, batches)    # host tier
  manager.read_partition(h, p [, map_range])       # -> RecordBatches
  manager.map_statistics(h)                        # AQE stats feed
  manager.remove_shuffle(h)                        # delete files
Commits are atomic (tmp files + rename, index last - the reference's
writeIndexFileAndCommit contract) and idempotent: re-committing a map id
replaces its output, which is what Spark's task retry requires.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa

from blaze_tpu_torch.io.ipc import partition_ranges, read_file_segment


@dataclasses.dataclass(frozen=True)
class ShuffleHandle:
    shuffle_id: int
    num_maps: int
    num_partitions: int
    key_names: Tuple[str, ...]
    root: str


class ShuffleManager:
    def __init__(self, root: Optional[str] = None):
        self.root = root or tempfile.mkdtemp(prefix="blz-shufmgr-")
        self._next_id = 0
        self._handles: Dict[int, ShuffleHandle] = {}
        self._committed: Dict[Tuple[int, int], Tuple[str, str]] = {}
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------
    def register_shuffle(self, num_maps: int, num_partitions: int,
                         keys: Sequence[str]) -> ShuffleHandle:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            d = os.path.join(self.root, f"shuffle_{sid}")
            os.makedirs(d, exist_ok=True)
            h = ShuffleHandle(sid, num_maps, num_partitions,
                              tuple(keys), d)
            self._handles[sid] = h
            return h

    def remove_shuffle(self, h: ShuffleHandle) -> None:
        with self._lock:
            self._handles.pop(h.shuffle_id, None)
            for key in [k for k in self._committed
                        if k[0] == h.shuffle_id]:
                self._committed.pop(key, None)
        shutil.rmtree(h.root, ignore_errors=True)

    # -- write side ----------------------------------------------------
    def _paths(self, h: ShuffleHandle, map_id: int) -> Tuple[str, str]:
        return (os.path.join(h.root, f"map_{map_id}.data"),
                os.path.join(h.root, f"map_{map_id}.index"))

    def _commit(self, h: ShuffleHandle, map_id: int,
                tmp_data: str, tmp_index: str) -> List[int]:
        """Atomic, idempotent commit: data lands first, the index rename
        is the commit point (a reader never sees an index whose data is
        missing - the reference's writeIndexFileAndCommit ordering)."""
        data, index = self._paths(h, map_id)
        os.replace(tmp_data, data)
        os.replace(tmp_index, index)
        with self._lock:
            self._committed[(h.shuffle_id, map_id)] = (data, index)
        return [length for _, length in partition_ranges(index)]

    def write_map_native(self, h: ShuffleHandle, map_id: int,
                         child, ctx=None) -> List[int]:
        """Run a native ShuffleWriterExec over `child`'s partition
        `map_id` (the device hash tier). Returns partition lengths."""
        from blaze_tpu_torch.exprs import ir
        from blaze_tpu_torch.ops.base import ExecContext
        from blaze_tpu_torch.ops.shuffle_writer import ShuffleWriterExec

        tmp_data, tmp_index = (
            p + f".tmp{os.getpid()}" for p in self._paths(h, map_id)
        )
        writer = ShuffleWriterExec(
            child, [ir.Col(k) for k in h.key_names],
            h.num_partitions, tmp_data, tmp_index,
        )
        for _ in writer.execute(map_id, ctx or ExecContext()):
            pass
        return self._commit(h, map_id, tmp_data, tmp_index)

    def write_map_batches(self, h: ShuffleHandle, map_id: int,
                          batches: Iterator[pa.RecordBatch]
                          ) -> List[int]:
        """Write host rows (the JVM-row-writer analog): same format,
        no device involvement."""
        from blaze_tpu_torch.ops.host_shuffle import host_shuffle_write

        tmp_data, tmp_index = (
            p + f".tmp{os.getpid()}" for p in self._paths(h, map_id)
        )
        host_shuffle_write(
            batches, list(h.key_names), h.num_partitions,
            tmp_data, tmp_index, spill_dir=h.root,
        )
        return self._commit(h, map_id, tmp_data, tmp_index)

    # -- read side -----------------------------------------------------
    def read_partition(self, h: ShuffleHandle, partition: int,
                       map_range: Optional[Tuple[int, int]] = None
                       ) -> Iterator[pa.RecordBatch]:
        """Stream one reduce partition across the selected map outputs
        (map_range enables AQE partial-mapper reads,
        NativeSupports.scala:131-212)."""
        lo, hi = map_range or (0, h.num_maps)
        for m in range(lo, hi):
            with self._lock:
                paths = self._committed.get((h.shuffle_id, m))
            if paths is None:
                raise KeyError(
                    f"map {m} of shuffle {h.shuffle_id} not committed"
                )
            data, index = paths
            off, length = partition_ranges(index)[partition]
            if length:
                yield from read_file_segment(data, off, length)

    def map_statistics(self, h: ShuffleHandle) -> List[int]:
        """Bytes per reduce partition summed over committed maps - the
        AQE stats feed (mapOutputStatisticsFuture analog)."""
        sizes = [0] * h.num_partitions
        for m in range(h.num_maps):
            with self._lock:
                paths = self._committed.get((h.shuffle_id, m))
            if paths is None:
                continue
            for p, (_, length) in enumerate(
                partition_ranges(paths[1])
            ):
                sizes[p] += length
        return sizes
