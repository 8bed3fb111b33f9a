"""Engine configuration.

Mirrors the reference's engine-sizing knobs (spark.blaze.batchSize,
memory fraction, tmp dirs: reference NativeSupports.scala:241-253 ->
exec.rs:53-107) plus the device the engine runs on. `device` is "cuda"
by default: entry points run on the card unless the caller asks for the
CPU (the tests do).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Sequence


@dataclasses.dataclass
class EngineConfig:
    # Max rows per device batch (reference default 16384, exec.rs:105).
    batch_size: int = 16384
    # Fraction of the memory budget the engine may use before spilling
    # (reference MemoryManagerConfig memory_fraction, exec.rs:79-94).
    memory_fraction: float = 0.75
    # Host-side budget in bytes for buffered shuffle state.
    max_memory: int = 4 << 30
    # Device budget for materialized operator input; sizes the bucket
    # count of grace execution (runtime/memory.py).
    device_memory_budget: int = 8 << 30
    # Spill directories (reference DiskManagerConfig::NewSpecified
    # tmp_dirs).
    tmp_dirs: Sequence[str] = dataclasses.field(
        default_factory=lambda: [tempfile.gettempdir()]
    )
    # Row-count buckets for padding batches. Each batch is padded up to
    # the smallest bucket >= its row count, so a stream of batches sees
    # a handful of distinct shapes (the kernels' launch shapes).
    shape_buckets: Sequence[int] = (256, 1024, 4096, 16384)
    # Pipeline-breaker materialization cap: a COMPLETE aggregate whose
    # input exceeds this many rows folds per-batch partial states
    # instead of concatenating its input (ops/hash_aggregate.py).
    max_materialize_rows: int = 1 << 22
    # Least bucket count of grace execution (ops/external.py).
    external_buckets: int = 32
    # zstd level of shuffle parts (the reference's level 1,
    # util/ipc.rs:20-49).
    ipc_compression_level: int = 1
    # torch device the engine computes on ("cuda", "cuda:1", "cpu").
    device: str = "cuda"
    # Join core (the JAX package's config.join_core): "scatter" builds
    # a hash table of the build relation (a dense direct table, a fused
    # key|row table or the generic table), demoted to the sorted core
    # when build keys repeat; "sort" always takes the sorted core;
    # "auto" is "scatter" on every device.
    join_core: str = "auto"
    # Sort core (the JAX package's config.sort_core): "scatter" packs
    # each key into one int64 lane (null rank, 32-bit order key, row
    # position) and sorts its values, one sort a key, for keys of at
    # most 32 bits below 2^29 rows; "sort" always takes the lexsort
    # path, iterated stable sorts from the least significant key;
    # "auto" is "scatter" on every device (ops/util.sort_indices).
    sort_core: str = "auto"

    def bucket_for(self, num_rows: int) -> int:
        for b in self.shape_buckets:
            if num_rows <= b:
                return b
        # Round up to a multiple of the largest bucket for oversized batches.
        top = self.shape_buckets[-1]
        return ((num_rows + top - 1) // top) * top

    def spill_dir(self) -> str:
        d = self.tmp_dirs[0]
        os.makedirs(d, exist_ok=True)
        return d


def resolve_join_core(value: str) -> str:
    """"scatter" or "sort" for a join_core value; unknown values raise,
    so a mistyped knob cannot silently run the other core."""
    if value not in ("auto", "scatter", "sort"):
        raise ValueError(
            f"join_core must be auto|scatter|sort, got {value!r}")
    return "sort" if value == "sort" else "scatter"


def resolve_sort_core(value: str) -> str:
    """"scatter" or "sort" for a sort_core value; unknown values raise."""
    if value not in ("auto", "scatter", "sort"):
        raise ValueError(
            f"sort_core must be auto|scatter|sort, got {value!r}")
    return "sort" if value == "sort" else "scatter"


_CONFIG: EngineConfig = EngineConfig()


def get_config() -> EngineConfig:
    return _CONFIG


def set_config(cfg: EngineConfig) -> EngineConfig:
    global _CONFIG
    _CONFIG = cfg
    return cfg
