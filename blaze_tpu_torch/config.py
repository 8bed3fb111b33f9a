"""Engine configuration.

Mirrors the reference's engine-sizing knobs (spark.blaze.batchSize:
reference NativeSupports.scala:241-253 -> exec.rs:53-107) plus the
device the engine runs on. `device` is "cuda" by default: entry points
run on the card unless the caller asks for the CPU (the tests do).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class EngineConfig:
    # Max rows per device batch (reference default 16384, exec.rs:105).
    batch_size: int = 16384
    # Row-count buckets for padding batches. Each batch is padded up to
    # the smallest bucket >= its row count, so a stream of batches sees
    # a handful of distinct shapes (the kernels' launch shapes).
    shape_buckets: Sequence[int] = (256, 1024, 4096, 16384)
    # Pipeline-breaker materialization cap: a COMPLETE aggregate whose
    # input exceeds this many rows folds per-batch partial states
    # instead of concatenating its input (ops/hash_aggregate.py).
    max_materialize_rows: int = 1 << 22
    # torch device the engine computes on ("cuda", "cuda:1", "cpu").
    device: str = "cuda"

    def bucket_for(self, num_rows: int) -> int:
        for b in self.shape_buckets:
            if num_rows <= b:
                return b
        # Round up to a multiple of the largest bucket for oversized batches.
        top = self.shape_buckets[-1]
        return ((num_rows + top - 1) // top) * top


_CONFIG: EngineConfig = EngineConfig()


def get_config() -> EngineConfig:
    return _CONFIG


def set_config(cfg: EngineConfig) -> EngineConfig:
    global _CONFIG
    _CONFIG = cfg
    return cfg
