"""Pass-through batch logger - the plan-level tracing facility
(reference DebugExec, debug_exec.rs:44-58). A batch is fetched to the
host only while the `blaze_tpu_torch.debug` logger takes INFO."""

from __future__ import annotations

import logging
from typing import Iterator

from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp

log = logging.getLogger("blaze_tpu_torch.debug")


class DebugExec(PhysicalOp):
    def __init__(self, child: PhysicalOp, debug_id: str):
        self.children = [child]
        self.debug_id = debug_id

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        for i, b in enumerate(self.children[0].execute(partition, ctx)):
            if log.isEnabledFor(logging.INFO):
                log.info("[%s] partition=%d batch=%d rows=%d:\n%s",
                         self.debug_id, partition, i, b.num_rows,
                         b.to_arrow().slice(0, 20))
            yield b
