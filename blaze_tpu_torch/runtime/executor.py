"""Task executor: the engine's entry point.

Reference counterpart: the JNI entry `callNative` (exec.rs:118-328) -
decode a TaskDefinition, build the operator tree, execute one partition,
stream Arrow batches back, then push collected metrics. Every decoded
tree goes through the fusion pass (`prepare_decoded_task`, as the JAX
package's does), and runs on the context's device ("cuda" unless the
caller asks for the CPU). There is no mesh lowering and no scan hints
in this slice (ROADMAP 'Modules to port' items 7 and 2).

Failure semantics follow the reference (SURVEY 5.3): operator errors are
wrapped with task context into TaskExecutionError and propagate cleanly to
the embedder; partial output is never silently dropped.
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Optional

import torch

from blaze_tpu_torch.errors import ErrorClass, classify
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.util import ensure_compacted
from blaze_tpu_torch.runtime import dispatch

log = logging.getLogger("blaze_tpu_torch.executor")


class TaskExecutionError(RuntimeError):
    def __init__(self, task_id: str, partition: int, cause: BaseException):
        super().__init__(
            f"task {task_id} partition {partition} failed: {cause!r}"
        )
        self.task_id = task_id
        self.partition = partition
        self.__cause__ = cause

    @property
    def error_class(self) -> ErrorClass:
        """Failure taxonomy class of the wrapped cause."""
        return classify(self)


def require_device(device: torch.device) -> None:
    """Refuse to run on a device this process does not have: no silent
    CPU run when the card is missing."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"blaze_tpu_torch: the task asks for device {device}, but "
            "torch.cuda.is_available() is False; pass "
            "ExecContext(device='cpu') to run on the CPU"
        )


def prepare_decoded_task(decoded, ctx: ExecContext):
    """Fuse a decoded tree (planner/fuse.py: the JAX package's
    `prepare_decoded_task` fuses every decoded task the same way) and
    install the task's identity and file resources into the context."""
    from blaze_tpu_torch.planner.fuse import fuse_pipelines

    op, partition, task_id, resources = decoded
    op = fuse_pipelines(op)
    ctx.partition_id = partition
    ctx.task_id = task_id
    for rid, provider in resources.items():
        ctx.resources.setdefault(rid, provider)
    return op, partition


def decode_task(task_bytes: bytes, ctx: ExecContext):
    """Decode TaskDefinition bytes into a runnable, fused (op,
    partition) pair."""
    from blaze_tpu_torch.plan.serde import task_from_proto

    return prepare_decoded_task(task_from_proto(task_bytes), ctx)


def execute_task(task_bytes: bytes,
                 ctx: Optional[ExecContext] = None):
    """Decode and run one serialized TaskDefinition; returns an iterator
    of Arrow batches (the FFI-equivalent boundary, exec.rs:205-255). The
    decode and the device check happen here, before the first batch."""
    ctx = ctx or ExecContext()
    op, partition = decode_task(task_bytes, ctx)
    return execute_partition(op, partition, ctx)


def execute_partition(op: PhysicalOp, partition: int, ctx: ExecContext):
    """Check the device now, then return the partition's Arrow batch
    stream."""
    require_device(ctx.device)
    return _drain(op, partition, ctx)


def _drain(op: PhysicalOp, partition: int, ctx: ExecContext
           ) -> Iterator:
    if log.isEnabledFor(logging.DEBUG):
        log.debug(
            "executing task %s partition %d:\n%s",
            ctx.task_id, partition, op.display(),
        )
    counter = dispatch.counting()
    counter.__enter__()
    try:
        for cb in op.execute(partition, ctx):
            cb = ensure_compacted(cb)
            if cb.num_rows == 0:
                continue
            rb = cb.to_arrow()
            ctx.metrics.add("output_rows", rb.num_rows)
            ctx.metrics.add("output_batches", 1)
            yield rb
    except (KeyboardInterrupt, GeneratorExit):
        # task cancellation must not poison the engine (the reference
        # swallows JVM-interrupts the same way, exec.rs:330-343)
        log.info("task %s partition %d cancelled", ctx.task_id, partition)
        raise
    except Exception as e:
        raise TaskExecutionError(ctx.task_id, partition, e) from e
    finally:
        # per-task launch/transfer accounting in the metric tree (delta
        # of the process-global counters)
        counter.__exit__(None, None, None)
        for k, v in counter.counts.items():
            ctx.metrics.add("dispatch." + k, v)


def run_plan(op: PhysicalOp, ctx: Optional[ExecContext] = None):
    """Run every partition and collect one Arrow table (driver-side
    convenience; partitions share the context)."""
    import pyarrow as pa

    from blaze_tpu_torch.types import to_arrow_schema

    ctx = ctx or ExecContext()
    batches: List = []
    schema = None
    for p in range(op.partition_count):
        for rb in execute_partition(op, p, ctx):
            if schema is None:
                schema = rb.schema
            batches.append(rb)
    if schema is None:
        return pa.Table.from_batches([], to_arrow_schema(op.schema))
    return pa.Table.from_batches(
        [rb if rb.schema == schema else rb.cast(schema) for rb in batches],
        schema,
    )
