"""Local task scheduler: concurrent partition execution with
CLASSIFIED retries.

Plays Spark's executor role for standalone/local runs, the way the
reference's TPC-DS CI exercises its whole distributed path with local-mode
Spark (SURVEY 4): partitions run as tasks on a thread pool (device
dispatch is async so threads overlap host decode/IPC work with device
compute), failed tasks retry like Spark's task retry (SURVEY 5.3), results
stream back in partition order.

Failure semantics (blaze_tpu_torch/errors.py taxonomy):

  TRANSIENT           retried up to max_attempts with exponential
                      backoff + jitter (immediate re-runs hammered the
                      same flaky resource and burned budget in bursts)
  RESOURCE_EXHAUSTED  on the CPU, degraded: the partition re-executes
                      through the pandas host engine
                      (planner/host_engine.py) - the native->Spark
                      fallback analog; the metric tree records
                      `degraded_partitions` and `degraded_rows`. On
                      the card it fails the plan: work never moves
                      to the host after a failure on the device
  PLAN_INVALID /      fail fast, zero retries - deterministic failures
  INTERNAL            don't get cheaper the second time
  CANCELLED           cooperative unwind, never counted as failure

The FIRST task to fail fatally fails the plan immediately - outstanding
sibling tasks are cancelled (queued ones never start; running ones
observe the cancel event at their next batch boundary and unwind through
the executor's GeneratorExit cancellation pass-through,
runtime/executor.py), instead of running to completion against a plan
that already failed.

The JAX package's runtime/scheduler.py on the port. Its tasks share one
card (each thread launches on the current stream; the graph cache
lends a graph to one task at a time). Its per-attempt trace spans wait
for the obs tier, and its mesh lowering for the multi-GPU tier
(ROADMAP 'Modules to port' items 8 and 7).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import random
import threading
import time
from typing import List, Optional

import pyarrow as pa

from blaze_tpu_torch.errors import classify, retry_action
from blaze_tpu_torch.obs import trace as obs_trace
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.runtime.executor import (
    TaskExecutionError,
    execute_partition,
)

log = logging.getLogger("blaze_tpu_torch.scheduler")


class PlanCancelled(RuntimeError):
    """A sibling task failed (or the caller cancelled the plan); this
    partition's work was abandoned cooperatively."""


def backoff_delay(attempt: int, base_s: float = 0.05,
                  cap_s: float = 2.0) -> float:
    """Exponential backoff with full jitter: uniform in
    (0, min(cap, base * 2^attempt)]. Jitter decorrelates retries from
    concurrent failed tasks - without it every sibling re-hits the
    flaky resource in lockstep."""
    hi = min(cap_s, base_s * (2 ** attempt))
    return random.uniform(hi * 0.5, hi)


def run_plan_parallel(
    op: PhysicalOp,
    ctx: Optional[ExecContext] = None,
    parallelism: int = 4,
    max_attempts: int = 3,
    cancel: Optional[threading.Event] = None,
    retry_backoff_s: float = 0.05,
) -> pa.Table:
    """Execute every partition on a thread pool and collect one table.

    `cancel` lets an embedder (the serving tier) abort the whole plan
    cooperatively. Fail-fast uses a separate INTERNAL event so a task
    failure never mutates the caller's (possibly shared) event."""
    ctx = ctx or ExecContext()
    abort = threading.Event()  # internal: first-failure fail-fast
    # a device task never degrades to the host engine: the failure
    # surfaces instead of moving the work off the card unseen
    can_degrade = ctx.device.type != "cuda"

    def cancelled() -> bool:
        return abort.is_set() or (
            cancel is not None and cancel.is_set()
        )

    def degrade(p: int, cause: BaseException) -> List[pa.RecordBatch]:
        """RESOURCE_EXHAUSTED: re-run the partition on the host engine
        (graceful degradation). Raises the ORIGINAL error when the
        tree has no host mapping."""
        from blaze_tpu_torch.planner.host_engine import execute_partition_host

        try:
            out = execute_partition_host(op, p, ctx)
        except Exception as host_err:  # noqa: BLE001 - original wins
            log.warning(
                "host degradation of partition %d unavailable (%s); "
                "surfacing original error", p, host_err,
            )
            raise cause
        ctx.metrics.add("degraded_partitions", 1)
        log.warning(
            "partition %d degraded to host engine after "
            "RESOURCE_EXHAUSTED: %s", p, cause,
        )
        return out

    def task(p: int) -> List[pa.RecordBatch]:
        for attempt in range(max_attempts):
            if cancelled():
                raise PlanCancelled(f"partition {p} cancelled")
            # obs seam: one span per attempt (a failed one is tagged
            # with its error class); the executor's partition span
            # nests under it
            span_cm = (
                obs_trace.span("attempt", rec=ctx.tracer,
                               partition=p, attempt=attempt)
                if obs_trace.ACTIVE else obs_trace.NULL
            )
            it = execute_partition(op, p, ctx)
            out: List[pa.RecordBatch] = []
            try:
                with span_cm:
                    for rb in it:
                        out.append(rb)
                        if cancelled():
                            # the executor's cancellation pass-through:
                            # close -> GeneratorExit unwinds the
                            # operator tree without poisoning the engine
                            it.close()
                            raise PlanCancelled(
                                f"partition {p} cancelled mid-stream"
                            )
                return out
            except PlanCancelled:
                raise
            except TaskExecutionError as e:
                if out:
                    # drop the abandoned attempt's partial output from
                    # the counters; a retry/degrade re-counts it
                    ctx.metrics.add(
                        "output_rows",
                        -sum(rb.num_rows for rb in out),
                    )
                    ctx.metrics.add("output_batches", -len(out))
                ec = classify(e)
                action = retry_action(ec, attempt, max_attempts,
                                      can_degrade)
                if action == "cancel":
                    raise PlanCancelled(
                        f"partition {p} cancelled in-task"
                    ) from e
                if action == "degrade":
                    return degrade(p, e)
                if action == "fail":
                    raise
                ctx.metrics.add("task_retries", 1)
                ctx.metrics.add("retries.transient", 1)
                log.warning(
                    "task for partition %d failed transiently "
                    "(attempt %d): %s; backing off", p, attempt + 1, e,
                )
                # interruptible backoff: a sibling failure wakes the
                # abort.wait immediately; the caller's cancel event is
                # a separate object, so poll it on a short tick - the
                # loop-top cancelled() check then unwinds
                wake_at = time.monotonic() + backoff_delay(
                    attempt, retry_backoff_s
                )
                while not cancelled():
                    left = wake_at - time.monotonic()
                    if left <= 0:
                        break
                    abort.wait(min(0.05, left))
            finally:
                it.close()
        raise AssertionError("unreachable: attempt loop fell through")

    n = op.partition_count
    results: List[List[pa.RecordBatch]] = [[] for _ in range(n)]
    from blaze_tpu_torch.runtime.dispatch import task_threads

    first_error: Optional[BaseException] = None
    with cf.ThreadPoolExecutor(
        max_workers=task_threads(n, cap=max(1, parallelism))
    ) as pool:
        futs = {pool.submit(task, p): p for p in range(n)}
        for fut in cf.as_completed(futs):
            try:
                results[futs[fut]] = fut.result()
            except PlanCancelled:
                continue  # secondary casualty of the first failure
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if first_error is None:
                    first_error = e
                    # fail fast: queued siblings never start, running
                    # ones observe the event at the next batch
                    abort.set()
                    for f in futs:
                        f.cancel()
    if first_error is not None:
        raise first_error
    if cancel is not None and cancel.is_set():
        raise PlanCancelled("plan cancelled by caller")
    batches = [rb for part in results for rb in part]
    if not batches:
        from blaze_tpu_torch.types import to_arrow_schema

        return pa.Table.from_batches([], to_arrow_schema(op.schema))
    schema = batches[0].schema
    aligned = [
        rb if rb.schema == schema else rb.cast(schema) for rb in batches
    ]
    return pa.Table.from_batches(aligned, schema)
