"""The port's local scheduler (runtime/scheduler.py), the twin of
tests/test_scheduler.py on the CPU: partitions run as tasks on a thread
pool and come back in partition order, equal to a serial run; transient
failures retry with backoff and are counted; a deterministic failure
fails the plan; RESOURCE_EXHAUSTED degrades the partition to the host
engine on the CPU and fails the plan on the card; the first fatal
failure cancels the running siblings; the caller's cancel event aborts
the plan. The instrumented metric tree
(runtime/instrument.py) waits for the obs tier."""

import threading
import time

import pyarrow as pa
import pytest

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.errors import ResourceExhaustedError
from blaze_tpu_torch.exprs.ir import Col
from blaze_tpu_torch.ops import FilterExec, MemoryScanExec, ProjectExec
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.executor import TaskExecutionError, run_plan
from blaze_tpu_torch.runtime.scheduler import (
    PlanCancelled,
    backoff_delay,
    run_plan_parallel,
)


def _batch(values):
    return ColumnBatch.from_pydict({"a": list(values)}, device="cpu")


def multi_scan(n_parts=6, rows=50):
    parts = [[_batch(range(p * rows, (p + 1) * rows))]
             for p in range(n_parts)]
    return MemoryScanExec(parts, parts[0][0].schema)


def _cpu():
    return ExecContext(device="cpu")


def test_parallel_matches_serial():
    op = ProjectExec(FilterExec(multi_scan(), Col("a") % 3 == 0),
                     [(Col("a") * 2, "a2")])
    par = run_plan_parallel(op, ctx=_cpu(), parallelism=4)
    ser = run_plan(op, _cpu())
    assert par.equals(ser)
    assert par.column("a2").to_pylist() == [2 * a for a in range(300)
                                            if a % 3 == 0]


def test_task_threads_cap():
    assert dispatch.task_threads(1) == 1
    assert dispatch.task_threads(10) == 4
    assert dispatch.task_threads(10, cap=2) == 2


def test_flaky_task_retries():
    fails = {"count": 0}
    lock = threading.Lock()

    class Flaky(MemoryScanExec):
        def execute(self, partition, ctx):
            with lock:
                if partition == 2 and fails["count"] < 2:
                    fails["count"] += 1
                    raise IOError("transient")
            return super().execute(partition, ctx)

    base = multi_scan(4)
    ctx = _cpu()
    out = run_plan_parallel(Flaky(base.partitions, base.schema), ctx=ctx,
                            parallelism=2, retry_backoff_s=0.001)
    assert out.num_rows == 200
    assert fails["count"] == 2
    assert ctx.metrics.counters["task_retries"] == 2
    assert ctx.metrics.counters["retries.transient"] == 2


def test_permanent_failure_raises():
    class Dead(MemoryScanExec):
        def execute(self, partition, ctx):
            raise ValueError("no")
            yield

    base = multi_scan(2)
    with pytest.raises(TaskExecutionError):
        run_plan_parallel(Dead(base.partitions, base.schema), ctx=_cpu(),
                          parallelism=2, max_attempts=2)


def test_resource_exhausted_degrades_to_host(monkeypatch):
    """On the CPU the failed partition re-runs through the pandas host
    engine (planner/host_engine.execute_partition_host); the others
    stay native; the result is the same. On the card the degrade is
    refused: the original error fails the plan (the context names
    cuda; every partition fails before it touches the device)."""
    from blaze_tpu_torch.runtime import executor

    class Oom(MemoryScanExec):
        def execute(self, partition, ctx):
            if partition == 1 or ctx.device.type == "cuda":
                raise ResourceExhaustedError("device memory")
            return super().execute(partition, ctx)

    base = multi_scan(3)
    op = FilterExec(Oom(base.partitions, base.schema), Col("a") % 2 == 0)
    ctx = _cpu()
    out = run_plan_parallel(op, ctx=ctx, parallelism=3)
    assert out.column("a").to_pylist() == list(range(0, 150, 2))
    assert ctx.metrics.counters["degraded_partitions"] == 1
    assert ctx.metrics.counters["degraded_rows"] == 25
    monkeypatch.setattr(executor, "require_device", lambda device: None)
    card = ExecContext(device="cuda")
    with pytest.raises(TaskExecutionError) as err:
        run_plan_parallel(op, ctx=card, parallelism=3)
    assert isinstance(err.value.__cause__, ResourceExhaustedError)
    assert "degraded_partitions" not in card.metrics.counters


def test_backoff_delay_bounds():
    for attempt in range(6):
        hi = min(2.0, 0.05 * 2 ** attempt)
        assert hi * 0.5 <= backoff_delay(attempt) <= hi


def test_first_failure_cancels_outstanding_siblings():
    closed = []
    close_lock = threading.Lock()

    class FailFast(MemoryScanExec):
        def execute(self, partition, ctx):
            if partition == 0:
                time.sleep(0.05)  # let the siblings start streaming
                raise IOError("partition 0 exploded")
            try:
                for _ in range(10_000):
                    yield _batch([partition])
                    time.sleep(0.005)
            finally:
                with close_lock:
                    closed.append(partition)

    base = multi_scan(4)
    t0 = time.monotonic()
    with pytest.raises(TaskExecutionError, match="partition 0"):
        run_plan_parallel(FailFast(base.partitions, base.schema),
                          ctx=_cpu(), parallelism=4, max_attempts=1)
    assert time.monotonic() - t0 < 20
    assert set(closed) >= {1, 2, 3}


def test_caller_cancel_event_aborts_plan():
    cancel = threading.Event()

    class Endless(MemoryScanExec):
        def execute(self, partition, ctx):
            for i in range(10_000):
                yield _batch([i])
                time.sleep(0.002)

    base = multi_scan(2)
    threading.Timer(0.1, cancel.set).start()
    with pytest.raises(PlanCancelled):
        run_plan_parallel(Endless(base.partitions, base.schema),
                          ctx=_cpu(), parallelism=2, cancel=cancel)


def test_empty_plan_has_its_schema():
    base = multi_scan(2)
    out = run_plan_parallel(FilterExec(base, Col("a") < 0), ctx=_cpu())
    assert out.num_rows == 0
    assert out.schema == pa.schema([("a", pa.int64())])


def test_metric_tree_counts_survive_threads():
    """Tasks of one plan share their context's metric tree: 16 threads
    adding at a short switch interval lose no update."""
    import sys

    from blaze_tpu_torch.ops.base import MetricNode

    node = MetricNode("root")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [node.add("n", 1) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert node.counters["n"] == 16 * 2000
