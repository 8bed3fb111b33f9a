"""The port's exchange operators (parallel/exchange.py, the local half)
against the JAX package's, on the CPU: the shuffle exchange in its hash,
single, round_robin and range modes (a map stage of one writer task a
child partition, run in threads, then reduce partitions read back from
the .data/.index files), the coalesced AQE reader with its skew split,
map output statistics, partition coalescing and the broadcast exchange.
Both packages get the same rows (seeded numpy, NULLs, NaN, strings) in
the same partitions; every reduce partition holds the same rows in the
same order. For range, both draw their bounds from the same sample and
must draw the same ones. The twins of tests/test_parallel.py's exchange
cases and tests/test_storage_aqe.py's reader cases; the JAX runs happen
once a test run (torch_support.computed_once)."""

import numpy as np
import pyarrow as pa
import pytest

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    FilterExec,
    HashAggregateExec,
    MemoryScanExec,
    ProjectExec,
)
from blaze_tpu_torch.parallel import (
    BroadcastExchangeExec,
    CoalescedShuffleReader,
    ShuffleExchangeExec,
    plan_coalesced_partitions,
)
from blaze_tpu_torch.runtime.executor import run_plan

from torch_support import assert_arrow_equal, computed_once

N_PARTS = 4  # child partitions (map tasks)
ROWS = 300  # rows a child partition
# (mode, keys, reduce partitions, directions)
MODES = {
    "hash": (["k", "s"], 5, None),
    "single": ([], 1, None),
    "round_robin": ([], 6, None),
    "range_int": (["k", "v"], 7, [True, False]),
    "range_string_float": (["s", "x"], 5, [False, True]),
}


def partition_batches(p: int) -> pa.RecordBatch:
    """Child partition p: int keys with NULLs, a float with NaN and
    NULLs, a string with NULLs."""
    rng = np.random.default_rng(100 + p)
    x = rng.random(ROWS) * 10
    x[rng.integers(0, ROWS, 9)] = np.nan
    words = np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu"])
    return pa.record_batch({
        "k": pa.array(((p * ROWS + np.arange(ROWS)) % 10).astype(np.int32),
                      mask=rng.random(ROWS) < 0.05),
        "v": np.arange(p * ROWS, (p + 1) * ROWS, dtype=np.int64),
        "x": pa.array(x, mask=rng.random(ROWS) < 0.05),
        "s": pa.array(words[rng.integers(0, len(words), ROWS)],
                      mask=rng.random(ROWS) < 0.05),
    })


def port_scan(n_parts=N_PARTS):
    cbs = [ColumnBatch.from_arrow(partition_batches(p), device="cpu")
           for p in range(n_parts)]
    return MemoryScanExec([[cb] for cb in cbs], cbs[0].schema)


def _cpu():
    return ExecContext(device="cpu")


def _jax_results(tmp_dir):
    """Each mode's reduce partitions (Arrow tables) and bounds, from the
    JAX package."""
    from blaze_tpu import ColumnBatch as JBatch
    from blaze_tpu.exprs.ir import Col as JCol
    from blaze_tpu.ops import ExecContext as JContext
    from blaze_tpu.ops import MemoryScanExec as JScan
    from blaze_tpu.parallel import ShuffleExchangeExec as JExchange

    out = {}
    for name, (keys, n, asc) in MODES.items():
        jbs = [JBatch.from_arrow(partition_batches(p))
               for p in range(N_PARTS)]
        scan = JScan([[b] for b in jbs], jbs[0].schema)
        mode = "range" if name.startswith("range") else name
        ex = JExchange(scan, [JCol(k) for k in keys], n, mode,
                       shuffle_dir=str(tmp_dir), sort_ascending=asc)
        ctx = JContext()
        parts = [[b.to_arrow() for b in ex.execute(r, ctx)]
                 for r in range(n)]
        out[name] = (parts, ex._range_bounds,
                     ex.map_output_statistics(ctx))
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_exchange")
    return computed_once(tmp_path_factory, "torch-parallel-exchange",
                         lambda: _jax_results(d))


@pytest.mark.parametrize("name", sorted(MODES))
def test_exchange_partitions_equal_jax(jax_results, name, tmp_path):
    keys, n, asc = MODES[name]
    mode = "range" if name.startswith("range") else name
    ex = ShuffleExchangeExec(port_scan(), [Col(k) for k in keys], n, mode,
                             shuffle_dir=str(tmp_path), sort_ascending=asc)
    ctx = _cpu()
    got = [[b.to_arrow() for b in ex.execute(r, ctx)] for r in range(n)]
    exp_parts, exp_bounds, exp_sizes = jax_results[name]
    assert ex.partition_count == n
    assert ctx.metrics.counters["exchange_map_tasks"] == N_PARTS
    total = 0
    for r in range(n):
        g = pa.Table.from_batches(got[r]) if got[r] else None
        e = pa.Table.from_batches(exp_parts[r]) if exp_parts[r] else None
        assert (g is None) == (e is None), r
        if g is not None:
            assert_arrow_equal(g.combine_chunks(), e.combine_chunks())
            total += g.num_rows
    assert total == N_PARTS * ROWS
    if mode == "range":
        assert ex.range_bounds(ctx) == exp_bounds
        assert len(exp_bounds) == n - 1
    sizes = ex.map_output_statistics(ctx)
    assert len(sizes) == n and [s > 0 for s in sizes] == \
        [s > 0 for s in exp_sizes]


def test_range_partitions_are_ordered(tmp_path):
    """Every row of range partition r sorts after every row of r - 1
    (k ascending with NULL first, then v descending)."""
    ex = ShuffleExchangeExec(port_scan(), [Col("k"), Col("v")], 7, "range",
                             shuffle_dir=str(tmp_path),
                             sort_ascending=[True, False])
    ctx = _cpu()
    prev_max = None
    for r in range(7):
        rows = [(kk if kk is not None else -1, -vv)
                for b in ex.execute(r, ctx)
                for kk, vv in zip(*(b.to_pydict()[c] for c in ("k", "v")))]
        if not rows:
            continue
        if prev_max is not None:
            assert min(rows) > prev_max, r
        prev_max = max(rows)


def test_shuffle_exchange_end_to_end(tmp_path):
    ex = ShuffleExchangeExec(port_scan(), [Col("k")], 5,
                             shuffle_dir=str(tmp_path))
    final = HashAggregateExec(
        ex, keys=[(Col("k"), "k")],
        aggs=[(AggExpr(AggFn.SUM, Col("v")), "s"),
              (AggExpr(AggFn.COUNT_STAR, None), "n")],
        mode=AggMode.COMPLETE)
    out = run_plan(final, _cpu()).to_pydict()
    t = pa.concat_tables([pa.table(partition_batches(p).to_pydict())
                          for p in range(N_PARTS)]).to_pandas()
    exp = t.groupby("k", dropna=False).v.sum()
    got = dict(zip(out["k"], out["s"]))
    assert got == {(None if k != k else int(k)): int(v)
                   for k, v in exp.items()}
    assert sum(out["n"]) == N_PARTS * ROWS


def test_coalesced_reader_and_statistics(tmp_path):
    ex = ShuffleExchangeExec(port_scan(), [Col("k")], 8,
                             shuffle_dir=str(tmp_path))
    rd = CoalescedShuffleReader(ex, [(0, 4), (4, 8)])
    ctx = _cpu()
    assert rd.partition_count == 2
    assert sum(b.num_rows for p in range(2)
               for b in rd.execute(p, ctx)) == N_PARTS * ROWS
    stats = ex.map_output_statistics(ctx)
    assert len(stats) == 8 and sum(stats) > 0


def test_partial_reducer_spec(tmp_path):
    """Skew split: one reduce partition served by disjoint map ranges
    reproduces the whole partition."""
    ex = ShuffleExchangeExec(port_scan(3), [Col("k")], 4,
                             shuffle_dir=str(tmp_path))
    ctx = _cpu()
    full = sorted(v for b in CoalescedShuffleReader(ex, [(2, 3)]).execute(
        0, ctx) for v in b.to_pydict()["v"])
    split = CoalescedShuffleReader(ex, [(2, 3), (2, 3)],
                                   map_ranges=[(0, 1), (1, 3)])
    got = sorted(v for p in range(2) for b in split.execute(p, ctx)
                 for v in b.to_pydict()["v"])
    assert got == full and len(full) > 0


def test_plan_coalescing_algorithm():
    sizes = [10, 10, 10, 100, 5, 5, 5, 5]
    ranges = plan_coalesced_partitions(sizes, target_bytes=30)
    assert [p for s, e in ranges for p in range(s, e)] == list(range(8))
    for s, e in ranges:
        if e - s > 1:
            assert sum(sizes[s:e]) <= 60


def test_broadcast_exchange():
    bc = BroadcastExchangeExec(port_scan(2), num_partitions=3)
    ctx = _cpu()
    assert [sum(b.num_rows for b in bc.execute(p, ctx))
            for p in range(3)] == [2 * ROWS] * 3
    assert ctx.metrics.counters["broadcast_bytes"] == sum(
        len(p) for p in bc.broadcast_bytes(ctx))


def test_plan_display_and_map_retry(tmp_path):
    """The plan display names the exchange; a map task that fails once
    is retried (Spark's task retry) and counted."""
    calls = {"n": 0}

    class FlakyOnce(MemoryScanExec):
        def execute(self, partition, ctx):
            if partition == 1 and calls["n"] == 0:
                calls["n"] += 1
                raise IOError("transient")
            return super().execute(partition, ctx)

    base = port_scan()
    ex = ShuffleExchangeExec(FlakyOnce(base.partitions, base.schema),
                             [Col("k")], 3, shuffle_dir=str(tmp_path))
    op = ProjectExec(FilterExec(ex, Col("v") >= 0), [(Col("v"), "v")])
    s = op.display()
    assert s.index("ProjectExec") < s.index("FilterExec") < \
        s.index("ShuffleExchangeExec(hash, 3 partitions)")
    ctx = _cpu()
    assert run_plan(op, ctx).num_rows == N_PARTS * ROWS
    assert ctx.metrics.counters["task_retries"] == 1


def test_map_task_deterministic_failure_not_retried(tmp_path):
    """A map task that fails with a deterministic error fails the stage
    at once: only a transient failure is retried (the scheduler's
    classification)."""
    calls = {"n": 0}

    class Broken(MemoryScanExec):
        def execute(self, partition, ctx):
            if partition == 1:
                calls["n"] += 1
                raise ValueError("bad plan")
            return super().execute(partition, ctx)

    base = port_scan()
    ex = ShuffleExchangeExec(Broken(base.partitions, base.schema),
                             [Col("k")], 3, shuffle_dir=str(tmp_path))
    ctx = _cpu()
    with pytest.raises(Exception, match="bad plan"):
        run_plan(ex, ctx)
    assert calls["n"] == 1
    assert "task_retries" not in ctx.metrics.counters
