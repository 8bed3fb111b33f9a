"""The port's dispatch budget for keyed fusion, from its counters on the
CPU (runtime/dispatch): the twin of the JAX package's
tests/test_dispatch_budget.py for the grouped carry and the fused
join+aggregate.

On the CPU every fused batch runs its graph body eagerly and counts in
`graph_eager_batches`; readbacks (`d2h_syncs`) and fetches
(`d2h_fetches`) are counted as on the card, where chip_smoke.py gates
the same budgets with one graph replay a batch:

- a one-batch keyed COMPLETE task: no readback, one fetch;
- a keyed 4-batch stream: one readback a batch (the carry's overflow
  guard), one fetch;
- join_agg: beyond the build's readbacks, one a probe batch at most
  (none for a one-batch stream), none a probe round;
- a keyed PARTIAL task: its group count read back once a batch, its
  states left on the device.

Each task's answer is held against numpy as well.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch.config import EngineConfig
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col, Literal
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    FileRange,
    FilterExec,
    HashAggregateExec,
    HashJoinExec,
    JoinType,
    ParquetScanExec,
    ProjectExec,
)
from blaze_tpu_torch.plan.serde import task_to_proto
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.executor import execute_task
from blaze_tpu_torch.types import DataType

BATCH = 2048
ITEMS = 1024
BUILD_SYNCS = ("d2h_syncs.join_keyspan", "d2h_syncs.join_dup",
               "d2h_syncs.join_insert_round", "d2h_syncs.join_chain_round")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    work = tmp_path_factory.mktemp("budget")
    rng = np.random.default_rng(21)
    n = 4 * BATCH
    data = {"item": rng.integers(0, ITEMS, n).astype(np.int32),
            "qty": rng.integers(1, 10, n).astype(np.int32),
            "price": (rng.random(n) * 100).astype(np.float32)}
    paths = {"fact": str(work / "fact.parquet"),
             "small": str(work / "small.parquet"),
             "dim": str(work / "dim.parquet")}
    pq.write_table(pa.table(data), paths["fact"], row_group_size=n)
    pq.write_table(pa.table({k: v[:1000] for k, v in data.items()}),
                   paths["small"])
    brands = rng.integers(0, 32, ITEMS).astype(np.int32)
    pq.write_table(pa.table({"i_item": np.arange(ITEMS, dtype=np.int32),
                             "i_brand": brands}), paths["dim"])
    return paths, data, brands


def _scan(path):
    return ParquetScanExec([[FileRange(path)]])


def _grouped(path, mode=AggMode.COMPLETE, filtered=True):
    proj = ProjectExec(_scan(path), [
        (Col("item") % Literal(16, DataType.int32()), "g"),
        (Col("price"), "price"), (Col("qty"), "qty")])
    child = FilterExec(proj, Col("price") > 25.0) if filtered else proj
    return HashAggregateExec(child, keys=[(Col("g"), "g")], aggs=[
        (AggExpr(AggFn.SUM, Col("price")), "s"),
        (AggExpr(AggFn.COUNT_STAR, None), "n"),
        (AggExpr(AggFn.MIN, Col("price")), "lo"),
        (AggExpr(AggFn.MAX, Col("price")), "hi"),
        (AggExpr(AggFn.AVG, Col("qty")), "aq")], mode=mode)


def _join_agg(paths, scale=1):
    def key(name):
        c = Col(name)
        return c if scale == 1 else c * Literal(scale, DataType.int32())

    dim = _scan(paths["dim"])
    if scale != 1:
        dim = ProjectExec(dim, [(key("i_item"), "i_item"),
                                (Col("i_brand"), "i_brand")])
    probe = ProjectExec(_scan(paths["fact"]), [(key("item"), "item"),
                                               (Col("price"), "price")])
    join = HashJoinExec(dim, probe, ["i_item"], ["item"], JoinType.INNER)
    return HashAggregateExec(
        ProjectExec(join, [(Col("i_brand"), "brand"),
                           (Col("price"), "price")]),
        keys=[(Col("brand"), "brand")],
        aggs=[(AggExpr(AggFn.SUM, Col("price")), "rev"),
              (AggExpr(AggFn.COUNT_STAR, None), "cnt")],
        mode=AggMode.COMPLETE)


def _run(plan):
    blob = task_to_proto(plan, 0)
    with dispatch.counting() as c:
        out = pa.Table.from_batches(list(execute_task(blob, ExecContext(
            device="cpu", config=EngineConfig(batch_size=BATCH)))))
    return out, c.counts


def _check_grouped(out, data, rows):
    item, price = data["item"][:rows], data["price"][:rows]
    keep = price > 25.0
    g = (item % 16)[keep]
    p = price[keep].astype(np.float64)
    t = out.sort_by("g")
    assert t.column("g").to_pylist() == sorted(set(g.tolist()))
    np.testing.assert_array_equal(t.column("n").to_numpy(),
                                  np.bincount(g, minlength=16))
    np.testing.assert_allclose(t.column("s").to_numpy(),
                               np.bincount(g, p, minlength=16), rtol=1e-9)
    assert t.column("hi").to_pylist() == [
        float(price[keep][g == k].max()) for k in range(16)]


def test_one_batch_keyed_complete_costs_no_sync_and_one_fetch(files):
    paths, data, _ = files
    out, counts = _run(_grouped(paths["small"]))
    _check_grouped(out, data, 1000)
    assert "d2h_syncs" not in counts
    assert counts["d2h_fetches"] == 1
    assert counts["graph_eager_batches"] == 1


def test_four_batch_stream_costs_a_guard_a_batch_and_one_fetch(files):
    paths, data, _ = files
    out, counts = _run(_grouped(paths["fact"]))
    _check_grouped(out, data, 4 * BATCH)
    assert counts["graph_eager_batches"] == 4
    assert counts["d2h_syncs"] == counts["d2h_syncs.carry_guard"] == 4
    assert counts["d2h_fetches"] == 1
    assert "carry_demotions" not in counts


def _check_join(out, data, brands, rows):
    b = brands[data["item"][:rows]]
    t = out.sort_by("brand")
    np.testing.assert_array_equal(t.column("cnt").to_numpy(),
                                  np.bincount(b, minlength=32))
    np.testing.assert_allclose(
        t.column("rev").to_numpy(),
        np.bincount(b, data["price"][:rows].astype(np.float64),
                    minlength=32), rtol=1e-9)


def _probe_syncs(counts):
    return counts.get("d2h_syncs", 0) - sum(counts.get(k, 0)
                                            for k in BUILD_SYNCS)


def test_one_batch_join_agg_adds_no_sync_beyond_the_build(files):
    paths, data, brands = files
    small = dict(paths, fact=paths["small"])
    out, counts = _run(_join_agg(small))
    _check_join(out, data, brands, 1000)
    assert counts["join_core.table_direct"] == 1
    assert _probe_syncs(counts) == 0
    assert counts["d2h_fetches"] == 1


@pytest.mark.parametrize("scale,core", [(1, "table_direct"),
                                        (16, "table_kr")])
def test_join_agg_stream_costs_a_guard_a_probe_batch(files, scale, core):
    paths, data, brands = files
    out, counts = _run(_join_agg(paths, scale))
    _check_join(out, data, brands, 4 * BATCH)
    assert counts["join_core." + core] == 1
    assert _probe_syncs(counts) == counts["d2h_syncs.carry_guard"] == 4
    assert "d2h_syncs.join_probe_round" not in counts
    assert counts["d2h_fetches"] == 1
    if core == "table_kr":
        # the table's probe-round bound, read once per build
        assert counts["d2h_syncs.join_chain_round"] >= 1


def test_keyed_partial_reads_its_count_once_a_batch(files):
    paths, _, _ = files
    out, counts = _run(_grouped(paths["fact"], AggMode.PARTIAL,
                                filtered=False))
    assert out.num_rows == 4 * 16  # one state batch a batch
    assert counts["d2h_syncs"] == counts["d2h_syncs.n_groups"] == 4
    assert counts["graph_eager_batches"] == 4


def test_wide_key_range_reruns_its_first_batch_with_both_arms(files):
    """A key range past the table (item * 100,003) fails the direct arm
    that a one-integer-key grouping tries first: that batch runs again
    with both arms, from the same carry (one more readback), and the
    rest of the stream takes both arms at once."""
    paths, data, _ = files
    proj = ProjectExec(_scan(paths["fact"]), [
        (Col("item").cast(DataType.int64()) * Literal(100003,
                                                      DataType.int64()),
         "k"), (Col("price"), "price")])
    out, counts = _run(HashAggregateExec(
        proj, keys=[(Col("k"), "k")],
        aggs=[(AggExpr(AggFn.COUNT_STAR, None), "n")],
        mode=AggMode.COMPLETE))
    t = out.sort_by("k")
    keys, cnt = np.unique(data["item"].astype(np.int64) * 100003,
                          return_counts=True)
    np.testing.assert_array_equal(t.column("k").to_numpy(), keys)
    np.testing.assert_array_equal(t.column("n").to_numpy(), cnt)
    assert counts["graph_eager_batches"] == 5
    assert counts["d2h_syncs"] == counts["d2h_syncs.carry_guard"] == 5
    assert counts["d2h_fetches"] == 1
