"""Keyed fusion in the port (ops/fused.py's keyed FusedAggregateExec,
HostFinalAggExec, planner/fuse.py's keyed rewrites and
`_fuse_join_under_agg`), held against the JAX package on the CPU.

The same TaskDefinition bytes run through both packages'
`execute_task`: bench.py's grouped_agg (COMPLETE, and PARTIAL then a
FINAL in each package), join_agg on each table core (direct, key|row
over sparse keys, the generic table over a two-column key), the twin of
the JAX package's keyed 4-chunk stream, decimal SUM/AVG through the
grouped carry, and a stream whose groups outgrow the carry's slots (it
demotes; pandas is its second oracle). On the CPU the fused nodes run
their graph bodies eagerly; the graphs run on the card, in
chip_smoke.py. Tolerances: float64 SUM and AVG within 1e-9 relative
(the carry adds batch sums in stream order), everything else exact.
The JAX results are computed once a test run.
"""

from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu import ops as J
from blaze_tpu.config import EngineConfig as JaxConfig
from blaze_tpu.exprs.ir import AggExpr as JAggExpr, AggFn as JAggFn
from blaze_tpu.exprs.ir import Col as JCol, Literal as JLiteral
from blaze_tpu.ops.base import ExecContext as JaxContext
from blaze_tpu.ops.memory_scan import MemoryScanExec as JMemoryScan
from blaze_tpu.ops.parquet_scan import FileRange as JRange
from blaze_tpu.ops.parquet_scan import ParquetScanExec as JScan
from blaze_tpu.plan.serde import task_to_proto as jax_task_to_proto
from blaze_tpu.runtime.executor import execute_task as jax_execute_task
from blaze_tpu.types import DataType as JDataType

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.config import EngineConfig
from blaze_tpu_torch.exprs.ir import Col
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    FileRange,
    HashAggregateExec,
    HashJoinExec,
    JoinType,
    MemoryScanExec,
    ParquetScanExec,
    ProjectExec,
)
from blaze_tpu_torch.ops import fused as fused_mod
from blaze_tpu_torch.ops import hash_table as ht
from blaze_tpu_torch.ops.fused import (
    FusedAggregateExec,
    FusedPipelineExec,
    HostFinalAggExec,
)
from blaze_tpu_torch.planner.fuse import fuse_pipelines
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.executor import decode_task, execute_task

from torch_support import computed_once

ROWS = 8192
BATCH = 2048  # four batches a stream
ITEMS = 4096  # the item dimension's keys
I32 = JDataType.int32()


def _write(work):
    """store_sales (item, k, qty, price, price_d decimal(12, 2), wide
    decimal(30, 4)), the item dimension (i_item, i_brand) and a
    two-column-key dimension (i_item, i_item3 = 3 * i_item, i_brand)."""
    rng = np.random.default_rng(14)
    item = rng.integers(0, ITEMS, ROWS).astype(np.int32)
    k = rng.integers(0, 1 << 17, ROWS).astype(np.int32)
    qty = rng.integers(1, 10, ROWS).astype(np.int32)
    price = (rng.random(ROWS) * 100).astype(np.float32)
    cents = rng.integers(-10**9, 10**9, ROWS)
    wide = rng.integers(-10**17, 10**17, ROWS)
    fact = pa.table({
        "item": item, "k": k, "qty": qty, "price": price,
        "price_d": pa.array([Decimal(int(c)).scaleb(-2) for c in cents],
                            pa.decimal128(12, 2)),
        "wide": pa.array([Decimal(int(w) * 10**12).scaleb(-4)
                          for w in wide], pa.decimal128(30, 4))})
    paths = {"fact": str(work / "fact.parquet"),
             "dim": str(work / "dim.parquet"),
             "dim2": str(work / "dim2.parquet"),
             "twice": str(work / "twice.parquet")}
    pq.write_table(fact, paths["fact"], row_group_size=ROWS)
    brands = rng.integers(0, 64, ITEMS).astype(np.int32)
    ids = np.arange(ITEMS, dtype=np.int32)
    pq.write_table(pa.table({"i_item": ids, "i_brand": brands}),
                   paths["dim"])
    pq.write_table(pa.table({"i_item": ids, "i_item3": ids * 3,
                             "i_brand": brands}), paths["dim2"])
    pq.write_table(pa.table({"i_item": np.tile(ids, 2),
                             "i_brand": np.tile(brands, 2)}),
                   paths["twice"])
    return paths, fact.to_pandas(), brands


def _scan(path):
    return JScan([[JRange(path)]])


def _grouped(path, mode):
    """bench.py's grouped_agg: g = item % 64, SUM/MIN/MAX(price),
    AVG(qty)."""
    proj = J.ProjectExec(_scan(path), [
        (JCol("item") % JLiteral(64, I32), "g"), (JCol("price"), "price"),
        (JCol("qty"), "qty")])
    return J.HashAggregateExec(proj, keys=[(JCol("g"), "g")], aggs=[
        (JAggExpr(JAggFn.SUM, JCol("price")), "sum_p"),
        (JAggExpr(JAggFn.MIN, JCol("price")), "lo"),
        (JAggExpr(JAggFn.MAX, JCol("price")), "hi"),
        (JAggExpr(JAggFn.AVG, JCol("qty")), "avg_q")], mode=mode)


def _join_agg(paths, core):
    """bench.py's join_agg: per brand SUM(price), COUNT(*) over the fact
    joined with the item dimension; `core` picks the keys: direct
    (dense), kr (both keys times 16: sparse), generic (two keys) or
    sorted (every dimension row twice: the materialized pairs)."""
    fact, dim = _scan(paths["fact"]), _scan(paths["dim"])
    if core == "sorted":
        dim = _scan(paths["twice"])
    if core in ("direct", "sorted"):
        lk, rk = ["i_item"], ["item"]
        probe = J.ProjectExec(fact, [(JCol("item"), "item"),
                                     (JCol("price"), "price")])
    elif core == "kr":
        lk, rk = ["i_item"], ["item"]
        dim = J.ProjectExec(dim, [(JCol("i_item") * JLiteral(16, I32),
                                   "i_item"), (JCol("i_brand"), "i_brand")])
        probe = J.ProjectExec(fact, [(JCol("item") * JLiteral(16, I32),
                                      "item"), (JCol("price"), "price")])
    else:
        dim = _scan(paths["dim2"])
        lk, rk = ["i_item", "i_item3"], ["item", "item3"]
        probe = J.ProjectExec(fact, [
            (JCol("item"), "item"), (JCol("item") * JLiteral(3, I32),
                                     "item3"), (JCol("price"), "price")])
    join = J.HashJoinExec(dim, probe, lk, rk, J.JoinType.INNER)
    return J.HashAggregateExec(
        J.ProjectExec(join, [(JCol("i_brand"), "brand"),
                             (JCol("price"), "price")]),
        keys=[(JCol("brand"), "brand")],
        aggs=[(JAggExpr(JAggFn.SUM, JCol("price")), "sum_rev"),
              (JAggExpr(JAggFn.COUNT_STAR, None), "cnt")],
        mode=J.AggMode.COMPLETE)


def _chunk4(path):
    """The twin of the JAX package's keyed 4-chunk stream
    (test_dispatch_budget.py::test_keyed_multi_chunk_carry_budget_and_
    oracle): a filter, then g keyed SUM, COUNT(*), MIN, MAX, AVG."""
    proj = J.ProjectExec(_scan(path), [
        (JCol("item") % JLiteral(64, I32), "g"), (JCol("price"), "price"),
        (JCol("qty"), "qty")])
    return J.HashAggregateExec(
        J.FilterExec(proj, JCol("price") > 25.0), keys=[(JCol("g"), "g")],
        aggs=[(JAggExpr(JAggFn.SUM, JCol("price")), "sum_s"),
              (JAggExpr(JAggFn.COUNT_STAR, None), "n"),
              (JAggExpr(JAggFn.MIN, JCol("price")), "lo"),
              (JAggExpr(JAggFn.MAX, JCol("price")), "hi"),
              (JAggExpr(JAggFn.AVG, JCol("qty")), "avg_q")],
        mode=J.AggMode.COMPLETE)


def _decimal(path):
    """Decimal SUM/AVG through the grouped carry: decimal(12, 2) and
    decimal(30, 4) chunk states, g = item % 64."""
    proj = J.ProjectExec(_scan(path), [
        (JCol("item") % JLiteral(64, I32), "g"), (JCol("price_d"), "d"),
        (JCol("wide"), "w")])
    return J.HashAggregateExec(proj, keys=[(JCol("g"), "g")], aggs=[
        (JAggExpr(JAggFn.SUM, JCol("d")), "sum_d"),
        (JAggExpr(JAggFn.AVG, JCol("d")), "avg_d"),
        (JAggExpr(JAggFn.SUM, JCol("w")), "sum_w"),
        (JAggExpr(JAggFn.AVG, JCol("w")), "avg_w")],
        mode=J.AggMode.COMPLETE)


def _demote(path):
    """GROUP BY k (values in [0, 2^17)): more groups than a batch's
    slots, so the grouped carry demotes mid-stream."""
    return J.HashAggregateExec(
        J.ProjectExec(_scan(path), [(JCol("k"), "k"),
                                    (JCol("price"), "price")]),
        keys=[(JCol("k"), "k")],
        aggs=[(JAggExpr(JAggFn.SUM, JCol("price")), "sum_p"),
              (JAggExpr(JAggFn.COUNT_STAR, None), "cnt"),
              (JAggExpr(JAggFn.MAX, JCol("price")), "hi")],
        mode=J.AggMode.COMPLETE)


def _jax_cfg():
    return JaxConfig(batch_size=BATCH, host_filter_pushdown=False)


def _jax_final(partial, states):
    """The JAX package's FINAL over its PARTIAL task's state batches."""
    from blaze_tpu.batch import ColumnBatch as JColumnBatch
    from blaze_tpu.runtime.executor import run_plan

    final = J.HashAggregateExec(
        JMemoryScan([[JColumnBatch.from_arrow(rb) for rb in states]],
                    partial.schema),
        keys=[(JCol("g"), "g")], aggs=list(partial.aggs),
        mode=J.AggMode.FINAL)
    return run_plan(final, JaxContext(config=_jax_cfg(), mesh_mode="off"))


def _plans(paths):
    return {
        "grouped": lambda: _grouped(paths["fact"], J.AggMode.COMPLETE),
        "partial": lambda: _grouped(paths["fact"], J.AggMode.PARTIAL),
        "join_direct": lambda: _join_agg(paths, "direct"),
        "join_kr": lambda: _join_agg(paths, "kr"),
        "join_generic": lambda: _join_agg(paths, "generic"),
        "join_sorted": lambda: _join_agg(paths, "sorted"),
        "chunk4": lambda: _chunk4(paths["fact"]),
        "decimal": lambda: _decimal(paths["fact"]),
        "demote": lambda: _demote(paths["fact"]),
    }


def _jax_run(paths, name):
    """(TaskDefinition bytes, the JAX package's batches) of one plan; for
    the PARTIAL task, the batches of a FINAL over its states and the
    state batch count."""
    plan = _plans(paths)[name]()
    blob = jax_task_to_proto(plan, 0)
    got = list(jax_execute_task(blob, JaxContext(config=_jax_cfg(),
                                                 mesh_mode="off")))
    if name == "partial":
        got = _jax_final(plan, got).to_batches() + [len(got)]
    return blob, got


class _Side:
    """The files (written once a test run) and each plan's JAX result,
    computed once a test run on whichever xdist worker asks first, so
    the workers share the compiles."""

    def __init__(self, tmp_path_factory):
        self._factory = tmp_path_factory
        self.paths = computed_once(
            tmp_path_factory, "fused-keyed-files",
            lambda: _write(tmp_path_factory.mktemp("keyed"))[0])
        self.fact = pq.read_table(self.paths["fact"]).to_pandas()

    def jax(self, name):
        return computed_once(self._factory, f"fused-keyed-{name}",
                             lambda: _jax_run(self.paths, name))


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    return _Side(tmp_path_factory)


def _ctx():
    return ExecContext(device="cpu", config=EngineConfig(batch_size=BATCH))


def _port(blob):
    with dispatch.counting() as c:
        got = list(execute_task(blob, _ctx()))
    return pa.Table.from_batches(got), c.counts


def _table(batches):
    return pa.Table.from_batches(batches)


def _assert_same(got: pa.Table, exp: pa.Table, key: str):
    """Sorted by `key`: keys, counts, MIN, MAX and decimals exact,
    float64 SUM and AVG within 1e-9 relative."""
    assert got.schema.names == exp.schema.names
    assert [f.type for f in got.schema] == [f.type for f in exp.schema]
    g, e = got.sort_by(key), exp.sort_by(key)
    assert g.num_rows == e.num_rows
    for name in e.schema.names:
        gc, ec = g.column(name).combine_chunks(), e.column(name)
        ec = ec.combine_chunks()
        np.testing.assert_array_equal(np.asarray(gc.is_null()),
                                      np.asarray(ec.is_null()), name)
        if pa.types.is_floating(gc.type) and \
                name.startswith(("sum", "avg")):
            np.testing.assert_allclose(gc.fill_null(0).to_numpy(),
                                       ec.fill_null(0).to_numpy(),
                                       rtol=1e-9, atol=0, err_msg=name)
        else:
            assert gc.equals(ec), name


@pytest.mark.parametrize("name,key", [
    ("grouped", "g"), ("join_direct", "brand"), ("join_kr", "brand"),
    ("join_generic", "brand"), ("join_sorted", "brand"), ("chunk4", "g"),
    ("decimal", "g"), ("demote", "k")])
def test_keyed_task_matches_jax(side, name, key):
    blob, exp = side.jax(name)
    got, counts = _port(blob)
    assert got.num_rows > 0
    _assert_same(got, _table(exp), key)
    # the port ran its fused bodies: four batches, eagerly on the CPU
    assert counts["graph_eager_batches"] >= 4
    if name == "join_sorted":
        # the materialized pairs: per-batch states, no carry
        assert counts["join_core.sorted"] == 1
        assert "d2h_syncs.carry_guard" not in counts


@pytest.mark.parametrize("name,key", [
    ("grouped", "g"), ("join_kr", "brand"), ("demote", "k")])
def test_eager_grouping_on_the_card_matches_jax(side, name, key,
                                                 monkeypatch):
    """On the card a batch no graph can take groups eagerly, reading the
    direct-or-hash branch and each probe round back
    (`fused._eager_rounds` None); the same answers."""
    monkeypatch.setattr(fused_mod, "_eager_rounds", lambda device: None)
    blob, exp = side.jax(name)
    got, counts = _port(blob)
    _assert_same(got, _table(exp), key)
    assert counts["d2h_syncs.group_branch"] >= 4


def test_partial_then_final_matches_jax(side):
    """The PARTIAL task: a FusedAggregateExec, one state batch a batch,
    its states on the device; a FINAL over them equals the JAX
    package's FINAL over its own."""
    from blaze_tpu_torch.runtime.executor import run_plan

    blob, exp = side.jax("partial")
    ctx = _ctx()
    op, _ = decode_task(blob, ctx)
    assert isinstance(op, FusedAggregateExec) and not op.fetch_host
    with dispatch.counting() as c:
        states = list(execute_task(blob, _ctx()))
    # one state batch a batch, as the JAX package's; each batch's count
    # read back, its states left on the device
    assert len(states) == exp[-1] == 4
    assert c.counts["d2h_syncs.n_groups"] == 4
    final = HashAggregateExec(
        MemoryScanExec([[ColumnBatch.from_arrow(rb, device="cpu")
                         for rb in states]], op.schema),
        keys=[(Col("g"), "g")], aggs=list(op.agg.aggs), mode=AggMode.FINAL)
    _assert_same(run_plan(final, ctx), _table(exp[:-1]), "g")


def test_demoted_stream_equals_pandas(side):
    """The demoting stream against pandas, and its counters: the carry
    demoted once, and the rest of the stream ran batch by batch under a
    device FINAL."""
    fact = side.fact
    got, counts = _port(side.jax("demote")[0])
    assert counts["carry_demotions"] == 1
    exp = fact.assign(p64=fact["price"].astype(np.float64)).groupby(
        "k").agg(sum_p=("p64", "sum"), cnt=("price", "size"),
                 hi=("price", "max"))
    g = got.to_pandas().sort_values("k").set_index("k")
    assert list(g.index) == list(exp.index)
    np.testing.assert_array_equal(g["cnt"].to_numpy(), exp["cnt"].to_numpy())
    np.testing.assert_array_equal(g["hi"].to_numpy(), exp["hi"].to_numpy())
    np.testing.assert_allclose(g["sum_p"].to_numpy(),
                               exp["sum_p"].to_numpy(), rtol=1e-9)


def test_round_overflow_stays_exact(side, monkeypatch):
    """One probe round a graph: most rows overflow the grouping, so the
    carry demotes, every batch climbs its ladder and ends in the eager
    run that probes until every row has a slot; the answer is the
    JAX package's all the same."""
    monkeypatch.setattr(fused_mod, "GRAPH_ROUNDS", 1)
    blob, exp = side.jax("demote")
    got, counts = _port(blob)
    assert counts["group_round_overflow"] >= 1
    assert counts["carry_demotions"] == 1
    _assert_same(got, _table(exp), "k")


def test_one_batch_overflow_takes_the_ladder(side, monkeypatch):
    """A one-batch stream whose carry overflows re-runs that batch on
    the per-batch ladder."""
    monkeypatch.setattr(fused_mod, "GRAPH_ROUNDS", 1)
    blob, exp = side.jax("demote")
    with dispatch.counting() as c:
        got = list(execute_task(blob, ExecContext(
            device="cpu", config=EngineConfig(batch_size=ROWS))))
    assert c.counts["group_round_overflow"] == 1
    assert "carry_demotions" not in c.counts
    _assert_same(pa.Table.from_batches(got), _table(exp), "k")


# ---------------------------------------------------------------------------
# the rewrites
# ---------------------------------------------------------------------------

def _port_join_agg(paths, join_type=JoinType.INNER, build_filter=False):
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn
    from blaze_tpu_torch.ops import FilterExec

    dim = ParquetScanExec([[FileRange(paths["dim"])]])
    if build_filter:
        dim = FilterExec(dim, Col("i_brand") < 30)
    probe = ProjectExec(ParquetScanExec([[FileRange(paths["fact"])]]),
                        [(Col("item"), "item"), (Col("price"), "price")])
    join = HashJoinExec(dim, probe, ["i_item"], ["item"], join_type)
    return HashAggregateExec(
        ProjectExec(join, [(Col("i_brand"), "brand"),
                           (Col("price"), "price")]),
        keys=[(Col("brand"), "brand")],
        aggs=[(AggExpr(AggFn.SUM, Col("price")), "sum_rev")],
        mode=AggMode.COMPLETE), join


def test_join_under_agg_fuses_both_chains(side):
    plan, join = _port_join_agg(side.paths, build_filter=True)
    op = fuse_pipelines(plan)
    assert isinstance(op, HostFinalAggExec) and not op.to_device
    agg = op.children[0]
    assert isinstance(agg, FusedAggregateExec) and agg.fetch_host
    assert agg.pipeline.children[0] is join and agg.children == [join]
    # the build chain, one stage, is one pipeline
    assert isinstance(join.children[0], FusedPipelineExec)
    assert len(join.children[0].stages) == 1
    # the probe chain is the join's child and its recorded fold
    pipe = join.children[1]
    assert isinstance(pipe, FusedPipelineExec)
    assert join._fused_probe == (pipe.children[0], pipe)
    assert isinstance(pipe.children[0], ParquetScanExec)


@pytest.mark.parametrize("join_type", [JoinType.LEFT, JoinType.FULL])
def test_outer_join_under_agg_stays(side, join_type):
    """An OUTER join under the aggregate is left as it is: no
    `_fused_probe`, its probe chain of one stage not fused."""
    plan, join = _port_join_agg(side.paths, join_type)
    op = fuse_pipelines(plan)
    assert isinstance(op, HostFinalAggExec)
    assert op.children[0].pipeline.children[0] is join
    assert not hasattr(join, "_fused_probe")
    assert isinstance(join.children[1], ProjectExec)
    out = pa.Table.from_batches([b.to_arrow() for b in
                                 op.execute(0, _ctx())])
    assert out.num_rows > 0


def test_keyed_rewrite_is_to_device_below_the_root(side):
    """A keyed COMPLETE aggregate under another operator copies its
    host result to the context's device (`to_device`); at the root it
    stays on the host."""
    plan, _ = _port_join_agg(side.paths)
    op = fuse_pipelines(ProjectExec(plan, [(Col("brand"), "b")]))
    assert isinstance(op.children[0], HostFinalAggExec)
    assert op.children[0].to_device


def test_string_key_keeps_the_eager_aggregate(tmp_path):
    """String keys (dictionary codes) stay on today's route: the JAX
    package's `_agg_exprs_fusable` refuses them."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn

    path = str(tmp_path / "s.parquet")
    pq.write_table(pa.table({"s": ["a", "b", "a"], "v": [1, 2, 3]}), path)
    proj = ProjectExec(ParquetScanExec([[FileRange(path)]]),
                       [(Col("s"), "s"), (Col("v"), "v")])
    op = fuse_pipelines(HashAggregateExec(
        proj, keys=[(Col("s"), "s")],
        aggs=[(AggExpr(AggFn.SUM, Col("v")), "t")], mode=AggMode.COMPLETE))
    assert isinstance(op, HashAggregateExec)
    assert isinstance(op.children[0], FusedPipelineExec)


def test_first_last_and_bool_extremes_run_eagerly(tmp_path):
    """FIRST/LAST and bool MIN/MAX have no carry plan: the keyed fused
    aggregate takes its per-batch path and runs every batch eagerly."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn

    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"g": [1, 2, 1, 2], "v": [5, 6, 7, 8],
                             "b": [True, False, False, True]}), path)
    proj = ProjectExec(ParquetScanExec([[FileRange(path)]]),
                       [(Col("g"), "g"), (Col("v"), "v"), (Col("b"), "b")])
    for agg in ((AggExpr(AggFn.FIRST, Col("v")), "x"),
                (AggExpr(AggFn.MIN, Col("b")), "x")):
        op = fuse_pipelines(HashAggregateExec(
            proj, keys=[(Col("g"), "g")], aggs=[agg],
            mode=AggMode.COMPLETE))
        fused = op.children[0]
        assert fused.plan is None and not fused.capturable
        out = pa.Table.from_batches(
            [b.to_arrow() for b in op.execute(0, _ctx())]).sort_by("g")
        want = [5, 6] if agg[0].fn is AggFn.FIRST else [False, False]
        assert out.column("x").to_pylist() == want


# ---------------------------------------------------------------------------
# the graph forms of the hash table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", ["int_direct", "int_wide", "float_multi"])
def test_static_group_slots_equal_the_eager_ones(keys):
    """`group_slots(static=True)` (both arms, fixed rounds, no readback)
    gives the eager slots and table wherever nothing overflows."""
    rng = np.random.default_rng(3)
    n = 4096
    if keys == "int_direct":
        cols = [(torch.from_numpy(rng.integers(0, 500, n).astype(
            np.int32)), None)]
    elif keys == "int_wide":
        cols = [(torch.from_numpy(rng.integers(-2**40, 2**40, n)), None)]
    else:
        f = rng.integers(0, 50, n).astype(np.float32)
        f[:7] = [np.nan, -0.0, 0.0, np.nan, 1.5, -1.5, np.inf]
        cols = [(torch.from_numpy(f), None),
                (torch.from_numpy(rng.integers(0, 3, n).astype(np.int16)),
                 torch.from_numpy(rng.random(n) < 0.9))]
    live = torch.from_numpy(rng.random(n) < 0.95)
    tsize = ht.table_size_for(n)
    e_slot, e_tab, _ = ht.group_slots(cols, live, n, tsize)
    s_slot, s_tab, ovf = ht.group_slots(cols, live, n, tsize,
                                        max_rounds=16, static=True)
    assert not bool(ovf)
    assert torch.equal(e_tab, s_tab)
    assert torch.equal(e_slot[live], s_slot[live])


@pytest.mark.parametrize("kind", ["kr", "generic"])
def test_fixed_round_lookups_equal_the_open_ones(kind):
    """`probe_rounds` bounds every probe of a table, so a lookup of that
    many rounds, with no readback, gives the open loop's matches."""
    rng = np.random.default_rng(5)
    nb, np_ = 3000, 5000
    bkeys = torch.from_numpy(rng.permutation(1 << 20)[:nb].astype(np.int32))
    pkeys = torch.from_numpy(np.where(
        rng.random(np_) < 0.5, bkeys.numpy()[rng.integers(0, nb, np_)],
        rng.integers(0, 1 << 20, np_)).astype(np.int32))
    live_b = torch.ones(nb, dtype=torch.bool)
    live_p = torch.from_numpy(rng.random(np_) < 0.9)
    tsize = ht.probe_table_size(nb)
    hb = ht.cheap_hash([(bkeys, None)], nb)
    hp = ht.cheap_hash([(pkeys, None)], np_)
    if kind == "kr":
        tab, _ = ht.insert_kr(ht.key_u32(bkeys, None), hb, live_b, nb, tsize)
        rounds = ht.probe_rounds(tab, ht.KR_EMPTY)
        args = (tab, ht.key_u32(pkeys, None), hp, live_p)
        open_ = ht.lookup_kr(*args)
        fixed = ht.lookup_kr(*args, rounds=rounds)
    else:
        _, tab, _, _ = ht.insert(hb, [(bkeys, None)], live_b, nb, tsize,
                                 null_equal=False)
        rounds = ht.probe_rounds(tab, nb)
        args = (tab, hp, [(pkeys, None)], [(bkeys, None)], live_p, nb)
        open_ = ht.lookup(*args)
        fixed = ht.lookup(*args, rounds=rounds)
    assert rounds >= 1
    assert torch.equal(open_[0], fixed[0]) and torch.equal(open_[1],
                                                           fixed[1])
    assert int(fixed[1].sum()) > 1000
