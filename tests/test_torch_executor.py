"""The PyTorch port end to end: TaskDefinition bytes made by the JAX
package run through both packages' `execute_task` on the CPU (the JAX
side with mesh_mode="off"), on small zstd parquet files made from a
seeded numpy generator. Plus the port's package rules: no jax or
blaze_tpu import, and no silent CPU run when CUDA is missing."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu.exprs.ir import AggExpr as JAggExpr, AggFn as JAggFn
from blaze_tpu.exprs.ir import Col as JCol
from blaze_tpu.exprs.ir import Literal as JLiteral
from blaze_tpu.ops import (
    AggMode as JAggMode,
    FilterExec as JFilter,
    HashAggregateExec as JAgg,
    ProjectExec as JProject,
    SortExec as JSort,
    SortKey as JSortKey,
)
from blaze_tpu.config import EngineConfig as JaxConfig
from blaze_tpu.ops.base import ExecContext as JaxContext
from blaze_tpu.ops.parquet_scan import FileRange as JRange
from blaze_tpu.ops.parquet_scan import ParquetScanExec as JScan
from blaze_tpu.plan.serde import task_to_proto as jax_task_to_proto
from blaze_tpu.runtime.executor import execute_task as jax_execute_task
from blaze_tpu.types import DataType as JDataType

from blaze_tpu_torch.config import EngineConfig
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    FileRange,
    FilterExec,
    HashAggregateExec,
    ParquetScanExec,
    ProjectExec,
)
from blaze_tpu_torch.plan.serde import task_to_proto
from blaze_tpu_torch.runtime.executor import execute_task, run_plan
from blaze_tpu_torch.types import DataType

import chip_smoke
from test_torch_hash_aggregate import assert_rows_equal
from torch_support import assert_arrow_equal

REPO = Path(__file__).resolve().parents[1]
ROWS = 20000


def _write(path, rows=ROWS, price_nulls_nan=False, seed=7):
    rng = np.random.default_rng(seed)
    item = rng.integers(0, 1 << 17, rows).astype(np.int32)
    qty = rng.integers(1, 10, rows).astype(np.int32)
    price = (rng.random(rows) * 100).astype(np.float32)
    mask = None
    if price_nulls_nan:
        price[rng.integers(0, rows, 50)] = np.nan
        mask = rng.random(rows) < 0.05
    pq.write_table(
        pa.table({"item": item, "qty": qty,
                  "price": pa.array(price, mask=mask)}),
        path, compression="zstd", row_group_size=4096,
    )
    return str(path)


def jax_q6(path, aggregate=True, threshold=50.0):
    """bench.py's q6 task shape, built with the JAX package."""
    proj = JProject(
        JFilter(JScan([[JRange(path)]]),
                (JCol("price") > threshold) & (JCol("qty") < 8)),
        [(JCol("price") * JCol("qty").cast(JDataType.float32()), "rev")],
    )
    if not aggregate:
        return proj
    return JAgg(proj, keys=[],
                aggs=[(JAggExpr(JAggFn.SUM, JCol("rev")), "t"),
                      (JAggExpr(JAggFn.COUNT_STAR, None), "n")],
                mode=JAggMode.COMPLETE)


def port_q6(path, aggregate=True):
    proj = ProjectExec(
        FilterExec(ParquetScanExec([[FileRange(path)]]),
                   (Col("price") > 50.0) & (Col("qty") < 8)),
        [(Col("price") * Col("qty").cast(DataType.float32()), "rev")],
    )
    if not aggregate:
        return proj
    return HashAggregateExec(
        proj, keys=[], aggs=[(AggExpr(AggFn.SUM, Col("rev")), "t"),
                             (AggExpr(AggFn.COUNT_STAR, None), "n")],
        mode=AggMode.COMPLETE)


def _both(blob):
    """Run one blob through both packages. The JAX side runs without
    host filter pushdown: pyarrow's compare drops NaN > x rows during
    decode, where the device predicate keeps them (Spark orders NaN
    above every value; ROADMAP section 3 records this). The port pushes
    the same conjuncts with Spark's order: a NaN row passes `>` on the
    host too, and the device filter decides it. (The port's pushdown is
    off by default; it is turned on here to hold its NaN rule.)"""
    got = list(execute_task(blob, ExecContext(
        device="cpu",
        config=EngineConfig(device="cpu", host_filter_pushdown=True))))
    exp = list(jax_execute_task(blob, JaxContext(
        config=JaxConfig(host_filter_pushdown=False), mesh_mode="off")))
    return got, exp


def _assert_q6(got, exp):
    assert len(got) == len(exp) == 1
    g, e = got[0], exp[0]
    assert g.schema.names == e.schema.names
    assert [f.type for f in g.schema] == [f.type for f in e.schema]
    assert g.column(1)[0].as_py() == e.column(1)[0].as_py()
    gs, es = g.column(0)[0].as_py(), e.column(0)[0].as_py()
    if es is None or gs is None:
        assert gs is None and es is None
    elif es != es:
        assert gs != gs
    else:
        assert abs(gs - es) <= 1e-12 * abs(es)
    return gs, g.column(1)[0].as_py()


@pytest.mark.parametrize("case", ["plain", "nulls_nan", "all_filtered",
                                  "empty_file"])
def test_q6_task_from_jax_blob(case, tmp_path):
    rows = 0 if case == "empty_file" else ROWS
    path = _write(tmp_path / "ss.parquet", rows=rows,
                  price_nulls_nan=case == "nulls_nan")
    blob = jax_task_to_proto(
        jax_q6(path, threshold=1000.0 if case == "all_filtered" else 50.0),
        0)
    got, exp = _both(blob)
    s, n = _assert_q6(got, exp)
    if case in ("all_filtered", "empty_file"):
        assert n == 0 and s is None
        return
    # independent numpy oracle with Spark's NaN order and null semantics
    t = pq.read_table(path)
    price = t.column("price").to_numpy(zero_copy_only=False)
    valid = ~np.asarray(t.column("price").is_null())
    qty = t.column("qty").to_numpy()
    live = valid & ((price > 50.0) | np.isnan(price)) & (qty < 8)
    assert n == int(live.sum())
    if case == "nulls_nan":
        assert s != s  # a NaN price among the live rows


@pytest.mark.parametrize("nulls_nan", [False, True])
def test_select_task_from_jax_blob(nulls_nan, tmp_path):
    """Filter and project with no aggregate: every output batch is
    compacted (K2's path); rows equal, in order."""
    path = _write(tmp_path / "ss.parquet", price_nulls_nan=nulls_nan)
    blob = jax_task_to_proto(jax_q6(path, aggregate=False), 0)
    got, exp = _both(blob)
    g = pa.Table.from_batches(got)
    e = pa.Table.from_batches(exp)
    assert g.num_rows > 0
    assert_arrow_equal(g, e)


def test_port_blob_runs_in_jax(tmp_path):
    """The reverse direction: the port's task_to_proto decodes and runs
    in the JAX package, with the same result."""
    path = _write(tmp_path / "ss.parquet")
    blob = task_to_proto(port_q6(path), 0)
    assert blob == jax_task_to_proto(jax_q6(path), 0)
    got, exp = _both(blob)
    _assert_q6(got, exp)


def test_unported_plan_node_raises(tmp_path):
    """Every plan arm decodes, range partitioning included: a JAX range
    map task writes the same partitions in the port. A remote file
    segment, the last thing the port refused here, decodes too since
    the transport tier is ported: the JAX package's reduce task reads
    its block over a BlockServer."""
    from blaze_tpu.ops import ShuffleWriterExec as JShuffleWriter
    from blaze_tpu.ops.ipc_reader import IpcReaderExec as JIpcReader
    from blaze_tpu.runtime.transport import RemoteSegment

    from blaze_tpu_torch.io.ipc import partition_ranges, read_file_segment

    path = _write(tmp_path / "ss.parquet", rows=100)
    tables = []
    for who, run in (("jax", lambda b: list(jax_execute_task(
            b, JaxContext(config=JaxConfig())))),
                     ("port", lambda b: list(execute_task(
                         b, ExecContext(device="cpu"))))):
        data, index = str(tmp_path / f"{who}.d"), str(tmp_path / f"{who}.i")
        blob = jax_task_to_proto(
            JShuffleWriter(JSort(JScan([[JRange(path)]]),
                                 [JSortKey(JCol("qty"))]),
                           [JCol("qty")], 2, data, index, mode="range",
                           range_bounds=[(5,)], sort_ascending=[True]), 0)
        assert run(blob) == []
        tables.append([pa.Table.from_batches(list(
            read_file_segment(data, o, n))) for o, n in
            partition_ranges(index)])
    for got, exp in zip(*reversed(tables)):
        assert_arrow_equal(got, exp)
    assert tables[1][0].column("qty").to_numpy().max() <= 5
    schema = tables[1][0].schema
    from blaze_tpu.types import from_arrow_schema as jax_from_arrow_schema

    from blaze_tpu_torch.runtime.transport import BlockServer

    data = str(tmp_path / "jax.d")
    off, n = partition_ranges(str(tmp_path / "jax.i"))[0]
    srv = BlockServer([str(tmp_path)]).start()
    try:
        host, port = srv.address
        blob = jax_task_to_proto(
            JIpcReader("in", jax_from_arrow_schema(schema), 1), 0,
            file_resources={"in": [RemoteSegment(host, port, data, off,
                                                  n)]})
        got = pa.Table.from_batches(
            execute_task(blob, ExecContext(device="cpu")))
    finally:
        srv.stop()
    assert_arrow_equal(got, tables[0][0])


def test_default_device_is_cuda_and_refuses_without_it(tmp_path):
    """execute_task(blob) with no context runs on cuda; with no CUDA it
    raises before any work, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default run would use it")
    path = _write(tmp_path / "ss.parquet", rows=100)
    blob = task_to_proto(port_q6(path), 0)
    assert ExecContext().device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        execute_task(blob)


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", "") == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_blaze_tpu():
    files = sorted((REPO / "blaze_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    # the serving tier's packages and the CLI are covered too
    assert {"service", "obs", "zerocopy", "testing"} <= {
        f.parent.name for f in files}
    assert REPO / "blaze_tpu_torch" / "__main__.py" in files
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "blaze_tpu"), (f, mod)


def test_cpu_path_leaves_jax_unloaded(tmp_path):
    """A process that runs the port's q6 task on the CPU never loads
    jax or blaze_tpu."""
    path = _write(tmp_path / "ss.parquet", rows=3000)
    code = (
        "import sys\n"
        "from blaze_tpu_torch.plan.serde import task_from_proto\n"
        "from blaze_tpu_torch.ops import ExecContext\n"
        "from blaze_tpu_torch.runtime.executor import execute_task\n"
        f"blob = open({str(tmp_path / 'blob')!r}, 'rb').read()\n"
        "out = list(execute_task(blob, ExecContext(device='cpu')))\n"
        "assert out[0].column(1)[0].as_py() > 0\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'blaze_tpu')]\n"
        "print('LOADED', bad)\n"
    )
    (tmp_path / "blob").write_bytes(task_to_proto(port_q6(path), 0))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def jax_grouped(path, mode=JAggMode.COMPLETE):
    """bench.py's grouped_agg task shape, built with the JAX package."""
    proj = JProject(JScan([[JRange(path)]]), [
        (JCol("item") % JLiteral(4096, JDataType.int32()), "g"),
        (JCol("price"), "price"), (JCol("qty"), "qty")])
    return JAgg(proj, keys=[(JCol("g"), "g")],
                aggs=[(JAggExpr(JAggFn.SUM, JCol("price")), "s"),
                      (JAggExpr(JAggFn.MIN, JCol("price")), "lo"),
                      (JAggExpr(JAggFn.MAX, JCol("price")), "hi"),
                      (JAggExpr(JAggFn.AVG, JCol("qty")), "aq")],
                mode=mode)


def _grouped_oracle(path):
    t = pq.read_table(path)
    return chip_smoke.grouped_oracle(*(t.column(c).to_numpy()
                                       for c in ("item", "qty", "price")))


def test_grouped_task_from_jax_blob(tmp_path):
    """The grouped task (keyed COMPLETE over g = item % 4096) made by the
    JAX package: equal to it row for row, and to chip_smoke's numpy
    oracle (bench.py's bincount/reduceat)."""
    path = _write(tmp_path / "ss.parquet")
    blob = jax_task_to_proto(jax_grouped(path), 0)
    got, exp = _both(blob)
    g, e = pa.Table.from_batches(got), pa.Table.from_batches(exp)
    assert g.num_rows > 4000
    assert_rows_equal(g, e)
    chip_smoke.check_grouped(g, _grouped_oracle(path), "grouped")


def test_port_grouped_blob_runs_in_jax(tmp_path):
    """The reverse direction: chip_smoke's grouped plan, serialized by
    the port, is the JAX package's blob byte for byte and runs there
    with the same rows."""
    path = _write(tmp_path / "ss.parquet", rows=5000)
    port = chip_smoke.grouped_plan(ParquetScanExec([[FileRange(path)]]),
                                   AggMode.COMPLETE)
    blob = task_to_proto(port, 0)
    assert blob == jax_task_to_proto(jax_grouped(path), 0)
    got, exp = _both(blob)
    assert_rows_equal(pa.Table.from_batches(got), pa.Table.from_batches(exp))


def test_grouped_partial_then_final(tmp_path):
    """The map-side form chip_smoke runs: a PARTIAL task (state batches
    equal to the JAX package's), then FINAL over its Arrow state
    batches through run_plan, against the numpy oracle."""
    path = _write(tmp_path / "ss.parquet")
    partial = chip_smoke.grouped_plan(
        ParquetScanExec([[FileRange(path)]]), AggMode.PARTIAL)
    blob = task_to_proto(partial, 0)
    assert blob == jax_task_to_proto(jax_grouped(path, JAggMode.PARTIAL), 0)
    states, exp = _both(blob)
    assert len(states) == len(exp) == 2
    for g, e in zip(states, exp):
        assert_rows_equal(pa.Table.from_batches([g]),
                          pa.Table.from_batches([e]))
    ctx = ExecContext(device="cpu")
    final = chip_smoke.final_plan(states, partial.schema, ctx.device)
    table = run_plan(final, ctx)
    chip_smoke.check_grouped(table, _grouped_oracle(path), "grouped_partial")
