"""The port's window operator (ops/window.py) against the JAX package's
and a Python oracle, on the CPU.

One batch of 300 rows in a 512-row buffer (nullable int32 partition
and order keys with ties, nullable int32, float64 and float32 values)
goes through both packages' WindowExec with every function and frame:
row_number, rank, dense_rank, ntile, percent_rank, cume_dist, lag/lead
at offsets 0-3, and sum/min/max/count/avg over the whole partition,
ROWS frames bounded and not, RANGE UNBOUNDED..CURRENT and RANGE value
offsets. The Python oracle sorts with numpy's stable lexsort and sums
each frame with math.fsum (correctly rounded).

Tolerances: rows, ranking, lag/lead, counts, integer sums and MIN/MAX
equal the oracle and the JAX package exactly; float SUM/AVG are within
1 ulp of the oracle in the output dtype; the JAX package's float sums
are held only to the error of its prefix-difference sums (rows x eps x
the column's absolute sum). Three cases pin the JAX package's faults
(float32 running sums at 2^17 rows; signed zero in its running MIN;
frame sums after an infinity), one the sort-permutation cache. Then
FusedWindowAggExec against the unfused plan, bench.py's window task
(JAX TaskDefinition bytes at 50,000 rows) against the JAX package's
answer, and the serde bytes of a window plan. Each JAX result is
computed once per module.
"""

import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu import ops as J
from blaze_tpu.exprs.ir import AggExpr as JAggExpr, AggFn as JAggFn
from blaze_tpu.exprs.ir import Col as JCol
from blaze_tpu.ops.base import ExecContext as JaxContext
from blaze_tpu.ops.parquet_scan import FileRange as JRange
from blaze_tpu.ops.parquet_scan import ParquetScanExec as JScan
from blaze_tpu.ops.sort import SortKey as JKey
from blaze_tpu.ops.window import WindowExec as JWindow, WindowFn as JFn
from blaze_tpu.plan import serde as jax_serde
from blaze_tpu.runtime.executor import execute_task as jax_execute_task
from blaze_tpu.runtime.executor import run_plan as jax_run_plan
from blaze_tpu.types import DataType as JDataType

from blaze_tpu_torch import interop
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    HashAggregateExec,
    MemoryScanExec,
    ProjectExec,
    RenameColumnsExec,
    SortKey,
    WindowExec,
    WindowFn,
)
from blaze_tpu_torch.ops.fused import FusedWindowAggExec, HostFinalAggExec
from blaze_tpu_torch.plan import serde
from blaze_tpu_torch.planner.fuse import fuse_pipelines
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.executor import (
    decode_task,
    execute_task,
    run_plan,
)
from blaze_tpu_torch.types import DataType, Field, Schema

from torch_support import computed_in_parts, jax_batch

N, CAP = 300, 512
CPU = ExecContext(device="cpu")
FRAMES = [None, ("rows", None, 0), ("rows", 2, 1), ("rows", None, None),
          ("rows", 1, None), ("rows", 0, 3), ("range", None, 0),
          ("range", 2, 3), ("range", None, 5), ("range", 4, None)]
RANKING = [("row_number", None, 1), ("rank", None, 1),
           ("dense_rank", None, 1), ("ntile", None, 3),
           ("ntile", None, 7), ("percent_rank", None, 1),
           ("cume_dist", None, 1), ("lag", "vi", 1), ("lag", "vf", 0),
           ("lead", "vf", 2), ("lag", "vs", 3), ("lead", "vi", 1)]
AGGS = [(k, s, fr) for k in ("sum", "min", "max", "count", "avg")
        for s in (("vi", "vf", "vs") if k in ("sum", "avg")
                  else ("vi", "vf")) for fr in FRAMES]
#: (kind, source, offset, frame) of every function, output f<i>
FNS = [(k, s, off, None) for k, s, off in RANKING] + \
    [(k, s, 1, fr) for k, s, fr in AGGS]
NAMES = ["p", "o", "vi", "vf", "vs", "rid"]


def _pad(a, fill=0):
    out = np.full(CAP, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 8, N).astype(np.int32),
            rng.integers(0, 25, N).astype(np.int32),
            rng.integers(-50, 50, N).astype(np.int32),
            rng.standard_normal(N) * 10,
            (rng.standard_normal(N) * 10).astype(np.float32),
            np.arange(N, dtype=np.int32)]
    valid = [rng.random(N) > 0.05, rng.random(N) > 0.1,
             rng.random(N) > 0.2, rng.random(N) > 0.2,
             rng.random(N) > 0.2, None]
    return cols, valid


SCHEMA = Schema([Field(n, dt, True) for n, dt in zip(NAMES, [
    DataType.int32(), DataType.int32(), DataType.int32(),
    DataType.float64(), DataType.float32(), DataType.int32()])])


def _batches(cols, valid, schema=SCHEMA, n=N):
    vals = [_pad(c) for c in cols]
    vms = [None if m is None else _pad(m, True) for m in valid]
    return (interop.batch_from_numpy(schema, vals, vms, None, n, "cpu"),
            jax_batch(schema, vals, vms, None, n))


def _window(W, F, K, C, scan, fns=FNS, order_asc=True, nulls_first=False,
            first=0):
    return W(scan, partition_by=[C("p")],
             order_by=[K(C("o"), order_asc, nulls_first)],
             functions=[F(k, None if s is None else C(s), f"f{first + i}",
                          off, fr)
                        for i, (k, s, off, fr) in enumerate(fns)])


#: the JAX window over FNS is computed in this many parts (one window
#: each over a slice of the functions), so the xdist workers compile
#: them side by side
JAX_PARTS = 6


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    """Both packages' window over the 132 functions; the JAX result (a
    13 s compile whole) is computed once a session for all xdist
    workers, in JAX_PARTS windows over slices of the functions whose
    passthrough columns must agree row for row."""
    cols, valid = _inputs()
    tb, jb = _batches(cols, valid)
    got = run_plan(_window(WindowExec, WindowFn, SortKey, Col,
                           MemoryScanExec([[tb]], SCHEMA)), CPU)
    cuts = [len(FNS) * p // JAX_PARTS for p in range(JAX_PARTS + 1)]

    def part(lo, hi):
        return lambda: jax_run_plan(_window(
            JWindow, JFn, JKey, JCol, J.MemoryScanExec([[jb]], jb.schema),
            fns=FNS[lo:hi], first=lo))

    parts = computed_in_parts(tmp_path_factory, "window-main-run",
                              [part(lo, hi)
                               for lo, hi in zip(cuts, cuts[1:])])
    for p in parts[1:]:
        assert p.select(NAMES).equals(parts[0].select(NAMES))
    exp = pa.table(
        {n: parts[0].column(n) for n in NAMES}
        | {n: p.column(n) for p in parts for n in p.column_names
           if n not in NAMES})
    return cols, valid, got, exp


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

def _oracle_order(cols, valid):
    """numpy's stable lexsort by (p asc nulls first, o asc nulls last)."""
    p, o = cols[0], cols[1]
    pv, ov = valid[0], valid[1]
    return np.lexsort((np.where(ov, o, 0), np.where(ov, 1, 2),
                       np.where(pv, p, 0), np.where(pv, 1, 0)))


def _runs(keys):
    """Start and end (exclusive) of each row's run of equal keys."""
    n = len(keys)
    start = np.zeros(n, np.int64)
    end = np.zeros(n, np.int64)
    i = 0
    while i < n:
        j = i
        while j < n and keys[j] == keys[i]:
            j += 1
        start[i:j], end[i:j] = i, j
        i = j
    return start, end


class Oracle:
    def __init__(self, cols, valid):
        self.order = _oracle_order(cols, valid)
        srt = [c[self.order] for c in cols]
        vm = [np.ones(N, bool) if m is None else m[self.order]
              for m in valid]
        self.cols = dict(zip(NAMES, srt))
        self.valid = dict(zip(NAMES, vm))
        pk = list(zip(vm[0], np.where(vm[0], srt[0], 0)))
        ok = list(zip(pk, vm[1], np.where(vm[1], srt[1], 0)))
        self.s, self.e = _runs(pk)
        self.rs, self.re = _runs(ok)

    def span(self, i, frame):
        s, e = self.s[i], self.e[i]
        if frame is None:
            return s, e - 1
        ftype, lo, hi = frame
        if ftype == "rows":
            return (s if lo is None else max(s, i - lo),
                    e - 1 if hi is None else min(e - 1, i + hi))
        if lo is None and hi == 0:
            return s, self.re[i] - 1
        o, ov = self.cols["o"], self.valid["o"]
        if not ov[i]:
            return (s if lo is None else self.rs[i],
                    e - 1 if hi is None else self.re[i] - 1)
        rows = [j for j in range(s, e) if ov[j]]
        a = s if lo is None else min(
            [j for j in rows if o[j] >= o[i] - lo], default=e)
        b = e - 1 if hi is None else max(
            [j for j in rows if o[j] <= o[i] + hi], default=s - 1)
        return a, b

    def fn(self, kind, src, off, frame):
        """(values, validity) of one function over the sorted rows."""
        vals, ok = [], []
        for i in range(N):
            v, m = self._one(i, kind, src, off, frame)
            vals.append(v)
            ok.append(m)
        return vals, np.array(ok)

    def _one(self, i, kind, src, off, frame):
        s, e = self.s[i], self.e[i]
        size, rn = e - s, i - s + 1
        rank = self.rs[i] - s + 1
        if kind == "row_number":
            return rn, True
        if kind == "rank":
            return rank, True
        if kind == "dense_rank":
            return len({self.rs[j] for j in range(s, i + 1)}), True
        if kind == "ntile":
            base, rem = divmod(size, off)
            cut = rem * (base + 1)
            t = (rn - 1) // (base + 1) if rn <= cut \
                else rem + (rn - 1 - cut) // base
            return t + 1, True
        if kind == "percent_rank":
            return (rank - 1) / (size - 1) if size > 1 else 0.0, True
        if kind == "cume_dist":
            return (self.re[i] - s) / size, True
        x, xm = self.cols[src], self.valid[src]
        if kind in ("lag", "lead"):
            j = i - off if kind == "lag" else i + off
            if s <= j < e and xm[j]:
                return x[j], True
            return None, False
        a, b = self.span(i, frame)
        vs = [x[j] for j in range(a, b + 1) if xm[j]]
        if kind == "count":
            return len(vs), True
        if not vs:
            return None, False
        if kind == "min":
            return min(vs), True
        if kind == "max":
            return max(vs), True
        total = sum(int(v) for v in vs) if x.dtype.kind == "i" \
            else math.fsum(float(v) for v in vs)
        if kind == "sum":
            return total, True
        return float(total) / len(vs), True


@pytest.fixture(scope="module")
def oracle(main_run):
    cols, valid, _, _ = main_run
    return Oracle(cols, valid)


def _col(table, name):
    c = table.column(name).combine_chunks()
    return c.fill_null(0).to_numpy(zero_copy_only=False), \
        ~np.asarray(c.is_null())


def _ulps(a, b, dtype):
    it = np.int32 if dtype == np.float32 else np.int64
    ia = np.asarray(a, dtype).view(it).astype(np.int64)
    ib = np.asarray(b, dtype).view(it).astype(np.int64)
    return np.abs(ia - ib)


def test_rows_come_out_in_spark_window_order(main_run, oracle):
    _, _, got, exp = main_run
    rid, _ = _col(got, "rid")
    np.testing.assert_array_equal(rid, oracle.order)
    for name in NAMES:
        a, am = _col(got, name)
        b, bm = _col(exp, name)
        np.testing.assert_array_equal(am, bm)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("i", range(len(FNS)),
                         ids=[f"{k}-{s}-{off}-{fr}" for k, s, off, fr in FNS])
def test_function_against_oracle_and_jax(i, main_run, oracle):
    _, _, got, exp = main_run
    kind, src, off, frame = FNS[i]
    name = f"f{i}"
    assert got.schema.field(name).type == exp.schema.field(name).type
    g, gm = _col(got, name)
    j, jm = _col(exp, name)
    o, om = oracle.fn(kind, src, off, frame)
    np.testing.assert_array_equal(gm, om, err_msg="validity vs oracle")
    np.testing.assert_array_equal(gm, jm, err_msg="validity vs JAX")
    o = np.array([0 if v is None else v for v in o], dtype=np.float64)
    float_sum = kind in ("sum", "avg") and (kind == "avg" or src != "vi")
    if not float_sum:
        np.testing.assert_array_equal(g[gm], o[gm].astype(g.dtype))
        np.testing.assert_array_equal(g[gm], j[gm])
        return
    # 1 ulp of the output dtype against the correctly rounded oracle
    assert _ulps(g[gm], o[gm].astype(g.dtype), g.dtype).max(initial=0) <= 1
    # the JAX package within its prefix sums' own error
    x = np.abs(oracle.cols[src][oracle.valid[src]]).sum()
    eps = np.finfo(np.float32 if src == "vs" else np.float64).eps
    np.testing.assert_allclose(j[gm], o[gm], rtol=0, atol=N * eps * x)


# ---------------------------------------------------------------------------
# the JAX package's faults
# ---------------------------------------------------------------------------

def _bench_window(W, F, K, C, scan):
    return W(scan, partition_by=[C("part")],
             order_by=[K(C("price"), False, True)],
             functions=[F("row_number", None, "rk"),
                        F("sum", C("price"), "run", 1, ("rows", None, 0))])


def test_float32_running_sum_per_partition():
    """bench.py's window shape at 2^17 rows: the JAX package's float32
    running SUM (one float32 prefix over the whole sorted column) is off
    by more than 1e-3 relative on some row; the port's is within 1 ulp
    of float32 of the per-partition float64 cumsum on every row."""
    n = 1 << 17
    rng = np.random.default_rng(42)
    part = rng.integers(0, 1024, n).astype(np.int32)
    price = (rng.random(n) * 100).astype(np.float32)
    schema = Schema([Field("part", DataType.int32(), True),
                     Field("price", DataType.float32(), True)])
    tb = interop.batch_from_numpy(schema, [part, price], [None, None],
                                  None, n, "cpu")
    jb = jax_batch(schema, [part, price], [None, None], None, n)
    got = run_plan(_bench_window(WindowExec, WindowFn, SortKey, Col,
                                 MemoryScanExec([[tb]], schema)), CPU)
    exp = jax_run_plan(_bench_window(JWindow, JFn, JKey, JCol,
                                     J.MemoryScanExec([[jb]], jb.schema)))
    order = np.lexsort((-price.astype(np.float64), part))
    ps, pr = part[order], price[order].astype(np.float64)
    starts = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
    want = np.concatenate([np.cumsum(pr[a:b]) for a, b in
                           zip(starts, np.r_[starts[1:], n])])
    g = got.column("run").to_numpy()
    j = exp.column("run").to_numpy()
    np.testing.assert_array_equal(got.column("rk").to_numpy(),
                                  exp.column("rk").to_numpy())
    assert (np.abs(j - want) / want).max() > 1e-3
    assert _ulps(g, want.astype(np.float32), np.float32).max() <= 1


MINMAX_FRAMES = [("rows", None, 0), None, ("rows", 1, 1),
                 ("range", None, 0), ("range", 1, 1)]


def test_min_signed_zero_and_nan_on_every_frame():
    """Partition 0 holds {0.0, -0.0, 2.0}, ordered as written; partition
    1 holds {5.0, NaN, 1.0}. The JAX package's running MIN gives +0.0 at
    the second row where its whole-partition MIN gives -0.0; the port
    gives -0.0 on every frame. MIN over a partition with NaN is NaN in
    both (NaN propagates, as in the aggregates)."""
    schema = Schema([Field("p", DataType.int32(), True),
                     Field("o", DataType.int32(), True),
                     Field("v", DataType.float64(), True)])
    cols = [np.array([0, 0, 0, 1, 1, 1], np.int32),
            np.array([0, 1, 2, 0, 1, 2], np.int32),
            np.array([0.0, -0.0, 2.0, 5.0, np.nan, 1.0])]
    fns = [("min", "v", 1, fr) for fr in MINMAX_FRAMES]
    vals = [_pad(c)[:8] for c in cols]
    tb = interop.batch_from_numpy(schema, vals, [None] * 3, None, 6, "cpu")
    jb = jax_batch(schema, vals, [None] * 3, None, 6)
    got = run_plan(_window(WindowExec, WindowFn, SortKey, Col,
                           MemoryScanExec([[tb]], schema), fns), CPU)
    exp = jax_run_plan(_window(JWindow, JFn, JKey, JCol,
                               J.MemoryScanExec([[jb]], jb.schema), fns))
    jrun, jwhole = (exp.column(f"f{i}").to_numpy() for i in (0, 1))
    assert jrun[1] == 0 and not np.signbit(jrun[1])
    assert np.signbit(jwhole[1])
    for i in range(len(fns)):
        g = got.column(f"f{i}").to_numpy()
        assert g[1] == 0 and np.signbit(g[1]), MINMAX_FRAMES[i]
    assert np.isnan(got.column("f1").to_numpy()[3:]).all()
    assert np.isnan(exp.column("f1").to_numpy()[3:]).all()


INF_FRAMES = [("rows", 0, 0), ("rows", 1, 0), ("rows", None, 0), None,
              ("range", 0, 1)]


def test_frame_sums_beside_infinities():
    """A frame after an infinity, not holding it, sums its own values on
    the port (Python's float sum of the frame); the JAX package's prefix
    difference gives inf - inf = NaN there."""
    schema = Schema([Field("p", DataType.int32(), True),
                     Field("o", DataType.int32(), True),
                     Field("v", DataType.float64(), True)])
    v = np.array([1.0, np.inf, 2.0, 3.0, -np.inf, 4.0, np.nan, 5.0])
    cols = [np.zeros(8, np.int32), np.arange(8, dtype=np.int32), v]
    fns = [("sum", "v", 1, fr) for fr in INF_FRAMES]
    tb = interop.batch_from_numpy(schema, cols, [None] * 3, None, 8, "cpu")
    jb = jax_batch(schema, cols, [None] * 3, None, 8)
    got = run_plan(_window(WindowExec, WindowFn, SortKey, Col,
                           MemoryScanExec([[tb]], schema), fns), CPU)
    exp = jax_run_plan(_window(JWindow, JFn, JKey, JCol,
                               J.MemoryScanExec([[jb]], jb.schema), fns))
    for i, (_, lo, hi) in enumerate(fr or ("", None, None)
                                    for fr in INF_FRAMES):
        with np.errstate(invalid="ignore"):  # inf + -inf is NaN
            want = [np.sum(v[0 if lo is None else max(0, r - lo):
                             8 if hi is None else r + hi + 1])
                    for r in range(8)]
        np.testing.assert_array_equal(got.column(f"f{i}").to_numpy(), want)
    assert got.column("f0").to_numpy()[2] == 2.0
    assert np.isnan(exp.column("f0").to_numpy()[2])


def test_sort_cache_sees_in_place_writes():
    """The sort permutation is cached on the input tensors' identity and
    version: a rerun over the same tensors reuses it, an in-place write
    to the order key invalidates it and the result follows the data."""
    cols, valid = _inputs(seed=9)
    cols, valid = [c[:256] for c in cols], [None] * 6
    tb = interop.batch_from_numpy(SCHEMA, cols, valid, None, 256, "cpu")
    fns = [("row_number", None, 1, None), ("sum", "vi", 1,
                                           ("rows", None, 0))]
    op = _window(WindowExec, WindowFn, SortKey, Col,
                 MemoryScanExec([[tb]], SCHEMA), fns)

    def run():
        with dispatch.counting() as c:
            t = run_plan(op, CPU)
        return t, c.counts.get("window_sort_cache_hits", 0)

    first, hits0 = run()
    again, hits1 = run()
    assert (hits0, hits1) == (0, 1)
    assert first.equals(again)
    tb.columns[1].values.mul_(-1)  # reverse the order key in place
    changed, hits2 = run()
    assert hits2 == 0
    fresh = run_plan(_window(WindowExec, WindowFn, SortKey, Col,
                             MemoryScanExec([[tb]], SCHEMA), fns), CPU)
    assert changed.equals(fresh)
    assert not changed.equals(first)


# ---------------------------------------------------------------------------
# FusedWindowAggExec, bench.py's window task, serde
# ---------------------------------------------------------------------------

def _rollup(W, F, K, C, Agg, AggE, AggF, Mode, P, R, scan, rename):
    inner = P(scan, [(C("p"), "p"), (C("vs"), "vs"), (C("vi"), "vi")])
    if rename:
        inner = R(inner, ["p", "x", "vi"])
    src = "x" if rename else "vs"
    win = W(inner, partition_by=[C("p")], order_by=[K(C(src), False, True)],
            functions=[F("row_number", None, "rk"),
                       F("sum", C(src), "run", 1, ("rows", None, 0)),
                       F("min", C("vi"), "lo", 1, ("rows", 2, 2)),
                       F("avg", C(src), "av", 1, None),
                       F("count", C(src), "n", 1, ("range", None, 0))])
    f64 = DataType.float64() if Agg is HashAggregateExec \
        else JDataType.float64()
    return Agg(win, keys=[], aggs=[
        (AggE(AggF.SUM, C("rk").cast(f64)), "rksum"),
        (AggE(AggF.SUM, C("run")), "runsum"),
        (AggE(AggF.MIN, C("lo")), "lomin"),
        (AggE(AggF.AVG, C("av")), "avav"),
        (AggE(AggF.MAX, C("n")), "nmax"),
        (AggE(AggF.COUNT_STAR, None), "rows")], mode=Mode.COMPLETE)


@pytest.mark.parametrize("rename", [False, True])
def test_fused_window_aggregate_equals_unfused_plan(rename):
    cols, valid = _inputs(seed=3)
    tb, _ = _batches(cols, valid)

    def plan():
        return _rollup(WindowExec, WindowFn, SortKey, Col,
                       HashAggregateExec, AggExpr, AggFn, AggMode,
                       ProjectExec, RenameColumnsExec,
                       MemoryScanExec([[tb]], SCHEMA), rename)

    fused = fuse_pipelines(plan())
    assert isinstance(fused, HostFinalAggExec)
    assert isinstance(fused.children[0], FusedWindowAggExec)
    win = fused.children[0].window
    assert win._fused_pipeline is not None
    assert [type(s).__name__ for s in win._fused_pipeline.stages] == \
        ["ProjectExec"] + (["RenameColumnsExec"] if rename else [])
    with dispatch.counting() as c:
        got = run_plan(fused, CPU)
    assert c.counts.get("window_route.fused_agg") == 1
    want = run_plan(plan(), CPU)
    assert got.equals(want), (got.to_pylist(), want.to_pylist())


@pytest.fixture(scope="module")
def bench_task(tmp_path_factory):
    """bench.py's window plan over 50,000 parquet rows as the JAX
    package's TaskDefinition bytes, run by both packages."""
    n = 50_000
    rng = np.random.default_rng(42)
    part = rng.integers(0, 1024, n).astype(np.int32)
    price = (rng.random(n) * 100).astype(np.float32)
    path = str(tmp_path_factory.mktemp("win") / "fact.parquet")
    pq.write_table(pa.table({"part": part, "price": price,
                             "item": np.arange(n, dtype=np.int32)}),
                   path, compression="zstd", row_group_size=1 << 14)
    scan = JScan([[JRange(path)]])
    plan = J.HashAggregateExec(
        _bench_window(JWindow, JFn, JKey, JCol, J.ProjectExec(
            scan, [(JCol("part"), "part"), (JCol("price"), "price")])),
        keys=[],
        aggs=[(JAggExpr(JAggFn.SUM, JCol("rk").cast(JDataType.float64())),
               "rksum"),
              (JAggExpr(JAggFn.SUM, JCol("run")), "runsum")],
        mode=J.AggMode.COMPLETE)
    blob = jax_serde.task_to_proto(plan, 0)
    with dispatch.counting() as c:
        got = pa.Table.from_batches(list(execute_task(
            blob, ExecContext(device="cpu"))))
    exp = pa.Table.from_batches(list(jax_execute_task(
        blob, JaxContext(mesh_mode="off"))))
    return blob, got, exp, part, price, c.counts


def test_bench_window_task_runs_fused_to_the_jax_answer(bench_task):
    blob, got, exp, part, price, counts = bench_task
    op, _ = decode_task(blob, ExecContext(device="cpu"))
    assert isinstance(op, HostFinalAggExec)
    assert isinstance(op.children[0], FusedWindowAggExec)
    assert counts.get("window_route.fused_agg") == 1
    assert counts.get("d2h_syncs.window_span") == 1
    sizes = np.bincount(part, minlength=1024).astype(np.int64)
    assert got.column("rksum")[0].as_py() == \
        exp.column("rksum")[0].as_py() == float((sizes * (sizes + 1) // 2)
                                                .sum())
    order = np.lexsort((-price.astype(np.float64), part))
    ps, pr = part[order], price[order].astype(np.float64)
    starts = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
    run = np.concatenate([np.cumsum(pr[a:b]).astype(np.float32) for a, b in
                          zip(starts, np.r_[starts[1:], len(ps)])])
    want = math.fsum(run.astype(np.float64))
    g = got.column("runsum")[0].as_py()
    j = exp.column("runsum")[0].as_py()
    assert abs(g - want) <= 1e-9 * want
    assert abs(j - g) <= 5e-5 * g  # bench.py's own tolerance


def test_window_plan_serde_bytes_and_round_trip(main_run, tmp_path):
    """Every function and frame: the port's plan_to_proto bytes equal
    the JAX package's, and the JAX bytes decode and run on the port to
    the same table as the plan built by hand."""
    cols, valid, got, _ = main_run
    path = str(tmp_path / "w.parquet")
    pq.write_table(pa.table({
        n: pa.array(c, mask=None if m is None else ~m)
        for n, c, m in zip(NAMES, cols, valid)}), path)
    from blaze_tpu_torch.ops import FileRange, ParquetScanExec

    mine = _window(WindowExec, WindowFn, SortKey, Col,
                   ParquetScanExec([[FileRange(path)]]))
    theirs = _window(JWindow, JFn, JKey, JCol, JScan([[JRange(path)]]))
    blob = jax_serde.plan_to_proto(theirs).SerializeToString()
    assert serde.plan_to_proto(mine).SerializeToString() == blob
    back = serde.plan_from_proto(serde.pb.PlanProto.FromString(blob))
    assert isinstance(back, WindowExec)
    assert run_plan(back, CPU).equals(got)
