"""The port's sort tier (ops/util.sort_indices, ops/sort.py, ops/limit.py,
ops/union.py, ops/empty.py, ops/rename.py, ops/debug.py) against the
JAX package's, on the CPU.

`sort_indices` over bool, int8-64, float32/64 (NaN, +/-0.0, +/-inf),
date32 and timestamp keys, ascending and descending, nulls first and
last, with padding rows: the port's packed and lexsort paths, the JAX
package's packed and lexsort paths (BLAZE_SORT_CORE) and numpy's stable
lexsort give one permutation. SortExec's four routes (in memory, top-k,
run merge, host sort), LimitExec, UnionExec, CoalescePartitionsExec,
EmptyPartitionsExec, RenameColumnsExec and DebugExec give the JAX
package's tables row for row (NaN equal to NaN). Where the JAX package
has no counterpart run (its host sort asserts plain column keys), the
port is held to the JAX package's in-memory sort of the same keys; one
case pins the JAX package's run merge placing +inf before NaN.
Serde: plan_to_proto bytes of every node equal the JAX package's, and
the JAX bytes decode and run on the port. Each JAX result is computed
once per module.
"""

import logging

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu import ops as J
from blaze_tpu.config import EngineConfig as JaxConfig
from blaze_tpu.exprs.ir import Col as JCol, Literal as JLit
from blaze_tpu.ops.base import ExecContext as JaxContext
from blaze_tpu.ops.parquet_scan import FileRange as JRange
from blaze_tpu.ops.parquet_scan import ParquetScanExec as JScan
from blaze_tpu.ops.util import sort_indices as jax_sort_indices
from blaze_tpu.plan import serde as jax_serde
from blaze_tpu.runtime.executor import run_plan as jax_run_plan
from blaze_tpu.types import DataType as JDataType

from blaze_tpu_torch import interop
from blaze_tpu_torch.config import EngineConfig, get_config, set_config
from blaze_tpu_torch.exprs.ir import Col, Literal
from blaze_tpu_torch.ops import (
    CoalescePartitionsExec,
    DebugExec,
    EmptyPartitionsExec,
    ExecContext,
    FileRange,
    FilterExec,
    LimitExec,
    MemoryScanExec,
    ParquetScanExec,
    RenameColumnsExec,
    SortExec,
    SortKey,
    UnionExec,
)
from blaze_tpu_torch.ops.util import sort_indices
from blaze_tpu_torch.plan import serde
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.executor import run_plan
from blaze_tpu_torch.types import DataType, Field, Schema

from torch_support import assert_arrow_equal, jax_batch

CAP, ROWS = 256, 200
KEY_TYPES = ["bool", "int8", "int16", "int32", "int64", "float32",
             "float64", "date32", "timestamp"]
_DT = {"bool": DataType.bool_(), "int8": DataType.int8(),
       "int16": DataType.int16(), "int32": DataType.int32(),
       "int64": DataType.int64(), "float32": DataType.float32(),
       "float64": DataType.float64(), "date32": DataType.date32(),
       "timestamp": DataType.timestamp_us()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(rng, kind):
    """ROWS values of one key type (few distinct values, so ties), padded
    to CAP with garbage, and a validity mask."""
    if kind == "bool":
        v = rng.random(CAP) < 0.5
    elif kind in ("float32", "float64"):
        v = rng.choice([-2.5, -1.0, -0.0, 0.0, 1.0, 3.0, np.inf, -np.inf,
                        np.nan], CAP).astype(kind)
    elif kind == "int64":
        v = rng.choice([-2 ** 63, -5, 0, 7, 2 ** 40, 2 ** 63 - 1], CAP)
        v = v.astype(np.int64)
    elif kind == "timestamp":
        v = rng.integers(-10 ** 12, 10 ** 12, CAP) // 10 ** 9 * 10 ** 9
    elif kind == "date32":
        v = rng.integers(-3000, 3000, CAP).astype(np.int32) // 100 * 100
    else:
        info = np.iinfo(kind)
        v = rng.choice([info.min, -3, 0, 1, 9, info.max], CAP).astype(kind)
    m = rng.random(CAP) > 0.15
    return np.asarray(v, dtype=_DT[kind].physical_dtype()), m


#: (name, [(key type, ascending, nulls_first)])
SINGLE = [(f"{k}-{'asc' if a else 'desc'}-{'nf' if nf else 'nl'}",
           [(k, a, nf)]) for k in KEY_TYPES for a in (True, False)
          for nf in (True, False)]
MULTI = [("int32+float32", [("int32", True, True), ("float32", False,
                                                      False)]),
         ("float64+int8", [("float64", False, True), ("int8", True,
                                                       False)]),
         ("bool+date32+timestamp", [("bool", False, False),
                                    ("date32", True, True),
                                    ("timestamp", False, True)]),
         ("int16+int64", [("int16", True, False), ("int64", False,
                                                     False)])]
CASES = SINGLE + MULTI


def _case_keys(i, spec):
    rng = np.random.default_rng(100 + i)
    return [(*_key(rng, k), a, nf) for k, a, nf in spec]


def _numpy_order(keys):
    """numpy's stable lexsort in Spark's order; padding last."""
    lanes = []
    for v, m, asc, nf in keys:
        x = v.astype(np.float64) if v.dtype.kind == "f" else v
        if x.dtype.kind == "f":
            nan = np.isnan(x)
            x = np.where(nan, np.inf, x)
            tie = nan.astype(np.int8)
            x = np.where(x == 0, 0.0, x)
            if not asc:
                x, tie = -x, -tie
        else:
            x = x.astype(np.int64) if x.dtype != np.bool_ else \
                x.astype(np.int64)
            tie = np.zeros(len(x), np.int8)
            if not asc:
                x = ~x
        rank = np.where(m, 1, 0 if nf else 2)
        x = np.where(m, x, 0)
        tie = np.where(m, tie, 0)
        lanes.append((tie, x, rank))
    flat = [lane for triple in reversed(lanes) for lane in triple]
    pad = (np.arange(CAP) >= ROWS).astype(np.int8)
    return np.lexsort(tuple(flat) + (pad,))


@pytest.fixture(scope="module")
def jax_perms():
    """{(case, core): JAX permutation} for both of its sort cores."""
    import os

    out = {}
    saved = os.environ.get("BLAZE_SORT_CORE")
    try:
        for core in ("scatter", "sort"):
            os.environ["BLAZE_SORT_CORE"] = core
            for i, (name, spec) in enumerate(CASES):
                keys = [(jnp.asarray(v), jnp.asarray(m), a, nf)
                        for v, m, a, nf in _case_keys(i, spec)]
                out[(name, core)] = np.asarray(
                    jax_sort_indices(keys, ROWS, CAP))
    finally:
        if saved is None:
            os.environ.pop("BLAZE_SORT_CORE", None)
        else:
            os.environ["BLAZE_SORT_CORE"] = saved
    return out


@pytest.fixture
def sort_core():
    saved = get_config()

    def use(core):
        set_config(EngineConfig(sort_core=core, device="cpu"))
    yield use
    set_config(saved)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[name for name, _ in CASES])
def test_sort_indices_both_cores_against_jax(i, jax_perms, sort_core):
    name, spec = CASES[i]
    keys = _case_keys(i, spec)
    tkeys = [(torch.from_numpy(v.copy()), torch.from_numpy(m.copy()), a,
              nf) for v, m, a, nf in keys]
    want = _numpy_order(keys)
    narrow = all(k not in ("int64", "float64", "timestamp")
                 for k, _, _ in spec)
    for core, route in (("scatter", "packed" if narrow else "lexsort"),
                        ("sort", "lexsort")):
        sort_core(core)
        with dispatch.counting() as c:
            got = sort_indices(tkeys, ROWS, CAP).numpy()
        assert c.counts == {f"sort_core.{route}": 1}
        np.testing.assert_array_equal(got[:ROWS], want[:ROWS],
                                      err_msg=core)
        np.testing.assert_array_equal(np.sort(got), np.arange(CAP))
        for jcore in ("scatter", "sort"):
            np.testing.assert_array_equal(
                got[:ROWS], jax_perms[(name, jcore)][:ROWS],
                err_msg=f"{core} vs JAX {jcore}")


def test_unknown_sort_core_raises(sort_core):
    sort_core("radix")
    with pytest.raises(ValueError, match="sort_core"):
        sort_indices([(torch.zeros(4), None, True, True)], 4, 4)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

SCHEMA = Schema([Field("a", DataType.int32(), True),
                 Field("b", DataType.float32(), True),
                 Field("c", DataType.int64(), True),
                 Field("rid", DataType.int32(), False)])
BATCH, NB = 256, 12  # twelve 256-row batches, the last one short


def _columns(seed, inf=True):
    rng = np.random.default_rng(seed)
    n = BATCH * NB - 37
    a = rng.integers(0, 40, n).astype(np.int32)
    vals = [-1.5, -0.0, 0.0, 2.0, 7.25, np.nan] + \
        ([np.inf, -np.inf] if inf else [])
    b = rng.choice(vals, n).astype(np.float32)
    c = rng.integers(-1000, 1000, n).astype(np.int64)
    rid = np.arange(n, dtype=np.int32)
    valid = [rng.random(n) > 0.1, rng.random(n) > 0.1,
             rng.random(n) > 0.1, None]
    return [a, b, c, rid], valid


def _scans(seed, inf=True, parts=1):
    """(port scan, JAX scan) over the same batches, in `parts`
    partitions."""
    cols, valid = _columns(seed, inf)
    n = len(cols[0])
    per = -(-NB // parts)
    tparts, jparts = [[] for _ in range(parts)], [[] for _ in range(parts)]
    for bi, start in enumerate(range(0, n, BATCH)):
        k = min(BATCH, n - start)
        vals = [np.resize(c[start:start + k], BATCH) for c in cols]
        vms = [None if m is None else
               np.r_[m[start:start + k], np.ones(BATCH - k, bool)]
               for m in valid]
        tparts[bi // per].append(interop.batch_from_numpy(
            SCHEMA, vals, vms, None, k, "cpu"))
        jparts[bi // per].append(jax_batch(SCHEMA, vals, vms, None, k))
    return (MemoryScanExec(tparts, SCHEMA),
            J.MemoryScanExec(jparts, jparts[0][0].schema))


KEYS = [("a", True, False), ("b", False, True)]


def _sort(S, K, C, scan, fetch=None, keys=KEYS):
    return S(scan, [K(C(n) if isinstance(n, str) else n, a, nf)
                    for n, a, nf in keys], fetch=fetch)


def _tables(plan_pair, limit=None, batch=16384):
    mine, theirs = plan_pair
    cfg = EngineConfig(device="cpu", batch_size=batch)
    jcfg = JaxConfig(batch_size=batch)
    if limit is not None:
        cfg.max_materialize_rows = jcfg.max_materialize_rows = limit
    with dispatch.counting() as c:
        got = run_plan(mine, ExecContext(device="cpu", config=cfg))
    exp = jax_run_plan(theirs, JaxContext(config=jcfg, mesh_mode="off"))
    return got, exp, c.counts


def _pair(seed, fetch=None, keys=KEYS, inf=True):
    ts, js = _scans(seed, inf)
    return (_sort(SortExec, SortKey, Col, ts, fetch, keys),
            _sort(J.SortExec, J.SortKey, JCol, js, fetch, keys))


ROUTES = {
    # name: (fetch, max_materialize_rows, batch_size, route)
    "in_memory": (None, None, 16384, "in_memory"),
    "in_memory_fetch": (70, None, 16384, "in_memory"),
    "topk": (50, 1000, 16384, "topk"),
    "run_merge": (None, 700, 128, "run_merge"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sort_routes_match_jax(route):
    fetch, limit, batch, want = ROUTES[route]
    # the JAX package's run merge misplaces NaN next to +inf
    # (test_jax_run_merge_puts_inf_before_nan): no inf there
    got, exp, counts = _tables(_pair(7, fetch, inf=route != "run_merge"),
                               limit, batch)
    assert counts.get(f"sort_route.{want}") == 1, counts
    assert_arrow_equal(got, exp)
    if route == "run_merge":
        assert counts["sort_spilled_runs"] >= 4


def test_run_merge_with_infinities_equals_in_memory_sort():
    """NaN above +inf across spilled runs: the merge's order lanes keep
    them apart. The row id breaks ties (the merge keeps ties in run
    order, not input order, in both packages)."""
    keys = KEYS + [("rid", True, True)]
    got, _, counts = _tables(_pair(8, keys=keys), 700, 128)
    assert counts.get("sort_route.run_merge") == 1
    whole, _, _ = _tables(_pair(8, keys=keys))
    assert_arrow_equal(got, whole)


def _key_order(t):
    """The (a, b) key sequence of a sorted table, NaN as a string."""
    b = [None if v is None else ("nan" if v != v else v)
         for v in t.column("b").to_pylist()]
    return list(zip(t.column("a").to_pylist(), b))


def test_jax_run_merge_puts_inf_before_nan():
    """A reference fault: the JAX package's run merge ranks a NaN key as
    +inf when it counts the safe prefix of a round (`row_ranks`,
    blaze_tpu/ops/sort.py:182), so across spilled runs it emits a +inf
    row before a NaN row of a descending key, where NaN is the
    greatest value. The port's merge keeps the in-memory order."""
    got, exp, _ = _tables(_pair(7), 700, 128)
    whole, jwhole, _ = _tables(_pair(7))
    assert _key_order(got) == _key_order(whole) == _key_order(jwhole)
    bad = [i for i, (x, y) in enumerate(zip(_key_order(exp),
                                            _key_order(jwhole))) if x != y]
    assert bad
    assert _key_order(exp)[bad[0]][1] == float("inf")
    assert _key_order(jwhole)[bad[0]][1] == "nan"


@pytest.mark.parametrize("fetch", [None, 600])
def test_host_sort_of_expression_keys(fetch):
    """Expression keys past the limit take the host sort (the JAX
    package asserts plain column keys there): equal to the JAX package's
    in-memory sort of the same keys."""
    keys = [((Col("a") % Literal(7, DataType.int32())), False, True),
            ("b", True, False), ("rid", True, True)]
    jkeys = [((JCol("a") % JLit(7, JDataType.int32())), False, True),
             ("b", True, False), ("rid", True, True)]
    ts, js = _scans(9)
    with dispatch.counting() as c:
        got = run_plan(_sort(SortExec, SortKey, Col, ts, fetch, keys),
                       ExecContext(device="cpu", config=EngineConfig(
                           device="cpu", max_materialize_rows=700)))
    assert c.counts.get("sort_route.host") == 1
    assert c.counts.get("host_sorts") == 1
    exp = jax_run_plan(_sort(J.SortExec, J.SortKey, JCol, js, fetch,
                             jkeys), JaxContext(mesh_mode="off"))
    assert_arrow_equal(got, exp)


def _pred(C, L, dt):
    return C("a") < L(25, dt)


def test_limit_over_filter_matches_jax():
    ts, js = _scans(11)
    mine = LimitExec(FilterExec(ts, _pred(Col, Literal, DataType.int32())),
                     300)
    theirs = J.LimitExec(J.FilterExec(js, _pred(JCol, JLit,
                                                JDataType.int32())), 300)
    got, exp, counts = _tables((mine, theirs))
    assert got.num_rows == 300
    assert_arrow_equal(got, exp)


def test_union_and_coalesce_match_jax():
    ts1, js1 = _scans(12, parts=2)
    ts2, js2 = _scans(13)
    union = UnionExec([ts1, RenameColumnsExec(ts2, ["a", "b", "c", "rid"])])
    jun = J.UnionExec([js1, J.RenameColumnsExec(js2, ["a", "b", "c",
                                                      "rid"])])
    assert union.partition_count == jun.partition_count == 3
    got, exp, _ = _tables((union, jun))
    assert_arrow_equal(got, exp)
    got, exp, _ = _tables((CoalescePartitionsExec(union),
                           J.CoalescePartitionsExec(jun)))
    assert_arrow_equal(got, exp)


def test_empty_rename_debug_match_jax(caplog):
    from blaze_tpu.types import Schema as JSchema

    empty = EmptyPartitionsExec(SCHEMA, 3)
    jempty = J.EmptyPartitionsExec(JSchema(list(_scans(1)[1].schema)), 3)
    got, exp, _ = _tables((empty, jempty))
    assert empty.partition_count == 3 and got.num_rows == exp.num_rows == 0
    assert got.schema.names == exp.schema.names
    ts, js = _scans(14)
    names = ["w", "x", "y", "z"]
    with caplog.at_level(logging.INFO, logger="blaze_tpu_torch.debug"):
        got, exp, _ = _tables((DebugExec(RenameColumnsExec(ts, names), "d1"),
                               J.DebugExec(J.RenameColumnsExec(js, names),
                                           "d1")))
    assert got.schema.names == names
    assert_arrow_equal(got, exp)
    assert any("[d1] partition=0 batch=0" in r.getMessage()
               for r in caplog.records)


# ---------------------------------------------------------------------------
# serde
# ---------------------------------------------------------------------------

def _file(tmp_path):
    cols, valid = _columns(15)
    path = str(tmp_path / "s.parquet")
    pq.write_table(pa.table({n: pa.array(c, mask=None if m is None else ~m)
                             for n, c, m in zip(SCHEMA.names(), cols,
                                                valid)}),
                   path, row_group_size=1000)
    return path


def _serde_plans(path):
    """(name, port plan, JAX plan) for every node of the sort tier."""
    ts, js = ParquetScanExec([[FileRange(path)]]), JScan([[JRange(path)]])
    names = ["w", "x", "y", "z"]
    f32 = (DataType.float32(), JDataType.float32())
    return [
        ("sort", _sort(SortExec, SortKey, Col, ts),
         _sort(J.SortExec, J.SortKey, JCol, js)),
        ("sort_fetch", _sort(SortExec, SortKey, Col, ts, 10),
         _sort(J.SortExec, J.SortKey, JCol, js, 10)),
        ("limit", LimitExec(FilterExec(
            ts, Col("b") > Literal(0.5, f32[0])), 40),
         J.LimitExec(J.FilterExec(js, JCol("b") > JLit(0.5, f32[1])), 40)),
        ("union", UnionExec([ts, ts]), J.UnionExec([js, js])),
        ("rename", RenameColumnsExec(ts, names),
         J.RenameColumnsExec(js, names)),
        ("debug", DebugExec(ts, "x"), J.DebugExec(js, "x")),
        ("empty", EmptyPartitionsExec(ts.schema, 2),
         J.EmptyPartitionsExec(js.schema, 2)),
    ]


@pytest.mark.parametrize("name", ["sort", "sort_fetch", "limit", "union",
                                  "rename", "debug", "empty"])
def test_serde_bytes_equal_jax_and_round_trip(name, tmp_path):
    path = _file(tmp_path)
    (_, mine, theirs), = [p for p in _serde_plans(path) if p[0] == name]
    blob = jax_serde.plan_to_proto(theirs).SerializeToString()
    assert serde.plan_to_proto(mine).SerializeToString() == blob
    back = serde.plan_from_proto(serde.pb.PlanProto.FromString(blob))
    assert type(back) is type(mine)
    got = run_plan(back, ExecContext(device="cpu"))
    exp = jax_run_plan(theirs, JaxContext(mesh_mode="off"))
    assert_arrow_equal(got, exp)
