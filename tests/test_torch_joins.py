"""The port's equi-joins against the JAX package's, on the CPU.

The same padded numpy buffers, made from seeded generators, go through
both packages' HashJoinExec, SortMergeJoinExec and
StreamingSortMergeJoinExec (interop.batch_from_numpy and
torch_support.jax_batch), for every join type and each join core: the
dense direct table, the fused key|row table, the generic table and the
sorted core (the JAX side forced with BLAZE_JOIN_CORE, the port with
EngineConfig.join_core). The inputs hold NULL keys, -0.0 and 0.0, NaN
keys in float32 and float64, repeated build keys, empty sides,
two-column keys, mixed-width keys and build relations far below their
shape bucket. Then grace sort-merge joins (a re-bucket and a hot key),
the concurrent build-side epilogue of the hash join, and TaskDefinitions
with joins, encoded by one package and run by the other.

Every output is Arrow-equal to the JAX package's row for row (NaN equal
to NaN), except where a test says it compares sorted rows; the join_agg
task's float sums agree within 1e-12 relative (the two packages add in
other orders).
"""

import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu import ops as jax_ops
from blaze_tpu.config import EngineConfig as JaxConfig
from blaze_tpu.config import get_config as jax_get_config
from blaze_tpu.ops.base import ExecContext as JaxContext
from blaze_tpu.ops.parquet_scan import ParquetScanExec as JParquetScan
from blaze_tpu.ops.streaming_smj import (
    StreamingSortMergeJoinExec as JStreamingSMJ,
)
from blaze_tpu.ops.util import ensure_compacted as jax_compacted
from blaze_tpu.plan import serde as jax_serde
from blaze_tpu.runtime.executor import execute_task as jax_execute_task

from blaze_tpu_torch import interop
from blaze_tpu_torch.config import EngineConfig, get_config, set_config
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
    SortMergeJoinExec,
    StreamingSortMergeJoinExec,
)
from blaze_tpu_torch.ops.util import ensure_compacted
from blaze_tpu_torch.plan import serde
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.executor import execute_task
from blaze_tpu_torch.types import DataType, Field, Schema

from torch_support import assert_arrow_equal, jax_batch

CAP = 256
JTS = list(JoinType)


# ---------------------------------------------------------------------------
# inputs: one side is a schema and a list of padded batches
# ---------------------------------------------------------------------------

def _pad(a, fill=0):
    out = np.full(CAP, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _side(names, dtypes, cols, valids, rows_per_batch):
    """(schema, [(values, validity, num_rows)]): `cols` are full-length
    host arrays cut into batches of the given row counts."""
    schema = Schema([Field(n, dt, True) for n, dt in zip(names, dtypes)])
    batches, start = [], 0
    for n in rows_per_batch:
        vals = [_pad(c[start:start + n]) for c in cols]
        vms = [None if m is None else _pad(m[start:start + n], True)
               for m in valids]
        batches.append((vals, vms, n))
        start += n
    return schema, batches


def _keys(rng, kind, n, dup):
    """One key column of n rows: kind in int32, int32_sparse, int64,
    float32, float64; dup=True repeats keys (and, for floats, gives both
    0.0 and -0.0 and two NaNs)."""
    if kind == "int32":
        k = rng.permutation(n + 20)[:n].astype(np.int32)
    elif kind == "int32_sparse":
        k = rng.choice(np.arange(-10 ** 6, 10 ** 6, 37), n,
                       replace=False).astype(np.int32)
    elif kind == "int64":
        k = rng.choice(np.arange(-2 ** 40, 2 ** 40, 2 ** 31 + 11), n,
                       replace=False).astype(np.int64)
    else:
        dt = np.float32 if kind == "float32" else np.float64
        k = (rng.choice(np.arange(-500, 500), n, replace=False) / 4
             ).astype(dt)
        k[:3] = [-0.0, np.nan, np.inf]
        if dup:
            k[3:6] = [0.0, np.nan, -np.inf]
    if dup:
        k[n // 2: n // 2 + n // 4] = k[: n // 4]
    return k


def _probe_keys(rng, build_k, n, kind, nan_payload):
    """Probe keys: about half drawn from the build keys, the rest new;
    floats also hold 0.0, -0.0 and NaN (with `nan_payload`, also a NaN
    of another payload)."""
    pick = build_k[rng.integers(0, len(build_k), n)]
    fresh = _keys(rng, kind, n, False)
    k = np.where(rng.random(n) < 0.5, pick, fresh).astype(pick.dtype)
    if k.dtype.kind == "f":
        nan2 = np.nan
        if nan_payload:
            nan2 = np.array([0x7FC00001], np.uint32).view(np.float32)[0] \
                if k.dtype == np.float32 else \
                np.array([0x7FF0000000000002], np.uint64).view(
                    np.float64)[0]
        k[:4] = [0.0, -0.0, np.nan, nan2]
    return k


#: name -> (build key kinds, probe key kinds, build keys repeat, NULL
#: keys, the core the port must take, join_core). A NaN of another
#: payload is left out of the sorted core's probes: the JAX package's
#: hash misses it there in float32 (test_sorted_core_nan_payloads holds
#: the sorted core's float32 keys to numpy instead).
DATASETS = {
    "direct": (["int32"], ["int32"], False, True, "table_direct", "auto"),
    "direct_forced_sort": (["int32"], ["int32"], False, True, "sorted",
                           "sort"),
    "kr_f32": (["float32"], ["float32"], False, False, "table_kr", "auto"),
    "table_multi": (["int32", "int64"], ["int32", "int64"], False, True,
                    "table", "auto"),
    "table_mixed": (["int32_sparse"], ["int64"], False, True, "table",
                    "auto"),
    "sorted_dup": (["int32"], ["int32"], True, True, "sorted", "auto"),
    "sorted_f64": (["float64"], ["float64"], True, False, "sorted", "auto"),
    "sorted_mixed": (["int32"], ["int64"], True, True, "sorted", "auto"),
    "sorted_multi": (["int32", "float64"], ["int32", "float64"], True,
                     True, "sorted", "auto"),
    "empty_build": (["int32"], ["int32"], False, True, None, "auto"),
    "empty_probe": (["int32"], ["int32"], False, True, "table_direct",
                    "auto"),
}
#: float32 keys on the sorted core, held to numpy
#: (test_sorted_core_nan_payloads)
SORTED_F32 = (["float32"], ["float32"], True, False, "sorted", "auto")
#: datasets the sort-merge join runs too (it shares the core)
SMJ_DATASETS = ("direct", "sorted_f64", "empty_build")

_NP = {"int32": np.int32, "int32_sparse": np.int32, "int64": np.int64,
       "float32": np.float32, "float64": np.float64}
_DT = {"int32": DataType.int32(), "int32_sparse": DataType.int32(),
       "int64": DataType.int64(), "float32": DataType.float32(),
       "float64": DataType.float64()}


def dataset(name, seed=0, nan_payload=None):
    """(build side, probe side) of a named dataset. The build has 180
    rows in one batch, the probe 250 and 190 in two (no probe rows for
    empty_probe, no build rows for empty_build)."""
    bkinds, pkinds, dup, nulls, core, _ = {**DATASETS,
                                           "sorted_f32": SORTED_F32}[name]
    if nan_payload is None:
        nan_payload = core != "sorted"
    rng = np.random.default_rng(seed)
    nb = 0 if name == "empty_build" else 180
    np_rows = [0] if name == "empty_probe" else [250, 190]
    npr = sum(np_rows)
    bcols, pcols = [], []
    for bk, pk in zip(bkinds, pkinds):
        b = _keys(rng, bk, max(nb, 8), dup)[:nb]
        if name == "sorted_multi" and bk == "float64":
            b = rng.integers(0, 3, nb).astype(np.float64)
        src = b if nb else _keys(rng, bk, 8, False)
        p = _probe_keys(rng, src, npr, pk, nan_payload).astype(_NP[pk])
        if pk == "int64" and bk != "int64":
            # wider than the build key: must match nothing
            p[4:6] = [2 ** 40, -2 ** 40]
        bcols.append(b)
        pcols.append(p)
    if name == "table_multi":
        # unique pairs: the second key is three times the row number
        bcols[1] = np.arange(nb, dtype=np.int64) * 3
        pcols[1] = np.where(rng.random(npr) < 0.7, pcols[1] % 600,
                            rng.integers(0, 600, npr))
    bvalid = [(rng.random(nb) < 0.9) if nulls else None for _ in bkinds]
    pvalid = [(rng.random(npr) < 0.9) if nulls else None for _ in pkinds]
    bpay = rng.integers(-1000, 1000, nb).astype(np.int64)
    ppay = rng.random(npr) * 100
    ppay[::17] = np.nan
    build = _side([f"bk{i}" for i in range(len(bkinds))] + ["bv"],
                  [_DT[k] for k in bkinds] + [DataType.int64()],
                  bcols + [bpay], bvalid + [None], [nb])
    probe = _side([f"pk{i}" for i in range(len(pkinds))] + ["pv"],
                  [_DT[k] for k in pkinds] + [DataType.float64()],
                  pcols + [ppay], pvalid + [(rng.random(npr) < 0.9)],
                  np_rows)
    return build, probe


def port_scan(side):
    schema, batches = side
    return MemoryScanExec(
        [[interop.batch_from_numpy(schema, v, m, None, n, "cpu")
          for v, m, n in batches]], schema)


def jax_scan(side):
    schema, batches = side
    jb = [jax_batch(schema, v, m, None, n) for v, m, n in batches]
    return jax_ops.MemoryScanExec([jb], jb[0].schema)


def key_names(side):
    return [f.name for f in side[0] if f.name != "bv" and f.name != "pv"]


# ---------------------------------------------------------------------------
# running both packages
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU searchsorted wakes its thread pool for a few hundred
    elements (tens of ms a call on this kind of host): the tests run
    torch on one thread."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def join_core(monkeypatch):
    """Set the join core of both packages for one test."""
    saved = get_config()

    def use(core):
        monkeypatch.setenv("BLAZE_JOIN_CORE", core)
        set_config(EngineConfig(device="cpu", join_core=core))

    use("auto")
    yield use
    set_config(saved)


def port_rows(op, partitions=None, config=None):
    ctx = ExecContext(device="cpu", config=config or get_config())
    out = []
    for p in partitions if partitions is not None \
            else range(op.partition_count):
        for cb in op.execute(p, ctx):
            cb = ensure_compacted(cb)
            if cb.num_rows:
                out.append(cb.to_arrow())
    return out, ctx


def jax_rows(op, config=None):
    ctx = JaxContext(config=config or jax_get_config())
    out = []
    for p in range(op.partition_count):
        for cb in op.execute(p, ctx):
            cb = jax_compacted(cb)
            if cb.num_rows:
                out.append(cb.to_arrow())
    return out, ctx


def as_table(batches, schema=None):
    if not batches:
        return None
    return pa.Table.from_batches(batches).combine_chunks()


def assert_same(port_batches, jax_batches, what=None):
    """Arrow-equal row for row (NaN equal to NaN)."""
    pt, jt = as_table(port_batches), as_table(jax_batches)
    if pt is None or jt is None:
        assert pt is None and jt is None, (what, pt, jt)
        return
    try:
        assert_arrow_equal(pt, jt)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from e


def make_join(pkg, kind, build, probe, jt):
    """The join of `kind` (hash, smj, streaming) in package `pkg`. The
    hash join builds on its left child; the sort-merge joins on their
    right, so their left child is the probe side."""
    ops = jax_ops if pkg == "jax" else None
    scan = jax_scan if pkg == "jax" else port_scan
    if kind == "hash":
        cls = ops.HashJoinExec if ops else HashJoinExec
        return cls(scan(build), scan(probe), key_names(build),
                   key_names(probe), _jt(pkg, jt))
    if kind == "smj":
        cls = ops.SortMergeJoinExec if ops else SortMergeJoinExec
    else:
        cls = JStreamingSMJ if ops else StreamingSortMergeJoinExec
    return cls(scan(probe), scan(build), key_names(probe),
               key_names(build), _jt(pkg, jt))


def _jt(pkg, jt):
    return jax_ops.JoinType[jt.name] if pkg == "jax" else jt


# ---------------------------------------------------------------------------
# every join type x core x dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DATASETS))
def test_join_matches_jax(name, join_core):
    """One dataset through the hash join (every type but NAAJ) and, for
    SMJ_DATASETS, the sort-merge join (every type), on the core the
    dataset names. One test a dataset: the JAX side compiles its
    kernels once for all the join types."""
    build, probe = dataset(name)
    core, knob = DATASETS[name][4:]
    join_core(knob)
    kinds = ("hash", "smj") if name in SMJ_DATASETS else ("hash",)
    for kind in kinds:
        for jt in JTS:
            if kind == "hash" and jt is JoinType.LEFT_ANTI_NULL_AWARE:
                continue
            with dispatch.counting() as c:
                got, _ = port_rows(make_join("port", kind, build, probe,
                                             jt))
            exp, _ = jax_rows(make_join("jax", kind, build, probe, jt))
            assert_same(got, exp, (kind, jt))
            if core is not None:
                assert c.counts.get("join_core." + core, 0) >= 1, \
                    (kind, jt, c.counts)


def test_sorted_core_nan_payloads(join_core):
    """Join keys compare as SQL values: float32 -0.0 equals 0.0 and a NaN
    of any payload equals every NaN, on the sorted core too (the port
    hashes through Spark's murmur3, which canonicalises NaN). The JAX
    package's sorted core hashes a float32 NaN's raw bits
    (blaze_tpu/exprs/hashing.py:205-209), so its probe NaN of another
    payload misses the build NaNs: a reference fault (ROADMAP section
    3), pinned here against a numpy oracle."""
    build, probe = dataset("sorted_f32", nan_payload=True)
    bk = np.concatenate([v[0][:n] for v, _, n in build[1]])
    pk = np.concatenate([v[0][:n] for v, _, n in probe[1]])
    eq = (pk[:, None] == bk[None, :]) | (np.isnan(pk)[:, None]
                                         & np.isnan(bk)[None, :])
    want = int(eq.sum())
    got, ctx = port_rows(make_join("port", "hash", build, probe,
                                   JoinType.INNER))
    assert sum(b.num_rows for b in got) == want
    pt = as_table(got)
    nan_rows = np.isnan(pt.column("pk0").to_numpy())
    assert nan_rows.sum() == int(eq[np.isnan(pk)].sum()) > 0
    exp, _ = jax_rows(make_join("jax", "hash", build, probe,
                                JoinType.INNER))
    assert sum(b.num_rows for b in exp) < want


def test_build_padding_stays_out_of_the_index(join_core):
    """A 300-row dimension in a 65,536-row bucket: every probe row
    matches once, on the table and the sorted core alike, and the
    output capacity stays at the match count's bucket (padding rows
    hashed into the index would add phantom candidates)."""
    for core in ("scatter", "sort"):
        join_core(core)
        set_config(EngineConfig(device="cpu", join_core=core,
                                batch_size=1 << 16,
                                shape_buckets=(1 << 16,)))
        rng = np.random.default_rng(13)
        n_items, n = 300, 40_000
        item = pa.record_batch({
            "i_item": np.arange(n_items, dtype=np.int32),
            "i_brand": (np.arange(n_items) % 17).astype(np.int32)})
        fact = pa.record_batch({
            "item": rng.integers(0, n_items, n).astype(np.int32),
            "v": rng.random(n).astype(np.float32)})
        from blaze_tpu_torch.batch import ColumnBatch

        icb = ColumnBatch.from_arrow(item, device="cpu")
        fcb = ColumnBatch.from_arrow(fact, device="cpu")
        join = HashJoinExec(MemoryScanExec([[icb]], icb.schema),
                            MemoryScanExec([[fcb]], fcb.schema),
                            ["i_item"], ["item"], JoinType.INNER)
        outs = list(join.execute(0, ExecContext(device="cpu")))
        assert sum(ensure_compacted(cb).num_rows for cb in outs) == n
        assert sum(cb.capacity for cb in outs) <= 2 * (1 << 16)
        t = pa.Table.from_batches(
            [ensure_compacted(cb).to_arrow() for cb in outs])
        np.testing.assert_array_equal(t.column("i_brand").to_numpy(),
                                      t.column("item").to_numpy() % 17)


def test_null_keys_take_no_candidate_pairs(join_core):
    """NULL keys share one hash (the seed), so on the sorted core every
    NULL-key probe row would meet every NULL-key build row; they never
    match, and the pair expansion stays at the match count's bucket."""
    join_core("sort")
    rng = np.random.default_rng(21)
    n = 2000
    null = rng.random(n) < 0.5
    side = _side(["bk0", "bv"], [DataType.int32(), DataType.int64()],
                 [rng.integers(0, 50, n).astype(np.int32),
                  np.arange(n, dtype=np.int64)], [~null, None], [200] * 10)
    schema, batches = side
    from blaze_tpu_torch.batch import ColumnBatch

    cbs = [interop.batch_from_numpy(schema, v, m, None, k, "cpu")
           for v, m, k in batches]
    big = ensure_compacted(ColumnBatch(schema, cbs[0].columns, 200))
    join = SortMergeJoinExec(MemoryScanExec([cbs], schema),
                             MemoryScanExec([[big]], schema),
                             ["bk0"], ["bk0"], JoinType.INNER)
    outs = list(join.execute(0, ExecContext(device="cpu")))
    live = sum(ensure_compacted(cb).num_rows for cb in outs)
    # about 1000 x 100 / 50 valid-key pairs; 1000 x 100 NULL-key
    # candidates would more than double the capacity
    assert 0 < live <= sum(cb.capacity for cb in outs) <= 2 * live + 1024


@pytest.mark.parametrize("jt", [JoinType.LEFT, JoinType.FULL,
                                JoinType.LEFT_SEMI, JoinType.LEFT_ANTI])
def test_build_epilogue_concurrent_probe_partitions(jt, join_core):
    """Build-emitting hash joins probe their partitions in parallel; the
    shared matched-build flags OR-merge and the last partition to finish
    emits the build side: the rows equal the single-partition run's and
    the JAX package's."""
    build, probe = dataset("sorted_dup")
    schema, batches = probe
    parts = [[interop.batch_from_numpy(schema, v, m, None, n, "cpu")]
             for v, m, n in batches]
    one = HashJoinExec(port_scan(build), port_scan(probe),
                       ["bk0"], ["pk0"], jt)
    multi = HashJoinExec(port_scan(build), MemoryScanExec(parts, schema),
                         ["bk0"], ["pk0"], jt)
    results = [None] * len(parts)
    errors = []

    def run(p):
        try:
            results[p] = port_rows(multi, partitions=[p])[0]
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(p,))
               for p in range(len(parts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and all(not t.is_alive() for t in threads)
    got = sorted_rows([b for r in results for b in r])
    assert got == sorted_rows(port_rows(one)[0])
    assert got == sorted_rows(jax_rows(make_join(
        "jax", "hash", build, probe, jt))[0])


def sorted_rows(batches):
    """Rows as tuples in a canonical order (NULL last, NaN as a string
    so it compares equal)."""
    t = as_table(batches)
    if t is None:
        return []
    rows = zip(*[t.column(i).to_pylist() for i in range(t.num_columns)])
    canon = [tuple("nan" if isinstance(x, float) and x != x else x
                   for x in r) for r in rows]
    return sorted(canon, key=lambda r: tuple(
        (x is None, str(type(x)), x if x is not None else 0) for x in r))


# ---------------------------------------------------------------------------
# grace sort-merge join
# ---------------------------------------------------------------------------

def _grace_sides(seed=3):
    """Left 1400 rows over 1000 keys plus key 7 400 times; right 700
    rows over the same keys plus key 7 100 times: with a cap of 300
    rows and 4 buckets, key 7's bucket overflows at every depth."""
    rng = np.random.default_rng(seed)
    lk = np.concatenate([rng.integers(0, 1000, 1000), np.full(400, 7)])
    rk = np.concatenate([rng.integers(0, 1000, 600), np.full(100, 7)])
    lk, rk = rng.permutation(lk), rng.permutation(rk)
    lv = rng.integers(0, 10 ** 6, len(lk))
    rv = rng.random(len(rk))

    def side(k, v, names, valid):
        schema = Schema([Field(names[0], DataType.int64(), True),
                         Field(names[1], DataType.float64()
                               if v.dtype.kind == "f" else
                               DataType.int64(), True)])
        from blaze_tpu_torch.batch import ColumnBatch

        bs = [ColumnBatch.from_arrow(pa.record_batch({
            names[0]: pa.array(k[s:s + 200], mask=~valid[s:s + 200]),
            names[1]: v[s:s + 200]}), device="cpu")
            for s in range(0, len(k), 200)]
        return MemoryScanExec([bs], bs[0].schema)

    lvalid = rng.random(len(lk)) < 0.95
    rvalid = rng.random(len(rk)) < 0.95
    return (lambda: side(lk, lv, ("k", "v"), lvalid),
            lambda: side(rk, rv, ("k2", "w"), rvalid))


@pytest.mark.parametrize("jt", [JoinType.INNER, JoinType.FULL])
def test_grace_smj_rebuckets_and_joins_hot_key(jt, join_core):
    """Past max_materialize_rows both sides are co-bucketed through K4's
    partition ids (its plain version here); the overflowing bucket is
    bucketed again twice and then joined whole as a hot bucket. The
    rows equal the unbucketed run's."""
    left, right = _grace_sides()
    cfg = EngineConfig(device="cpu", max_materialize_rows=300,
                       external_buckets=4)
    got, ctx = port_rows(SortMergeJoinExec(left(), right(), ["k"], ["k2"],
                                           jt), config=cfg)
    counters = ctx.metrics.counters
    assert counters["external_join_buckets"] == 4 + 4 + 4
    assert counters["external_join_rebuckets"] == 2
    assert counters["external_join_hot_buckets"] == 1
    exp, _ = port_rows(SortMergeJoinExec(left(), right(), ["k"], ["k2"],
                                         jt))
    assert sorted_rows(got) == sorted_rows(exp)
    # key 7 alone gives about 380 x 95 pairs
    assert len(sorted_rows(got)) > 30_000


def test_grace_smj_buckets_mixed_width_keys_together(join_core):
    """An int64 left key against an int32 right key: the port buckets
    the left key as its cast to int32, so equal keys share a bucket and
    the grace join equals the unbucketed one. The JAX package buckets
    each side in its own type (murmur3's hashLong against hashInt) and
    loses the matches: a reference fault (ROADMAP section 3)."""
    rng = np.random.default_rng(11)
    left = _side(["k", "v"], [DataType.int64(), DataType.int64()],
                 [rng.integers(0, 100, 400).astype(np.int64),
                  np.arange(400, dtype=np.int64)], [None, None],
                 [200, 200])
    right = _side(["k2", "w"], [DataType.int32(), DataType.int64()],
                  [rng.integers(0, 100, 150).astype(np.int32),
                   np.arange(150, dtype=np.int64)], [None, None], [150])

    def smj(pkg):
        cls = jax_ops.SortMergeJoinExec if pkg == "jax" \
            else SortMergeJoinExec
        scan = jax_scan if pkg == "jax" else port_scan
        return cls(scan(left), scan(right), ["k"], ["k2"],
                   _jt(pkg, JoinType.INNER))

    got, ctx = port_rows(smj("port"), config=EngineConfig(
        device="cpu", max_materialize_rows=100, external_buckets=4))
    assert ctx.metrics.counters["external_join_buckets"] >= 4
    exp = sorted_rows(port_rows(smj("port"))[0])
    assert sorted_rows(got) == exp and len(exp) > 400
    jgot, _ = jax_rows(smj("jax"), config=JaxConfig(
        max_materialize_rows=100, external_buckets=4))
    assert len(sorted_rows(jgot)) < len(exp)


# ---------------------------------------------------------------------------
# streaming sort-merge join
# ---------------------------------------------------------------------------

def _sorted_side(keys, vals, rows, names):
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    schema = Schema([Field(names[0], DataType.int64(), True),
                     Field(names[1], DataType.int64(), True)])
    cuts = list(range(0, len(keys), rows)) or [0]
    batches = [([_pad(keys[s:s + rows]), _pad(vals[s:s + rows])],
                [None, None], len(keys[s:s + rows])) for s in cuts]
    return schema, batches


@pytest.mark.parametrize("seed", [0])
def test_streaming_smj_matches_jax(seed, join_core):
    """Sorted multi-batch streams through the streaming join, every join
    type it takes: row for row equal to the JAX package's streaming
    join, and equal as sorted rows to the materializing join."""
    rng = np.random.default_rng(seed)
    left = _sorted_side(rng.integers(0, 25, 60), rng.integers(0, 100, 60),
                        7, ("k", "v"))
    right = _sorted_side(rng.integers(0, 25, 45), rng.integers(0, 100, 45),
                         5, ("k2", "w"))
    for jt in JTS[:-1]:
        got, _ = port_rows(StreamingSortMergeJoinExec(
            port_scan(left), port_scan(right), ["k"], ["k2"], jt))
        exp, _ = jax_rows(JStreamingSMJ(
            jax_scan(left), jax_scan(right), ["k"], ["k2"],
            jax_ops.JoinType[jt.name]))
        assert_same(got, exp, jt)
        ref, _ = port_rows(SortMergeJoinExec(
            port_scan(left), port_scan(right), ["k"], ["k2"], jt))
        assert sorted_rows(got) == sorted_rows(ref), jt


def test_streaming_smj_window_and_cores(monkeypatch, join_core):
    """The window never holds the whole right side, each right batch's
    core is built at most once, and empty sides join: the twins of
    test_streaming_smj.py's window, amortisation and empty-side tests."""
    from blaze_tpu_torch.ops import joins as port_joins

    keys = np.arange(100)
    op = StreamingSortMergeJoinExec(
        port_scan(_sorted_side(keys, keys * 2, 10, ("k", "v"))),
        port_scan(_sorted_side(keys, keys * 3, 10, ("k2", "w"))),
        ["k"], ["k2"], JoinType.INNER)
    widest = []
    orig = op._join_left_batch
    op._join_left_batch = lambda lb, lmax, window: (
        widest.append(len(window)) or orig(lb, lmax, window))
    assert sum(b.num_rows for b in port_rows(op)[0]) == 100
    assert max(widest) <= 3

    builds = []
    orig_init = port_joins._JoinCore.__init__

    def counting_init(self, *args, **kw):
        builds.append(1)
        orig_init(self, *args, **kw)

    monkeypatch.setattr(port_joins._JoinCore, "__init__", counting_init)
    rng = np.random.default_rng(5)
    lk, rk = np.sort(rng.integers(0, 12, 84)), np.sort(rng.integers(0, 12,
                                                                   84))
    left = _sorted_side(lk, np.arange(84), 7, ("k", "v"))
    right = _sorted_side(rk, np.arange(84) * 10, 7, ("k2", "w"))
    got = port_rows(StreamingSortMergeJoinExec(
        port_scan(left), port_scan(right), ["k"], ["k2"],
        JoinType.INNER))[0]
    assert len(builds) <= 12
    assert sorted_rows(got) == sorted_rows(port_rows(SortMergeJoinExec(
        port_scan(left), port_scan(right), ["k"], ["k2"],
        JoinType.INNER))[0])

    empty = _sorted_side(np.zeros(0, np.int64), np.zeros(0, np.int64), 5,
                         ("k", "v"))
    full = StreamingSortMergeJoinExec(
        port_scan(empty),
        port_scan(_sorted_side(np.array([1, 2]), np.array([10, 20]), 5,
                               ("k2", "w"))),
        ["k"], ["k2"], JoinType.FULL)
    assert sorted_rows(port_rows(full)[0]) == [(None, None, 1, 10),
                                               (None, None, 2, 20)]
    with pytest.raises(NotImplementedError):
        StreamingSortMergeJoinExec(
            port_scan(empty), port_scan(empty), ["k"], ["k"],
            JoinType.LEFT_ANTI_NULL_AWARE)


# ---------------------------------------------------------------------------
# TaskDefinitions
# ---------------------------------------------------------------------------

def _write(path, table):
    pq.write_table(table, path, row_group_size=1000)
    return path


@pytest.fixture(scope="module")
def join_files(tmp_path_factory):
    """A store_sales-shaped fact (item int32, price float32) and an item
    dimension (i_item = arange, i_brand int32), as bench.py makes them,
    at 5000 and 300 rows; and two sides for the join types, sorted on
    their keys (the streaming join needs it), with NULL keys."""
    d = tmp_path_factory.mktemp("joins")
    rng = np.random.default_rng(8)
    n, items = 5000, 300
    fact = _write(str(d / "ss.parquet"), pa.table({
        "item": rng.integers(0, items + 20, n).astype(np.int32),
        "price": (rng.random(n) * 100).astype(np.float32)}))
    dim = _write(str(d / "item.parquet"), pa.table({
        "i_item": np.arange(items, dtype=np.int32),
        "i_brand": rng.integers(0, 40, items).astype(np.int32)}))
    lk = np.sort(rng.integers(0, 60, 700))
    rk = np.sort(rng.integers(20, 90, 400))
    left = _write(str(d / "l.parquet"), pa.table({
        "a": pa.array(lk, mask=rng.random(700) < 0.05),
        "x": rng.random(700)}))
    right = _write(str(d / "r.parquet"), pa.table({
        "b": pa.array(rk, mask=rng.random(400) < 0.05),
        "y": rng.integers(0, 1000, 400)}))
    return {"fact": fact, "dim": dim, "left": left, "right": right}


def _join_agg(ops, scan, cols, fact, dim):
    """bench.py's join_agg: per brand SUM(price) and COUNT(*) over the
    fact joined with the item dimension."""
    return ops.HashAggregateExec(
        ops.ProjectExec(
            ops.HashJoinExec(
                scan(dim),
                ops.ProjectExec(scan(fact), [(cols.Col("item"), "item"),
                                             (cols.Col("price"), "price")]),
                ["i_item"], ["item"], ops.JoinType.INNER),
            [(cols.Col("i_brand"), "brand"), (cols.Col("price"), "price")]),
        keys=[(cols.Col("brand"), "brand")],
        aggs=[(cols.AggExpr(cols.AggFn.SUM, cols.Col("price")), "rev"),
              (cols.AggExpr(cols.AggFn.COUNT_STAR, None), "cnt")],
        mode=ops.AggMode.COMPLETE)


def _assert_agg_equal(got, exp):
    """brand and cnt equal row for row; rev within 1e-12 relative."""
    assert got.column("brand").equals(exp.column("brand"))
    assert got.column("cnt").equals(exp.column("cnt"))
    np.testing.assert_allclose(got.column("rev").to_numpy(),
                               exp.column("rev").to_numpy(), rtol=1e-12)


def test_join_agg_task_both_ways(join_files, join_core):
    """The join_agg TaskDefinition encoded by the JAX package runs on the
    port, and the port's encoding runs on the JAX package: the result
    equals the JAX package's row for row, on the direct table core."""
    import blaze_tpu.exprs.ir as jir
    from blaze_tpu.ops.parquet_scan import FileRange as JFileRange

    fact, dim = join_files["fact"], join_files["dim"]
    jplan = _join_agg(jax_ops, lambda p: JParquetScan(
        [[JFileRange(p)]]), jir, fact, dim)
    import blaze_tpu_torch.exprs.ir as pir

    pplan = _join_agg(_PortOps, lambda p: ParquetScanExec(
        [[FileRange(p)]]), pir, fact, dim)
    jblob = jax_serde.task_to_proto(jplan, 0)
    pblob = serde.task_to_proto(pplan, 0)
    ctx = ExecContext(device="cpu")
    got = pa.Table.from_batches(list(execute_task(jblob, ctx)))
    exp = pa.Table.from_batches(list(jax_execute_task(
        jblob, JaxContext(mesh_mode="off"))))
    _assert_agg_equal(got, exp)
    assert ctx.metrics.counters["dispatch.join_core.table_direct"] == 1
    assert ctx.metrics.counters["dispatch.d2h_syncs.join_keyspan"] == 1
    assert ctx.metrics.counters["dispatch.d2h_syncs.join_dup"] == 1
    back = pa.Table.from_batches(list(jax_execute_task(
        pblob, JaxContext(mesh_mode="off"))))
    _assert_agg_equal(back, exp)
    # and against numpy
    ft, dt = pq.read_table(fact), pq.read_table(dim)
    item = ft.column("item").to_numpy()
    ok = item < dt.num_rows
    brand = dt.column("i_brand").to_numpy()[item[ok]]
    cnt = np.bincount(brand, minlength=40)
    rev = np.bincount(brand, ft.column("price").to_numpy()[ok]
                      .astype(np.float64), minlength=40)
    b = got.column("brand").to_numpy()
    np.testing.assert_array_equal(got.column("cnt").to_numpy(), cnt[b])
    np.testing.assert_allclose(got.column("rev").to_numpy(), rev[b],
                               rtol=1e-12)


class _PortOps:
    """The port's operators under the JAX package's names."""
    HashAggregateExec = HashAggregateExec
    ProjectExec = ProjectExec
    HashJoinExec = HashJoinExec
    JoinType = JoinType
    AggMode = AggMode


@pytest.mark.parametrize("kind", ["hash", "smj", "streaming"])
def test_join_tasks_from_jax_blobs(kind, join_files, join_core):
    """hash_join and sort_merge_join TaskDefinitions (streaming on and
    off) for every join type, encoded by the JAX package: the port
    decodes the same operator and its rows equal the JAX package's
    (sorted: a task's batches may split differently); the port's
    re-encoding is byte-equal to the JAX blob."""
    from blaze_tpu.ops.parquet_scan import FileRange as JFileRange

    def scan(p):
        return JParquetScan([[JFileRange(p)]])

    left, right = join_files["left"], join_files["right"]
    for jt in JTS:
        jjt = jax_ops.JoinType[jt.name]
        if kind == "hash":
            if jt is JoinType.LEFT_ANTI_NULL_AWARE:
                continue
            jop = jax_ops.HashJoinExec(scan(left), scan(right), ["a"],
                                       ["b"], jjt)
        elif kind == "smj" or jt is JoinType.LEFT_ANTI_NULL_AWARE:
            jop = jax_ops.SortMergeJoinExec(scan(left), scan(right), ["a"],
                                            ["b"], jjt)
        else:
            jop = JStreamingSMJ(scan(left), scan(right), ["a"], ["b"], jjt)
        blob = jax_serde.task_to_proto(jop, 0)
        op, _, _, _ = serde.task_from_proto(blob)
        assert type(op).__name__ == type(jop).__name__
        assert serde.task_to_proto(op, 0) == blob
        got = list(execute_task(blob, ExecContext(device="cpu")))
        exp = list(jax_execute_task(blob, JaxContext(mesh_mode="off")))
        assert sorted_rows(got) == sorted_rows(exp), (kind, jt)


def test_join_plan_fusion_and_key_types(join_files, tmp_path, join_core):
    """The fusion pass reaches joins: the keyed COMPLETE aggregate above
    becomes HostFinalAggExec over a keyed FusedAggregateExec, and the
    INNER join under it gets its Filter/Project chains fused
    (`_fuse_join_under_agg`): the build side's even at one stage, the
    probe side's one stage recorded as `_fused_probe`. A string key
    against an integer key raises."""
    import blaze_tpu_torch.exprs.ir as pir
    from blaze_tpu_torch.ops import FilterExec
    from blaze_tpu_torch.ops.fused import (
        FusedAggregateExec,
        FusedPipelineExec,
        HostFinalAggExec,
    )
    from blaze_tpu_torch.planner.fuse import fuse_pipelines

    fact, dim = join_files["fact"], join_files["dim"]
    plan = _join_agg(_PortOps, lambda p: ParquetScanExec(
        [[FileRange(p)]]), pir, fact, dim)
    join = plan.children[0].children[0]
    join.children[0] = FilterExec(join.children[0], Col("i_brand") < 30)
    fused = fuse_pipelines(plan)
    assert isinstance(fused, HostFinalAggExec)
    agg = fused.children[0]
    assert isinstance(agg, FusedAggregateExec) and agg.fetch_host
    join = agg.pipeline.children[0]
    assert isinstance(join, HashJoinExec) and agg.children == [join]
    assert isinstance(join.children[0], FusedPipelineExec)
    probe = join.children[1]
    assert isinstance(probe, FusedPipelineExec)
    assert [type(s) for s in probe.stages] == [ProjectExec]
    assert join._fused_probe == (probe.children[0], probe)
    ctx = ExecContext(device="cpu")
    from blaze_tpu_torch.runtime.executor import execute_partition

    out = pa.Table.from_batches(list(execute_partition(fused, 0, ctx)))
    assert out.num_rows > 0
    assert ctx.metrics.counters["dispatch.join_core.table_direct"] == 1

    # string keys join since the strings slice; a string key against an
    # integer key still raises
    strings = _write(str(tmp_path / "s.parquet"),
                     pa.table({"s": ["a", "b"], "v": [1, 2]}))
    sj = HashJoinExec(ParquetScanExec([[FileRange(strings)]]),
                      ParquetScanExec([[FileRange(strings)]]), ["s"], ["s"])
    (rb,), _ = port_rows(sj)
    assert sorted(zip(*(c.to_pylist() for c in rb.columns))) == [
        ("a", 1, "a", 1), ("b", 2, "b", 2)]
    with pytest.raises(NotImplementedError, match="string key"):
        HashJoinExec(ParquetScanExec([[FileRange(strings)]]),
                     ParquetScanExec([[FileRange(strings)]]), ["s"], ["v"])
    with pytest.raises(ValueError, match="auto|scatter|sort"):
        set_config(EngineConfig(device="cpu", join_core="hash"))
        port_rows(make_join("port", "hash", *dataset("direct"),
                            JoinType.INNER))
