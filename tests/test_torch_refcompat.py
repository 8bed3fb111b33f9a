"""The port's reference-wire decoder (plan/refcompat.py) against the JAX
package's, on the CPU: the twin of tests/test_refcompat.py and
tests/test_refwire_corpus.py. The same reference-format TaskDefinition
bytes (built with the reference's own proto schema, plan.protobuf, or
hand-encoded by the corpus's wire-rule helpers) go through both
packages' `execute_reference_task`, for every arm of `plan_from_ref`:
parquet scan (file groups, byte range, projection, pruning predicate,
limit), filter, projection, sort, union, hash join, sort-merge join,
hash aggregate (PARTIAL, FINAL, FINAL_PARTITIONED), shuffle writer,
ipc reader in its three modes, ipc writer, rename, empty partitions and
debug; every expression arm and literal kind rides in them. Integer,
string, count and min/max columns are Arrow-equal after canonical row
order; float columns agree within 1e-9 relative (the corpus's
np.allclose/np.isclose checks are looser). Shuffle files are byte-equal.
The arms the JAX package refuses raise NotImplementedError in both."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.plan import refcompat
from blaze_tpu_torch.plan.refpb import refplan_pb2 as rp

from torch_support import assert_arrow_equal

N_FACT = 3000
N_DIM = 40
WORDS = np.array(["ant", "bee", "cat", "dog", "eel", "fox"])
FACT = [("k", "INT64"), ("p", "FLOAT64"), ("s", "UTF8"), ("q", "INT32")]
DIM = [("dk", "INT64"), ("dv", "FLOAT64")]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_refcompat")
    rng = np.random.default_rng(13)
    fact = pa.table({
        "k": pa.array(rng.integers(0, N_DIM + 5, N_FACT), pa.int64()),
        "p": np.round(rng.random(N_FACT) * 100, 3),
        "s": pa.array(WORDS[rng.integers(0, len(WORDS), N_FACT)],
                      mask=rng.random(N_FACT) < 0.1),
        "q": pa.array(rng.integers(-50, 50, N_FACT).astype(np.int32),
                      mask=rng.random(N_FACT) < 0.05),
    })
    fact_path = str(d / "fact.parquet")
    pq.write_table(fact, fact_path, row_group_size=700)
    dim_path = str(d / "dim.parquet")
    pq.write_table(pa.table({
        # 20 keys the fact side lacks: the anti joins keep them
        "dk": np.arange(N_DIM + 20, dtype=np.int64),
        "dv": np.round(rng.random(N_DIM + 20) * 10, 3)}), dim_path)
    return {"dir": d, "fact": fact_path, "dim": dim_path}


# ---------------------------------------------------------------------------
# reference-format builders (the Spark tier's proto emission)
# ---------------------------------------------------------------------------

def col(name):
    e = rp.PhysicalExprNode()
    e.column.name = name
    return e


def lit(kind, value):
    e = rp.PhysicalExprNode()
    setattr(e.literal, kind, value)
    return e


def binop(op, l, r):
    e = rp.PhysicalExprNode()
    e.binary_expr.op = op
    e.binary_expr.l.CopyFrom(l)
    e.binary_expr.r.CopyFrom(r)
    return e


def unary(kind, inner):
    e = rp.PhysicalExprNode()
    getattr(e, kind).expr.CopyFrom(inner)
    return e


def cast(inner, ty, kind="cast"):
    e = rp.PhysicalExprNode()
    getattr(e, kind).expr.CopyFrom(inner)
    getattr(getattr(e, kind).arrow_type, ty).SetInParent()
    return e


def fn(fun, *args, name=""):
    e = rp.PhysicalExprNode()
    e.scalar_function.fun = fun
    e.scalar_function.name = name
    for a in args:
        e.scalar_function.args.add().CopyFrom(a)
    return e


def agg(f, arg):
    e = rp.PhysicalExprNode()
    e.aggregate_expr.aggr_function = f
    e.aggregate_expr.expr.CopyFrom(arg)
    return e


def schema(fields):
    s = rp.Schema()
    for name, ty in fields:
        f = s.columns.add(name=name, nullable=True)
        getattr(f.arrow_type, ty).SetInParent()
    return s


def scan(path, fields, projection=None, rng=None, pruning=None,
         limit=None):
    node = rp.PhysicalPlanNode()
    conf = node.parquet_scan.base_conf
    f = conf.file_groups.add().files.add(path=path,
                                         size=os.path.getsize(path))
    if rng is not None:
        f.range.start, f.range.end = rng
    conf.schema.CopyFrom(schema(fields))
    if projection is not None:
        conf.projection.extend(projection)
    if limit is not None:
        conf.limit.limit = limit
    if pruning is not None:
        node.parquet_scan.pruning_predicate.CopyFrom(pruning)
    return node


def filt(inp, expr):
    node = rp.PhysicalPlanNode()
    node.filter.input.CopyFrom(inp)
    node.filter.expr.CopyFrom(expr)
    return node


def project(inp, named):
    node = rp.PhysicalPlanNode()
    node.projection.input.CopyFrom(inp)
    for e, name in named:
        node.projection.expr.add().CopyFrom(e)
        node.projection.expr_name.append(name)
    return node


def hash_agg(inp, mode, keys, aggs, fields):
    node = rp.PhysicalPlanNode()
    h = node.hash_aggregate
    h.mode = mode
    h.input.CopyFrom(inp)
    for e, name in keys:
        h.group_expr.add().CopyFrom(e)
        h.group_expr_name.append(name)
    for e, name in aggs:
        h.aggr_expr.add().CopyFrom(e)
        h.aggr_expr_name.append(name)
    h.input_schema.CopyFrom(schema(fields))
    return node


def join(kind, left, right, on, join_type, **extra):
    node = rp.PhysicalPlanNode()
    j = getattr(node, kind)
    j.left.CopyFrom(left)
    j.right.CopyFrom(right)
    for lk, rk in on:
        o = j.on.add()
        o.left.name = lk
        o.right.name = rk
        if kind == "sort_merge_join":
            j.sort_options.add(asc=True)
    j.join_type = join_type
    for k, v in extra.items():
        setattr(j, k, v)
    return node


def shuffle_writer(inp, keys, count, data, index):
    node = rp.PhysicalPlanNode()
    w = node.shuffle_writer
    w.input.CopyFrom(inp)
    for e in keys:
        w.output_partitioning.hash_expr.add().CopyFrom(e)
    w.output_partitioning.partition_count = count
    w.output_data_file = data
    w.output_index_file = index
    return node


def ipc_reader(rid, fields, n, mode):
    node = rp.PhysicalPlanNode()
    r = node.ipc_reader
    r.num_partitions = n
    r.schema.CopyFrom(schema(fields))
    r.mode = mode
    r.ipc_provider_resource_id = rid
    return node


def task(plan, partition=0, out_partitioning=None):
    t = rp.TaskDefinition()
    t.task_id.job_id = "twin"
    t.task_id.partition_id = partition
    t.plan.CopyFrom(plan)
    if out_partitioning is not None:
        t.output_partitioning.CopyFrom(out_partitioning)
    return t.SerializeToString()


# ---------------------------------------------------------------------------
# the cases: name -> (data, out dir) -> (blob, resources)
# ---------------------------------------------------------------------------

def _scan_pruned(d, out):
    size = os.path.getsize(d["fact"])
    pruning = rp.LogicalExprNode()
    b = pruning.between
    b.expr.column.name = "p"
    b.low.literal.float64_value = 10.0
    b.high.literal.float64_value = 60.0
    return task(scan(d["fact"], FACT, projection=[3, 1, 0],
                     rng=(0, size), pruning=pruning)), {}


def _scan_limit(d, out):
    return task(scan(d["fact"], FACT, limit=777)), {}


def _filter_project(d, out):
    pred = binop(
        "Or",
        binop("And", unary("is_not_null_expr", col("s")),
              binop("LtEq", col("p"), lit("float64_value", 40.0))),
        binop("And",
              unary("not_expr", unary("is_null_expr", col("q"))),
              binop("Gt", col("q"), lit("int32_value", 30))))
    inl = rp.PhysicalExprNode()
    inl.in_list.expr.CopyFrom(col("s"))
    for w in ("ant", "eel"):
        inl.in_list.list.add().literal.utf8_value = w
    case = rp.PhysicalExprNode()
    case.case_.expr.CopyFrom(col("s"))
    wt = case.case_.when_then_expr.add()
    wt.when_expr.literal.utf8_value = "cat"
    wt.then_expr.CopyFrom(lit("int64_value", 1))
    case.case_.else_expr.CopyFrom(lit("int64_value", -1))
    named = [
        (col("k"), "k"),
        (binop("Multiply", col("p"), lit("float64_value", 2.5)), "p2"),
        (binop("Plus", cast(col("q"), "INT64"), col("k")), "qk"),
        (binop("Modulo", col("k"), lit("int64_value", 7)), "km"),
        (binop("Divide", col("p"), lit("float64_value", 4.0)), "pd"),
        (unary("negative", col("q")), "nq"),
        (inl, "in_ae"),
        (case, "is_cat"),
        (fn(rp.Upper, col("s")), "su"),
        (fn(rp.Abs, col("q")), "aq"),
        (fn(rp.Sqrt, col("p")), "sp"),
        (fn(rp.Coalesce, col("q"), lit("int32_value", 0)), "cq"),
        (cast(col("q"), "FLOAT64", "try_cast"), "qf"),
        (binop("NotEq", col("s"), lit("utf8_value", "dog")), "nd"),
    ]
    return task(project(filt(scan(d["fact"], FACT), pred), named)), {}


def _sort(d, out):
    node = rp.PhysicalPlanNode()
    node.sort.input.CopyFrom(scan(d["fact"], FACT))
    for c, asc, nf in (("s", True, True), ("p", False, False)):
        e = node.sort.expr.add()
        e.sort.expr.CopyFrom(col(c))
        e.sort.asc = asc
        e.sort.nulls_first = nf
    return task(node), {}


def _union(d, out):
    node = rp.PhysicalPlanNode()
    node.union.children.add().CopyFrom(
        filt(scan(d["fact"], FACT),
             binop("Lt", col("k"), lit("int64_value", 10))))
    node.union.children.add().CopyFrom(
        filt(scan(d["fact"], FACT),
             binop("GtEq", col("k"), lit("int64_value", 30))))
    return task(node, partition=1), {}


def _join(kind, jt):
    def make(d, out):
        return task(join(kind, scan(d["dim"], DIM), scan(d["fact"], FACT),
                         [("dk", "k")], jt)), {}
    return make


def _agg_stack(final_mode, keyed):
    def make(d, out):
        keys = [(col("k"), "k")] if keyed else []
        partial = hash_agg(
            scan(d["fact"], FACT), rp.PARTIAL, keys,
            [(agg(rp.SUM, col("p")), "sp"), (agg(rp.COUNT, col("q")), "cq"),
             (agg(rp.MIN, col("q")), "mn"), (agg(rp.MAX, col("p")), "mx"),
             (agg(rp.AVG, col("q")), "aq")], FACT)
        mid = [("k", "INT64")] if keyed else []
        final = hash_agg(
            partial, final_mode, keys,
            [(agg(rp.SUM, col("sp")), "sp"), (agg(rp.COUNT, col("cq")), "cq"),
             (agg(rp.MIN, col("mn")), "mn"), (agg(rp.MAX, col("mx")), "mx"),
             (agg(rp.AVG, col("aq")), "aq")],
            mid + [("sp", "FLOAT64"), ("cq", "INT64"), ("mn", "INT32"),
                   ("mx", "FLOAT64"), ("aq", "FLOAT64")])
        return task(final), {}
    return make


def _variance(d, out):
    return task(hash_agg(
        scan(d["fact"], FACT), rp.PARTIAL, [(col("s"), "s")],
        [(agg(rp.VARIANCE, col("p")), "v"),
         (agg(rp.STDDEV_POP, col("p")), "sd")], FACT)), {}


def _shuffle(d, out):
    node = shuffle_writer(scan(d["fact"], FACT), [col("k"), col("s")], 5,
                          os.path.join(out, "h.data"),
                          os.path.join(out, "h.index"))
    return task(node, out_partitioning=node.shuffle_writer
                .output_partitioning), {}


def _shuffle_single(d, out):
    node = shuffle_writer(scan(d["fact"], FACT), [], 1,
                          os.path.join(out, "s.data"),
                          os.path.join(out, "s.index"))
    return task(node), {}


def _fact_parts():
    from blaze_tpu_torch.io.ipc import encode_ipc_segment

    rb = pa.record_batch({
        "k": pa.array([3, 1, None, 7], pa.int64()),
        "p": pa.array([0.5, 1.5, 2.5, None], pa.float64()),
        "s": pa.array(["x", None, "yy", "x"]),
        "q": pa.array([1, 2, 3, 4], pa.int32())})
    return rb, encode_ipc_segment(rb)


def _ipc_file_segment(d, out):
    from blaze_tpu_torch.io.ipc import encode_ipc_segment

    rb, part = _fact_parts()
    path = os.path.join(out, "seg.data")
    with open(path, "wb") as f:
        f.write(b"\0" * 11 + part + encode_ipc_segment(rb.slice(1, 2)))
    n = os.path.getsize(path) - 11
    segs = [[], [{"file": path, "offset": 11, "length": n}]]
    return task(ipc_reader("r", FACT, 2, rp.CHANNEL_AND_FILE_SEGMENT),
                partition=1), {"r": segs}


def _ipc_channel(d, out):
    rb, part = _fact_parts()
    return task(ipc_reader("r", FACT, 1, rp.CHANNEL)), {"r": [[part]]}


def _ipc_uncompressed(d, out):
    rb, _ = _fact_parts()
    return task(ipc_reader("r", FACT, 1, rp.CHANNEL_UNCOMPRESSED)), \
        {"r": [[rb]]}


def _ipc_writer(d, out):
    node = rp.PhysicalPlanNode()
    node.ipc_writer.input.CopyFrom(
        filt(scan(d["fact"], FACT),
             binop("Gt", col("p"), lit("float64_value", 90.0))))
    node.ipc_writer.ipc_consumer_resource_id = "sink"
    return task(node), {}


def _rename_debug(d, out):
    node = rp.PhysicalPlanNode()
    node.debug.debug_id = "dbg"
    node.debug.input.rename_columns.input.CopyFrom(scan(d["dim"], DIM))
    node.debug.input.rename_columns.renamed_column_names.extend(
        ["a", "b"])
    return task(node), {}


def _empty(d, out):
    node = rp.PhysicalPlanNode()
    node.empty_partitions.schema.CopyFrom(schema(FACT))
    node.empty_partitions.num_partitions = 3
    return task(node, partition=2), {}


def _corpus_hand_bytes(d, out):
    """A fixture of tests/test_refwire_corpus.py, hand-encoded from the
    protobuf wire rules (not by the generated encoder)."""
    import test_refwire_corpus as c

    fact = c.schema_(c.field_("k", c.A_INT64), c.field_("p", c.A_FLOAT64))
    sc = c.parquet_scan_node(d["fact"], fact, projection=(0, 1))
    plan = c.sort_node(
        c.projection_node(
            c.filter_node(sc, c.binop("Gt", c.col("p", 1),
                                      c.lit_f64(50.0))),
            [c.binop("Multiply", c.col("p", 1), c.lit_f64(2.0)),
             c.col("k", 0)], ["p2", "k"]),
        [c.sort_expr(c.col("p2", 0), asc=False)])
    return c.task(plan), {}


CASES = {
    "scan_range_projection_pruning": _scan_pruned,
    "scan_limit": _scan_limit,
    "filter_project_exprs": _filter_project,
    "sort": _sort,
    "union": _union,
    "hash_join_inner": _join("hash_join", rp.INNER),
    "hash_join_left": _join("hash_join", rp.LEFT),
    "hash_join_semi": _join("hash_join", rp.SEMI),
    "hash_join_anti": _join("hash_join", rp.ANTI),
    "smj_inner": _join("sort_merge_join", rp.INNER),
    "smj_full": _join("sort_merge_join", rp.FULL),
    "smj_right": _join("sort_merge_join", rp.RIGHT),
    "agg_partial_final": _agg_stack(rp.FINAL, True),
    "agg_final_partitioned": _agg_stack(rp.FINAL_PARTITIONED, True),
    "agg_keyless": _agg_stack(rp.FINAL, False),
    "agg_variance_by_string": _variance,
    "shuffle_writer_hash": _shuffle,
    "shuffle_writer_single": _shuffle_single,
    "ipc_reader_file_segment": _ipc_file_segment,
    "ipc_reader_channel": _ipc_channel,
    "ipc_reader_uncompressed": _ipc_uncompressed,
    "ipc_writer": _ipc_writer,
    "rename_debug": _rename_debug,
    "empty_partitions": _empty,
    "corpus_hand_bytes": _corpus_hand_bytes,
}


def _resources(raw, package):
    """Manifest-like {rid: [[source...]]} as the package's sources."""
    if package == "jax":
        from blaze_tpu.ops.ipc_reader import FileSegment
    else:
        from blaze_tpu_torch.ops.ipc_reader import FileSegment
    return {rid: [[FileSegment(s["file"], s["offset"], s["length"])
                   if isinstance(s, dict) else s for s in part]
                  for part in parts] for rid, parts in raw.items()}


def _run(package, blob, resources):
    if package == "jax":
        from blaze_tpu.ops.base import ExecContext as JCtx
        from blaze_tpu.plan.refcompat import execute_reference_task

        ctx = JCtx()
    else:
        execute_reference_task = refcompat.execute_reference_task
        ctx = ExecContext(device="cpu")
    ctx.resources.update(resources)
    out = list(execute_reference_task(blob, ctx=ctx))
    return out, ctx


def _canonical(batches):
    t = pa.Table.from_batches(batches).combine_chunks()
    t = t.cast(pa.schema([
        pa.field(f.name, f.type.value_type)
        if pa.types.is_dictionary(f.type) else f for f in t.schema]))
    floats = [n for n, f in zip(t.schema.names, t.schema)
              if pa.types.is_floating(f.type)]
    order = [n for n in t.schema.names if n not in floats] + floats
    if not t.num_rows:
        return t
    return t.sort_by([(n, "ascending") for n in order])


def _assert_tables_match(a, b):
    assert a.schema.names == b.schema.names
    assert a.num_rows == b.num_rows
    floats = [n for n, f in zip(a.schema.names, a.schema)
              if pa.types.is_floating(f.type)]
    exact = [n for n in a.schema.names if n not in floats]
    assert_arrow_equal(a.select(exact), b.select(exact))
    for n in floats:
        x, y = a.column(n), b.column(n)
        assert x.type == y.type, n
        assert x.is_null().equals(y.is_null()), n
        np.testing.assert_allclose(
            x.fill_null(0).to_numpy(), y.fill_null(0).to_numpy(),
            rtol=1e-9, equal_nan=True, err_msg=n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_task_matches_jax(name, data, tmp_path):
    outs = {}
    for package in ("jax", "port"):
        out_dir = tmp_path / package
        out_dir.mkdir()
        blob, raw = CASES[name](data, str(out_dir))
        batches, ctx = _run(package, blob, _resources(raw, package))
        outs[package] = (batches, ctx, str(out_dir))
    (jb, jctx, jdir), (pb_, pctx, pdir) = outs["jax"], outs["port"]
    if name.startswith("shuffle_writer"):
        assert jb == [] and pb_ == []
        for f in sorted(os.listdir(jdir)):
            with open(os.path.join(jdir, f), "rb") as a, \
                    open(os.path.join(pdir, f), "rb") as b:
                assert a.read() == b.read(), f
        return
    if name == "ipc_writer":
        from blaze_tpu_torch.io.ipc import decode_ipc_parts

        jb = [rb for p in jctx.resources["sink"] for rb in
              decode_ipc_parts(p)]
        pb_ = [rb for p in pctx.resources["sink"] for rb in
               decode_ipc_parts(p)]
        assert jb
    if name == "empty_partitions":
        assert jb == [] and pb_ == []
        return
    if name in ("sort", "corpus_hand_bytes"):
        # the sort's output order itself, not only its rows
        jt, pt = pa.Table.from_batches(jb), pa.Table.from_batches(pb_)
        for n in jt.schema.names:
            assert jt.column(n).to_pylist() == pt.column(n).to_pylist(), n
    jt, pt = _canonical(jb), _canonical(pb_)
    assert jt.num_rows > 0
    _assert_tables_match(jt, pt)


# ---------------------------------------------------------------------------
# refused arms: both packages raise NotImplementedError at decode
# ---------------------------------------------------------------------------

def _refused_cases(d):
    fact = scan(d["fact"], FACT)
    dim = scan(d["dim"], DIM)
    cases = {
        "partitioned_hash_join": join("hash_join", dim, fact, [("dk", "k")],
                                      rp.INNER, partition_mode=rp.PARTITIONED),
        "null_safe_hash_join": join("hash_join", dim, fact, [("dk", "k")],
                                    rp.INNER, null_equals_null=True),
        "null_safe_smj": join("sort_merge_join", dim, fact, [("dk", "k")],
                              rp.INNER, null_equals_null=True),
        "hash_join_post_filter": join("hash_join", dim, fact,
                                      [("dk", "k")], rp.INNER),
        "md5": filt(fact, fn(rp.MD5, col("s"))),
        "approx_distinct": hash_agg(fact, rp.PARTIAL, [],
                                    [(agg(rp.APPROX_DISTINCT, col("k")),
                                      "n")], FACT),
        "keyless_multi_partition_writer": shuffle_writer(fact, [], 4,
                                                         "/d", "/i"),
        "bare_sort_expr": project(fact, [(rp.PhysicalExprNode(
            sort=rp.PhysicalSortExprNode(expr=col("k"))), "x")]),
        "window_expr": project(fact, [(rp.PhysicalExprNode(
            window_expr=rp.PhysicalWindowExprNode(
                aggr_function=rp.SUM, expr=col("k"))), "w")]),
        "uint64_beyond_int64": filt(fact, binop(
            "Gt", col("k"), lit("uint64_value", 1 << 63))),
        "nanosecond_timestamp": ipc_reader("r", [("t", "TIMESTAMP")], 1,
                                           rp.CHANNEL),
        "unknown_binary_op": filt(fact, binop("BitwiseXor", col("k"),
                                              col("k"))),
    }
    j = cases["hash_join_post_filter"].hash_join
    j.filter.expression.CopyFrom(lit("bool_value", True))
    cases["nanosecond_timestamp"].ipc_reader.schema.columns[0] \
        .arrow_type.TIMESTAMP.time_unit = rp.Nanosecond
    part_cols = scan(d["fact"], FACT)
    part_cols.parquet_scan.base_conf.table_partition_cols.append("dt")
    cases["table_partition_cols"] = part_cols
    part_vals = scan(d["fact"], FACT)
    part_vals.parquet_scan.base_conf.file_groups[0].files[0] \
        .partition_values.add().int32_value = 1
    cases["partition_values"] = part_vals
    blobs = {k: task(v) for k, v in cases.items()}
    out = rp.PhysicalHashRepartition(partition_count=3)
    out.hash_expr.add().CopyFrom(col("k"))
    blobs["output_partitioning_without_writer"] = task(fact,
                                                      out_partitioning=out)
    return blobs


REFUSED = [
    "partitioned_hash_join", "null_safe_hash_join", "null_safe_smj",
    "hash_join_post_filter", "md5", "approx_distinct",
    "keyless_multi_partition_writer", "bare_sort_expr", "window_expr",
    "uint64_beyond_int64", "nanosecond_timestamp", "unknown_binary_op",
    "table_partition_cols", "partition_values",
    "output_partitioning_without_writer",
]


@pytest.mark.parametrize("name", REFUSED)
def test_refused_arms_raise_in_both(name, data):
    from blaze_tpu.plan.refcompat import task_from_reference_proto as jdec

    blob = _refused_cases(data)[name]
    with pytest.raises(NotImplementedError) as jerr:
        jdec(blob)
    with pytest.raises(NotImplementedError) as perr:
        refcompat.task_from_reference_proto(blob)
    assert str(perr.value) == str(jerr.value)


def test_degenerate_range_scans_nothing_and_pruning_may_fail(data):
    """A split with an empty byte range owns no rows, and a pruning
    predicate of a shape the scan cannot read is dropped, not fatal -
    in both packages."""
    from blaze_tpu.plan.refcompat import plan_from_ref as jplan

    node = scan(data["fact"], FACT, rng=(5, 5))
    assert refcompat.plan_from_ref(node).file_groups == [[]] == \
        jplan(node).file_groups
    node = scan(data["fact"], FACT)
    node.parquet_scan.pruning_predicate.is_null_expr.expr.column.name = "k"
    assert refcompat.plan_from_ref(node).pruning_predicate is None
    assert jplan(node).pruning_predicate is None
