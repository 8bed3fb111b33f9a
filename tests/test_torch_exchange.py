"""The port's exchange tier against the JAX package, on the CPU: the
segmented-IPC format (io/ipc.py), the shuffle writer in its hash, single
and round_robin modes, the IPC reader and writer, their serde arms and
task file resources, a map stage and its reduce tasks through
`execute_task`, and keyed grace aggregation (ops/external.py,
HashAggregateExec._grace_agg).

Inputs come from seeded numpy generators. The JAX side runs under
JAX_PLATFORMS=cpu with mesh_mode="off", once per module fixture.
Integer, count and min/max results are Arrow-equal; float sums agree
within 1e-12 relative (the two packages add in other orders). Zstd bytes
may differ between zstd builds, so files are compared by their framing,
their index and each part's decompressed IPC stream.
"""

import io
import os
import struct

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.types as pat
import pytest

from blaze_tpu import ops as jax_ops
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.config import EngineConfig as JaxConfig
from blaze_tpu.exprs.ir import AggExpr as JAggExpr, AggFn as JAggFn
from blaze_tpu.exprs.ir import Col as JCol
from blaze_tpu.io import ipc as jax_ipc
from blaze_tpu.ops.base import ExecContext as JaxContext
from blaze_tpu.ops.ipc_reader import FileSegment as JFileSegment
from blaze_tpu.ops.ipc_reader import IpcReaderExec as JIpcReader
from blaze_tpu.ops.ipc_reader import IpcReadMode as JIpcReadMode
from blaze_tpu.ops.ipc_writer import IpcWriterExec as JIpcWriter
from blaze_tpu.ops.shuffle_writer import ShuffleWriterExec as JShuffleWriter
from blaze_tpu.plan import serde as jax_serde
from blaze_tpu.runtime import memory as jax_memory
from blaze_tpu.runtime.executor import execute_task as jax_execute_task
from blaze_tpu.runtime.executor import run_plan as jax_run_plan
from blaze_tpu.runtime.transport import RemoteSegment

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.config import EngineConfig
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
from blaze_tpu_torch.io import ipc
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    FileRange,
    FilterExec,
    HashAggregateExec,
    MemoryScanExec,
    ParquetScanExec,
)
from blaze_tpu_torch.ops.ipc_reader import FileSegment, IpcReaderExec, \
    IpcReadMode
from blaze_tpu_torch.ops.ipc_writer import IpcWriterExec, collect_ipc
from blaze_tpu_torch.ops.shuffle_writer import ShuffleWriterExec
from blaze_tpu_torch.plan import serde
from blaze_tpu_torch.runtime import memory
from blaze_tpu_torch.runtime.executor import execute_task, run_plan

import chip_smoke
from test_format_goldens import DATA_HEX, INDEX_HEX, _expected_tables
from torch_support import assert_arrow_equal, jax_schema

PARTS = 13  # shuffle partitions of the writer tests


def parts_of(buf: bytes):
    """The decompressed IPC stream of each part of a segment."""
    out, pos = [], 0
    while pos + 8 <= len(buf):
        (n,) = struct.unpack_from("<Q", buf, pos)
        out.append(ipc.decompress_frame(buf[pos + 8: pos + 8 + n]))
        pos += 8 + n
    assert pos == len(buf)
    return out


def assert_files_equal(data_a, index_a, data_b, index_b):
    """Same index; per partition the same number of parts with the same
    decompressed IPC bytes."""
    assert open(index_a, "rb").read() == open(index_b, "rb").read()
    a, b = open(data_a, "rb").read(), open(data_b, "rb").read()
    for off, length in ipc.partition_ranges(index_a):
        assert parts_of(a[off:off + length]) == parts_of(b[off:off + length])


def same(got_batches, exp_batches):
    """The same rows, NaN equal to NaN."""
    assert_arrow_equal(pa.Table.from_batches(got_batches),
                       pa.Table.from_batches(exp_batches))


def assert_close_rows(got, exp):
    """Row for row: float columns within 1e-12 relative (sums), all else
    exact."""
    assert got.schema == exp.schema, (got.schema, exp.schema)
    assert got.num_rows == exp.num_rows
    for name in exp.schema.names:
        g = got.column(name).combine_chunks()
        e = exp.column(name).combine_chunks()
        np.testing.assert_array_equal(np.asarray(g.is_null()),
                                      np.asarray(e.is_null()), err_msg=name)
        if pat.is_floating(g.type):
            np.testing.assert_allclose(
                g.fill_null(0).to_numpy(), e.fill_null(0).to_numpy(),
                rtol=1e-12, atol=0, equal_nan=True, err_msg=name)
        else:
            assert g.equals(e), name


def arrow_batches(seed, sizes):
    """Batches with a nullable int32 key, an int64 key, a float64 with
    NaN and nulls, a date32 and a bool."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = rng.random(n) * 100
        x[rng.integers(0, n, 3)] = np.nan
        out.append(pa.record_batch({
            "k": pa.array(rng.integers(-500, 500, n).astype(np.int32),
                          mask=rng.random(n) < 0.1),
            "l": rng.integers(-2 ** 40, 2 ** 40, n),
            "x": pa.array(x, mask=rng.random(n) < 0.05),
            "d": pa.array(rng.integers(0, 20000, n).astype(np.int32))
                  .cast(pa.date32()),
            "b": rng.random(n) < 0.5,
        }))
    return out


# ---------------------------------------------------------------------------
# io/ipc.py
# ---------------------------------------------------------------------------

FORMAT_BATCHES = {
    "mixed": lambda: arrow_batches(1, [300])[0],
    "one_row": lambda: arrow_batches(2, [1])[0],
    "decimal_ts": lambda: pa.record_batch({
        "m": pa.array([12345, -1, None], pa.decimal128(12, 2)),
        "t": pa.array([0, 1_600_000_000_000_000, None],
                      pa.timestamp("us"))}),
    "wide": lambda: pa.record_batch(
        {f"c{i}": np.arange(5000, dtype=np.int64) * i for i in range(8)}),
}


@pytest.mark.parametrize("kind", sorted(FORMAT_BATCHES))
def test_parts_decode_in_both_packages(kind):
    """A part the port writes decodes in the JAX package and the
    reverse; both hold the same IPC stream bytes."""
    rb = FORMAT_BATCHES[kind]()
    mine, theirs = ipc.encode_ipc_segment(rb), jax_ipc.encode_ipc_segment(rb)
    assert parts_of(mine) == parts_of(theirs) == [ipc.ipc_stream_bytes(rb)]
    for buf in (mine, theirs):
        same(list(ipc.decode_ipc_parts(buf)), [rb])
        same(list(jax_ipc.decode_ipc_parts(buf)), [rb])
    stream = list(ipc.decode_ipc_stream(io.BytesIO(theirs + mine)))
    assert len(stream) == 2


def test_empty_batch_writes_nothing():
    rb = arrow_batches(3, [5])[0].slice(0, 0)
    assert ipc.encode_ipc_segment(rb) == jax_ipc.encode_ipc_segment(rb) == b""
    assert list(ipc.decode_ipc_parts(b"\0" * 8)) == []


def test_raw_and_streaming_frames_decode():
    """The JAX package's zstd-less BLZRAW frame, and a zstd frame whose
    header states no content size (a streaming compressor's)."""
    rb = arrow_batches(4, [50])[0]
    raw = ipc.ipc_stream_bytes(rb)
    blz = ipc.RAW_FRAME_MAGIC + raw
    sink = pa.BufferOutputStream()
    with pa.output_stream(sink, compression="zstd") as out:
        out.write(raw)
    streamed = sink.getvalue().to_pybytes()
    assert ipc._content_size(streamed) is None
    for frame in (blz, streamed):
        part = struct.pack("<Q", len(frame)) + frame
        same(list(ipc.decode_ipc_parts(part)), [rb])
        same(list(jax_ipc.decode_ipc_parts(part)), [rb])


def test_golden_shuffle_pair_decodes():
    """tests/test_format_goldens.py's pinned .data/.index pair."""
    data = bytes.fromhex(DATA_HEX)
    path = io.BytesIO(bytes.fromhex(INDEX_HEX))
    offs = struct.unpack("<4q", path.getvalue())
    t0, t2 = _expected_tables()
    got = [pa.Table.from_batches(list(ipc.decode_ipc_parts(
        data[offs[i]:offs[i + 1]]))) if offs[i + 1] > offs[i] else None
        for i in range(3)]
    assert got[0].equals(t0) and got[1] is None and got[2].equals(t2)


def test_golden_index_ranges(tmp_path):
    (tmp_path / "g.index").write_bytes(bytes.fromhex(INDEX_HEX))
    (tmp_path / "g.data").write_bytes(bytes.fromhex(DATA_HEX))
    ranges = ipc.partition_ranges(str(tmp_path / "g.index"))
    assert ranges == [(0, 193), (193, 0), (193, 184)]
    got = list(ipc.read_file_segment(str(tmp_path / "g.data"), 193, 184))
    assert pa.Table.from_batches(got).equals(_expected_tables()[1])


def test_truncated_part_and_missing_codec_raise(monkeypatch, tmp_path):
    part = ipc.encode_ipc_segment(arrow_batches(5, [20])[0])
    with pytest.raises(IOError):
        list(ipc.decode_ipc_parts(part[:-3]))
    with pytest.raises(IOError):
        list(ipc.decode_ipc_stream(io.BytesIO(part[:-3])))
    (tmp_path / "d").write_bytes(part)
    with pytest.raises(IOError):
        list(ipc.read_file_segment(str(tmp_path / "d"), 0, len(part) + 1))
    import types

    monkeypatch.setattr(ipc, "pa", types.SimpleNamespace(
        Codec=types.SimpleNamespace(is_available=lambda name: False)))
    with pytest.raises(RuntimeError, match="zstd"):
        ipc.encode_ipc_segment(arrow_batches(5, [20])[0])


def test_coalesce_keeps_rows_and_order():
    rbs = arrow_batches(6, [100, 200, 50, 400, 10])
    out = list(ipc.coalesce(iter(rbs), 350))
    assert [b.num_rows for b in out] == [350, 400, 10]
    same(out, rbs)


# ---------------------------------------------------------------------------
# the shuffle writer against the JAX package's
# ---------------------------------------------------------------------------

WRITER_SIZES = [1000, 613, 1024, 300]  # one capacity, 1024
MAP_PARTITION = 2  # round robin starts here


def _writer_inputs():
    return arrow_batches(10, WRITER_SIZES)


# range: (k ASC NULLS FIRST, x DESC) against bounds that put NULL k, a
# NaN x (ranked above every number) and ties on a bound to the test
RANGE_BOUNDS = [(None, 50.0), (-200, float("inf")), (-200, 10.0), (0, 99.0),
                (250, 0.5), (499, None)]
RANGE_ASC = [True, False]


def _writer_keys(mode, col):
    if mode == "hash":
        return [col("k"), col("l")]
    return [col("k"), col("x")] if mode == "range" else []


def _range_args(mode):
    if mode != "range":
        return {}
    return {"range_bounds": RANGE_BOUNDS, "sort_ascending": RANGE_ASC}


def port_writer(mode, data, index, child=None, parts=PARTS):
    if child is None:
        cbs = [ColumnBatch.from_arrow(rb, device="cpu")
               for rb in _writer_inputs()]
        child = MemoryScanExec([cbs] * (MAP_PARTITION + 1), cbs[0].schema)
    return ShuffleWriterExec(child, _writer_keys(mode, Col), parts, data,
                             index, mode, **_range_args(mode))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each mode's .data/.index pair from both packages' writers over
    the same batches, as map partition MAP_PARTITION."""
    d = tmp_path_factory.mktemp("writer")
    out = {}
    for mode in ("hash", "single", "round_robin", "range"):
        pd_, pi = str(d / f"port_{mode}.data"), str(d / f"port_{mode}.index")
        op = port_writer(mode, pd_, pi)
        ctx = ExecContext(device="cpu")
        assert list(op.execute(MAP_PARTITION, ctx)) == []
        jbs = [JBatch.from_arrow(rb) for rb in _writer_inputs()]
        jd, ji = str(d / f"jax_{mode}.data"), str(d / f"jax_{mode}.index")
        jop = JShuffleWriter(
            jax_ops.MemoryScanExec([jbs] * (MAP_PARTITION + 1),
                                   jbs[0].schema),
            _writer_keys(mode, JCol), PARTS, jd, ji, mode,
            **_range_args(mode))
        list(jop.execute(MAP_PARTITION, JaxContext()))
        out[mode] = (pd_, pi, jd, ji, ctx.metrics.counters)
    return out


@pytest.mark.parametrize("mode", ["hash", "single", "round_robin", "range"])
def test_shuffle_writer_matches_jax(written, mode):
    pd_, pi, jd, ji, counters = written[mode]
    assert_files_equal(pd_, pi, jd, ji)
    rows = sum(WRITER_SIZES)
    assert counters["shuffle_rows_written"] == rows
    assert counters["shuffle_bytes_written"] == os.path.getsize(pd_)
    offs = ipc.read_index_file(pi)
    assert len(offs) == PARTS + 1 and offs[0] == 0
    assert offs == sorted(offs) and offs[-1] == os.path.getsize(pd_)
    got = sum(rb.num_rows for o, n in ipc.partition_ranges(pi)
              for rb in ipc.read_file_segment(pd_, o, n))
    assert got == rows


def test_hash_partitions_follow_spark_in_input_order(written):
    """Every row lies in the partition numpy's Spark hash of (k, l)
    gives it, in input order."""
    from blaze_tpu_torch.exprs import hashing

    pd_, pi = written["hash"][:2]
    t = pa.Table.from_batches(_writer_inputs())
    k = t.column("k").combine_chunks()
    h = np.full(t.num_rows, 42, np.uint32)
    link = hashing._np_hash_int(
        k.fill_null(0).to_numpy().astype(np.int32).view(np.uint32), h)
    h = np.where(np.asarray(k.is_valid()), link, h)
    h = hashing._np_hash_long(t.column("l").to_numpy(), h)
    pid = h.view(np.int32).astype(np.int64) % PARTS
    for p, (o, n) in enumerate(ipc.partition_ranges(pi)):
        got = pa.Table.from_batches(list(ipc.read_file_segment(pd_, o, n)),
                                    t.schema)
        assert_arrow_equal(got, t.take(np.flatnonzero(pid == p)))


def test_round_robin_starts_at_map_partition(written):
    pd_, pi = written["round_robin"][:2]
    t = pa.Table.from_batches(_writer_inputs())
    pos = np.concatenate([np.arange(n) for n in WRITER_SIZES])
    # each batch continues where the last one stopped
    starts = np.cumsum([MAP_PARTITION] + WRITER_SIZES[:-1])
    pid = (pos + np.repeat(starts, WRITER_SIZES)) % PARTS
    o, n = ipc.partition_ranges(pi)[0]
    got = pa.Table.from_batches(list(ipc.read_file_segment(pd_, o, n)))
    assert_arrow_equal(got, t.take(np.flatnonzero(pid == 0)))


def test_spill_and_merge_matches_unspilled(written, tmp_path, monkeypatch):
    """A pool budget of 64 bytes spills after every part; the merged
    file equals the JAX writer's unspilled one, and the spill files are
    gone."""
    pool = memory.MemoryPool(budget=64)
    monkeypatch.setattr(memory, "_POOL", pool)
    spill = tmp_path / "spill"
    spill.mkdir()
    cfg = EngineConfig(device="cpu", tmp_dirs=[str(spill)])
    op = port_writer("hash", str(tmp_path / "s.data"),
                     str(tmp_path / "s.index"))
    list(op.execute(MAP_PARTITION, ExecContext(config=cfg)))
    assert pool.spill_count > 5 and pool.total_used() == 0
    assert list(spill.iterdir()) == []
    _, _, jd, ji, _ = written["hash"]
    assert_files_equal(str(tmp_path / "s.data"), str(tmp_path / "s.index"),
                       jd, ji)


def test_empty_map_output_writes_zero_index(tmp_path):
    """A map task whose filter keeps nothing still writes an index of
    n + 1 zero offsets and an empty data file."""
    cbs = [ColumnBatch.from_arrow(rb, device="cpu")
           for rb in arrow_batches(11, [100])]
    child = FilterExec(MemoryScanExec([cbs], cbs[0].schema),
                       Col("l") > 2 ** 50)
    op = port_writer("hash", str(tmp_path / "e.data"),
                     str(tmp_path / "e.index"), child=child, parts=7)
    list(op.execute(0, ExecContext(device="cpu")))
    assert (tmp_path / "e.index").read_bytes() == b"\0" * 8 * 8
    assert (tmp_path / "e.data").read_bytes() == b""


def test_writer_refuses_range_and_keyless_hash(tmp_path):
    """Range and hash partitioning need keys; a decimal(>18) range key
    is refused, where the JAX package's writer fails too."""
    cbs = [ColumnBatch.from_arrow(arrow_batches(12, [4])[0], device="cpu")]
    scan = MemoryScanExec([cbs], cbs[0].schema)
    with pytest.raises(ValueError):
        ShuffleWriterExec(scan, [], 4, "d", "i", "range")
    with pytest.raises(ValueError):
        ShuffleWriterExec(scan, [], 4, "d", "i", "hash")
    rb = pa.record_batch({"w": pa.array([10 ** 30, None, -5],
                                        pa.decimal128(38, 2))})
    wide = MemoryScanExec([[ColumnBatch.from_arrow(rb, device="cpu")]],
                          ColumnBatch.from_arrow(rb, device="cpu").schema)
    op = ShuffleWriterExec(wide, [Col("w")], 2, str(tmp_path / "d"),
                           str(tmp_path / "i"), "range",
                           range_bounds=[(0,)])
    with pytest.raises(NotImplementedError, match="decimal"):
        list(op.execute(0, ExecContext(device="cpu")))
    jb = JBatch.from_arrow(rb)
    jop = JShuffleWriter(jax_ops.MemoryScanExec([[jb]], jb.schema),
                         [JCol("w")], 2, str(tmp_path / "jd"),
                         str(tmp_path / "ji"), "range",
                         range_bounds=[(0,)])
    with pytest.raises(Exception):
        list(jop.execute(0, JaxContext()))


# ---------------------------------------------------------------------------
# IPC reader and writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(IpcReadMode))
def test_ipc_reader_modes(mode, tmp_path):
    rbs = arrow_batches(13, [70, 30])
    schema = ColumnBatch.from_arrow(rbs[0], device="cpu").schema
    if mode is IpcReadMode.CHANNEL_UNCOMPRESSED:
        sources = rbs
    elif mode is IpcReadMode.CHANNEL:
        sources = [ipc.encode_ipc_segment(rb) for rb in rbs]
    else:
        blob = b"".join(ipc.encode_ipc_segment(rb) for rb in rbs)
        (tmp_path / "r.data").write_bytes(b"junk" + blob)
        sources = [FileSegment(str(tmp_path / "r.data"), 4, len(blob))]
    ctx = ExecContext(device="cpu", resources={"r": [[], sources]})
    out = run_plan(IpcReaderExec("r", schema, 2, mode), ctx)
    assert_arrow_equal(out, pa.Table.from_batches(rbs).cast(out.schema))
    assert ctx.metrics.counters["ipc_rows_read"] == 100


def test_collect_ipc_roundtrip_through_jax_reader():
    """IpcWriter's parts (the broadcast collect) decode in the JAX
    package's reader as the rows the port wrote."""
    rbs = arrow_batches(14, [64, 16])
    cbs = [ColumnBatch.from_arrow(rb, device="cpu") for rb in rbs]
    ctx = ExecContext(device="cpu")
    parts = collect_ipc(MemoryScanExec([cbs[:1], cbs[1:]], cbs[0].schema),
                        ctx)
    assert len(parts) == 2
    jr = JIpcReader("p", jax_schema(cbs[0].schema), 1, JIpcReadMode.CHANNEL)
    got = jax_run_plan(jr, JaxContext(resources={"p": [parts]}))
    assert_arrow_equal(got, pa.Table.from_batches(rbs).cast(got.schema))


# ---------------------------------------------------------------------------
# serde: the new arms and file resources, both ways
# ---------------------------------------------------------------------------

def _reader_schema():
    return ColumnBatch.from_arrow(arrow_batches(15, [1])[0],
                                  device="cpu").schema


def port_plans():
    schema = _reader_schema()
    reader = IpcReaderExec("in", schema, 3,
                           IpcReadMode.CHANNEL_AND_FILE_SEGMENT)
    plans = {f"reader_{m.value}": IpcReaderExec("in", schema, 3, m)
             for m in IpcReadMode}
    for mode in ("hash", "single", "round_robin"):
        keys = [Col("k"), Col("l")] if mode == "hash" else []
        plans[f"writer_{mode}"] = ShuffleWriterExec(
            reader, keys, 200, "/tmp/x.data", "/tmp/x.index", mode)
    plans["ipc_writer"] = IpcWriterExec(reader, "out")
    plans["final_over_reader"] = HashAggregateExec(
        reader, [(Col("k"), "k")], [(AggExpr(AggFn.SUM, Col("x")), "s")],
        AggMode.PARTIAL)
    return plans


RESOURCES = {"in": [("/tmp/a.data", 0, 100), ("/tmp/b.data", 40, 0),
                    ("/tmp/a.data", 100, 7)]}


@pytest.mark.parametrize("name", sorted(port_plans()))
def test_port_blob_decodes_in_jax(name):
    op = port_plans()[name]
    res = {k: [FileSegment(*s) for s in v] for k, v in RESOURCES.items()}
    blob = serde.task_to_proto(op, 1, "t", file_resources=res)
    jop, part, tid, jres = jax_serde.task_from_proto(blob)
    assert (part, tid) == (1, "t")
    assert [(s.path, s.offset, s.length) for s in jres["in"](1)] == \
        RESOURCES["in"]
    jseg = {k: [JFileSegment(*s) for s in v] for k, v in RESOURCES.items()}
    assert jax_serde.task_to_proto(jop, 1, "t", file_resources=jseg) == blob


@pytest.mark.parametrize("name", sorted(port_plans()))
def test_jax_blob_decodes_in_port(name):
    jop = jax_serde.task_from_proto(
        serde.task_to_proto(port_plans()[name], 0))[0]
    jseg = {k: [JFileSegment(*s) for s in v] for k, v in RESOURCES.items()}
    blob = jax_serde.task_to_proto(jop, 2, "u", file_resources=jseg)
    op, part, tid, res = serde.task_from_proto(blob)
    assert (part, tid) == (2, "u")
    assert type(op).__name__ == type(jop).__name__
    assert [(s.path, s.offset, s.length) for s in res["in"](5)] == \
        RESOURCES["in"]
    seg = {k: [FileSegment(*s) for s in v] for k, v in RESOURCES.items()}
    assert serde.task_to_proto(op, 2, "u", file_resources=seg) == blob


def test_remote_segments_and_range_writers_raise():
    jr = JIpcReader("in", jax_schema(_reader_schema()), 1)
    blob = jax_serde.task_to_proto(jr, 0, file_resources={
        "in": [RemoteSegment("h", 1, "/p", 0, 8)]})
    # a remote segment decodes now (the transport tier is ported) and
    # encodes back to the JAX package's bytes; a resource that is no
    # segment still raises
    op, _, _, res = serde.task_from_proto(blob)
    (seg,) = res["in"](0)
    assert (type(seg).__name__, seg.host, seg.port, seg.path, seg.offset,
            seg.length) == ("RemoteSegment", "h", 1, "/p", 0, 8)
    assert serde.task_to_proto(op, 0, file_resources={"in": [seg]}) == blob
    with pytest.raises(TypeError, match="file resource"):
        serde.task_to_proto(IpcReaderExec("in", _reader_schema(), 1), 0,
                            file_resources={"in": [object()]})
    # a range writer decodes now, with its bounds and directions, and
    # encodes back to the JAX package's bytes
    rng_w = JShuffleWriter(jr, [JCol("k")], 4, "d", "i", "range",
                           range_bounds=[(1,), (5,), (9,)],
                           sort_ascending=[False])
    blob = jax_serde.task_to_proto(rng_w, 0)
    op = serde.task_from_proto(blob)[0]
    assert (op.mode, op.range_bounds, op.sort_ascending) == (
        "range", [(1,), (5,), (9,)], [False])
    assert serde.task_to_proto(op, 0) == blob


def test_decode_task_installs_resources():
    from blaze_tpu_torch.runtime.executor import decode_task

    blob = serde.task_to_proto(
        IpcReaderExec("in", _reader_schema(), 3), 1,
        file_resources={"in": [FileSegment("/x", 1, 2)]})
    ctx = ExecContext(device="cpu")
    op, part = decode_task(blob, ctx)
    assert part == 1 and isinstance(op, IpcReaderExec)
    assert [(s.path, s.offset, s.length)
            for s in ctx.resources["in"](1)] == [("/x", 1, 2)]


# ---------------------------------------------------------------------------
# a map stage and its reduce tasks through execute_task
# ---------------------------------------------------------------------------

SPLITS = 2
SPLIT_ROWS = 4096
REDUCERS = 8


@pytest.fixture(scope="module")
def exchange_maps(tmp_path_factory):
    """chip_smoke's exchange_agg path, cut to SPLITS map tasks of
    SPLIT_ROWS rows and REDUCERS reduce tasks; the map stage run by both
    packages from the port's blobs, each package on its own files."""
    d = tmp_path_factory.mktemp("exchange")
    item, qty, price = chip_smoke.store_sales_columns(SPLITS * SPLIT_ROWS, 9)
    paths = []
    for i in range(SPLITS):
        sl = slice(i * SPLIT_ROWS, (i + 1) * SPLIT_ROWS)
        paths.append(str(d / f"s{i}.parquet"))
        chip_smoke.write_parquet(paths[-1], item[sl], qty[sl], price[sl])
    scan = ParquetScanExec([[FileRange(p)] for p in paths])
    out = {"columns": (item, qty, price)}
    for who in ("port", "jax"):
        files = [(str(d / f"{who}{i}.data"), str(d / f"{who}{i}.index"))
                 for i in range(SPLITS)]
        maps = [chip_smoke.exchange_map_plan(scan, *files[i], REDUCERS)
                for i in range(SPLITS)]
        for i, m in enumerate(maps):
            blob = serde.task_to_proto(m, i)
            if who == "port":
                assert list(execute_task(blob, ExecContext(device="cpu"))) \
                    == []
            else:
                list(jax_execute_task(blob, JaxContext(mesh_mode="off")))
        out[who] = (files, chip_smoke.reduce_tasks(
            chip_smoke.exchange_reduce_plan(maps[0].schema, REDUCERS),
            files, REDUCERS))
    return out


@pytest.fixture(scope="module")
def exchange_reduces(exchange_maps):
    """Each package's reduce tasks over its own map files."""
    port = [list(execute_task(b, ExecContext(device="cpu")))
            for b in exchange_maps["port"][1]]
    jax = [list(jax_execute_task(b, JaxContext(mesh_mode="off")))
           for b in exchange_maps["jax"][1]]
    return port, jax


@pytest.mark.parametrize("split", range(SPLITS))
def test_map_task_writes_jax_files(exchange_maps, split):
    assert_files_equal(*exchange_maps["port"][0][split],
                       *exchange_maps["jax"][0][split])


@pytest.mark.parametrize("reducer", range(REDUCERS))
def test_reduce_task_matches_jax(exchange_reduces, reducer):
    got = pa.Table.from_batches(exchange_reduces[0][reducer])
    assert_close_rows(got,
                      pa.Table.from_batches(exchange_reduces[1][reducer]))
    g = got.column("g").to_numpy()
    assert (chip_smoke.spark_pids(g, REDUCERS) == reducer).all()


def test_exchange_agg_matches_numpy_oracle(exchange_maps, exchange_reduces):
    """The union of the reduce outputs is bench.py's grouped_agg, each
    group in exactly one reducer."""
    table = pa.concat_tables(pa.Table.from_batches(o)
                             for o in exchange_reduces[0] if o)
    chip_smoke.check_grouped(
        table, chip_smoke.grouped_oracle(*exchange_maps["columns"]),
        "exchange_agg")


def test_repartition_tasks_keep_partition_and_order(tmp_path):
    """chip_smoke's repartition path, cut small: every reducer gets
    exactly the rows numpy's Spark hash of k gives it, in input order."""
    item, qty, price = chip_smoke.store_sales_columns(5000, 4)
    path = str(tmp_path / "s.parquet")
    chip_smoke.write_parquet(path, item, qty, price)
    files = [(str(tmp_path / "r.data"), str(tmp_path / "r.index"))]
    m = chip_smoke.repartition_map_plan(
        ParquetScanExec([[FileRange(path)]]), *files[0], REDUCERS)
    list(execute_task(serde.task_to_proto(m, 0), ExecContext(device="cpu")))
    blobs = chip_smoke.reduce_tasks(
        chip_smoke.repartition_reduce_plan(m.schema, REDUCERS), files,
        REDUCERS)
    k = item.astype(np.int64)
    pid = chip_smoke.spark_pids(k, REDUCERS)
    for r, blob in enumerate(blobs):
        got = pa.Table.from_batches(
            list(execute_task(blob, ExecContext(device="cpu"))))
        idx = np.flatnonzero(pid == r)
        np.testing.assert_array_equal(got.column("k").to_numpy(), k[idx])
        np.testing.assert_array_equal(got.column("price").to_numpy(),
                                      price[idx])


# ---------------------------------------------------------------------------
# keyed grace aggregation against the JAX package
# ---------------------------------------------------------------------------

HOT = 777  # the hot key


def _grace_aggs(expr, agg_expr, fn):
    return [(agg_expr(fn.SUM, expr("v")), "sum_v"),
            (agg_expr(fn.COUNT_STAR, None), "n"),
            (agg_expr(fn.MIN, expr("q")), "lo")]


def complete_input(seed, hot_only=False):
    """2 batches of 4096 rows. `hot_only`: every row carries the hot key,
    more than the limit at every depth, so its bucket is bucketed twice
    more and then aggregated in chunks. Else 40% of the rows carry 300
    keys of grace bucket 0 (over the limit once, so bucket 0 is bucketed
    again), the rest 3000 other keys and NULL."""
    rng = np.random.default_rng(seed)
    keys = np.arange(100_000, dtype=np.int32)
    bucket0 = keys[chip_smoke.spark_pids(keys, 32) == 0][:300]
    out = []
    for _ in range(2):
        if hot_only:
            k = pa.array(np.full(4096, HOT, np.int32))
        else:
            k = rng.integers(0, 3000, 4096).astype(np.int32)
            pick = rng.random(4096) < 0.4
            k[pick] = rng.choice(bucket0, int(pick.sum()))
            k = pa.array(k, mask=rng.random(4096) < 0.01)
        out.append(pa.record_batch({
            "k": k, "v": rng.random(4096) * 10,
            "q": rng.integers(-50, 50, 4096).astype(np.int64)}))
    return out


def final_input(seed):
    """PARTIAL states of the aggregates above, as a map stage sends
    them: the hot key's state in 30 rows, 300 other keys in one row
    each, shuffled into two batches."""
    rng = np.random.default_rng(seed)
    cbs = [ColumnBatch.from_arrow(rb, device="cpu")
           for rb in complete_input(seed)[:1]]
    partial = HashAggregateExec(
        MemoryScanExec([cbs], cbs[0].schema), [(Col("k"), "k")],
        _grace_aggs(Col, AggExpr, AggFn), AggMode.PARTIAL)
    schema = next(partial.execute(0, ExecContext(device="cpu"))) \
        .to_arrow().schema
    keys = np.concatenate([np.full(30, HOT), rng.choice(
        np.setdiff1d(np.arange(3000), [HOT]), 300, replace=False)])
    rng.shuffle(keys)
    n = len(keys)
    cols = {"k": pa.array(keys.astype(np.int32)),
            "sum_v#sum": pa.array(rng.random(n) * 100),
            "n#count": pa.array(rng.integers(1, 20, n)),
            "lo#min": pa.array(rng.integers(-50, 50, n))}
    t = pa.table([cols[f.name].cast(f.type) for f in schema], schema=schema)
    return t.to_batches(max_chunksize=165)


def _run_grace(rbs, mode, limit):
    """(port table, port counters, JAX table, JAX counters) of a keyed
    aggregate by k over `rbs` with max_materialize_rows = `limit`. Both
    packages pad every batch to one shape (4096 rows): the JAX package's
    kernels then compile once, and both hash tables take the same size,
    so groups come out in the same order."""
    import blaze_tpu.config as jax_config
    import blaze_tpu_torch.config as port_config

    cfg = EngineConfig(device="cpu", max_materialize_rows=limit,
                       shape_buckets=(4096,))
    jcfg = JaxConfig(max_materialize_rows=limit, shape_buckets=(4096,))
    saved = port_config.get_config(), jax_config.get_config()
    port_config.set_config(cfg)
    jax_config.set_config(jcfg)
    try:
        cbs = [ColumnBatch.from_arrow(rb, device="cpu") for rb in rbs]
        op = HashAggregateExec(MemoryScanExec([cbs], cbs[0].schema),
                               [(Col("k"), "k")],
                               _grace_aggs(Col, AggExpr, AggFn), mode)
        ctx = ExecContext(config=cfg)
        got = run_plan(op, ctx)
        jbs = [JBatch.from_arrow(rb) for rb in rbs]
        jop = jax_ops.HashAggregateExec(
            jax_ops.MemoryScanExec([jbs], jbs[0].schema),
            [(JCol("k"), "k")], _grace_aggs(JCol, JAggExpr, JAggFn),
            jax_ops.AggMode[mode.name])
        jctx = JaxContext(config=jcfg, mesh_mode="off")
        exp = jax_run_plan(jop, jctx)
    finally:
        port_config.set_config(saved[0])
        jax_config.set_config(saved[1])
    return got, ctx.metrics.counters, exp, jctx.metrics.counters


@pytest.fixture(scope="module")
def grace_complete():
    """COMPLETE with one bucket over the limit of 1500 rows."""
    return _run_grace(complete_input(21), AggMode.COMPLETE, 1500)


@pytest.fixture(scope="module")
def grace_hot():
    """COMPLETE over one hot key: chunked at the greatest depth."""
    return _run_grace(complete_input(24, hot_only=True), AggMode.COMPLETE,
                      1500)


@pytest.fixture(scope="module")
def grace_final():
    """FINAL over states with a limit of 20 rows: the hot key's 30
    state rows exceed it at the greatest depth, where a FINAL bucket
    merges whole."""
    return _run_grace(final_input(22), AggMode.FINAL, 20)


GRACE = {"grace_complete": (1, 0), "grace_hot": (2, 1), "grace_final": (2, 0)}


@pytest.mark.parametrize("fixture", sorted(GRACE))
def test_grace_counters_match_jax(request, fixture):
    _, counters, _, jax_counters = request.getfixturevalue(fixture)
    for key in ("external_agg_buckets", "external_agg_rebuckets",
                "external_agg_hot_buckets"):
        assert counters.get(key, 0) == jax_counters.get(key, 0), key
    rebuckets, hot = GRACE[fixture]
    assert counters.get("external_agg_rebuckets", 0) == rebuckets
    assert counters.get("external_agg_hot_buckets", 0) == hot


@pytest.mark.parametrize("fixture", sorted(GRACE))
def test_grace_matches_jax(request, fixture):
    got, _, exp, _ = request.getfixturevalue(fixture)
    if fixture == "grace_hot":
        # one group, from PARTIAL states of chunks cut from batches of
        # other sizes: the float sum may differ in the last bits
        assert got.num_rows == 1
    assert_close_rows(got, exp)


def test_grace_matches_in_memory_aggregate(grace_complete):
    """The grace result equals the port's in-memory aggregate (no limit)
    after sorting by key."""
    cbs = [ColumnBatch.from_arrow(rb, device="cpu")
           for rb in complete_input(21)]
    op = HashAggregateExec(MemoryScanExec([cbs], cbs[0].schema),
                           [(Col("k"), "k")],
                           _grace_aggs(Col, AggExpr, AggFn),
                           AggMode.COMPLETE)
    whole = run_plan(op, ExecContext(device="cpu"))
    srt = [("k", "ascending")]
    assert_close_rows(grace_complete[0].sort_by(srt), whole.sort_by(srt))


def test_grace_cleans_its_bucket_files(tmp_path):
    cfg = EngineConfig(device="cpu", max_materialize_rows=1000,
                       tmp_dirs=[str(tmp_path)])
    cbs = [ColumnBatch.from_arrow(rb, device="cpu")
           for rb in complete_input(23)[:2]]
    op = HashAggregateExec(MemoryScanExec([cbs], cbs[0].schema),
                           [(Col("k"), "k")],
                           [(AggExpr(AggFn.COUNT_STAR, None), "n")],
                           AggMode.COMPLETE)
    t = run_plan(op, ExecContext(config=cfg))
    assert sum(t.column("n").to_pylist()) == 8192
    assert list(tmp_path.iterdir()) == []
