"""The port's task gateway (runtime/gateway.py) on the CPU: the twin of
tests/test_gateway.py and of tests/test_refwire_corpus.py's gateway
drive. `cpp/blaze_client.cpp`, the client of both packages' gateways,
is built with g++ once a session and sends native-wire and
reference-wire (`--ref`, header bit 63) TaskDefinitions, with a
resource manifest (`--manifest`, bit 62) for the reduce reads; every
result equals the JAX package's in-process result for the same bytes.
Two connections at once stay exact. A failing task answers with the
error frame (the client exits 2), so does a connection that asks for
the service protocol (bit 61, the serving tier), and a client that
hangs up mid-stream cancels its task without failing it."""

import base64
import json
import logging
import os
import shutil
import socket
import struct
import subprocess
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
from blaze_tpu_torch.io.ipc import decode_ipc_parts, encode_ipc_segment
from blaze_tpu_torch.ops import AggMode, FilterExec, HashAggregateExec
from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec
from blaze_tpu_torch.plan.serde import task_to_proto
from blaze_tpu_torch.runtime.gateway import TaskGatewayServer

from torch_support import assert_arrow_equal, built_once

CLIENT_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cpp", "blaze_client.cpp")


@pytest.fixture(scope="module")
def client_bin(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this box")

    def build(out):
        subprocess.run(["g++", "-O2", "-o", out, CLIENT_SRC, "-lzstd"],
                       check=True, capture_output=True)

    return built_once(tmp_path_factory, "blaze_client", build)


@pytest.fixture(scope="module")
def gateway():
    with TaskGatewayServer(device="cpu") as srv:
        yield srv


@pytest.fixture(scope="module")
def fact(tmp_path_factory):
    rng = np.random.default_rng(5)
    p = str(tmp_path_factory.mktemp("gw") / "t.parquet")
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 50, 5000), pa.int64()),
        "p": pa.array(np.round(rng.random(5000) * 100, 3), pa.float64()),
    }), p, row_group_size=1000)
    return p


def run_client(client_bin, gateway, tmp_path, blob, ref=False,
               manifest=None, tag="t"):
    task_file = str(tmp_path / f"{tag}.task")
    out_file = str(tmp_path / f"{tag}.out")
    with open(task_file, "wb") as f:
        f.write(blob)
    host, port = gateway.address
    argv = [client_bin, host, str(port), task_file, out_file]
    if ref:
        argv.append("--ref")
    if manifest is not None:
        mf = str(tmp_path / f"{tag}.manifest.json")
        with open(mf, "w") as f:
            json.dump(manifest, f)
        argv += ["--manifest", mf]
    r = subprocess.run(argv, capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        return r, None
    with open(out_file, "rb") as f:
        return r, list(decode_ipc_parts(f.read()))


def _table(batches):
    t = pa.Table.from_batches(batches).combine_chunks()
    return t.sort_by([(n, "ascending") for n in t.schema.names])


def _jax_native(blob):
    from blaze_tpu.runtime.executor import execute_task

    return _table(list(execute_task(blob)))


def _jax_ref(blob, resources=None):
    from blaze_tpu.ops.base import ExecContext
    from blaze_tpu.plan.refcompat import execute_reference_task

    ctx = ExecContext()
    ctx.resources.update(resources or {})
    return _table(list(execute_reference_task(blob, ctx=ctx)))


def _close(a, b):
    ints = [n for n, f in zip(a.schema.names, a.schema)
            if not pa.types.is_floating(f.type)]
    assert_arrow_equal(a.select(ints), b.select(ints))
    for n in a.schema.names:
        if n not in ints:
            np.testing.assert_allclose(a.column(n).to_numpy(),
                                       b.column(n).to_numpy(), rtol=1e-9)


def _native_task(path):
    plan = HashAggregateExec(
        FilterExec(ParquetScanExec([[FileRange(path)]]), Col("p") > 50.0),
        keys=[(Col("k"), "k")],
        aggs=[(AggExpr(AggFn.SUM, Col("p")), "s"),
              (AggExpr(AggFn.COUNT_STAR, None), "n")],
        mode=AggMode.COMPLETE)
    return task_to_proto(plan, 0)


def test_native_wire_roundtrip(client_bin, gateway, fact, tmp_path):
    blob = _native_task(fact)
    r, batches = run_client(client_bin, gateway, tmp_path, blob)
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["parts"] >= 1 and summary["bytes"] > 0
    _close(_table(batches), _jax_native(blob))


def _ref_q(path):
    """A filter -> projection -> sort, hand-encoded by the reference
    corpus's wire-rule helpers."""
    import test_refwire_corpus as c

    schema = c.schema_(c.field_("k", c.A_INT64), c.field_("p", c.A_FLOAT64))
    plan = c.sort_node(c.projection_node(
        c.filter_node(c.parquet_scan_node(path, schema),
                      c.binop("Gt", c.col("p", 1), c.lit_f64(20.0))),
        [c.binop("Multiply", c.col("p", 1), c.lit_f64(2.0)),
         c.col("k", 0)], ["p2", "k"]),
        [c.sort_expr(c.col("p2", 0), asc=False)])
    return c.task(plan)


def test_reference_wire_roundtrip(client_bin, gateway, fact, tmp_path):
    blob = _ref_q(fact)
    r, batches = run_client(client_bin, gateway, tmp_path, blob, ref=True)
    assert r.returncode == 0, r.stderr
    got = pa.Table.from_batches(batches)
    # the sort's order itself, then the rows
    p2 = got.column("p2").to_numpy()
    assert (np.diff(p2) <= 0).all() and got.num_rows > 0
    _close(_table(batches), _jax_ref(blob))


def test_reference_shuffle_and_manifest_reads(client_bin, gateway, fact,
                                              tmp_path):
    """A reference-wire shuffle writer, then each partition read back by
    an ipc_reader task whose segments ride in the manifest (file
    segments), and a CHANNEL read of inline b64 parts."""
    import test_refwire_corpus as c

    schema = c.schema_(c.field_("k", c.A_INT64), c.field_("p", c.A_FLOAT64))
    data, index = str(tmp_path / "c.data"), str(tmp_path / "c.index")
    node, rep = c.shuffle_writer_node(c.parquet_scan_node(fact, schema),
                                      [c.col("k", 0)], 3, data, index)
    r, batches = run_client(client_bin, gateway, tmp_path,
                            c.task(node, out_rep=rep), ref=True)
    assert r.returncode == 0 and batches == [], r.stderr
    raw = open(index, "rb").read()
    offs = struct.unpack(f"<{len(raw) // 8}q", raw)
    manifest = {"sh": [[{"file": data, "offset": offs[p],
                         "length": offs[p + 1] - offs[p]}]
                       for p in range(3)]}
    from blaze_tpu.ops.ipc_reader import FileSegment as JSeg

    jres = {"sh": [[JSeg(data, offs[p], offs[p + 1] - offs[p])]
                   for p in range(3)]}
    rows = 0
    for p in range(3):
        blob = c.task(c.ipc_reader_node("sh", schema, 3, 2), partition=p)
        r, batches = run_client(client_bin, gateway, tmp_path, blob,
                                ref=True, manifest=manifest, tag=f"r{p}")
        assert r.returncode == 0, r.stderr
        got = _table(batches)
        _close(got, _jax_ref(blob, jres))
        rows += got.num_rows
    assert rows == pq.read_metadata(fact).num_rows

    rb = pa.record_batch({"k": pa.array([1, 2, 3], pa.int64()),
                          "p": pa.array([1.5, 2.5, 3.5])})
    manifest = {"ch": [[{"b64": base64.b64encode(
        encode_ipc_segment(rb)).decode()}]]}
    r, batches = run_client(client_bin, gateway, tmp_path,
                            c.task(c.ipc_reader_node("ch", schema, 1, 1)),
                            ref=True, manifest=manifest, tag="ch")
    assert r.returncode == 0, r.stderr
    assert pa.Table.from_batches(batches).to_pydict() == rb.to_pydict()


def test_two_connections_at_once(client_bin, gateway, fact, tmp_path):
    blobs = [(_native_task(fact), False), (_ref_q(fact), True)]
    out = [None, None]

    def go(i):
        out[i] = run_client(client_bin, gateway, tmp_path, blobs[i][0],
                            ref=blobs[i][1], tag=f"c{i}")

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (blob, ref), (r, batches) in zip(blobs, out):
        assert r.returncode == 0, r.stderr
        _close(_table(batches), _jax_ref(blob) if ref else _jax_native(blob))


def test_error_frame(client_bin, gateway, tmp_path):
    from blaze_tpu_torch.plan import plan_pb2 as pb

    t = pb.TaskDefinitionProto(partition=0, task_id="boom")
    t.plan.parquet_scan.file_groups.add().files.add().path = \
        "/nonexistent/nope.parquet"
    t.plan.parquet_scan.schema.fields.add().name = "x"
    r, _ = run_client(client_bin, gateway, tmp_path, t.SerializeToString())
    assert r.returncode == 2
    assert "engine error" in r.stderr and "nope.parquet" in r.stderr
    # a manifest that is not JSON gets the error frame too
    with open(tmp_path / "bad.json", "w") as f:
        f.write("{not json")
    host, port = gateway.address
    r = subprocess.run(
        [client_bin, host, str(port), str(tmp_path / "t.task"),
         str(tmp_path / "o"), "--manifest", str(tmp_path / "bad.json")],
        capture_output=True, text=True, timeout=60)
    assert r.returncode == 2 and "engine error" in r.stderr


def test_service_protocol_gets_the_error_frame(gateway):
    with socket.create_connection(gateway.address, timeout=30) as s:
        s.sendall(struct.pack("<Q", 1 << 61))
        head = s.recv(8, socket.MSG_WAITALL)
        (mlen,) = struct.unpack("<I", s.recv(4, socket.MSG_WAITALL))
        msg = s.recv(mlen, socket.MSG_WAITALL).decode()
    # a gateway without a QueryService answers the service protocol
    # with the JAX package's error frame (with one, service/wire.py
    # serves it: tests/test_torch_service_wire.py)
    assert head == struct.pack("<Q", 0xFFFFFFFFFFFFFFFF)
    assert msg == "no query service attached"


class _FakeSock:
    """Feeds a canned request; sendall starts raising after N calls to
    model the client vanishing mid-stream."""

    def __init__(self, request: bytes, sends_before_break: int):
        self._buf = request
        self._pos = 0
        self.sent = []
        self._ok_sends = sends_before_break

    def recv_into(self, view, n: int = 0) -> int:
        n = n or len(view)
        chunk = self._buf[self._pos:self._pos + n]
        self._pos += len(chunk)
        view[:len(chunk)] = chunk
        return len(chunk)

    def sendall(self, data: bytes) -> None:
        if len(self.sent) >= self._ok_sends:
            raise BrokenPipeError("client went away")
        self.sent.append(data)


def _handle(sock):
    from blaze_tpu_torch.runtime import gateway

    class _Srv:
        device = "cpu"

    gateway._Handler(sock, ("127.0.0.1", 0), _Srv())


def test_disconnect_mid_stream_cancels_not_fails(monkeypatch, caplog):
    from blaze_tpu_torch.runtime import executor

    state = {"closed": False, "yielded": 0}
    rb = pa.record_batch({"x": pa.array([1, 2, 3], pa.int64())})

    def fake_execute_task(blob, ctx=None):
        assert str(ctx.device) == "cpu"

        def gen():
            try:
                for _ in range(100):
                    state["yielded"] += 1
                    yield rb
            finally:
                state["closed"] = True
        return gen()

    monkeypatch.setattr(executor, "execute_task", fake_execute_task)
    sock = _FakeSock(struct.pack("<Q", 4) + b"task", sends_before_break=1)
    with caplog.at_level(logging.INFO, logger="blaze_tpu_torch.gateway"):
        _handle(sock)  # returns cleanly
    assert state["closed"] and state["yielded"] == 2
    assert len(sock.sent) == 1
    assert not sock.sent[0].startswith(struct.pack("<Q", 0xFFFFFFFFFFFFFFFF))
    assert any("disconnected mid-stream" in r.message
               for r in caplog.records)
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING
                and r.name.startswith("blaze_tpu_torch")]


def test_execution_error_reports_error_frame(monkeypatch):
    from blaze_tpu_torch.runtime import executor

    def fake_execute_task(blob, ctx=None):
        def gen():
            raise ValueError("deliberate engine error")
            yield
        return gen()

    monkeypatch.setattr(executor, "execute_task", fake_execute_task)
    sock = _FakeSock(struct.pack("<Q", 4) + b"task", sends_before_break=99)
    _handle(sock)
    assert len(sock.sent) == 1
    assert sock.sent[0].startswith(struct.pack("<Q", 0xFFFFFFFFFFFFFFFF))
    assert b"deliberate engine error" in sock.sent[0]
