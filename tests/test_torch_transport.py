"""The port's block transport (runtime/transport.py) and object stores
(io/object_store.py) against the JAX package's, on the CPU: the twin of
tests/test_transport.py. BlockServer range reads and stats across the
two packages' servers and clients (one wire), protocol errors (scoping,
an over-long path, a missing file, a truncated stream), the remote block
store's retries, remote segments through the port's IPC reader (the
batches equal those the JAX package's reader decodes from the same
file), parquet scans over `blz://` paths in both packages, and the
memory, callback and smuggled-path stores."""

import os
import socket
import struct
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch.io import object_store
from blaze_tpu_torch.io.ipc import encode_ipc_segment
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.runtime import transport
from blaze_tpu_torch.runtime.transport import (
    BlockProtocolError,
    BlockServer,
    RemoteSegment,
    open_remote_stream,
    remote_stat,
)

from torch_support import assert_arrow_equal


def _packages():
    from blaze_tpu.runtime import transport as jt

    return {"port": transport, "jax": jt}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("blocks")
    payload = bytes(range(256)) * 10
    (d / "x.data").write_bytes(payload)
    servers = {name: mod.BlockServer([str(d)]).start()
               for name, mod in _packages().items()}
    yield str(d), payload, servers
    for srv in servers.values():
        srv.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_range_reads_and_stat_across_packages(served, server, client):
    d, payload, servers = served
    mod = _packages()[client]
    host, port = servers[server].address
    path = os.path.join(d, "x.data")
    for off, length, want in ((100, 300, payload[100:400]),
                              (0, -1, payload),
                              (2500, 500, payload[2500:]),
                              (len(payload), 10, b"")):
        s = mod.open_remote_stream(mod.RemoteSegment(host, port, path, off,
                                                     length))
        try:
            assert s.read() == want
        finally:
            s.close()
    assert mod.remote_stat(host, port, path) == len(payload)


def test_protocol_errors(served, tmp_path):
    d, payload, servers = served
    host, port = servers["port"].address
    outside = tmp_path / "secret.txt"
    outside.write_text("no")
    for path in (str(outside), os.path.join(d, "missing.data"),
                 os.path.join(d, "..", "secret.txt")):
        with pytest.raises(BlockProtocolError):
            open_remote_stream(RemoteSegment(host, port, path, 0, -1))
        with pytest.raises(BlockProtocolError):
            remote_stat(host, port, path)
    # an over-long path is refused by the server with the error status
    with pytest.raises(BlockProtocolError):
        open_remote_stream(RemoteSegment(host, port, "/" + "a" * 5000, 0, 1))
    # a stream shorter than its header claims raises on read
    with socket.create_server(("127.0.0.1", 0)) as lsock:
        def serve_short():
            conn, _ = lsock.accept()
            with conn:
                conn.recv(4096)
                conn.sendall(struct.pack("<Bq", 0, 100) + b"x" * 10)

        t = threading.Thread(target=serve_short)
        t.start()
        s = open_remote_stream(RemoteSegment(
            "127.0.0.1", lsock.getsockname()[1], "/p", 0, 100))
        with pytest.raises(ConnectionError, match="truncated"):
            s.read()
        s.close()
        t.join()


def test_remote_store_retries_then_raises(served, monkeypatch):
    d, payload, servers = served
    host, port = servers["port"].address
    path = f"blz://{host}:{port}{d}/x.data"
    real = socket.create_connection
    fails = {"n": 2}

    def flaky(*a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise ConnectionRefusedError("injected")
        return real(*a, **kw)

    monkeypatch.setattr(transport.socket, "create_connection", flaky)
    st = object_store.RemoteBlockStore(retries=3, base_delay=0.001)
    assert st.get_range(path, 3, 7) == payload[3:10]
    assert fails["n"] == 0
    fails["n"] = 2
    assert st.size(path) == len(payload)
    # exhausted retries surface one IOError naming the attempts
    fails["n"] = 99
    with pytest.raises(IOError, match="after 3 attempts"):
        st.get_range(path, 0, 7)
    # a protocol error is deterministic: raised at once, no retry
    monkeypatch.setattr(transport.socket, "create_connection", real)
    calls = {"n": 0}

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(transport.socket, "create_connection", counting)
    with pytest.raises(BlockProtocolError):
        st.get_range(f"blz://{host}:{port}/etc/passwd", 0, 7)
    assert calls["n"] == 1


def _segment_file(d):
    rng = np.random.default_rng(4)
    batches = [pa.record_batch({
        "a": pa.array(rng.integers(-9, 9, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "x": rng.random(n),
        "s": pa.array(np.array(["u", "vv", "w"])[rng.integers(0, 3, n)]),
    }) for n in (3, 700, 41)]
    path = os.path.join(d, "s.data")
    with open(path, "wb") as f:
        f.write(b"JUNKHEAD")
        for rb in batches:
            f.write(encode_ipc_segment(rb))
    return path, batches


def test_remote_segments_through_ipc_readers(served):
    """A RemoteSegment source streams through the port's IpcReaderExec
    and gives the batches the JAX package's reader decodes from the
    same remote bytes."""
    from blaze_tpu.ops import ExecContext as JCtx
    from blaze_tpu.ops.ipc_reader import IpcReaderExec as JReader
    from blaze_tpu.ops.ipc_reader import IpcReadMode as JMode

    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.ops.ipc_reader import IpcReaderExec, IpcReadMode

    d, _, servers = served
    path, batches = _segment_file(d)
    length = os.path.getsize(path) - 8
    host, port = servers["port"].address
    schema = ColumnBatch.from_arrow(batches[0], device="cpu").schema
    reader = IpcReaderExec("r", schema, 2,
                           IpcReadMode.CHANNEL_AND_FILE_SEGMENT)
    ctx = ExecContext(device="cpu")
    seg = RemoteSegment(host, port, path, 8, length)
    ctx.resources["r"] = [[], [seg]]
    got = pa.Table.from_batches(
        [cb.to_arrow() for cb in reader.execute(1, ctx)])

    from blaze_tpu.runtime.transport import RemoteSegment as JSeg
    from torch_support import jax_schema

    jreader = JReader("r", jax_schema(schema), 2,
                      JMode.CHANNEL_AND_FILE_SEGMENT)
    jctx = JCtx()
    jctx.resources["r"] = [[], [JSeg(host, port, path, 8, length)]]
    want = pa.Table.from_batches(
        [cb.to_arrow() for cb in jreader.execute(1, jctx)])
    assert got.num_rows == sum(rb.num_rows for rb in batches)
    assert_arrow_equal(got.combine_chunks(), want.combine_chunks())
    assert_arrow_equal(got.combine_chunks(),
                       pa.Table.from_batches(batches).combine_chunks())


def test_parquet_scan_over_blz_paths(tmp_path):
    """A parquet scan reads through the remote block store (pyarrow's
    reader drives get_range) in both packages, with the same rows; the
    port's in two byte ranges, each owning its row groups."""
    from blaze_tpu.ops.base import ExecContext as JCtx
    from blaze_tpu.ops.parquet_scan import FileRange as JRange
    from blaze_tpu.ops.parquet_scan import ParquetScanExec as JScan
    from blaze_tpu.runtime.executor import run_plan as jrun

    from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec
    from blaze_tpu_torch.runtime.executor import run_plan

    rng = np.random.default_rng(3)
    local = tmp_path / "remote_fact.parquet"
    pq.write_table(pa.table({
        "k": rng.integers(0, 9, 5000).astype(np.int64),
        "v": rng.random(5000)}), str(local), row_group_size=1024)
    srv = BlockServer([str(tmp_path)]).start()
    try:
        host, port = srv.address
        path = f"blz://{host}:{port}{local}"
        size = os.path.getsize(local)
        groups = [[FileRange(path, 0, size // 2)],
                  [FileRange(path, size // 2, size - size // 2)]]
        got = run_plan(ParquetScanExec(groups), ExecContext(device="cpu"))
        want = jrun(JScan([[JRange(path)]]), JCtx())
    finally:
        srv.stop()
    assert got.num_rows == 5000
    key = [("k", "ascending"), ("v", "ascending")]
    assert_arrow_equal(got.sort_by(key).combine_chunks(),
                       want.sort_by(key).combine_chunks())


def test_memory_callback_and_smuggled_stores(tmp_path):
    from blaze_tpu.io import object_store as jstore

    blob = bytes(range(100))
    mem = object_store.MemoryStore()
    mem.put("mem://a", blob)
    assert mem.get_range("mem://a", 5, 3) == blob[5:8]
    assert mem.size("mem://a") == 100
    assert mem.open_input("mem://a").read() == blob

    real = str(tmp_path / "real.bin")
    with open(real, "wb") as f:
        f.write(blob)
    smuggled = object_store.encode_smuggled_path("hdfs", real)
    assert smuggled == jstore.encode_smuggled_path("hdfs", real)
    assert object_store.decode_smuggled_path(smuggled) == real
    assert object_store.decode_smuggled_path(real) is None
    seen = []

    def read_range(p, off, n):
        seen.append(p)
        return object_store.LocalStore().get_range(p, off, n)

    cb = object_store.CallbackStore(read_range, os.path.getsize)
    object_store.register_store("hdfs", cb)
    st = object_store.store_for(smuggled)
    assert st is cb and st.size(smuggled) == 100
    f = st.open_input(smuggled)
    f.seek(-10, 2)
    assert f.read() == blob[-10:] and seen == [real]
    with pytest.raises(KeyError, match="no object store registered"):
        object_store.store_for("s3x://bucket/key")
    assert isinstance(object_store.store_for("blz://h:1/p"),
                      object_store.RemoteBlockStore)
    assert isinstance(object_store.store_for(real),
                      object_store.LocalStore)
