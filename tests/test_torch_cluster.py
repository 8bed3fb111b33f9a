"""The port's mini-cluster (runtime/cluster.py) and its cluster exchanges
(parallel/exchange.py) on the CPU: the twin of tests/test_cluster.py and
of tests/test_transport.py's remote exchanges. One module-scoped
MiniCluster of 2 worker processes (`device="cpu"`) runs the map stage of
a grouped aggregate through ClusterShuffleExchangeExec (a shared shuffle
directory) and RemoteClusterShuffleExchangeExec (each worker's private
directory, every block fetched over its BlockServer); both results equal
the JAX package's local ShuffleExchangeExec result for the same plan,
run in this process (no JAX worker is started). A reduce task whose
first block fetch is dropped fails TRANSIENT and is retried; a worker
asked for cuda on this box fails every task INTERNAL and is quarantined,
and it never runs a task on the CPU."""

import os
import socket
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    HashAggregateExec,
    IpcReaderExec,
    IpcReadMode,
    ShuffleWriterExec,
)
from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec
from blaze_tpu_torch.parallel import (
    ClusterShuffleExchangeExec,
    RemoteClusterShuffleExchangeExec,
)
from blaze_tpu_torch.plan.serde import task_to_proto
from blaze_tpu_torch.runtime.cluster import (
    MiniCluster,
    _rewrite_worker_local,
)
from blaze_tpu_torch.runtime.executor import run_plan
from blaze_tpu_torch.runtime.transport import RemoteSegment

from torch_support import assert_arrow_equal

N = 3000
PARTS = 4


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    d = tmp_path_factory.mktemp("cluster_data")
    rng = np.random.default_rng(9)
    paths = []
    for i in range(2):
        p = str(d / f"t{i}.parquet")
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 15, N), pa.int64(),
                          mask=rng.random(N) < 0.03),
            "v": rng.integers(-50, 50, N).astype(np.int64),
            "x": np.round(rng.random(N) * 10, 3),
        }), p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    spool = str(tmp_path_factory.mktemp("spool"))
    with MiniCluster(num_workers=2, spool_dir=spool, device="cpu") as c:
        yield c


def _agg(child, ops):
    """SUM/MIN/MAX/COUNT(*) of v and SUM of x, grouped by k."""
    agg_exec, agg_expr, agg_fn, col, mode = ops
    return agg_exec(
        child, keys=[(col("k"), "k")],
        aggs=[(agg_expr(agg_fn.SUM, col("v")), "sv"),
              (agg_expr(agg_fn.MIN, col("v")), "mn"),
              (agg_expr(agg_fn.MAX, col("v")), "mx"),
              (agg_expr(agg_fn.COUNT_STAR, None), "n"),
              (agg_expr(agg_fn.SUM, col("x")), "sx")],
        mode=mode.COMPLETE)


@pytest.fixture(scope="module")
def jax_result(splits):
    from blaze_tpu.exprs import AggExpr as JAgg
    from blaze_tpu.exprs import AggFn as JFn
    from blaze_tpu.exprs import Col as JCol
    from blaze_tpu.ops import AggMode as JMode
    from blaze_tpu.ops import HashAggregateExec as JHashAgg
    from blaze_tpu.ops.parquet_scan import FileRange as JRange
    from blaze_tpu.ops.parquet_scan import ParquetScanExec as JScan
    from blaze_tpu.parallel.exchange import ShuffleExchangeExec as JEx
    from blaze_tpu.runtime.executor import run_plan as jrun

    scan = JScan([[JRange(p)] for p in splits])
    plan = _agg(JEx(scan, [JCol("k")], PARTS), (JHashAgg, JAgg, JFn, JCol,
                                                   JMode))
    return _canonical(jrun(plan))


def _canonical(t):
    return t.combine_chunks().sort_by([("k", "ascending")])


def _assert_matches(got, want):
    assert_arrow_equal(got.drop(["sx"]), want.drop(["sx"]))
    np.testing.assert_allclose(got.column("sx").to_numpy(),
                               want.column("sx").to_numpy(), rtol=1e-9)


@pytest.mark.parametrize("exchange", [ClusterShuffleExchangeExec,
                                      RemoteClusterShuffleExchangeExec])
def test_cluster_exchanges_match_jax(exchange, cluster, splits, jax_result,
                                     tmp_path):
    scan = ParquetScanExec([[FileRange(p)] for p in splits])
    kw = ({"shuffle_dir": str(tmp_path / "sh")}
          if exchange is ClusterShuffleExchangeExec else {})
    ex = exchange(scan, [Col("k")], PARTS, cluster, **kw)
    ctx = ExecContext(device="cpu")
    retries = cluster.retries
    got = _canonical(run_plan(_agg(ex, (HashAggregateExec, AggExpr, AggFn, Col,
                                        AggMode)),
                              ctx))
    _assert_matches(got, jax_result)
    assert cluster.retries == retries and cluster.quarantined == []
    metas = ex.map_metas
    assert len(metas) == 2 and all(m["wall_s"] > 0 for m in metas)
    assert all(set(m["launches"]) >= {"murmur3", "segment_reduce"}
               for m in metas)
    segs = ex.segments_for((0, PARTS), ctx)
    assert sum(s.length for s in segs) == sum(
        ex.map_output_statistics(ctx)) > 0
    if exchange is RemoteClusterShuffleExchangeExec:
        assert all(isinstance(s, RemoteSegment) for s in segs)
        # the outputs sit in the workers' private directories, one
        # directory a worker
        assert all(out["data"].startswith(cluster.spool)
                   and "__WORKER_LOCAL__" not in out["data"]
                   for m in metas for out in m["outputs"])
        assert len({os.path.dirname(out["data"]) for m in metas
                    for out in m["outputs"]}) == len(
            {m["pid"] for m in metas})
    else:
        assert sorted(os.listdir(tmp_path / "sh")) == [
            "cm0.data", "cm0.index", "cm1.data", "cm1.index"]


def test_rewrite_worker_local_paths(splits, tmp_path):
    scan = ParquetScanExec([[FileRange(splits[0])]])
    blob = task_to_proto(ShuffleWriterExec(
        scan, [Col("k")], 3, "__WORKER_LOCAL__/a.data",
        "__WORKER_LOCAL__/a.index"), 0)
    new, outputs = _rewrite_worker_local(blob, str(tmp_path))
    assert outputs == [(str(tmp_path / "a.data"), str(tmp_path / "a.index"))]
    assert new != blob
    plain = task_to_proto(scan, 0)
    assert _rewrite_worker_local(plain, str(tmp_path)) == (plain, [])


class _DropFirst:
    """A block server stand-in that hangs up on its first connection and
    forwards every later one to a real BlockServer."""

    def __init__(self, target):
        self.target = target
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.connections = 0
        threading.Thread(target=self._serve, daemon=True).start()

    @property
    def port(self):
        return self.sock.getsockname()[1]

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.connections += 1
            if self.connections == 1:
                conn.close()
                continue
            with conn, socket.create_connection(self.target) as up:
                up.sendall(conn.recv(1 << 16))
                while True:
                    b = up.recv(1 << 16)
                    if not b:
                        break
                    conn.sendall(b)


def test_transient_failure_retries(cluster, splits, tmp_path):
    """A reduce task whose first remote fetch is dropped fails TRANSIENT
    (a ConnectionError) and runs again on a claiming worker; the second
    attempt reads the block."""
    from blaze_tpu_torch.io.ipc import encode_ipc_segment
    from blaze_tpu_torch.runtime.transport import BlockServer

    rb = pq.read_table(splits[0]).to_batches()[0]
    path = tmp_path / "blk.data"
    path.write_bytes(encode_ipc_segment(rb))
    srv = BlockServer([str(tmp_path)]).start()
    proxy = _DropFirst(srv.address)
    try:
        from blaze_tpu_torch.batch import ColumnBatch

        schema = ColumnBatch.from_arrow(rb, device="cpu").schema
        reader = IpcReaderExec("in", schema, 1,
                               IpcReadMode.CHANNEL_AND_FILE_SEGMENT)
        blob = task_to_proto(reader, 0, "reduce-0", file_resources={
            "in": [RemoteSegment("127.0.0.1", proxy.port, str(path), 0,
                                 path.stat().st_size)]})
        before = cluster.retries
        (table,) = cluster.run_tasks([blob], timeout=120)
    finally:
        proxy.sock.close()
        srv.stop()
    assert cluster.retries == before + 1 and proxy.connections == 2
    assert table.num_rows == rb.num_rows
    assert_arrow_equal(table.combine_chunks(),
                       pa.Table.from_batches([rb]).combine_chunks())


def test_fatal_failures_quarantine_a_cuda_worker(splits, tmp_path):
    """A worker asked for cuda on a box without it fails each task it
    claims (INTERNAL, the device check), is quarantined after two such
    failures, and never computes the task on the CPU."""
    blob = task_to_proto(ParquetScanExec([[FileRange(splits[0])]]), 0)
    with MiniCluster(num_workers=1, spool_dir=str(tmp_path / "spool"),
                     device="cuda") as c:
        with pytest.raises(RuntimeError, match=r"\[INTERNAL\].*cuda"):
            c.run_tasks([blob], timeout=120)
        assert c.retries == 1 and len(c.quarantined) == 1
        with pytest.raises(RuntimeError, match="quarantined"):
            c.run_tasks([blob], timeout=120)
    assert not os.listdir(tmp_path / "spool" / "out") or all(
        not f.endswith(".done") for f in os.listdir(tmp_path / "spool"
                                                    / "out"))
