"""The port's in-process C-ABI embedding (runtime/embed.py) on the CPU:
the twin of tests/test_embed.py. The port's C++ embed host
(csrc/blaze_embed_main.cpp with csrc/blaze_embed.cpp, copies of cpp/'s
with the module re-pointed) is built with g++ and `python3-config
--embed`, hosts CPython, runs a TaskDefinition through
`blaze_tpu_torch.runtime.embed` with `BLAZE_EMBED_DEVICE=cpu`, and
checksums every exported Arrow C-Data column by walking its raw
buffers. Its checksums equal the port's own pyarrow answer
(`run_task_checksums`), for q6's shape (and there the JAX package's for
the same blob too) and for a stream of several batches with NULLs; an
engine error comes back through `blz_embed_last_error`. The three blobs
go through one run of the host (one embedded interpreter)."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
from blaze_tpu_torch.ops import AggMode, FilterExec, HashAggregateExec
from blaze_tpu_torch.ops import ProjectExec
from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec
from blaze_tpu_torch.plan.serde import task_to_proto
from blaze_tpu_torch.runtime import embed
from blaze_tpu_torch.types import DataType

from torch_support import computed_once


def _q6_blob(d):
    """q6's shape: ParquetScan -> Filter -> Project -> keyless
    aggregate, through the in-process boundary."""
    rng = np.random.default_rng(11)
    n = 20_000
    path = str(d / "ss.parquet")
    pq.write_table(pa.table({
        "item": rng.integers(0, 50, n).astype(np.int32),
        "qty": rng.integers(1, 10, n).astype(np.int32),
        "price": (rng.random(n) * 100).astype(np.float32)}), path)
    plan = HashAggregateExec(
        ProjectExec(
            FilterExec(ParquetScanExec([[FileRange(path)]]),
                       (Col("price") > 25.0) & (Col("qty") < 9)),
            [(Col("price") * Col("qty").cast(DataType.float32()), "rev")]),
        keys=[],
        aggs=[(AggExpr(AggFn.SUM, Col("rev")), "rev"),
              (AggExpr(AggFn.COUNT_STAR, None), "cnt")],
        mode=AggMode.COMPLETE)
    return task_to_proto(plan, 0)


def _stream_blob(d):
    """Several exported batches with NULLs: the consumer sees every
    batch and honours the validity bitmaps."""
    rng = np.random.default_rng(12)
    n = 50_000  # several batches of the 16,384-row default
    v = rng.random(n)
    v[rng.random(n) < 0.1] = np.nan
    path = str(d / "m.parquet")
    pq.write_table(pa.table({
        "v": pd.Series(v),
        "g": rng.integers(0, 7, n).astype(np.int64),
        "q": pa.array(rng.integers(-9, 9, n).astype(np.int32),
                      mask=rng.random(n) < 0.2)}), path,
        row_group_size=1024)
    return task_to_proto(FilterExec(ParquetScanExec([[FileRange(path)]]),
                                    Col("g") >= 1), 0)


@pytest.fixture(scope="module")
def hosted(tmp_path_factory):
    """The three blobs (q6, the stream, garbage) through one run of the
    host, shared by the xdist workers: one interpreter start, not
    three."""
    try:
        embed.python_config()
    except RuntimeError as e:
        pytest.skip(f"this box lacks python3-config --embed: {e}")

    def compute():
        d = tmp_path_factory.mktemp("embed")
        blobs = [_q6_blob(d), _stream_blob(d), b"\x07garbage-not-a-task"]
        paths = []
        for i, blob in enumerate(blobs):
            paths.append(d / f"task{i}.bin")
            paths[-1].write_bytes(blob)
        r = embed.run_host(paths, device="cpu", timeout=300)
        return {"blobs": blobs, "returncode": r.returncode,
                "stdout": r.stdout, "stderr": r.stderr}

    out = computed_once(tmp_path_factory, "torch-embed-host", compute)
    out["tasks"] = embed.parse_checksums(out["stdout"])
    assert len(out["tasks"]) == 3, out["stderr"][-2000:]
    return out


def _assert_close(got, exp):
    assert got is not None
    assert got[0] == exp[0], (got, exp)  # the row count exactly
    assert len(got) == len(exp)
    for g, e in zip(got[1:], exp[1:]):
        assert abs(g - e) <= max(1e-6, 1e-9 * abs(e)), (got, exp)


def test_embed_q6(hosted, monkeypatch):
    from blaze_tpu.runtime.embed import run_task_checksums as jsums

    blob = hosted["blobs"][0]
    monkeypatch.setenv(embed.DEVICE_ENV, "cpu")
    port = embed.run_task_checksums(blob)
    _assert_close(port, jsums(blob))
    _assert_close(hosted["tasks"][0], port)


def test_embed_multi_batch_stream(hosted, monkeypatch):
    monkeypatch.setenv(embed.DEVICE_ENV, "cpu")
    got = hosted["tasks"][1]
    _assert_close(got, embed.run_task_checksums(hosted["blobs"][1]))
    assert got[0] > 16_384


def test_embed_error_propagates(hosted):
    """The garbage blob's engine error comes back through
    blz_embed_last_error, and the host exits 1; the blobs before it ran
    in the same interpreter."""
    assert hosted["returncode"] == 1
    assert hosted["tasks"][2] is None
    assert "task2.bin: execute failed" in hosted["stderr"]
