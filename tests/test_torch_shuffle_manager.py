"""The port's shuffle manager (parallel/shuffle_manager.py) and host-tier
shuffle writer (ops/host_shuffle.py) against the JAX package's, on the
CPU: the twin of tests/test_shuffle_manager.py. The lifecycle (register,
write by either tier, atomic and idempotent commit, read with a map
range, statistics, remove), shuffles written by the port read by the
JAX package's `ShuffleManager.read_partition` and the other way round,
host-tier files byte-equal across the packages, and `host_partition_ids`
bit-equal to the JAX package's (string keys included) and to the port's
device ids (K4's plain version on the CPU)."""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops import ExecContext, MemoryScanExec
from blaze_tpu_torch.ops.host_shuffle import host_partition_ids
from blaze_tpu_torch.parallel.shuffle_manager import ShuffleManager

WORDS = np.array(["", "a", "bb", "céé", "dddd", "naïve", "z" * 40])


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    return pa.record_batch({
        "k": pa.array(rng.integers(-30, 30, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "s": pa.array(WORDS[rng.integers(0, len(WORDS), n)],
                      mask=rng.random(n) < 0.05),
        "v": rng.random(n),
    })


def _rows(batches):
    if not batches:
        return pd.DataFrame({"k": [], "s": [], "v": []})
    return pa.Table.from_batches(batches).to_pandas()


def _sorted(df):
    return df.sort_values(["k", "s", "v"], na_position="first") \
        .reset_index(drop=True)


def _port_shuffle(root, frames, keys=("k", "s"), n=4):
    """Maps 0 and 1 on the port's device tier (the CPU here), map 2 on
    its host tier."""
    mgr = ShuffleManager(str(root))
    h = mgr.register_shuffle(num_maps=3, num_partitions=n, keys=list(keys))
    cbs = [ColumnBatch.from_arrow(rb, device="cpu") for rb in frames]
    scan = MemoryScanExec([[cbs[0]], [cbs[1]]], cbs[0].schema)
    for m in (0, 1):
        assert len(mgr.write_map_native(
            h, m, scan, ExecContext(device="cpu"))) == n
    assert len(mgr.write_map_batches(h, 2, iter([frames[2]]))) == n
    return mgr, h


def _jax_shuffle(root, frames, keys=("k", "s"), n=4):
    from blaze_tpu.batch import ColumnBatch as JBatch
    from blaze_tpu.ops import MemoryScanExec as JScan
    from blaze_tpu.parallel.shuffle_manager import ShuffleManager as JMgr

    mgr = JMgr(str(root))
    h = mgr.register_shuffle(num_maps=3, num_partitions=n, keys=list(keys))
    cbs = [JBatch.from_arrow(rb) for rb in frames]
    scan = JScan([[cbs[0]], [cbs[1]]], cbs[0].schema)
    for m in (0, 1):
        mgr.write_map_native(h, m, scan)
    mgr.write_map_batches(h, 2, iter([frames[2]]))
    return mgr, h


def _adopt(reader_mgr, writer_mgr, writer_h):
    """Register a shuffle in `reader_mgr` whose committed maps are the
    files `writer_mgr` committed (the files are all that crosses)."""
    h = reader_mgr.register_shuffle(writer_h.num_maps,
                                    writer_h.num_partitions,
                                    list(writer_h.key_names))
    for m in range(writer_h.num_maps):
        reader_mgr._committed[(h.shuffle_id, m)] = \
            writer_mgr._committed[(writer_h.shuffle_id, m)]
    return h


@pytest.fixture(scope="module")
def shuffles(tmp_path_factory):
    frames = [_batch(s, 1500) for s in (1, 2, 3)]
    port = _port_shuffle(tmp_path_factory.mktemp("port_shuffle"), frames)
    jax = _jax_shuffle(tmp_path_factory.mktemp("jax_shuffle"), frames)
    return frames, port, jax


def test_mixed_producers_roundtrip(shuffles):
    """Every row lands exactly once, and a key lands in one partition
    whichever tier wrote it."""
    frames, (mgr, h), _ = shuffles
    all_rows = _rows(frames)
    parts = [_rows(list(mgr.read_partition(h, p))) for p in range(4)]
    pd.testing.assert_frame_equal(
        _sorted(pd.concat(parts, ignore_index=True)), _sorted(all_rows))
    keys = [set(zip(df.k.astype("Int64").astype(str), df.s.astype(str)))
            for df in parts]
    for p in range(4):
        for q in range(p + 1, 4):
            assert not keys[p] & keys[q]
    stats = mgr.map_statistics(h)
    assert len(stats) == 4 and sum(stats) > 0


def test_each_package_reads_the_others_shuffle(shuffles):
    from blaze_tpu.parallel.shuffle_manager import ShuffleManager as JMgr

    frames, (pmgr, ph), (jmgr, jh) = shuffles
    jreader = JMgr(pmgr.root + "-jax-reader")
    jh_of_port = _adopt(jreader, pmgr, ph)
    preader = ShuffleManager(jmgr.root + "-port-reader")
    ph_of_jax = _adopt(preader, jmgr, jh)
    for p in range(4):
        own = _rows(list(pmgr.read_partition(ph, p)))
        by_jax = _rows(list(jreader.read_partition(jh_of_port, p)))
        jax_own = _rows(list(jmgr.read_partition(jh, p)))
        by_port = _rows(list(preader.read_partition(ph_of_jax, p)))
        # same rows, in the same order, whoever wrote or reads them
        pd.testing.assert_frame_equal(own, by_jax)
        pd.testing.assert_frame_equal(jax_own, by_port)
        pd.testing.assert_frame_equal(_sorted(own), _sorted(jax_own))
    assert preader.map_statistics(ph_of_jax) == jmgr.map_statistics(jh)


def test_host_tier_files_are_byte_equal(shuffles):
    frames, (pmgr, ph), (jmgr, jh) = shuffles
    for suffix in (".data", ".index"):
        with open(os.path.join(ph.root, "map_2" + suffix), "rb") as a, \
                open(os.path.join(jh.root, "map_2" + suffix), "rb") as b:
            assert a.read() == b.read(), suffix


def test_host_shuffle_spills_keep_the_layout(tmp_path, monkeypatch):
    """With spills at the same points, the host tier writes the JAX
    package's bytes (its C++ `shuffle_assemble`): each partition is its
    buffered parts, then its parts of each spill file in spill order."""
    from blaze_tpu.ops import shuffle_writer as jshuffle_writer
    from blaze_tpu.ops.host_shuffle import host_shuffle_write as jwrite

    from blaze_tpu_torch.ops import shuffle_writer
    from blaze_tpu_torch.ops.host_shuffle import host_shuffle_write

    batches = [_batch(s, 300) for s in range(6)]
    for mod in (shuffle_writer, jshuffle_writer):
        real = mod.PartitionBuffers.append

        def append_and_spill(self, partition, part, real=real):
            real(self, partition, part)
            if len(self.spills) < 3:
                self.spill()

        monkeypatch.setattr(mod.PartitionBuffers, "append",
                            append_and_spill)
    lens = host_shuffle_write(iter(batches), ["s", "k"], 7,
                              str(tmp_path / "p.data"),
                              str(tmp_path / "p.index"), str(tmp_path))
    jlens = jwrite(iter(batches), ["s", "k"], 7, str(tmp_path / "j.data"),
                   str(tmp_path / "j.index"), str(tmp_path))
    assert lens == jlens
    for suffix in (".data", ".index"):
        assert (tmp_path / f"p{suffix}").read_bytes() == \
            (tmp_path / f"j{suffix}").read_bytes()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_idempotent_recommit_and_map_range(tmp_path):
    """A task retry re-commits a map id: the replacement wins; map_range
    reads select a subset of maps (AQE partial-mapper)."""
    mgr = ShuffleManager(str(tmp_path))
    h = mgr.register_shuffle(num_maps=2, num_partitions=2, keys=["k"])
    f0, f1 = _batch(7, 400), _batch(8, 300)
    mgr.write_map_batches(h, 0, iter([f0]))
    mgr.write_map_batches(h, 0, iter([f1]))  # the retry
    mgr.write_map_batches(h, 1, iter([f0]))
    rows = sum(rb.num_rows for p in range(2)
               for rb in mgr.read_partition(h, p))
    assert rows == 700
    assert sum(rb.num_rows for p in range(2)
               for rb in mgr.read_partition(h, p, map_range=(0, 1))) == 300
    # no temporary file survives a commit
    assert sorted(os.listdir(h.root)) == [
        "map_0.data", "map_0.index", "map_1.data", "map_1.index"]
    with pytest.raises(KeyError, match="not committed"):
        next(iter(mgr.read_partition(mgr.register_shuffle(1, 2, ["k"]),
                                     0)))


def test_remove_shuffle_deletes_files(tmp_path):
    mgr = ShuffleManager(str(tmp_path))
    h = mgr.register_shuffle(num_maps=1, num_partitions=2, keys=["k"])
    mgr.write_map_batches(h, 0, iter([_batch(9, 100)]))
    assert os.path.exists(h.root)
    mgr.remove_shuffle(h)
    assert not os.path.exists(h.root)
    with pytest.raises(KeyError):
        next(iter(mgr.read_partition(h, 0)))


def _typed_batch(n=2000):
    rng = np.random.default_rng(21)
    null = rng.random(n) < 0.1
    f64 = rng.normal(size=n)
    f64[rng.integers(0, n, 20)] = np.nan
    f64[rng.integers(0, n, 20)] = -0.0
    return pa.record_batch({
        "b": pa.array(rng.random(n) < 0.5),
        "bn": pa.array(rng.random(n) < 0.5, mask=null),
        "i8": pa.array(rng.integers(-128, 127, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-999, 999, n).astype(np.int16)),
        "i32": pa.array(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
                        mask=null),
        "i64": pa.array(rng.integers(-2**62, 2**62, n)),
        "f32": pa.array(f64.astype(np.float32)),
        "f64": pa.array(f64, mask=rng.random(n) < 0.05),
        "d": pa.array(rng.integers(-9000, 9000, n).astype(np.int32),
                      pa.date32()),
        "ts": pa.array(rng.integers(0, 2**50, n), pa.timestamp("us")),
        "s": pa.array(WORDS[rng.integers(0, len(WORDS), n)], mask=null),
        "ds": pa.array(WORDS[rng.integers(0, len(WORDS), n)])
        .dictionary_encode(),
    })


KEY_SETS = [["i32"], ["i64", "s"], ["s"], ["ds", "b"], ["f64", "f32"],
            ["d", "ts", "i8", "i16"], ["s", "f64", "i32", "b"],
            ["bn", "i64"]]


@pytest.mark.parametrize("keys", KEY_SETS, ids="-".join)
@pytest.mark.parametrize("n", [1, 7, 200])
def test_host_partition_ids_match_jax_and_device(keys, n):
    """Bit-equal to the port's device ids everywhere, and to the JAX
    package's where it computes them: its host hash fails on a bool key
    with NULLs (pyarrow's to_numpy gives Python objects there,
    blaze_tpu/ops/host_shuffle.py:50-52), which the port hashes as
    Spark does (a NULL keeps the running hash)."""
    from blaze_tpu.ops.host_shuffle import host_partition_ids as jids

    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.exprs.optimize import bind_opt
    from blaze_tpu_torch.ops.shuffle_writer import spark_partition_ids

    rb = _typed_batch()
    got = host_partition_ids(rb, keys, n)
    assert got.dtype == np.int32
    if "bn" in keys:
        with pytest.raises(TypeError):
            jids(rb, keys, n)
    else:
        np.testing.assert_array_equal(got, jids(rb, keys, n))
    cb = ColumnBatch.from_arrow(rb, device="cpu")
    dev = spark_partition_ids(cb, [bind_opt(Col(k), cb.schema)
                                   for k in keys], n)
    np.testing.assert_array_equal(got, dev.numpy()[:rb.num_rows])
