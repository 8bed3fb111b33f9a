"""Kernel K4's plain version and the port's Spark murmur3 chain
(blaze_tpu_torch.exprs.hashing, ops/kernels/murmur3.py) against the JAX
package, on the CPU: the Pallas kernel in interpret mode, the device
chain `hash_columns_device` + `pmod`, and the numpy host twins. All
bit-exact.

Float keys whose NaN payload or subnormal bits matter are held against
a numpy Spark oracle instead (Java's floatToIntBits / doubleToLongBits
then the JAX package's scalar `hash_int_host` / `hash_long_host`): the
JAX device chain hashes a float32 NaN's raw bits and flushes subnormals
(ROADMAP section 3), and partition ids are a Spark interop contract.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blaze_tpu.exprs import hashing as jax_hashing
from blaze_tpu.ops.kernels import murmur3_pallas
from blaze_tpu.types import DataType as JDataType
from blaze_tpu.types import TypeId as JTypeId

from blaze_tpu_torch.exprs import hashing
from blaze_tpu_torch.ops.kernels import murmur3
from blaze_tpu_torch.types import DataType

from torch_support import computed_once

CAP = 2048
NS = (7, 200)
TYPES = ["bool", "int8", "int16", "int32", "date32", "int64",
         "timestamp_us", "decimal18", "float32", "float64"]
_NP = {"bool": np.bool_, "int8": np.int8, "int16": np.int16,
       "int32": np.int32, "date32": np.int32, "int64": np.int64,
       "timestamp_us": np.int64, "decimal18": np.int64,
       "float32": np.float32, "float64": np.float64}


def port_dtype(name):
    return DataType.decimal(18, 2) if name == "decimal18" \
        else getattr(DataType, "bool_" if name == "bool" else name)()


def jax_dtype(name):
    dt = port_dtype(name)
    return JDataType(JTypeId(dt.id.value), dt.precision, dt.scale)


def column(name, seed, nullable):
    """Values with the type's extremes, and (floats) +/-0.0, +/-inf and
    the canonical NaN, on which both packages follow Spark."""
    rng = np.random.default_rng(seed)
    dt = _NP[name]
    if dt == np.bool_:
        v = rng.random(CAP) < 0.5
    elif np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, CAP, dtype=dt, endpoint=True)
        v[:5] = [info.min, info.max, 0, -1, 1]
    else:
        v = ((rng.random(CAP) - 0.5) * 1e6).astype(dt)
        v[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.5]
    m = (rng.random(CAP) < 0.8) if nullable else None
    return v, m


def port_hash(cols):
    return hashing.hash_columns_device(
        [(torch.from_numpy(v), None if m is None else torch.from_numpy(m),
          port_dtype(t)) for t, v, m in cols], CAP).numpy()


MIXES = {
    "int32+float64_null+int8": [("int32", False), ("float64", True),
                                ("int8", False)],
    "int64_null+float32+bool_null": [("int64", True), ("float32", False),
                                     ("bool", True)],
    "date32+decimal18+int16_null": [("date32", False), ("decimal18", False),
                                    ("int16", True)],
    "timestamp_us_null+int32": [("timestamp_us", True), ("int32", False)],
}


def chain_inputs():
    """{case: [(type, values, validity)]}: every type alone, nullable
    and not, and the multi-column mixes."""
    cases = {f"{t}-{'null' if null else 'valid'}":
             [(t, *column(t, TYPES.index(t), null))]
             for t in TYPES for null in (False, True)}
    for mix, spec in MIXES.items():
        cases[mix] = [(t, *column(t, 40 + i, null))
                      for i, (t, null) in enumerate(spec)]
    return cases


@pytest.fixture(scope="module")
def jax_chain(tmp_path_factory):
    return computed_once(tmp_path_factory, "murmur3-jax_chain", _jax_chain)


def _jax_chain():
    """(inputs, the JAX package's hash_columns_device of each): one
    jax.jit over every case, so the chain compiles once."""
    cases = chain_inputs()
    names = sorted(cases)
    dtypes = {k: [jax_dtype(t) for t, _, _ in cases[k]] for k in names}

    def run(arrays):
        return [jax_hashing.hash_columns_device(
            [(v, m, dt) for (v, m), dt in zip(arrays[i], dtypes[k])], CAP)
            for i, k in enumerate(names)]

    arrays = [[(jnp.asarray(v), None if m is None else jnp.asarray(m))
               for _, v, m in cases[k]] for k in names]
    out = jax.jit(run)(arrays)
    return cases, {k: np.asarray(h) for k, h in zip(names, out)}


# ---------------------------------------------------------------------------
# K4's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pallas_ids(tmp_path_factory):
    return computed_once(tmp_path_factory, "murmur3-pallas_ids", _pallas_ids)


def _pallas_ids():
    """The Pallas kernel's ids, one compile per (key width, n), as
    tests/test_pallas_kernels.py runs it."""
    rng = np.random.default_rng(3)
    v32 = rng.integers(-2 ** 31, 2 ** 31, CAP, dtype=np.int64) \
        .astype(np.int32)
    v64 = rng.integers(-2 ** 63, 2 ** 63 - 1, CAP, dtype=np.int64)
    v32[:3] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0]
    v64[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
    out = {}
    for n in NS:
        out["int32", n] = (v32, np.asarray(murmur3_pallas.partition_ids_int32(
            jnp.asarray(v32), n, interpret=True)))
        out["int64", n] = (v64, np.asarray(murmur3_pallas.partition_ids_int64(
            jnp.asarray(v64), n, interpret=True)))
    return out


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("key", ["int32", "int64"])
def test_k4_plain_matches_pallas_kernel(pallas_ids, key, n):
    values, exp = pallas_ids[key, n]
    got = murmur3.partition_ids(
        [(torch.from_numpy(values), None, port_dtype(key))], CAP, n)
    np.testing.assert_array_equal(got.numpy(), exp)


# ---------------------------------------------------------------------------
# the chain against hash_columns_device + pmod
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nullable", [False, True], ids=["valid", "null"])
@pytest.mark.parametrize("name", TYPES)
def test_chain_matches_jax(jax_chain, name, nullable):
    cases, exp_h = jax_chain
    key = f"{name}-{'null' if nullable else 'valid'}"
    ((_, v, m),) = cases[key]
    h = port_hash(cases[key])
    np.testing.assert_array_equal(h, exp_h[key])
    num_rows = CAP - 9
    got = murmur3.partition_ids(
        [(torch.from_numpy(v), None if m is None else torch.from_numpy(m),
          port_dtype(name))], num_rows, 200).numpy()
    exp = np.where(np.arange(CAP) < num_rows,
                   exp_h[key].astype(np.int64) % 200, 200)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_multi_column_chain_matches_jax(jax_chain, mix):
    cases, exp_h = jax_chain
    np.testing.assert_array_equal(port_hash(cases[mix]), exp_h[mix])


PMOD_NS = [1, 2, 3, 200, 1024, 2 ** 31 - 1]


@pytest.fixture(scope="module")
def jax_pmod(tmp_path_factory):
    return computed_once(tmp_path_factory, "murmur3-jax_pmod", _jax_pmod)


def _jax_pmod():
    """Random int32 hashes with the extremes, and the JAX package's pmod
    of them for every n (one jax.jit)."""
    h = np.random.default_rng(97).integers(
        -2 ** 31, 2 ** 31, CAP, dtype=np.int64).astype(np.int32)
    h[:3] = [np.iinfo(np.int32).min, -1, np.iinfo(np.int32).max]
    out = jax.jit(lambda x: [jax_hashing.pmod(x, n) for n in PMOD_NS])(
        jnp.asarray(h))
    return h, dict(zip(PMOD_NS, (np.asarray(r) for r in out)))


@pytest.mark.parametrize("n", PMOD_NS)
def test_pmod_matches_jax(jax_pmod, n):
    h, exp = jax_pmod
    got = hashing.pmod(torch.from_numpy(h), n).numpy()
    np.testing.assert_array_equal(got, exp[n])
    assert got.min() >= 0 and got.max() < n


# ---------------------------------------------------------------------------
# float keys against Spark (Java's canonical NaN, subnormals kept)
# ---------------------------------------------------------------------------

F32_EDGES = [0x00000000, 0x80000000, 0x7FC00000, 0xFFC00000, 0x7F800001,
             0x7FFFFFFF, 0xFFFFFFFF, 0x00000001, 0x807FFFFF, 0x7F800000,
             0xFF800000, 0x7F7FFFFF, 0x00800000]
F64_EDGES = [0x0, 0x8000000000000000, 0x7FF8000000000000,
             0xFFF8000000000000, 0x7FF0000000000001, 0x7FFFFFFFFFFFFFFF,
             0xFFFFFFFFFFFFFFFF, 0x1, 0x800FFFFFFFFFFFFF,
             0x7FF0000000000000, 0xFFF0000000000000, 0x7FEFFFFFFFFFFFFF,
             0x0010000000000000]


def spark_float_hash(bits: int, width: int) -> int:
    """Spark's Murmur3Hash of one float key given its bits: Java's
    floatToIntBits / doubleToLongBits (every NaN canonical, -0.0
    normalised to 0.0 first), then hashInt / hashLong, as a signed
    int."""
    if width == 32:
        f = np.array([bits], np.uint32).view(np.float32)[0]
        if np.isnan(f):
            bits = 0x7FC00000
        elif f == 0:
            bits = 0
        h = jax_hashing.hash_int_host(int(np.uint32(bits).view(np.int32)))
    else:
        d = np.array([bits], np.uint64).view(np.float64)[0]
        if np.isnan(d):
            bits = 0x7FF8000000000000
        elif d == 0:
            bits = 0
        h = jax_hashing.hash_long_host(int(np.uint64(bits).view(np.int64)))
    return int(np.uint32(h).view(np.int32))


@pytest.mark.parametrize(
    "width,bits",
    [(32, b) for b in F32_EDGES] + [(64, b) for b in F64_EDGES],
    ids=[f"f32_{b:08x}" for b in F32_EDGES]
    + [f"f64_{b:016x}" for b in F64_EDGES])
def test_float_key_hash_follows_spark(width, bits):
    npt, ints = ((np.float32, np.uint32) if width == 32
                 else (np.float64, np.uint64))
    v = np.array([bits] * 4, ints).view(npt)
    dt = DataType.float32() if width == 32 else DataType.float64()
    h = hashing.hash_columns_device([(torch.from_numpy(v), None, dt)], 4)
    exp = spark_float_hash(bits, width)
    assert h.tolist() == [exp] * 4
    ids = murmur3.partition_ids([(torch.from_numpy(v), None, dt)], 4, 200)
    assert ids.tolist() == [exp % 200] * 4
    assert murmur3.hashes([(torch.from_numpy(v), None, dt)], 4).tolist() \
        == [exp] * 4


def test_jax_device_float_hash_deviates_from_spark():
    """The reference fault the port does not copy (ROADMAP section 3):
    for float32 keys the JAX package's device hash takes x86's negative
    quiet NaN (0/0) by its raw bits and flushes the subnormal 0x00000001
    to zero. Spark hashes them to -349261430 and -559580957."""
    v = np.array([0xFFC00000, 0x00000001], np.uint32).view(np.float32)
    spark = [-349261430, -559580957]
    assert [spark_float_hash(b, 32) for b in (0xFFC00000, 1)] == spark
    port = hashing.hash_columns_device(
        [(torch.from_numpy(v), None, DataType.float32())], 2).tolist()
    assert port == spark
    jax = np.asarray(jax_hashing.hash_columns_device(
        [(jnp.asarray(v), None, JDataType.float32())], 2)).tolist()
    assert jax == [299915115, 933211791]


# ---------------------------------------------------------------------------
# numpy host twins against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v", [0, 1, -1, 42, 2 ** 31 - 1, -2 ** 31])
def test_hash_int_host_matches_jax(v):
    assert hashing.hash_int_host(v) == jax_hashing.hash_int_host(v)
    assert hashing.hash_int_host(v, 7) == jax_hashing.hash_int_host(v, 7)


@pytest.mark.parametrize("v", [0, 1, -1, 2 ** 40 + 3, 2 ** 63 - 1, -2 ** 63])
def test_hash_long_host_matches_jax(v):
    assert hashing.hash_long_host(v) == jax_hashing.hash_long_host(v)


@pytest.mark.parametrize("data", [b"", b"a", b"abcd", b"hello w\xffrld",
                                  "Spark ünïcode".encode()])
def test_hash_bytes_host_matches_jax(data):
    assert hashing.hash_bytes_host(data) == jax_hashing.hash_bytes_host(data)


def test_host_twins_match_the_torch_chain():
    """The vectorised numpy twins equal the torch chain (chip_smoke's
    repartition gate rests on them)."""
    rng = np.random.default_rng(11)
    i32 = rng.integers(-2 ** 31, 2 ** 31, CAP, dtype=np.int64) \
        .astype(np.int32)
    i64 = rng.integers(-2 ** 63, 2 ** 63 - 1, CAP, dtype=np.int64)
    seed = np.uint32(42)
    got32 = hashing._np_hash_int(i32.view(np.uint32), seed).view(np.int32)
    got64 = hashing._np_hash_long(i64, seed).view(np.int32)
    np.testing.assert_array_equal(got32, port_hash([("int32", i32, None)]))
    np.testing.assert_array_equal(got64, port_hash([("int64", i64, None)]))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_partition_ids_refuse_bad_input():
    v = torch.zeros(16, dtype=torch.int32)
    i32 = DataType.int32()
    # strings hash on the host (exprs/hashing.hash_rows_host), not in K4
    with pytest.raises(NotImplementedError, match="host"):
        murmur3.partition_ids([(v, None, DataType.utf8())], 16, 4)
    # decimal(>18) keys are hashed by neither package
    with pytest.raises(NotImplementedError, match="hash of decimal"):
        murmur3.partition_ids([(v, None, DataType.decimal(30, 2))], 16, 4)
    with pytest.raises(ValueError):
        murmur3.partition_ids([(v, None, i32)], 16, 0)
    with pytest.raises(ValueError):
        murmur3.partition_ids([(v, None, i32), (v[:8], None, i32)], 16, 4)
    with pytest.raises(ValueError):
        murmur3.partition_ids([(v, None, i32)], 17, 4)
    with pytest.raises(ValueError):
        murmur3.partition_ids([], 16, 4)


def test_partition_ids_refuse_non_cpu_tensors_instead_of_plain():
    """A tensor that is not on the CPU never takes the plain version:
    the wrapper launches the kernel (CUDA) or raises."""
    v = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        murmur3.partition_ids([(v, None, DataType.int32())], 16, 4)
    w = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="devices"):
        murmur3.partition_ids([(w, None, DataType.int32()),
                               (v, None, DataType.int32())], 16, 4)
    assert murmur3.LAUNCHES == 0


# ---------------------------------------------------------------------------
# hashes: the chained hash itself (the sorted join core's bucketing)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["int32-null", "float64-valid",
                                  "float32-null", "bool-valid"]
                         + sorted(MIXES) + ["nine_columns"])
def test_hashes_matches_jax_chain(jax_chain, case):
    """`hashes` is the JAX package's hash_columns_device below num_rows
    and HASH_PAD past it, for one, three and nine key columns (nine
    take two launches on the card); pmod of it is partition_ids."""
    cases, exp_h = jax_chain
    if case == "nine_columns":
        spec = [cases[f"{t}-{'null' if i % 2 else 'valid'}"][0]
                for i, t in enumerate(["int32", "float64", "int64", "bool",
                                       "int8", "int16", "date32",
                                       "timestamp_us", "decimal18"])]
        exp = jax_hash_of(spec)
    else:
        spec, exp = cases[case], exp_h[case]
    cols = [(torch.from_numpy(v), None if m is None else torch.from_numpy(m),
             port_dtype(t)) for t, v, m in spec]
    num_rows = CAP - 13
    got = murmur3.hashes(cols, num_rows).numpy()
    np.testing.assert_array_equal(got[:num_rows], exp[:num_rows])
    assert (got[num_rows:] == murmur3.HASH_PAD).all()
    ids = murmur3.partition_ids(cols, num_rows, 200).numpy()
    np.testing.assert_array_equal(
        ids[:num_rows], got[:num_rows].astype(np.int64) % 200)
    assert murmur3.HASH_LAUNCHES == 0


def jax_hash_of(spec):
    """The JAX package's hash_columns_device of [(type, values,
    validity)]."""
    cols = [(jnp.asarray(v), None if m is None else jnp.asarray(m),
             jax_dtype(t)) for t, v, m in spec]
    return np.asarray(jax_hashing.hash_columns_device(cols, CAP))


def test_hashes_refuse_bad_input():
    v = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="host"):
        murmur3.hashes([(v, None, DataType.utf8())], 16)
    with pytest.raises(ValueError):
        murmur3.hashes([(v, None, DataType.int32())], 17)
    with pytest.raises(ValueError):
        murmur3.hashes([], 16)
    meta = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        murmur3.hashes([(meta, None, DataType.int32())], 16)
