"""The PyTorch port's ColumnBatch against the JAX package's, on the CPU:
bucket padding, validity, deferred selection and the Arrow boundary,
plus the numpy interop that carries batches between the packages."""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu.batch import ColumnBatch as JaxBatch

from blaze_tpu_torch import interop
from blaze_tpu_torch.batch import ColumnBatch, row_mask
from blaze_tpu_torch.types import DataType, Field, Schema

from torch_support import assert_arrow_equal

CPU = torch.device("cpu")


def _record_batch(n, seed=0, nulls=True):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2 if nulls else np.ones(n, bool)

    def col(values, typ):
        return pa.array(values, type=typ, mask=~valid)

    return pa.record_batch({
        "b": col(rng.random(n) < 0.5, pa.bool_()),
        "i8": col(rng.integers(-128, 128, n).astype(np.int8), pa.int8()),
        "i16": col(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
                   pa.int16()),
        "i32": col(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                   pa.int32()),
        "i64": col(rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64),
                   pa.int64()),
        "f32": col((rng.random(n) * 100).astype(np.float32), pa.float32()),
        "f64": col(np.where(rng.random(n) < 0.1, np.nan, rng.random(n)),
                   pa.float64()),
        "d": col([datetime.date(2000, 1, 1)
                  + datetime.timedelta(days=int(x))
                  for x in rng.integers(-5000, 5000, n)], pa.date32()),
        "ts": col(rng.integers(0, 2 ** 50, n).astype("datetime64[us]"),
                  pa.timestamp("us")),
        "dec": col([decimal.Decimal(int(x)).scaleb(-2)
                    for x in rng.integers(-10 ** 9, 10 ** 9, n)],
                   pa.decimal128(12, 2)),
    })


@pytest.mark.parametrize("n", [0, 1, 300, 5000])
@pytest.mark.parametrize("nulls", [False, True])
def test_arrow_round_trip_matches_jax_batch(n, nulls):
    """Same bucket, same padded values on valid rows, same validity
    (padding rows stay valid), and the Arrow output equals the input."""
    rb = _record_batch(n, seed=n, nulls=nulls)
    port = ColumnBatch.from_arrow(rb, device=CPU)
    ref = JaxBatch.from_arrow(rb)
    assert port.capacity == ref.capacity and port.num_rows == ref.num_rows
    for pc_, jc in zip(port.columns, ref.columns):
        jv = np.asarray(jc.values)
        pv = pc_.values.numpy()
        assert pv.dtype == jv.dtype and pv.shape == jv.shape
        assert (pc_.validity is None) == (jc.validity is None)
        valid = np.ones(port.capacity, bool)
        if jc.validity is not None:
            valid = np.asarray(jc.validity)
            np.testing.assert_array_equal(pc_.validity.numpy(), valid)
        live = valid.copy()
        live[n:] = False
        np.testing.assert_array_equal(pv[live].view(np.uint8),
                                      jv[live].view(np.uint8))
    assert_arrow_equal(port.to_arrow(), rb)
    assert_arrow_equal(ref.to_arrow(), port.to_arrow())


def test_selection_and_live_mask():
    rb = _record_batch(300, nulls=False)
    cb = ColumnBatch.from_arrow(rb, device=CPU)
    assert cb.capacity == 1024
    sel = torch.from_numpy(np.arange(1024) % 3 == 0)
    cb.selection = sel
    exp = (np.arange(1024) < 300) & (np.arange(1024) % 3 == 0)
    np.testing.assert_array_equal(cb.live_mask().numpy(), exp)
    out = cb.to_arrow()
    assert_arrow_equal(out, rb.filter(pa.array(exp[:300])))
    np.testing.assert_array_equal(row_mask(5, 8, CPU).numpy(),
                                  np.arange(8) < 5)


def test_interop_round_trip_keeps_padding_and_selection():
    rng = np.random.default_rng(3)
    schema = Schema([Field("x", DataType.int32()),
                     Field("y", DataType.float64())])
    cap = 256
    values = [rng.integers(-9, 9, cap).astype(np.int32),
              rng.random(cap)]
    validity = [None, rng.random(cap) < 0.8]
    sel = rng.random(cap) < 0.5
    cb = interop.batch_from_numpy(schema, values, validity, sel, 200, "cpu")
    v2, m2, s2, n2 = interop.batch_to_numpy(cb)
    assert n2 == 200 and m2[0] is None
    np.testing.assert_array_equal(v2[0], values[0])
    np.testing.assert_array_equal(v2[1], values[1])
    np.testing.assert_array_equal(m2[1], validity[1])
    np.testing.assert_array_equal(s2, sel)


def test_interop_rejects_mixed_capacity_and_strings():
    schema = Schema([Field("x", DataType.int32()),
                     Field("y", DataType.int32())])
    with pytest.raises(ValueError):
        interop.batch_from_numpy(
            schema, [np.zeros(256, np.int32), np.zeros(512, np.int32)],
            [None, None], None, 10, "cpu")
    # strings cross as codes with their dictionary; decimal(>18) as
    # (capacity, 2) limbs, and a column of another shape is refused
    cb = interop.batch_from_numpy(
        Schema([Field("s", DataType.utf8())]),
        [np.array([1, 0, 1, 7], np.int32)], [np.array([1, 1, 1, 0], bool)],
        None, 3, "cpu", dictionaries=[pa.array(["x", "y"])])
    assert cb.to_pydict() == {"s": ["y", "x", "y"]}
    wide = Schema([Field("w", DataType.decimal(30, 2))])
    with pytest.raises(ValueError, match="shape"):
        interop.batch_from_numpy(wide, [np.zeros(4, np.int64)], [None],
                                 None, 4, "cpu")
    limbs = np.array([[5, 0], [-5, -1], [0, 1], [9, 9]], np.int64)
    cb = interop.batch_from_numpy(wide, [limbs], [None], None, 3, "cpu")
    assert cb.to_pydict() == {"w": [decimal.Decimal("0.05"),
                                    decimal.Decimal("-0.05"),
                                    decimal.Decimal(1 << 64) / 100]}


# utf8 columns are dictionary-encoded since the strings slice, and
# decimal(>18) columns load as limbs since the decimal128 slice; a type
# no slice brings still raises
@pytest.mark.parametrize("typ", [pa.decimal128(38, 10),
                                 pa.decimal128(30, 2)])
def test_unsupported_columns_raise_naming_roadmap(typ):
    arr = pa.array([decimal.Decimal("1.5"), None,
                    decimal.Decimal(10**17) * 3], type=typ)
    rb = pa.record_batch({"c": arr})
    cb = ColumnBatch.from_arrow(rb, device=CPU)
    assert tuple(cb.columns[0].values.shape) == (cb.capacity, 2)
    assert cb.to_arrow().equals(rb)
    assert JaxBatch.from_arrow(rb).to_arrow().equals(rb)
    with pytest.raises(NotImplementedError, match="list"):
        ColumnBatch.from_arrow(pa.record_batch({"c": pa.array(
            [[1]], pa.list_(pa.int32()))}), device=CPU)
