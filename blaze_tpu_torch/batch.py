"""Columnar batch substrate on torch tensors.

A `ColumnBatch` is the engine's unit of data flow - the counterpart of
the reference's Arrow `RecordBatch` streaming through DataFusion
operators (reference exec.rs:196-255). As in the JAX package:

- Every column is a fixed-capacity device tensor padded up to a shape
  bucket (`EngineConfig.bucket_for`). The live row count is carried
  separately (`num_rows`); rows past it are padding that kernels mask.
- SQL NULLs are a separate bool validity tensor per column (None ==
  all valid).
- A filter defers its work into `selection`, a device row mask; the
  next pipeline breaker or the host boundary compacts it away.

A scan's batches are `PackedColumnBatch`es: every buffer a view of one
device byte buffer that crossed in one H2D copy (runtime/pack.py).
`to_arrow` fetches a batch's buffers in one D2H copy.

Types: bool, int8-64, float32/64, date32, timestamp_us, decimal(<=18)
as unscaled int64, decimal(>18) as a (capacity, 2) int64 tensor of
[lo bit pattern, hi] limbs (the JAX package's `_decimal_limbs`, the
reference's 16-byte decimal slot), and utf8/binary as int32 dictionary codes on the
device with a host pyarrow dictionary beside them (`Column.dictionary`),
as the JAX package carries strings (blaze_tpu/batch.py). Device compute
sees only codes; codes of two batches compare only after
`ops/util.unify_dictionaries`. A padded row's code indexes nothing, and
a NULL row's code is 0 whatever the dictionary holds.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.config import get_config
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.types import (
    DataType,
    Schema,
    TypeId,
    from_arrow_schema,
    to_arrow_type,
)

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt: DataType) -> torch.dtype:
    """torch dtype of a logical type's device values."""
    return _TORCH_DTYPES[dt.physical_dtype()]


def default_device() -> torch.device:
    return torch.device(get_config().device)


def value_shape(dt: DataType, capacity: int) -> Tuple[int, ...]:
    """Shape of a column's device values: (capacity, 2) limbs for a
    decimal(>18), else (capacity,)."""
    return (capacity, 2) if dt.is_wide_decimal else (capacity,)


def zero_values(dt: DataType, capacity: int,
                device: torch.device) -> torch.Tensor:
    """Zero device values of a column of `dt`."""
    return torch.zeros(value_shape(dt, capacity), dtype=torch_dtype(dt),
                       device=device)


def string_value_type(dt: DataType):
    """The Arrow type of a string-like column's dictionary values."""
    import pyarrow as pa

    return pa.binary() if dt.id is TypeId.BINARY else pa.utf8()


# dictionaries known to hold each value once (made by dictionary_encode
# or by a unification), by identity; an entry leaves with its array
_UNIQUE: dict = {}


def mark_unique(dictionary):
    """Note that `dictionary` holds each value once; returns it."""
    key = id(dictionary)
    _UNIQUE[key] = weakref.ref(dictionary,
                               lambda _r, key=key: _UNIQUE.pop(key, None))
    return dictionary


def is_unique(dictionary) -> bool:
    """Whether a dictionary holds each value once: known by identity,
    else checked on the host (and then known)."""
    import pyarrow.compute as pc

    ref = _UNIQUE.get(id(dictionary))
    if ref is not None and ref() is dictionary:
        return True
    if len(pc.unique(dictionary)) == len(dictionary):
        mark_unique(dictionary)
        return True
    return False


def encode_strings(arr, dt: DataType):
    """(int32 codes with NULL rows at 0, dictionary) of a string-like
    Arrow array: a dictionary array keeps its own dictionary (which may
    repeat a value), any other is dictionary-encoded here. large_string
    and large_binary dictionaries narrow to utf8 and binary."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        if pa.types.is_dictionary(arr.type):
            arr = arr.unify_dictionaries()
        arr = arr.combine_chunks()
    encoded = not pa.types.is_dictionary(arr.type)
    if encoded:
        arr = pc.dictionary_encode(arr)
    dictionary = arr.dictionary.cast(string_value_type(dt))
    if encoded:
        mark_unique(dictionary)
    codes = arr.indices.fill_null(0).to_numpy(zero_copy_only=False)
    return np.ascontiguousarray(codes, dtype=np.int32), dictionary


def decode_strings(codes: np.ndarray, null: Optional[np.ndarray],
                   dictionary, dt: DataType):
    """The Arrow array of codes through their dictionary; `null` marks
    NULL rows, whose codes are not read. A column with no dictionary
    (a pruned placeholder, an all-NULL side) renders as NULLs, as the
    JAX package's `to_arrow` renders it."""
    import pyarrow as pa

    typ = string_value_type(dt)
    if dictionary is None:
        return pa.nulls(len(codes), type=typ)
    codes = np.asarray(codes, dtype=np.int32)
    if null is not None:
        codes = np.where(null, 0, codes)
    return dictionary.cast(typ).take(pa.array(codes, mask=null))


@dataclasses.dataclass
class Column:
    """One column: padded device values + optional validity."""

    dtype: DataType
    values: torch.Tensor  # physical dtype, shape value_shape(dtype, cap)
    validity: Optional[torch.Tensor] = None  # bool (capacity,) or None
    dictionary: Optional[object] = None  # pyarrow Array for utf8/binary

    @property
    def capacity(self) -> int:
        return self.values.shape[0]


@dataclasses.dataclass
class ColumnBatch:
    """Batch of padded device columns.

    `selection` is an optional device row mask: a row is live iff its
    index < num_rows AND selection[i]."""

    schema: Schema
    columns: List[Column]
    num_rows: int
    selection: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return self.columns[0].capacity

    @property
    def device(self) -> torch.device:
        if self.columns:
            return self.columns[0].values.device
        if self.selection is not None:
            return self.selection.device
        return default_device()

    def live_mask(self) -> torch.Tensor:
        m = row_mask(self.num_rows, self.capacity, self.device)
        if self.selection is not None:
            m = m & self.selection
        return m

    # ------------------------------------------------------------------
    # host boundary: pyarrow interop
    # ------------------------------------------------------------------
    @staticmethod
    def from_arrow(rb, capacity: Optional[int] = None,
                   device: Optional[torch.device] = None) -> "ColumnBatch":
        """Build from a pyarrow RecordBatch: pad to a shape bucket on
        the host, then one blocking H2D copy per buffer."""
        device = torch.device(device) if device is not None \
            else default_device()
        schema, host = host_columns(rb)
        n = rb.num_rows
        cap = capacity or get_config().bucket_for(n)
        cols: List[Column] = []
        for field, (vals, valid, d) in zip(schema, host):
            values = _h2d(_pad(vals, cap, 0), device)
            validity = None
            if valid is not None:
                # padding rows stay valid, but for the NULL type
                fill = field.dtype.id is not TypeId.NULL
                validity = _h2d(_pad(valid, cap, fill), device)
            cols.append(Column(field.dtype, values, validity, d))
        return ColumnBatch(schema, cols, n)

    @staticmethod
    def from_arrow_pruned(rb, schema: Schema, present: Sequence[int],
                          capacity: Optional[int] = None,
                          device: Optional[torch.device] = None
                          ) -> "ColumnBatch":
        """A batch with `schema`'s positions from a RecordBatch holding
        only the columns at `present` (ascending). Pruned positions get
        zero placeholders, never decoded nor copied, for columns no
        consumer reads (the JAX package's `from_arrow_pruned`)."""
        sub = ColumnBatch.from_arrow(rb, capacity, device)
        cap = sub.capacity if sub.columns else (
            capacity or get_config().bucket_for(rb.num_rows))
        dev = sub.device if sub.columns else (
            torch.device(device) if device is not None
            else default_device())
        pres = set(present)
        it = iter(sub.columns)
        cols = [next(it) if i in pres else
                Column(f.dtype, zero_values(f.dtype, cap, dev))
                for i, f in enumerate(schema)]
        return ColumnBatch(schema, cols, rb.num_rows)

    def to_arrow(self):
        """Materialize the live rows back to a pyarrow RecordBatch: the
        live prefix of every buffer in one D2H fetch
        (runtime/pack.get_packed)."""
        import pyarrow as pa

        from blaze_tpu_torch.runtime.pack import get_packed

        n = self.num_rows
        wanted = [c.values[:n] for c in self.columns]
        wanted += [c.validity[:n] for c in self.columns
                   if c.validity is not None]
        if self.selection is not None:
            wanted.append(self.selection[:n])
        host = iter(get_packed(wanted))
        values = [next(host) for _ in self.columns]
        masks = [None if c.validity is None else ~next(host)
                 for c in self.columns]
        sel = next(host) if self.selection is not None else None
        arrays = []
        fields = []
        for field, col, vals, mask in zip(self.schema, self.columns, values,
                                          masks):
            dt = field.dtype
            if sel is not None:
                vals = vals[sel]
                if mask is not None:
                    mask = mask[sel]
            if dt.is_string_like:
                arr = decode_strings(vals, mask, col.dictionary, dt)
            elif dt.is_wide_decimal:
                arr = _decimal_from_limbs(vals, mask, dt.precision, dt.scale)
            elif dt.id is TypeId.DECIMAL:
                arr = _decimal_from_unscaled_i64(
                    vals.astype(np.int64), mask, dt.precision, dt.scale)
            elif dt.id is TypeId.DATE32:
                arr = pa.array(vals.astype(np.int32), mask=mask,
                               type=pa.int32()).cast(pa.date32())
            elif dt.id is TypeId.TIMESTAMP_US:
                arr = pa.array(vals.astype(np.int64), mask=mask,
                               type=pa.int64()).cast(pa.timestamp("us"))
            elif dt.id is TypeId.NULL:
                arr = pa.nulls(len(vals))
            else:
                arr = pa.array(vals, mask=mask, type=to_arrow_type(dt))
            arrays.append(arr)
            fields.append(pa.field(field.name, arr.type, field.nullable))
        return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))

    @staticmethod
    def from_pydict(data: dict, schema: Optional[Schema] = None,
                    capacity: Optional[int] = None,
                    device: Optional[torch.device] = None
                    ) -> "ColumnBatch":
        """Test and interop helper: build from {name: list} via
        pyarrow."""
        import pyarrow as pa

        from blaze_tpu_torch.types import to_arrow_schema

        rb = pa.RecordBatch.from_pydict(
            data, schema=None if schema is None else to_arrow_schema(schema))
        return ColumnBatch.from_arrow(rb, capacity, device)

    def to_pydict(self) -> dict:
        return self.to_arrow().to_pydict()

    def slice_host(self, start: int, length: int) -> "ColumnBatch":
        """Host-side row slice (strings re-encode with a dictionary of
        the slice's own values)."""
        rb = self.to_arrow().slice(start, length)
        return ColumnBatch.from_arrow(rb, device=self.device)


@dataclasses.dataclass
class PackedColumnBatch(ColumnBatch):
    """A batch whose buffers are typed views of ONE device byte buffer,
    filled by one H2D copy (runtime/pack.put_packed); the counterpart
    of the JAX package's `PackedColumnBatch` (blaze_tpu/batch.py).

    `buf` also holds the live row count in its header, so a CUDA graph
    over the batch reads it on the device (ops/fused.py). `key` names
    the layout - capacity and each column's dtype and validity - which
    decides whether two batches can share one graph. The batch is an
    ordinary ColumnBatch to every other operator."""

    buf: Optional[torch.Tensor] = None
    key: Tuple = ()
    # schema positions of pruned columns: shared zero placeholders,
    # not in `buf` (`from_arrow_pruned`)
    placeholders: Tuple[int, ...] = ()

    @staticmethod
    def from_arrow(rb, capacity: Optional[int] = None,
                   device: Optional[torch.device] = None,
                   staging=None) -> "PackedColumnBatch":
        """Pad and pack a RecordBatch on the host and copy it to the
        device in one transfer; CUDA devices need a `pack.Staging`."""
        from blaze_tpu_torch.runtime.pack import put_packed

        device = torch.device(device) if device is not None \
            else default_device()
        schema, host = host_columns(rb)
        n = rb.num_rows
        cap = capacity or get_config().bucket_for(n)
        segments = []
        for field, (vals, valid, _) in zip(schema, host):
            segments.append((vals, 0))
            if valid is not None:
                segments.append((valid, field.dtype.id is not TypeId.NULL))
        buf, views = put_packed(segments, n, cap, device, staging)
        it = iter(views)
        cols = []
        for field, (_, valid, d) in zip(schema, host):
            values = next(it)
            cols.append(Column(field.dtype, values,
                               next(it) if valid is not None else None, d))
        return PackedColumnBatch(schema, cols, n, None, buf, _layout_key(
            cap, cols, ()))

    @staticmethod
    def from_arrow_pruned(rb, schema: Schema, present: Sequence[int],
                          capacity: Optional[int] = None,
                          device: Optional[torch.device] = None,
                          staging=None) -> "PackedColumnBatch":
        """`from_arrow` of the columns at `present` (ascending) of
        `schema`, in one copy; every other position is a shared zero
        placeholder (`placeholder_values`), never decoded nor copied,
        for a column no consumer reads (planner/colprune.py)."""
        sub = PackedColumnBatch.from_arrow(rb, capacity, device, staging)
        cap, dev = sub.capacity, sub.buf.device
        pres = set(present)
        it = iter(sub.columns)
        cols = [next(it) if i in pres else
                Column(f.dtype, placeholder_values(f.dtype, cap, dev))
                for i, f in enumerate(schema)]
        holes = tuple(i for i in range(len(schema)) if i not in pres)
        return PackedColumnBatch(schema, cols, rb.num_rows, None, sub.buf,
                                 _layout_key(cap, cols, holes), holes)


def _layout_key(cap: int, cols: List[Column], holes: Tuple[int, ...]):
    """A packed batch's layout: its capacity, each column's dtype, shape
    and validity, and the placeholder positions."""
    return (cap, tuple((str(c.values.dtype), tuple(c.values.shape[1:]),
                        c.validity is not None) for c in cols), holes)


_PLACEHOLDERS: dict = {}
_PLACEHOLDER_LOCK = threading.Lock()


def placeholder_values(dt: DataType, capacity: int,
                       device: torch.device) -> torch.Tensor:
    """Zero values of a pruned column, one tensor per (dtype, shape,
    device) shared by every batch (never written: no consumer reads a
    pruned column)."""
    key = (torch_dtype(dt), value_shape(dt, capacity), str(device))
    with _PLACEHOLDER_LOCK:
        t = _PLACEHOLDERS.get(key)
        if t is None:
            t = _PLACEHOLDERS[key] = zero_values(dt, capacity, device)
    return t


def host_columns(rb):
    """(schema, [(values, validity or None, dictionary or None)]) of a
    RecordBatch as host numpy arrays of the live rows: values in the
    physical dtype (dictionary codes for strings), NULLs filled,
    validity only for a column with NULLs (all False for the NULL
    type)."""
    import pyarrow as pa

    schema = from_arrow_schema(rb.schema)
    n = rb.num_rows
    out = []
    for i, field in enumerate(schema):
        dt = field.dtype
        arr = rb.column(i)
        if isinstance(arr, pa.ChunkedArray):
            if pa.types.is_dictionary(arr.type):
                arr = arr.unify_dictionaries()
            arr = arr.combine_chunks()
        has_nulls = arr.null_count > 0
        valid = ~np.asarray(arr.is_null()) if has_nulls else None
        dictionary = None
        if dt.is_string_like:
            np_vals, dictionary = encode_strings(arr, dt)
        elif dt.is_wide_decimal:
            np_vals = _decimal_limbs(arr)
        elif dt.id is TypeId.DECIMAL:
            np_vals = _decimal_unscaled_i64(arr)
        elif dt.id is TypeId.TIMESTAMP_US:
            np_vals = arr.cast(pa.timestamp("us")).fill_null(0) \
                .to_numpy(zero_copy_only=False).view(np.int64)
        elif dt.id is TypeId.DATE32:
            np_vals = arr.cast(pa.int32()).fill_null(0).to_numpy(
                zero_copy_only=False)
        elif dt.id is TypeId.NULL:
            np_vals = np.zeros(n, dtype=np.int8)
            valid = np.zeros(n, dtype=bool)
        else:
            if has_nulls:
                # nulls are tracked in validity; fill so pyarrow
                # does not surface ints as float64 with NaN
                arr = arr.fill_null(
                    False if dt.id is TypeId.BOOL else 0)
            np_vals = arr.to_numpy(zero_copy_only=False)
        out.append((np_vals.astype(dt.physical_dtype(), copy=False), valid,
                    dictionary))
    return schema, out


def _pad(a: np.ndarray, cap: int, fill) -> np.ndarray:
    if len(a) == cap:
        # pyarrow's zero-copy views are read-only; torch wants its own
        if a.flags.writeable and a.flags.c_contiguous:
            return a
        return np.array(a, order="C")
    out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if not a.flags.writeable:
        a = a.copy()  # a pyarrow zero-copy view: torch wants its own
    t = torch.from_numpy(a)
    if device.type == "cpu":
        return t
    dispatch.record("h2d_copies")
    return t.to(device)


def _decimal_unscaled_i64(arr) -> np.ndarray:
    """Extract decimal128 unscaled values that fit in i64 (the engine's
    decimal representation; matches the reference's i64-only decimals,
    plan.proto:598-601)."""
    buf = arr.buffers()[1]
    if buf is None:
        return np.zeros(len(arr), dtype=np.int64)
    raw = np.frombuffer(buf, dtype=np.int64)
    # decimal128 is 16 bytes little-endian; the low limb is the i64
    # value for anything within i64 range
    lo = raw[arr.offset * 2::2][: len(arr)]
    return np.ascontiguousarray(lo)


def _decimal_limbs(arr) -> np.ndarray:
    """(n, 2) little-endian int64 limbs [lo bit pattern, hi] of a
    decimal128 array: its full 16-byte representation."""
    buf = arr.buffers()[1]
    n = len(arr)
    if buf is None:
        return np.zeros((n, 2), dtype=np.int64)
    raw = np.frombuffer(buf, dtype=np.int64)
    start = arr.offset * 2
    return raw[start: start + 2 * n].reshape(n, 2).copy()


def _decimal_from_limbs(vals: np.ndarray, mask, precision: int,
                        scale: int):
    """(n, 2) [lo, hi] limbs -> Decimal128Array."""
    import pyarrow as pa

    n = len(vals)
    data = pa.py_buffer(np.ascontiguousarray(vals, dtype=np.int64).tobytes())
    validity = pa.array(~mask).buffers()[1] if mask is not None else None
    return pa.Array.from_buffers(
        pa.decimal128(precision, scale), n, [validity, data]
    )


def _decimal_from_unscaled_i64(vals: np.ndarray, mask, precision: int,
                               scale: int):
    """Inverse of _decimal_unscaled_i64: i64 unscaled -> Decimal128Array."""
    import pyarrow as pa

    n = len(vals)
    limbs = np.zeros(2 * n, dtype=np.int64)
    limbs[0::2] = vals  # low limb, little-endian
    limbs[1::2] = np.where(vals < 0, -1, 0)  # sign extension
    data = pa.py_buffer(limbs.tobytes())
    validity = pa.array(~mask).buffers()[1] if mask is not None else None
    return pa.Array.from_buffers(
        pa.decimal128(precision, scale), n, [validity, data]
    )


def empty_batch(schema: Schema, device: torch.device) -> ColumnBatch:
    cap = get_config().shape_buckets[0]
    cols = [Column(f.dtype, zero_values(f.dtype, cap, device))
            for f in schema]
    return ColumnBatch(schema, cols, 0)


def row_mask(num_rows: int, capacity: int,
             device: torch.device) -> torch.Tensor:
    """Mask of live rows for a padded batch."""
    return torch.arange(capacity, dtype=torch.int32, device=device) \
        < num_rows
