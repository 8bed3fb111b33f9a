"""Arrow-aligned logical type system.

Covers the reference's supported type surface (Spark<->Arrow map,
spark-extension NativeConverters.scala:117-213 and plan-serde arrow type
messages plan.proto): null, bool, int8/16/32/64, float32/64, utf8, binary,
date32, timestamp (microseconds), decimal(precision, scale).

Device representation (TPU-first, ragged-free):
- fixed-width types map 1:1 to a device array of the physical dtype
- utf8/binary are dictionary-encoded: an int32 code array on device plus a
  host-side dictionary (the reference instead streams raw Arrow string
  buffers; TPUs have no string compute, so we normalize early - SURVEY 7)
- date32 is int32 days, timestamp is int64 microseconds
- decimal(p, s) is an int64 unscaled value (the reference constrains decimals
  to i64 the same way: plan.proto:598-601 "only use i64 for blaze")
- validity is a separate bool device array (None == all valid)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

import numpy as np


class TypeId(enum.Enum):
    NULL = "null"
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    UTF8 = "utf8"
    BINARY = "binary"
    DATE32 = "date32"
    TIMESTAMP_US = "timestamp_us"
    DECIMAL = "decimal"


@dataclasses.dataclass(frozen=True)
class DataType:
    id: TypeId
    # Only meaningful for DECIMAL.
    precision: int = 0
    scale: int = 0

    # ---- constructors ----
    @staticmethod
    def null() -> "DataType":
        return DataType(TypeId.NULL)

    @staticmethod
    def bool_() -> "DataType":
        return DataType(TypeId.BOOL)

    @staticmethod
    def int8() -> "DataType":
        return DataType(TypeId.INT8)

    @staticmethod
    def int16() -> "DataType":
        return DataType(TypeId.INT16)

    @staticmethod
    def int32() -> "DataType":
        return DataType(TypeId.INT32)

    @staticmethod
    def int64() -> "DataType":
        return DataType(TypeId.INT64)

    @staticmethod
    def float32() -> "DataType":
        return DataType(TypeId.FLOAT32)

    @staticmethod
    def float64() -> "DataType":
        return DataType(TypeId.FLOAT64)

    @staticmethod
    def utf8() -> "DataType":
        return DataType(TypeId.UTF8)

    @staticmethod
    def binary() -> "DataType":
        return DataType(TypeId.BINARY)

    @staticmethod
    def date32() -> "DataType":
        return DataType(TypeId.DATE32)

    @staticmethod
    def timestamp_us() -> "DataType":
        return DataType(TypeId.TIMESTAMP_US)

    @staticmethod
    def decimal(precision: int, scale: int) -> "DataType":
        return DataType(TypeId.DECIMAL, precision, scale)

    # ---- classification ----
    @property
    def is_numeric(self) -> bool:
        return self.id in _NUMERIC

    @property
    def is_integer(self) -> bool:
        return self.id in _INTEGER

    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)

    @property
    def is_string_like(self) -> bool:
        return self.id in (TypeId.UTF8, TypeId.BINARY)

    @property
    def is_dictionary_encoded(self) -> bool:
        """True when the device representation is int32 codes + host dict."""
        return self.is_string_like

    @property
    def is_wide_decimal(self) -> bool:
        """DECIMAL whose unscaled values exceed i64 (precision > 18):
        the device representation is a (capacity, 2) int64 array of
        little-endian limbs [lo64-bit-pattern, hi64] (the reference's
        16-byte decimal shuffle slot, shuffle_writer_exec.rs:196-220).
        Wide columns pass through scans/aggregates exactly; value
        compute on them is host-tier work."""
        return self.id is TypeId.DECIMAL and self.precision > 18

    def physical_dtype(self) -> np.dtype:
        """numpy dtype of the on-device value array."""
        return np.dtype(_PHYSICAL[self.id])

    def __repr__(self) -> str:
        if self.id is TypeId.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        return self.id.value


_NUMERIC = {
    TypeId.INT8,
    TypeId.INT16,
    TypeId.INT32,
    TypeId.INT64,
    TypeId.FLOAT32,
    TypeId.FLOAT64,
    TypeId.DECIMAL,
}
_INTEGER = {TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64}

_PHYSICAL = {
    TypeId.NULL: np.int8,
    TypeId.BOOL: np.bool_,
    TypeId.INT8: np.int8,
    TypeId.INT16: np.int16,
    TypeId.INT32: np.int32,
    TypeId.INT64: np.int64,
    TypeId.FLOAT32: np.float32,
    TypeId.FLOAT64: np.float64,
    TypeId.UTF8: np.int32,  # dictionary codes
    TypeId.BINARY: np.int32,  # dictionary codes
    TypeId.DATE32: np.int32,
    TypeId.TIMESTAMP_US: np.int64,
    TypeId.DECIMAL: np.int64,  # unscaled value
}


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def with_name(self, name: str) -> "Field":
        return Field(name, self.dtype, self.nullable)


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __init__(self, fields: Sequence[Field]):
        object.__setattr__(self, "fields", tuple(fields))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"no field named {name!r} in {self.names()}")

    def field(self, name_or_index) -> Field:
        if isinstance(name_or_index, int):
            return self.fields[name_or_index]
        return self.fields[self.index_of(name_or_index)]

    def rename(self, names: Sequence[str]) -> "Schema":
        """Positional rename (reference RenameColumnsExec semantics,
        rename_columns_exec.rs:38-75)."""
        if len(names) != len(self.fields):
            raise ValueError("rename arity mismatch")
        return Schema([f.with_name(n) for f, n in zip(self.fields, names)])

    def select(self, indices: Sequence[int]) -> "Schema":
        return Schema([self.fields[i] for i in indices])


# ---------------------------------------------------------------------------
# pyarrow interop (host boundary only; never imported inside jitted code)
# ---------------------------------------------------------------------------

def to_arrow_type(dt: DataType):
    import pyarrow as pa

    m = {
        TypeId.NULL: pa.null(),
        TypeId.BOOL: pa.bool_(),
        TypeId.INT8: pa.int8(),
        TypeId.INT16: pa.int16(),
        TypeId.INT32: pa.int32(),
        TypeId.INT64: pa.int64(),
        TypeId.FLOAT32: pa.float32(),
        TypeId.FLOAT64: pa.float64(),
        TypeId.UTF8: pa.utf8(),
        TypeId.BINARY: pa.binary(),
        TypeId.DATE32: pa.date32(),
        TypeId.TIMESTAMP_US: pa.timestamp("us"),
    }
    if dt.id is TypeId.DECIMAL:
        return __import__("pyarrow").decimal128(dt.precision, dt.scale)
    return m[dt.id]


def from_arrow_type(at) -> DataType:
    import pyarrow as pa
    import pyarrow.types as pat

    if pat.is_dictionary(at):
        return from_arrow_type(at.value_type)
    if pat.is_null(at):
        return DataType.null()
    if pat.is_boolean(at):
        return DataType.bool_()
    if pat.is_int8(at):
        return DataType.int8()
    if pat.is_int16(at):
        return DataType.int16()
    if pat.is_int32(at):
        return DataType.int32()
    if pat.is_int64(at):
        return DataType.int64()
    if pat.is_float32(at):
        return DataType.float32()
    if pat.is_float64(at):
        return DataType.float64()
    if pat.is_string(at) or pat.is_large_string(at):
        return DataType.utf8()
    if pat.is_binary(at) or pat.is_large_binary(at):
        return DataType.binary()
    if pat.is_date32(at):
        return DataType.date32()
    if pat.is_timestamp(at):
        return DataType.timestamp_us()
    if pat.is_decimal(at):
        return DataType.decimal(at.precision, at.scale)
    raise NotImplementedError(f"unsupported arrow type {at}")


def to_arrow_schema(schema: Schema):
    import pyarrow as pa

    return pa.schema(
        [pa.field(f.name, to_arrow_type(f.dtype), f.nullable) for f in schema]
    )


def from_arrow_schema(aschema) -> Schema:
    return Schema(
        [Field(f.name, from_arrow_type(f.type), f.nullable) for f in aschema]
    )
