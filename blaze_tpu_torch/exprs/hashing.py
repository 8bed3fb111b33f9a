"""Spark-compatible Murmur3 (x86_32, seed 42) hashing of fixed-width
columns.

A bit-compatibility contract: shuffle partitioning must send a key to
the reducer a Spark executor would (the reference's spark_hash.rs:27-87,
against Spark's `Murmur3_x86_32.hashInt/hashLong`; seed 42, NULL columns
leave the running hash unchanged, the hash chains left to right across
the key columns).

Two implementations of the same function:

- torch (`hash_column_device`, `hash_columns_device`, `pmod`): the
  plain version behind kernel K4 (ops/kernels/murmur3.py), which the
  CPU tests run and `chip_smoke.py` holds the kernel against. torch has
  no full uint32 arithmetic and its `>>` on int32 is arithmetic, so the
  uint32 words live in int64 in [0, 2^32), masked after every step.
- numpy (`_np_*`, `hash_int_host`, `hash_long_host`, `hash_bytes_host`):
  the host twins, the port's own oracle.

Strings and binary hash on the host, from their real bytes
(`hash_rows_host`, the JAX package's function of that name): Spark's
`hashUnsafeBytes` of each row's UTF-8 bytes, through the C++ chain of
runtime/native.py; `hash_bytes_host` is its pure-Python plain version.

Per type, as Spark does it: bool, int8, int16, int32 and date32 hash as
`hashInt` of the sign-extended int; int64, timestamp_us and decimal(<=18)
(the unscaled value) as `hashLong`; float32 as `hashInt(floatToIntBits)`
and float64 as `hashLong(doubleToLongBits)`, with -0.0 hashed as 0.0 and
every NaN as Java's canonical NaN (0x7fc00000, 0x7ff8000000000000).
Subnormals hash by their own bits. (The JAX package's device hash takes
a float32 NaN's raw bits and flushes subnormals to zero; the port
follows Spark here: ROADMAP section 3.)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.types import DataType, TypeId

SPARK_SEED = 42

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M5 = 0xE6546B64
_FX1 = 0x85EBCA6B
_FX2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF
#: Java's canonical NaN bit patterns (floatToIntBits, doubleToLongBits)
F32_NAN_BITS = 0x7FC00000
F64_NAN_BITS = 0x7FF8000000000000

_INT_WORD = (TypeId.BOOL, TypeId.INT8, TypeId.INT16, TypeId.INT32,
             TypeId.DATE32)
_LONG_WORD = (TypeId.INT64, TypeId.TIMESTAMP_US, TypeId.DECIMAL)


def device_hash_supported(dtype: DataType) -> bool:
    """Whether the port hashes this type (on either device, exactly):
    every fixed-width type; not strings, binary or decimal(>18)."""
    if dtype.is_string_like or dtype.is_wide_decimal:
        return False
    return dtype.id in _INT_WORD + _LONG_WORD + (TypeId.FLOAT32,
                                                 TypeId.FLOAT64)


def check_hashable(dtype: DataType) -> None:
    """Raise NotImplementedError for a key type the port cannot hash."""
    if dtype.is_string_like:
        raise NotImplementedError(
            f"murmur3 of {dtype} keys runs on the host (hash_rows_host), "
            "not on the device")
    if dtype.is_wide_decimal:
        # the JAX package hashes no decimal(>18) key, on the device
        # (device_hash_supported) or the host (the shuffle's host hash)
        raise NotImplementedError(
            f"hash of {dtype}: decimal(>18) keys are not hashed")
    if not device_hash_supported(dtype):
        raise NotImplementedError(f"murmur3 of {dtype} keys")


# ---------------------------------------------------------------------------
# torch: uint32 words held in int64 [0, 2^32)
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32): split `c` in 16-bit
    halves so no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (_mul32(h1, 5) + _M5) & _M32


def _fmix(h1: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, _FX1)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, _FX2)
    return h1 ^ (h1 >> 16)


def hash_int32(u: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashInt: `u` the int's uint32 bits, `seed` the running hash."""
    return _fmix(_mix_h1(seed, _mix_k1(u)), 4)


def hash_int64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashLong of int64 `v`: the low word, then the high word."""
    h1 = _mix_h1(seed, _mix_k1(v & _M32))
    h1 = _mix_h1(h1, _mix_k1((v >> 32) & _M32))
    return _fmix(h1, 8)


def _float_bits(values: torch.Tensor) -> torch.Tensor:
    """Java's floatToIntBits / doubleToLongBits as int64, after Spark's
    -0.0 -> 0.0: the bits of a float32 as a word in [0, 2^32), of a
    float64 as the signed 64-bit pattern."""
    if values.dtype == torch.float32:
        bits = values.view(torch.int32).to(torch.int64) & _M32
        nan = F32_NAN_BITS
    else:
        bits = values.view(torch.int64)
        nan = F64_NAN_BITS
    bits = torch.where(values == 0, torch.zeros_like(bits), bits)
    return torch.where(torch.isnan(values), torch.full_like(bits, nan), bits)


def hash_column_device(values: torch.Tensor,
                       validity: Optional[torch.Tensor],
                       dtype: DataType, seed: torch.Tensor) -> torch.Tensor:
    """Chain one column into the running per-row hash (int64 words)."""
    check_hashable(dtype)
    tid = dtype.id
    if tid in _INT_WORD:
        # bool is 0 or 1; the narrow ints sign-extend to int32
        h = hash_int32(values.to(torch.int64) & _M32, seed)
    elif tid in _LONG_WORD:
        h = hash_int64(values.to(torch.int64), seed)
    elif tid is TypeId.FLOAT32:
        h = hash_int32(_float_bits(values), seed)
    else:
        h = hash_int64(_float_bits(values.to(torch.float64)), seed)
    if validity is not None:
        h = torch.where(validity, h, seed)  # NULL leaves the hash as it was
    return h


def hash_columns_device(
    cols: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor], DataType]],
    capacity: int,
) -> torch.Tensor:
    """Spark's multi-column hash per row as int32 (the signed view of
    the uint32 hash)."""
    dev = cols[0][0].device
    h = torch.full((capacity,), SPARK_SEED, dtype=torch.int64, device=dev)
    for values, validity, dtype in cols:
        h = hash_column_device(values, validity, dtype, h)
    return (h - ((h >> 31) << 32)).to(torch.int32)


def pmod(hash_i32: torch.Tensor, n: int) -> torch.Tensor:
    """Spark's non-negative modulo (Java's `%` truncates; a negative
    remainder gets n added). For n > 0 that is the floor modulo, which
    torch's `%` computes."""
    return (hash_i32.to(torch.int64) % n).to(torch.int32)


# ---------------------------------------------------------------------------
# numpy host twins
# ---------------------------------------------------------------------------

def _np_rotl32(x, r: int):
    x = np.uint32(x) if np.isscalar(x) else x
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _np_mix_k1(k1):
    with np.errstate(over="ignore"):
        k1 = k1 * np.uint32(_C1)
        k1 = _np_rotl32(k1, 15)
        return k1 * np.uint32(_C2)


def _np_mix_h1(h1, k1):
    with np.errstate(over="ignore"):
        h1 = _np_rotl32(h1 ^ k1, 13)
        return h1 * np.uint32(5) + np.uint32(_M5)


def _np_fmix(h1, length: int):
    with np.errstate(over="ignore"):
        h1 = h1 ^ np.uint32(length)
        h1 ^= h1 >> np.uint32(16)
        h1 = h1 * np.uint32(_FX1)
        h1 ^= h1 >> np.uint32(13)
        h1 = h1 * np.uint32(_FX2)
        h1 ^= h1 >> np.uint32(16)
    return h1


def _np_hash_int(v: np.ndarray, seed) -> np.ndarray:
    """hashInt of uint32 words `v` (vectorised), running hash `seed`."""
    return _np_fmix(_np_mix_h1(np.asarray(seed, np.uint32),
                               _np_mix_k1(v.astype(np.uint32))), 4)


def _np_hash_long(v: np.ndarray, seed) -> np.ndarray:
    """hashLong of int64 `v` (vectorised), running hash `seed`."""
    u = np.asarray(v, np.int64).view(np.uint64)
    low = (u & np.uint64(_M32)).astype(np.uint32)
    high = (u >> np.uint64(32)).astype(np.uint32)
    h1 = _np_mix_h1(np.asarray(seed, np.uint32), _np_mix_k1(low))
    h1 = _np_mix_h1(h1, _np_mix_k1(high))
    return _np_fmix(h1, 8)


def hash_int_host(v: int, seed: int = SPARK_SEED) -> int:
    """Spark Murmur3_x86_32.hashInt of one int, as a uint32."""
    return int(_np_hash_int(np.array([v], np.int64).astype(np.uint32),
                            np.uint32(seed))[0])


def hash_long_host(v: int, seed: int = SPARK_SEED) -> int:
    """Spark Murmur3_x86_32.hashLong of one long, as a uint32."""
    return int(_np_hash_long(np.array([v], np.int64), np.uint32(seed))[0])


def hash_bytes_host(data: bytes, seed: int = SPARK_SEED) -> int:
    """Spark Murmur3_x86_32.hashUnsafeBytes of one byte string: whole
    4-byte words, then each tail byte sign-extended through the full
    mixK1/mixH1 pipeline (unlike standard murmur3 tails)."""
    h1 = np.uint32(seed)
    n = len(data)
    aligned = n - n % 4
    for i in range(0, aligned, 4):
        word = np.uint32(int.from_bytes(data[i:i + 4], "little"))
        h1 = _np_mix_h1(h1, _np_mix_k1(word))
    for b in data[aligned:]:
        sb = b - 256 if b >= 128 else b  # a Java byte
        h1 = _np_mix_h1(h1, _np_mix_k1(np.uint32(sb & _M32)))
    return int(_np_fmix(h1, n))


def hash_strings_py(values, seeds: np.ndarray) -> np.ndarray:
    """The plain version of the C++ string chain: each non-NULL value
    (str as UTF-8, or bytes) hashed with its row's running seed."""
    out = np.asarray(seeds, np.uint32).copy()
    for i, v in enumerate(values):
        if v is None:
            continue
        b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        out[i] = hash_bytes_host(b, int(out[i]))
    return out


def _np_link(values: np.ndarray, dtype: DataType, h: np.ndarray
             ) -> np.ndarray:
    """One fixed-width column chained into the uint32 hashes `h`, with
    Spark's rules (the numpy twin of `hash_column_device`)."""
    tid = dtype.id
    if tid in _INT_WORD:
        return _np_hash_int(values.astype(np.int32).view(np.uint32), h)
    if tid in _LONG_WORD:
        return _np_hash_long(values.astype(np.int64), h)
    if tid is TypeId.FLOAT32:
        v = values.astype(np.float32)
        bits = np.where(v == 0, np.float32(0), v).view(np.uint32)
        bits = np.where(np.isnan(v), np.uint32(F32_NAN_BITS), bits)
        return _np_hash_int(bits, h)
    if tid is TypeId.FLOAT64:
        v = values.astype(np.float64)
        bits = np.where(v == 0, 0.0, v).view(np.int64)
        bits = np.where(np.isnan(v), np.int64(F64_NAN_BITS), bits)
        return _np_hash_long(bits, h)
    check_hashable(dtype)
    raise NotImplementedError(f"host hash of {dtype}")


def hash_rows_host(columns, num_rows: int) -> np.ndarray:
    """Spark's multi-column hash per row on the host, as int32.

    `columns` is a list of (numpy values, numpy validity or None,
    DataType, dictionary or None), the host mirror of a batch's key
    columns: strings and binary are int32 codes into a pyarrow
    dictionary and hash from the dictionary's real bytes (the C++
    chain); every other type hashes as on the device, with Spark's float
    rules (-0.0 as 0.0, one canonical NaN)."""
    from blaze_tpu_torch.runtime import native

    h = np.full(num_rows, SPARK_SEED, dtype=np.uint32)
    for values, validity, dtype, dictionary in columns:
        valid = None if validity is None \
            else np.asarray(validity[:num_rows], dtype=bool)
        if dtype.is_string_like:
            if dictionary is None:
                if valid is not None and not valid.any():
                    continue  # an all-NULL column keeps every seed
                raise ValueError("a string key column has no dictionary")
            link = native.murmur3_dict_strings_chain(
                dictionary, values[:num_rows], valid, h.copy())
        else:
            link = _np_link(np.asarray(values[:num_rows]), dtype, h)
            if valid is not None:
                link = np.where(valid, link, h)
        h = link.astype(np.uint32)
    return h.view(np.int32)


def hash_arrays_host(arrays, dtypes) -> np.ndarray:
    """Spark's hash (`hash(a, b, ...)`, seed 42) of pyarrow arrays, one
    per argument, as int32: the host evaluator's arm for arguments that
    include strings."""
    import pyarrow as pa

    from blaze_tpu_torch.batch import encode_strings, host_columns

    n = len(arrays[0]) if arrays else 0
    cols = []
    for arr, dt in zip(arrays, dtypes):
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        valid = np.asarray(arr.is_valid()) if arr.null_count else None
        if dt.is_string_like:
            codes, d = encode_strings(arr, dt)
            cols.append((codes, valid, dt, d))
        else:
            _, [(vals, _v, _d)] = host_columns(
                pa.RecordBatch.from_arrays([arr], names=["x"]))
            cols.append((vals, valid, dt, None))
    return hash_rows_host(cols, n)
