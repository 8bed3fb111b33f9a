"""The host string hash chains, in C++ (csrc/strings_host.cpp).

The port's counterpart of the JAX package's runtime/native.py string
chains (`murmur3_strings_chain`, `murmur3_dict_strings_chain`): Spark's
murmur3 of each row's UTF-8 (or binary) bytes, chained into running
per-row hashes. The library builds with g++ at first use into
`build/blaze_tpu_torch/` at the root of the checkout (the file name
carries a hash of the source and the flags, so an edit rebuilds it) and
loads with ctypes. A failed build raises: there is no quiet switch to
the pure-Python chain (`exprs/hashing.hash_bytes_host`), which is the
plain version the tests hold this one against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from blaze_tpu_torch.ops.kernels._build import BUILD_DIR, CSRC

SOURCE = CSRC / "strings_host.cpp"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path():
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libstrings_host-{digest}.so"


def load() -> ctypes.CDLL:
    """The loaded chain library, built on first use. Raises
    RuntimeError with the compiler's output when g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed for {SOURCE.name}:\n{proc.stdout}"
                    f"{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.blz_murmur3_strings_chain.argtypes = [
            u8p, i32p, u8p, ctypes.c_int64, u32p]
        lib.blz_murmur3_strings_chain.restype = None
        lib.blz_murmur3_dict_strings_chain.argtypes = [
            u8p, i32p, ctypes.c_int64, i32p, u8p, ctypes.c_int64, u32p]
        lib.blz_murmur3_dict_strings_chain.restype = ctypes.c_int64
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _string_buffers(arr):
    """(data uint8, int32 offsets of n + 1 entries) of a string or
    binary array, re-materialized at offset 0 with 32-bit offsets."""
    import pyarrow as pa

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.dictionary_decode()
    if pa.types.is_large_string(arr.type):
        arr = arr.cast(pa.string())
    elif pa.types.is_large_binary(arr.type):
        arr = arr.cast(pa.binary())
    if arr.offset != 0:
        arr = pa.concat_arrays([arr])
    bufs = arr.buffers()
    n = len(arr)
    offsets = np.ascontiguousarray(
        np.frombuffer(bufs[1], dtype=np.int32)[: n + 1]) if n else \
        np.zeros(1, dtype=np.int32)
    data = np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] is not None \
        and len(bufs[2]) else np.zeros(1, dtype=np.uint8)
    return np.ascontiguousarray(data), offsets, arr


def _valid_u8(validity) -> Optional[np.ndarray]:
    if validity is None:
        return None
    return np.ascontiguousarray(validity, dtype=np.uint8)


def murmur3_strings_chain(arr, hashes: np.ndarray) -> np.ndarray:
    """Chain a pyarrow string or binary array into the running uint32
    hashes (in place, returned). NULL rows keep their hash."""
    lib = load()
    data, offsets, arr = _string_buffers(arr)
    n = len(arr)
    assert hashes.dtype == np.uint32 and len(hashes) == n
    valid = _valid_u8(np.asarray(arr.is_valid())) \
        if arr.null_count else None
    lib.blz_murmur3_strings_chain(
        _ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int32),
        None if valid is None else _ptr(valid, ctypes.c_uint8), n,
        _ptr(hashes, ctypes.c_uint32))
    return hashes


def murmur3_dict_strings_chain(dictionary, codes: np.ndarray,
                               validity: Optional[np.ndarray],
                               hashes: np.ndarray) -> np.ndarray:
    """Chain a dictionary-encoded column (int32 codes into a pyarrow
    dictionary) into the running uint32 hashes (in place, returned).
    A valid row's code outside the dictionary raises ValueError."""
    lib = load()
    data, offsets, d = _string_buffers(dictionary)
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    n = len(codes)
    assert hashes.dtype == np.uint32 and len(hashes) == n
    valid = _valid_u8(validity)
    bad = lib.blz_murmur3_dict_strings_chain(
        _ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int32), len(d),
        _ptr(codes, ctypes.c_int32),
        None if valid is None else _ptr(valid, ctypes.c_uint8), n,
        _ptr(hashes, ctypes.c_uint32))
    if bad:
        raise ValueError(f"{bad} valid rows carry codes outside a "
                         f"dictionary of {len(d)} entries")
    return hashes
