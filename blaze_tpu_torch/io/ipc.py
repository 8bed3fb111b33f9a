"""Segmented Arrow-IPC exchange format.

The JAX package's format, which is the reference's on-disk and wire
format (a bit-compatibility contract with a Spark executor):

  part     := [u64 LE length][zstd(Arrow IPC stream)]      (util/ipc.rs:20-49)
  segment  := part*                                        (per partition)
  data     := segment per partition, concatenated
  index    := (num_partitions + 1) LE i64 start offsets
              (shuffle_writer_exec.rs:437-506)

Empty batches write nothing. Readers skip zero-length parts.

zstd comes from pyarrow's codec; the port builds no host library. A
frame whose header carries its content size decompresses in one call,
any other frame as a stream. The reader also takes the JAX package's
raw frames (`BLZRAW\\x00\\x01` + the IPC stream, which a JAX process
without zstd writes, runtime/native.py:119-131); the writer only ever
writes zstd and raises where pyarrow has no zstd codec.
"""

from __future__ import annotations

import io
import struct
from typing import Iterator, List, Optional, Tuple

import pyarrow as pa

RAW_FRAME_MAGIC = b"BLZRAW\x00\x01"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _require_zstd() -> None:
    if not pa.Codec.is_available("zstd"):
        raise RuntimeError("pyarrow has no zstd codec: the shuffle "
                           "format needs zstd")


def _codec(level: Optional[int] = None) -> "pa.Codec":
    _require_zstd()
    return pa.Codec("zstd", compression_level=level)


def ipc_stream_bytes(rb: pa.RecordBatch) -> bytes:
    """One batch as an uncompressed Arrow IPC stream."""
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as writer:
        writer.write_batch(rb)
    return sink.getvalue()


def encode_ipc_segment(rb: pa.RecordBatch, level: int = 1) -> bytes:
    """One length-prefixed zstd Arrow-IPC part. Empty batch -> b''."""
    if rb.num_rows == 0:
        return b""
    frame = _codec(level).compress(ipc_stream_bytes(rb), asbytes=True)
    return struct.pack("<Q", len(frame)) + frame


def _content_size(frame: bytes) -> Optional[int]:
    """The decompressed size a zstd frame header states, else None
    (zstd format, RFC 8878 section 3.1.1.1)."""
    if len(frame) < 5 or frame[:4] != _ZSTD_MAGIC:
        return None
    fhd = frame[4]
    fcs_flag = fhd >> 6
    single = (fhd >> 5) & 1
    dict_bytes = (0, 1, 2, 4)[fhd & 3]
    fcs_bytes = (single, 2, 4, 8)[fcs_flag]
    if fcs_bytes == 0:
        return None
    pos = 5 + (0 if single else 1) + dict_bytes
    if len(frame) < pos + fcs_bytes:
        return None
    size = int.from_bytes(frame[pos:pos + fcs_bytes], "little")
    return size + 256 if fcs_bytes == 2 else size


def decompress_frame(frame: bytes) -> bytes:
    """The Arrow IPC stream inside one part's frame."""
    if frame[:8] == RAW_FRAME_MAGIC:
        return frame[8:]
    size = _content_size(frame)
    if size is not None:
        return _codec().decompress(frame, decompressed_size=size,
                                   asbytes=True)
    _require_zstd()
    return pa.input_stream(pa.py_buffer(frame), compression="zstd").read()


def _batches(raw: bytes) -> Iterator[pa.RecordBatch]:
    if not raw:
        return
    with pa.ipc.open_stream(raw) as reader:
        for rb in reader:
            if rb.num_rows > 0:
                yield rb


def decode_ipc_parts(buf: bytes) -> Iterator[pa.RecordBatch]:
    """Iterate RecordBatches out of a concatenated parts buffer."""
    pos = 0
    n = len(buf)
    while pos + 8 <= n:
        (length,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        if length == 0:
            continue
        if pos + length > n:
            raise IOError("truncated IPC part in buffer")
        frame = buf[pos: pos + length]
        pos += length
        yield from _batches(decompress_frame(frame))


def decode_ipc_stream(stream) -> Iterator[pa.RecordBatch]:
    """Decode parts from a file-like object one part at a time, so
    memory stays bounded by the largest part."""
    while True:
        hdr = stream.read(8)
        if len(hdr) < 8:
            return
        (length,) = struct.unpack("<Q", hdr)
        if length == 0:
            continue
        frame = b""
        while len(frame) < length:
            chunk = stream.read(length - len(frame))
            if not chunk:
                raise IOError("truncated IPC part in stream")
            frame += chunk
        yield from _batches(decompress_frame(frame))


def read_file_segment(path: str, offset: int, length: int
                      ) -> Iterator[pa.RecordBatch]:
    """One partition's byte range of a .data file (the reference's local
    FileSegment path, ArrowBlockStoreShuffleReader301.scala:83-123)."""
    with open(path, "rb") as f:
        f.seek(offset)
        buf = f.read(length)
    if len(buf) != length:
        raise IOError(f"{path}: {len(buf)} of {length} bytes at {offset}")
    yield from decode_ipc_parts(buf)


def read_index_file(path: str) -> List[int]:
    with open(path, "rb") as f:
        raw = f.read()
    count = len(raw) // 8
    return list(struct.unpack(f"<{count}q", raw))


def partition_ranges(index_path: str) -> List[Tuple[int, int]]:
    """(offset, length) per partition from an .index file."""
    offs = read_index_file(index_path)
    return [(offs[i], offs[i + 1] - offs[i]) for i in range(len(offs) - 1)]


def coalesce(batches: Iterator[pa.RecordBatch], rows: int
             ) -> Iterator[pa.RecordBatch]:
    """Concatenate consecutive batches of one schema while they stay
    within `rows` rows; a larger batch passes as it is."""
    pending: List[pa.RecordBatch] = []
    count = 0
    for rb in batches:
        if pending and (count + rb.num_rows > rows
                        or not rb.schema.equals(pending[0].schema)):
            yield pending[0] if len(pending) == 1 \
                else pa.concat_batches(pending)
            pending, count = [], 0
        pending.append(rb)
        count += rb.num_rows
    if pending:
        yield pending[0] if len(pending) == 1 else pa.concat_batches(pending)
