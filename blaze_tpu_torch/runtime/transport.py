"""Block transport: the network tier behind CHANNEL shuffle reads.

Reference counterpart: Spark's netty block transfer feeding the native
reader's ReadableByteChannel path (ArrowBlockStoreShuffleReader301.scala:
83-123 recovers local FileSegments for zero-copy reads and hands REMOTE
blocks over as streams; ipc_reader_exec.rs:283-326 wraps the channel).
Here: every worker runs a BlockServer over TCP serving byte ranges of
files under its local data roots; reduce tasks on other hosts stream
remote segments through `open_remote_stream`, which presents a file-like
object the existing segmented-IPC channel decoder consumes unchanged.
The JAX package's module (blaze_tpu/runtime/transport.py), with its
scatter-gather send (`sendmsg_all`, the serving tier's arena FETCH).

Framing (one request per connection, like a shuffle block fetch):
  request:  u32 path_len | path utf8 | i64 offset | i64 length
  response: u8 status (0 ok) | i64 payload_len | payload bytes
"""

from __future__ import annotations

import dataclasses
import io
import os
import socket
import socketserver
import struct
import threading
from typing import Sequence


_REQ_HEAD = struct.Struct("<I")
_REQ_RANGE = struct.Struct("<qq")
_RESP_HEAD = struct.Struct("<Bq")

MAX_PATH = 4096


@dataclasses.dataclass(frozen=True)
class RemoteSegment:
    """A shuffle block living on another host's BlockServer."""

    host: str
    port: int
    path: str
    offset: int
    length: int


_CHUNK = 1 << 20


class BlockProtocolError(IOError):
    """Server answered with an error status - deterministic (bad path,
    scoping violation), so callers must NOT retry it."""


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        server: BlockServer = self.server.block_server  # type: ignore
        try:
            head = _recv_exact(self.request, _REQ_HEAD.size)
            (path_len,) = _REQ_HEAD.unpack(head)
            if path_len > MAX_PATH:
                raise ValueError("path too long")
            path = _recv_exact(self.request, path_len).decode("utf-8")
            offset, length = _REQ_RANGE.unpack(
                _recv_exact(self.request, _REQ_RANGE.size)
            )
            if offset < 0:  # stat request: size in the length field,
                # no payload (offset is never negative for reads)
                size = server.stat(path)
                self.request.sendall(_RESP_HEAD.pack(0, size))
                return
            f, total = server.open_range(path, offset, length)
        except Exception:
            try:
                self.request.sendall(_RESP_HEAD.pack(1, 0))
            except OSError:
                pass
            return
        # stream straight off the file in bounded chunks: O(chunk)
        # memory per connection regardless of block size
        with f:
            self.request.sendall(_RESP_HEAD.pack(0, total))
            left = total
            while left:
                chunk = f.read(min(left, _CHUNK))
                if not chunk:
                    break  # truncated on disk; client sees short stream
                self.request.sendall(chunk)
                left -= len(chunk)


class BlockServer:
    """Serves byte ranges of files under the registered roots (a
    worker's local shuffle/data directories - nothing else is readable,
    mirroring the block-manager's scoping), on loopback: every reader
    shares this machine."""

    def __init__(self, roots: Sequence[str]):
        self.roots = [os.path.realpath(r) for r in roots]
        self._srv = socketserver.ThreadingTCPServer(
            ("127.0.0.1", 0), _Handler, bind_and_activate=True
        )
        self._srv.daemon_threads = True
        self._srv.block_server = self  # type: ignore[attr-defined]
        # stop() returns within the accept loop's poll (socketserver's
        # default, 0.5 s, is what every stop would otherwise wait)
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True,
            kwargs={"poll_interval": 0.05},
        )

    @property
    def address(self):
        return self._srv.server_address  # (host, port)

    def start(self) -> "BlockServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    def open_range(self, path: str, offset: int, length: int):
        """(open file positioned at offset, byte count) for a scoped
        range; length < 0 means to end-of-file."""
        real = os.path.realpath(path)
        if not any(
            real == r or real.startswith(r + os.sep) for r in self.roots
        ):
            raise PermissionError(f"{path} outside served roots")
        size = os.path.getsize(real)
        if length < 0:
            length = max(size - offset, 0)
        length = min(length, max(size - offset, 0))
        f = open(real, "rb")
        f.seek(offset)
        return f, length

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        f, total = self.open_range(path, offset, length)
        with f:
            return f.read(total)

    def stat(self, path: str) -> int:
        real = os.path.realpath(path)
        if not any(
            real == r or real.startswith(r + os.sep) for r in self.roots
        ):
            raise PermissionError(f"{path} outside served roots")
        return os.path.getsize(real)


class _SocketStream(io.RawIOBase):
    """File-like over the response payload; feeds decode_ipc_stream the
    way the reference wraps a ReadableByteChannel in Read."""

    def __init__(self, sock: socket.socket, remaining: int):
        self._sock = sock
        self._remaining = remaining

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        if self._remaining == 0:
            return b""
        if n is None or n < 0:
            n = self._remaining
        n = min(n, self._remaining)
        chunks = []
        while n:
            b = self._sock.recv(min(n, 1 << 20))
            if not b:
                raise ConnectionError("block stream truncated")
            chunks.append(b)
            n -= len(b)
            self._remaining -= len(b)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self._sock.close()
        finally:
            super().close()


def open_remote_stream(seg: RemoteSegment,
                       timeout: float = 60.0) -> _SocketStream:
    """Fetch one remote block as a stream (the CHANNEL read path)."""
    sock = socket.create_connection((seg.host, seg.port), timeout=timeout)
    try:
        p = seg.path.encode("utf-8")
        sock.sendall(
            _REQ_HEAD.pack(len(p)) + p
            + _REQ_RANGE.pack(seg.offset, seg.length)
        )
        head = _recv_exact(sock, _RESP_HEAD.size)
        status, length = _RESP_HEAD.unpack(head)
        if status != 0:
            raise BlockProtocolError(
                f"block fetch failed: {seg.path}@{seg.offset}"
            )
        return _SocketStream(sock, length)
    except Exception:
        sock.close()
        raise


def remote_stat(host: str, port: int, path: str,
                timeout: float = 60.0) -> int:
    """File size over the block protocol (offset=-1 stat request)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        p = path.encode("utf-8")
        sock.sendall(_REQ_HEAD.pack(len(p)) + p + _REQ_RANGE.pack(-1, 0))
        status, size = _RESP_HEAD.unpack(
            _recv_exact(sock, _RESP_HEAD.size)
        )
        if status != 0:
            raise BlockProtocolError(f"stat failed: {path}")
        return size
    finally:
        sock.close()


def iter_remote_batches(seg: RemoteSegment):
    """Stream one remote block's Arrow RecordBatches, closing the socket
    even when the consumer stops early - the single fetch loop shared by
    every remote-read call site."""
    from blaze_tpu_torch.io.ipc import decode_ipc_stream

    stream = open_remote_stream(seg)
    try:
        yield from decode_ipc_stream(stream)
    finally:
        stream.close()


def _recv_exact(sock, n: int) -> bytes:
    # recv_into a preallocated buffer: large frames (multi-MB result
    # parts) would otherwise pay O(n^2) bytes-concat churn
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("socket closed mid-frame")
        got += k
    return bytes(buf)


# sendmsg iovec bound: Linux caps a single sendmsg at IOV_MAX (1024)
# buffers; stay comfortably under it
_IOV_CHUNK = 512


def sendmsg_all(sock, buffers) -> int:
    """Scatter-gather send: write a buffer list (bytes / memoryview,
    e.g. the arena's mmap-backed frame views) without concatenating a
    reply - the writev-style half of the zero-copy serve path
    (service/wire.py's FETCH of arena parts). Handles partial sends and
    IOV_MAX chunking; falls back to sendall when the socket has no
    sendmsg. Returns bytes sent."""
    views = [memoryview(b) for b in buffers if len(b)]
    sendmsg = getattr(sock, "sendmsg", None)
    total = 0
    if sendmsg is None:
        for v in views:
            sock.sendall(v)
            total += len(v)
        return total
    while views:
        try:
            sent = sendmsg(views[:_IOV_CHUNK])
        except InterruptedError:
            continue
        total += sent
        while sent and views:
            head = views[0]
            if sent >= len(head):
                sent -= len(head)
                views.pop(0)
            else:
                views[0] = head[sent:]
                sent = 0
    return total
