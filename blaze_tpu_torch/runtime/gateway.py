"""Task gateway: the engine's cross-language entry point over a socket.

The reference's defining boundary is JNI + Arrow C-Data with a batch
handshake (exec.rs:118-255 decodes a TaskDefinition from the JVM and
pumps batches back; JniBridge.java:33-36). The socket gateway speaks the
same two currencies out of process: TaskDefinition protobuf in,
segmented Arrow-IPC parts out (the u64-LE length + zstd Arrow-IPC
framing of io/ipc.py - also the shuffle wire format, so any client that
reads shuffle files can read this). `cpp/blaze_client.cpp` is the client
of both packages' gateways: the wire is the JAX package's
(blaze_tpu/runtime/gateway.py), byte for byte.

Framing:
  request:  u64-LE header | [manifest] | TaskDefinition protobuf bytes
            header low 61 bits = blob_len; bit 63 set = the blob is in
            the REFERENCE wire format (plan/refcompat.py decodes it -
            the reference's own plan.proto:508-513 TaskDefinition);
            bit 62 set = a resource manifest precedes the blob:
            u32-LE json_len | JSON {resource_id: [[source...] per
            partition]}, source = {"file": p, "offset": o, "length": l}
            (shuffle FileSegment) or {"b64": "..."} (raw IPC part
            bytes) - the socket-tier analog of the reference's JVM
            resource registry (JniBridge.java:31);
            bit 61 set = the connection speaks the multi-query SERVICE
            protocol (service/wire.py verbs: submit / poll / fetch /
            cancel / ... over one connection) - requires a
            QueryService attached (`python -m blaze_tpu_torch serve`);
            without one the connection gets the error frame.
  response: per batch, one segmented-IPC part (u64-LE part_len | zstd
            Arrow IPC stream)
            then u64-LE 0 (end of stream)
            on error: u64-LE 0xFFFFFFFFFFFFFFFF | u32-LE msg_len | utf8

Each connection runs on a thread of its own (a ThreadingTCPServer: the
JAX package's "threaded" wire, the one plane the port has until the
event-loop wire, service/wire_async.py, lands), its task on the
server's device ("cuda" unless the server is made for the CPU);
connections at once share the card as the scheduler's map threads do.
A service connection runs its queries on the attached service's
device. A client that hangs up mid-stream cancels
its task: the task's iterator is closed and nothing is reported as a
failure.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import socketserver
import struct
import threading
from typing import Optional

from blaze_tpu_torch.runtime.transport import _recv_exact

log = logging.getLogger("blaze_tpu_torch.gateway")

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_ERR = 0xFFFFFFFFFFFFFFFF
_FLAG_REF = 1 << 63
_FLAG_MANIFEST = 1 << 62
# connection-mode switch: a first header with this bit set speaks the
# multi-query service protocol (service/wire.py) instead of the legacy
# one-shot task exchange
_FLAG_SERVICE = 1 << 61
MAX_TASK_BYTES = 64 << 20
NO_SERVICE = "no query service attached"
# accept-loop shutdown poll: stop() returns within this (socketserver's
# default, 0.5 s, is what every stop would otherwise wait)
_POLL_S = 0.05


def _manifest_resources(manifest: dict):
    """Decode a JSON resource manifest into ExecContext providers."""
    from blaze_tpu_torch.ops.ipc_reader import FileSegment

    def src(d):
        if "file" in d:
            return FileSegment(
                d["file"], int(d.get("offset", 0)), int(d["length"]))
        if "b64" in d:
            return base64.b64decode(d["b64"])
        raise ValueError(f"unknown manifest source {sorted(d)}")

    return {
        rid: [[src(s) for s in part] for part in parts]
        for rid, parts in manifest.items()
    }


def _send_error(sock, message: str) -> None:
    msg = message.encode("utf-8")[:65536]
    try:
        sock.sendall(_U64.pack(_ERR) + _U32.pack(len(msg)) + msg)
    except OSError:
        pass


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        try:
            (header,) = _U64.unpack(_recv_exact(sock, _U64.size))
        except Exception:
            return
        if header & _FLAG_SERVICE:
            service = self.server.service
            if service is None:
                _send_error(sock, NO_SERVICE)
                return
            from blaze_tpu_torch.service.wire import (
                handle_service_connection,
            )

            handle_service_connection(sock, service)
            return
        handle_legacy_connection(sock, header, self.server.device)


def handle_legacy_connection(sock, header: int,
                             device: Optional[str] = None) -> None:
    """One-shot task exchange; the header u64 is already consumed. The
    task runs on `device` (the config's, "cuda", when None)."""
    from blaze_tpu_torch.io.ipc import encode_ipc_segment
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import execute_task

    try:
        is_ref = bool(header & _FLAG_REF)
        has_manifest = bool(header & _FLAG_MANIFEST)
        blob_len = header & ~(_FLAG_REF | _FLAG_MANIFEST | _FLAG_SERVICE)
        if blob_len > MAX_TASK_BYTES:
            raise ValueError("task too large")
        manifest_raw = None
        if has_manifest:
            (mlen,) = _U32.unpack(_recv_exact(sock, _U32.size))
            if mlen > MAX_TASK_BYTES:
                raise ValueError("manifest too large")
            manifest_raw = _recv_exact(sock, mlen)
        blob = _recv_exact(sock, blob_len)
    except Exception:
        return
    batches = None
    try:
        # manifest SEMANTIC failures (bad JSON, missing keys) get the
        # error frame - only framing failures above drop the connection
        resources = (_manifest_resources(json.loads(manifest_raw))
                     if manifest_raw is not None else {})
        ctx = ExecContext(device=device)
        ctx.resources.update(resources)
        if is_ref:
            from blaze_tpu_torch.plan.refcompat import (
                execute_reference_task,
            )

            batches = execute_reference_task(blob, ctx=ctx)
        else:
            batches = execute_task(blob, ctx=ctx)
        it = iter(batches)
        while True:
            rb = next(it, None)  # execution errors surface here
            if rb is None:
                break
            try:
                sock.sendall(encode_ipc_segment(rb))  # length-prefixed
            except OSError:
                # the client hung up mid-stream: a CANCELLATION, not an
                # execution failure - close the task's iterator so the
                # operators unwind (the executor lets GeneratorExit
                # through); no error frame, no task failure
                it.close()
                log.info("client disconnected mid-stream; task cancelled")
                return
        sock.sendall(_U64.pack(0))
    except Exception as e:
        _send_error(sock, str(e))
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True  # fixed-port restarts during TIME_WAIT
    daemon_threads = True


class TaskGatewayServer:
    """Gateway listener: one thread a connection (the JAX package's
    "threaded" wire). `device` is the device every legacy task runs on
    (None: the config's, "cuda"); `service`, a QueryService, enables
    service-protocol connections on the same listener. `wire` (or the
    BLAZE_WIRE environment variable) picks the data plane: "threaded"
    is the port's default and its only plane, and "async" raises until
    the event-loop wire is ported."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 device: Optional[str] = None, service=None,
                 wire: Optional[str] = None):
        if wire is None:
            wire = os.environ.get("BLAZE_WIRE", "threaded")
        if wire == "async":
            from blaze_tpu_torch.service.wire import ASYNC_WIRE_REFUSAL

            raise NotImplementedError(ASYNC_WIRE_REFUSAL)
        if wire != "threaded":
            raise ValueError(f"unknown wire mode {wire!r}")
        self.wire = wire
        self.service = service
        self._srv = _Server((host, port), _Handler, bind_and_activate=True)
        self._srv.device = device
        self._srv.service = service
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True,
            kwargs={"poll_interval": _POLL_S})

    @property
    def address(self):
        return self._srv.server_address

    def start(self) -> "TaskGatewayServer":
        self._thread.start()
        return self

    def serve_blocking(self) -> None:
        """Run the accept loop on the calling thread (the CLI's shape;
        instead of start()) until shutdown()."""
        self._srv.serve_forever(poll_interval=_POLL_S)

    def shutdown(self) -> None:
        """Stop the accept loop without closing the listener; safe from
        any thread (the drain path calls it once the service is
        empty)."""
        self._srv.shutdown()

    def stop(self) -> None:
        # shutdown() waits for a running accept loop; a listener never
        # started has none to wait for
        if self._thread.is_alive():
            self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def serve_forever(host: str = "127.0.0.1", port: int = 8484,
                  service=None, device: Optional[str] = None
                  ) -> None:  # pragma: no cover - CLI
    srv = TaskGatewayServer(host, port, device=device, service=service)
    print(f"blaze_tpu_torch gateway listening on {srv.address}",
          flush=True)
    srv.serve_blocking()
