"""In-process C-ABI embedding: execute_task behind Arrow C-Data.

The reference's defining boundary is an IN-PROCESS pointer handoff: the
native engine exports each finished batch as an Arrow C-Data
`ArrowSchema`/`ArrowArray` pair straight into its embedder's memory
(exec.rs:233-243 `export_array_into_raw`; consumer side
FFIHelper.scala:57-130 imports the pair). The socket gateway
(runtime/gateway.py) proves the same contract over TCP but copies every
byte; this module is the zero-copy tier: `csrc/blaze_embed.cpp` (the
port's copy of cpp/blaze_embed.cpp) hosts CPython in the embedder
process, calls `open_stream`/`export_next` here, and pyarrow's
`_export_to_c` hands the embedder raw buffer pointers plus a release
callback - no IPC, no serialization, one process.

Contract (mirrors BlazeCallNativeWrapper.nextBatch semantics,
NativeSupports.scala:285-301), the JAX package's runtime/embed.py:
  open_stream(blob)              -> opaque stream object
  export_next(stream, s_ptr, a_ptr) -> 1 batch exported | 0 exhausted
  on error: raises - the C layer converts to blz_last_error().

The C ABI carries no device: tasks run on the config's device ("cuda"),
or on the device named by the embedder's `BLAZE_EMBED_DEVICE`
environment variable ("cpu" in the tests). `build_host` compiles the
C++ test host (`csrc/blaze_embed_main.cpp` with `csrc/blaze_embed.cpp`)
with g++ and `python3-config --embed` into `build/blaze_tpu_torch/` at
first use; `run_host` runs it on one or more blobs in one interpreter,
and `parse_checksums` reads each blob's checksums from its output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from typing import Iterator, List, Optional, Sequence

DEVICE_ENV = "BLAZE_EMBED_DEVICE"


class _Stream:
    __slots__ = ("it", "current")

    def __init__(self, it: Iterator):
        self.it = it
        # the previously exported batch is parked here so its buffers
        # outlive the consumer's copy window even if the consumer calls
        # export_next again before invoking the release callback
        self.current = None


def _execute(blob: bytes):
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import execute_task

    return execute_task(bytes(blob),
                        ExecContext(device=os.environ.get(DEVICE_ENV)))


def open_stream(blob: bytes) -> _Stream:
    """Decode a TaskDefinition and start executing it; batches stream
    out through export_next."""
    return _Stream(iter(_execute(blob)))


def export_next(stream: _Stream, schema_ptr: int, array_ptr: int) -> int:
    """Export the next batch into caller-allocated ArrowSchema /
    ArrowArray structs (addresses as ints). Returns 1 if a batch was
    exported, 0 when the stream is exhausted."""
    rb = next(stream.it, None)
    if rb is None:
        stream.current = None
        return 0
    # _export_to_c moves ownership of the buffers into the C structs;
    # pyarrow keeps them alive until the consumer calls the embedded
    # release callback, so `current` only covers consumers that defer
    # the release past the next call
    rb._export_to_c(array_ptr, schema_ptr)
    stream.current = rb
    return 1


def run_task_checksums(blob: bytes) -> list:
    """Execute the same blob in process and return [rows] + per-column
    float checksums (sum of valid values; dictionary columns sum their
    codes) - what csrc/blaze_embed_main.cpp prints, computed the pyarrow
    way."""
    import pyarrow as pa
    import pyarrow.compute as pc

    sums: Optional[list] = None
    rows = 0
    for rb in _execute(blob):
        rows += rb.num_rows
        vals = []
        for col in rb.columns:
            if pa.types.is_dictionary(col.type):
                col = col.indices
            if pa.types.is_boolean(col.type):
                col = col.cast(pa.int8())
            vals.append(float(pc.sum(col).as_py() or 0.0))
        sums = vals if sums is None else [a + b
                                          for a, b in zip(sums, vals)]
    return [rows] + (sums or [])


# ---------------------------------------------------------------------------
# the C++ test host
# ---------------------------------------------------------------------------

_lock = threading.Lock()


def _sources():
    from blaze_tpu_torch.ops.kernels._build import CSRC

    return [CSRC / "blaze_embed_main.cpp", CSRC / "blaze_embed.cpp",
            CSRC / "arrow_c_data.h"]


def python_config() -> str:
    """The python-config of the running interpreter. Raises
    RuntimeError when it is missing or has no `--embed`."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    for name in (f"python{ver}-config", "python3-config"):
        path = shutil.which(name) or os.path.join(
            os.path.dirname(sys.executable), name)
        if os.path.exists(path):
            probe = subprocess.run([path, "--embed", "--ldflags"],
                                   capture_output=True, text=True)
            if probe.returncode == 0:
                return path
    raise RuntimeError(
        f"no python{ver}-config with --embed for {sys.executable}: the "
        "embed host cannot be built")


def build_host() -> str:
    """Path of the built C++ test host, compiled at first use. Raises
    RuntimeError with the compiler's output when g++ fails."""
    from blaze_tpu_torch.ops.kernels._build import BUILD_DIR

    cfg = python_config()
    flags = []
    for arg in (["--includes"], ["--embed", "--ldflags"]):
        flags += subprocess.run([cfg, *arg], capture_output=True,
                                text=True, check=True).stdout.split()
    libdir = sysconfig.get_config_var("LIBDIR")
    if libdir:
        flags.append(f"-Wl,-rpath,{libdir}")
    srcs = _sources()
    digest = hashlib.sha256(
        b"".join(s.read_bytes() for s in srcs)
        + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"blaze_embed_main-{digest}"
    with _lock:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", "-O2", "-std=c++17", str(srcs[0]), str(srcs[1]),
                 *flags, "-o", str(tmp)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed for the embed host:\n{proc.stdout}"
                    f"{proc.stderr}")
            os.replace(tmp, out)
    return str(out)


def host_env(device: Optional[str] = None) -> dict:
    """Environment for the embed host: this interpreter's module path
    (the embedded interpreter must find torch and pyarrow where this
    one does) and the task device."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    if device is not None:
        env[DEVICE_ENV] = device
    return env


def run_host(blob_paths: Sequence[str], device: Optional[str] = None,
             timeout: float = 600.0) -> subprocess.CompletedProcess:
    """Run the C++ test host on TaskDefinition files, one embedded
    interpreter for all of them."""
    from blaze_tpu_torch.ops.kernels._build import _PKG

    return subprocess.run(
        [build_host(), str(_PKG.parent), *map(str, blob_paths)],
        capture_output=True, text=True, timeout=timeout,
        env=host_env(device))


def parse_checksums(stdout: str) -> List[Optional[List[float]]]:
    """One entry a blob, from the host's `task k` / `rows N` / `col i
    sum x` lines: [rows] + column sums, or None where the blob's task
    failed (its error is on the host's stderr)."""
    tasks: List[Optional[List[float]]] = []
    for line in stdout.splitlines():
        parts = line.split()
        if parts[:1] == ["task"]:
            tasks.append(None)
        elif parts[:1] == ["rows"]:
            tasks[-1] = [int(parts[1])]
        elif parts[:1] == ["col"]:
            tasks[-1].append(float(parts[3]))
    if not tasks:
        raise ValueError(f"no task line in the embed host's output: "
                         f"{stdout!r}")
    return tasks
