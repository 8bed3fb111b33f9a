"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/blaze_tpu_torch/lib<name>-<hash>.so

The file name carries a hash of the source and the flags, so an edit
rebuilds it. The build goes to `build/blaze_tpu_torch/` at the root of
the checkout, at first use. A failed build raises; nothing falls back
to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
#: every kernel source, csrc/<name>.cu
SOURCES = ("stats", "compact", "segreduce", "murmur3")
BUILD_DIR = _PKG.parent / "build" / "blaze_tpu_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_sms: Dict[int, int] = {}


def nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (name, final path, tmp path, process or None)."""
    out = library_path(name)
    if out.exists():
        return name, out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, out, tmp, proc


def build(names: Iterable[str]) -> List[Path]:
    """Build the named kernels, one nvcc per source, all started
    together. Raises RuntimeError with the compiler's output on
    failure."""
    started = [_start(n) for n in names]
    paths = []
    errors = []
    for name, out, tmp, proc in started:
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        paths.append(out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def stream(dev) -> int:
    """The raw handle of the device's current stream (a kernel launches
    on it); cheaper per call than a torch.cuda.Stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(dev.index)


def sm_count(dev) -> int:
    """The device's SM count, read once per device."""
    sms = _sms.get(dev.index)
    if sms is None:
        import torch

        sms = _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
