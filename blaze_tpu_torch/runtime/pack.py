"""Packed host <-> device transfers: one copy per batch each way.

The reference hands a whole batch across its FFI boundary as one
pointer pair (exec.rs:205-255); the JAX package packs a batch's buffers
into one uint8 buffer for one `device_put` (blaze_tpu/runtime/pack.py,
`put_packed_padded_lazy`) and one fetch (`get_packed`). Here:

- H2D (`put_packed`): the padded buffers of a batch are written on the
  host into ONE pinned staging buffer at 16-byte-aligned offsets, after
  a 16-byte header that holds the live row count, and cross in one
  `non_blocking` copy. On the device each column is a typed view of the
  byte buffer (no split kernel: a view costs nothing in torch). The
  header lets a CUDA graph read the live row count from the batch
  instead of baking it in (ops/fused.py).
- Staging is double-buffered (`Staging`): a pinned buffer is written
  again only after the CUDA event recorded behind its last copy has
  completed, so a copy in flight never reads a buffer being refilled.
- D2H (`get_packed`): the live prefixes of several device buffers are
  concatenated on the device (one launch) and fetched in one copy,
  then split into numpy views on the host.

Byte order is the host's (little-endian) on both sides; bool travels as
one byte 0/1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.obs import trace as obs_trace
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.testing import chaos

ALIGN = 16
HEADER = 16  # int64 live row count, then padding to ALIGN


def _round_up(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class Layout:
    """The packed format: typed segments in one uint8 buffer, after a
    `header` of bytes, each at an ALIGN-aligned offset. `specs` are
    (torch dtype, shape), a shape an element count or a tuple;
    `views(buf)` reads the segments of a buffer of `nbytes` bytes as
    typed views of those shapes. A batch from `put_packed` has a
    HEADER; a fused graph's outputs and its carry (ops/fused.py) have
    none."""

    def __init__(self, specs: Sequence[Tuple[torch.dtype, object]],
                 header: int = HEADER):
        self.specs: List[Tuple[torch.dtype, int, int, Tuple[int, ...]]] = []
        off = header
        for dtype, shape in specs:
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
            nb = int(np.prod(shape)) * _itemsize(dtype)
            self.specs.append((dtype, off, nb, shape))
            off += _round_up(nb)
        self.nbytes = off

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        return [buf[off: off + nb].view(dtype).view(shape)
                for dtype, off, nb, shape in self.specs]


class Staging:
    """Two pinned host buffers used in turn for one stream of batches.
    `take` waits for the event behind the buffer's previous copy."""

    def __init__(self):
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._events: List[Optional[object]] = [None, None]
        self._next = 0

    def take(self, nbytes: int) -> Tuple[int, torch.Tensor]:
        i = self._next
        self._next ^= 1
        ev = self._events[i]
        if ev is not None:
            ev.synchronize()
            self._events[i] = None
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                              pin_memory=True)
        return i, buf[:nbytes]

    def copied(self, i: int) -> None:
        """Mark buffer i in flight until the current stream passes
        here."""
        ev = torch.cuda.Event()
        ev.record()
        self._events[i] = ev


def put_packed(segments: Sequence[Tuple[np.ndarray, object]], num_rows: int,
               cap: int, device: torch.device,
               staging: Optional[Staging] = None
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Pad and pack host arrays into one buffer and copy it to `device`
    in one transfer (`_put_packed`). A copy to the card passes the
    `h2d.transfer` chaos seam and takes one `h2d` span (the pack and the
    copy's launch; the copy itself is asynchronous); a CPU batch, which
    aliases its host buffer, has no transfer and no seam (the JAX
    package's CPU backend has none either)."""
    if device.type != "cuda":
        return _put_packed(segments, num_rows, cap, device, staging)
    if chaos.ACTIVE:
        # chaos seam: the host->device staging transfer fails
        chaos.fire("h2d.transfer", n_arrays=len(segments))
    if obs_trace.ACTIVE:
        with obs_trace.span("h2d", n_arrays=len(segments)):
            return _put_packed(segments, num_rows, cap, device, staging)
    return _put_packed(segments, num_rows, cap, device, staging)


def _put_packed(segments: Sequence[Tuple[np.ndarray, object]],
                num_rows: int, cap: int, device: torch.device,
                staging: Optional[Staging] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The pack and the transfer.

    `segments` are `(values, fill)`: the live rows (at most `cap`,
    each row a scalar or, for decimal(>18) limbs, a pair) and the
    scalar that pads them to `cap`. Returns the device byte buffer
    (header included) and one typed device view per segment, shaped
    (cap,) + the row shape. CUDA devices need `staging`; a CPU batch
    aliases a fresh host buffer."""
    dtypes = [np.dtype(v.dtype) for v, _ in segments]
    shapes = [(cap,) + v.shape[1:] for v, _ in segments]
    lay = Layout([(_TORCH[dt], sh) for dt, sh in zip(dtypes, shapes)])
    cuda = device.type == "cuda"
    if cuda:
        slot, pinned = staging.take(lay.nbytes)
        host = pinned.numpy()
    else:
        host = np.empty(lay.nbytes, dtype=np.uint8)
    host[:HEADER] = 0
    host[:8].view(np.int64)[0] = num_rows
    for (vals, fill), dt, (_, off, nb, sh) in zip(segments, dtypes,
                                                  lay.specs):
        n = len(vals)
        seg = host[off: off + nb].view(dt).reshape(sh)
        seg[:n] = vals
        seg[n:] = fill
    if cuda:
        buf = torch.empty(lay.nbytes, dtype=torch.uint8, device=device)
        buf.copy_(pinned, non_blocking=True)
        staging.copied(slot)
        dispatch.record("h2d_copies")
    else:
        buf = torch.from_numpy(host)
    return buf, lay.views(buf)


_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def live_rows(buf: torch.Tensor) -> torch.Tensor:
    """The (1,)-shaped int64 live row count in a packed buffer's
    header, on the buffer's device."""
    return buf[:8].view(torch.int64)


def get_packed(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of tensors of one device in ONE fetch, each in its
    own shape: the device concatenates their bytes (one launch), the
    host splits the copy into views. A single tensor, or CPU tensors,
    need no packing."""
    if not tensors:
        return []
    if tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    dispatch.record("d2h_fetches")
    if len(tensors) == 1:
        return [tensors[0].cpu().numpy()]
    return split_bytes(concat_bytes(tensors).cpu().numpy(), tensors)


def concat_bytes(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The bytes of tensors of one device, back to back, in one uint8
    tensor on that device (one launch)."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def split_bytes(host: np.ndarray, tensors: Sequence[torch.Tensor]
                ) -> List[np.ndarray]:
    """`concat_bytes`'s host copy as numpy views shaped like `tensors`."""
    out = []
    off = 0
    for t in tensors:
        dt = np.dtype(str(t.dtype).replace("torch.", ""))
        nb = t.numel() * dt.itemsize
        out.append(host[off: off + nb].view(dt).reshape(t.shape))
        off += nb
    return out
