"""Double-buffered host pipeline.

The reference's hot loop is a tokio stream pumping batches through a
rendezvous queue (exec.rs:196-255). Here the producer iterator (parquet
decode, padding, H2D copy) runs on a worker thread ahead of the
consumer, bounded by a small queue, so host decode overlaps device
compute.

Stream ordering: neither thread sets a CUDA stream, so both issue on
the device's default stream. A batch's copy (blocking from pageable
memory in batch.from_arrow, non_blocking from pinned staging in
runtime/pack.put_packed) is enqueued before the batch enters the queue,
so it lands in stream order ahead of any kernel the consumer launches
on it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterator[T], depth: int = 2) -> Iterator[T]:
    """Run `it` on a background thread with `depth` items of lookahead.
    Exceptions propagate to the consumer at the point of consumption;
    early consumer exit stops the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                if stop.is_set():
                    return
                q.put(item)
            q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
