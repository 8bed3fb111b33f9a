"""Device-work accounting: kernel launches, H2D copies and D2H fetches.

The reference engine's hot loop is one native call per task
(exec.rs:196-255). An eager PyTorch engine pays per launch and per
transfer instead, so those counts are the engine's cost model for small
and medium queries. This module keeps them process-wide (GIL-safe
increments under a lock); `counting()` gives the delta attributable to a
block, and the executor files it into each task's metric tree.

Keys in use:
- `h2d_copies`: host -> device buffer copies (batch.from_arrow);
- `d2h_fetches`: device -> host buffer copies (batch.to_arrow);
- `d2h_syncs`: blocking scalar readbacks (`host_int`, `host_bool`,
  `host_ints`); the grouped aggregate's are also counted by cause:
  `d2h_syncs.insert_round` (one per probe round of the hash table's
  insert loop), `d2h_syncs.group_branch` (direct or hashed slots) and
  `d2h_syncs.n_groups` (the group-capacity ladder); so are the joins'
  (ops/joins.py): `d2h_syncs.join_keyspan` (the build key's min and
  max, once per build for the direct table), `.join_dup` (whether
  build keys repeat, once per table built), `.join_insert_round` (one
  per round of a join table's insert), `.join_probe_round` (one per
  lookup round past the second) and `.join_pairs` (the sorted core's
  pair count, once per probe batch), `.join_chain_round` (one per
  round of a table's probe-round bound, once per table the fused join
  probes);
- the keyed fusion's (ops/fused.py): `d2h_syncs.carry_guard` (the
  grouped carry's overflow guard, once per batch of a stream of two
  batches or more), `d2h_syncs.n_groups` (a per-batch state batch's
  group count), `carry_demotions` (a carry that outgrew its slots and
  left as a device partial batch), `group_round_overflow` (a batch
  whose grouping left rows after the graph's probe rounds at its top
  tier and ran once more eagerly);
- `join_core.<core>`: which join core a build relation took
  (`table_direct`, `table_kr`, `table`, `sorted`);
- the sort tier's (ops/util.py, ops/sort.py): `sort_core.<packed|
  lexsort>` (one per argsort), `sort_route.<in_memory|topk|run_merge|
  host>` (one per SortExec run), `sort_spilled_runs` (runs the run
  merge spilled), `host_sorts`, and the merge's syncs
  `d2h_syncs.sort_merge`;
- the window's (ops/window.py, ops/fused.py): `window_route.window` or
  `window_route.fused_agg` (one per task), `window_sort_cache_hits`,
  and its one sync `d2h_syncs.window_span` (the longest partition);
- `launch.<kernel>`: launches of a hand-written kernel (ops/kernels);
  a launch inside a CUDA graph counts at each replay (`launched`);
- `graph_captures`, `graph_replays`: CUDA graphs captured and replayed
  by the fused operators (ops/fused.py); `graph_eager_batches`: batches
  a fused operator ran op by op instead, because the plan or the batch
  rules a graph out (a CPU device, a batch not packed by the scan).

It also keeps the fused operators' CUDA graphs (`GraphCache`), the
counterpart of the JAX package's `cached_kernel`
(blaze_tpu/runtime/dispatch.py): one captured graph per stage structure
and batch layout, replayed for every batch that has them. A keyed
aggregate's key also names its keys, functions and state fields, its
group-capacity tier, and for the grouped carry whether the graph reads
a previous carry, the carry's slot count and the batch's; a fused
join's names its table core (mode, probe rounds, and the core itself,
whose build the graph reads).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional

_lock = threading.Lock()
_counts: Dict[str, int] = {}


def record(kind: str, n: int = 1) -> None:
    with _lock:
        _counts[kind] = _counts.get(kind, 0) + n


def snapshot() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


class counting:
    """Context manager: `with counting() as c: ...; c.counts` gives the
    launch/transfer counts attributable to the block (delta of the
    global counters; concurrent tasks in other threads also land here)."""

    def __enter__(self):
        self._start = snapshot()
        self.counts: Dict[str, int] = {}
        return self

    def __exit__(self, *exc):
        end = snapshot()
        self.counts = {
            k: v - self._start.get(k, 0)
            for k, v in end.items()
            if v - self._start.get(k, 0)
        }
        return False


def task_threads(n_tasks: int, cap: int = 4) -> int:
    """Concurrency of a task pool (an exchange's map stage, the
    scheduler). One process shares one card, so threads buy overlap of
    host decode, encode and IO with the card's work, not compute."""
    return min(cap, max(1, n_tasks))


def _sync(what: Optional[str]) -> None:
    record("d2h_syncs")
    if what:
        record("d2h_syncs." + what)


def host_int(x, what: Optional[str] = None) -> int:
    """Blocking scalar readback (a full device round trip); `what` names
    it in a second counter, `d2h_syncs.<what>`."""
    _sync(what)
    return int(x)


def host_bool(x, what: Optional[str] = None) -> bool:
    """Blocking readback of a device bool, counted as host_int."""
    _sync(what)
    return bool(x)


def host_ints(x, what: Optional[str] = None) -> List[int]:
    """Blocking readback of a small device tensor as ints, one round
    trip counted as host_int."""
    _sync(what)
    return [int(v) for v in x.tolist()]


# ---------------------------------------------------------------------------
# CUDA graphs
# ---------------------------------------------------------------------------

_tls = threading.local()


def launched(count: Callable[[], None]) -> None:
    """A kernel wrapper reports one launch: `count()` adds it to the
    wrapper's count now or, while this thread captures a CUDA graph, at
    each replay of that graph (a capture runs nothing on the card)."""
    pending = getattr(_tls, "capture", None)
    if pending is None:
        count()
    else:
        pending.append(count)


class Graph:
    """A captured CUDA graph with its static tensors. `replay()` runs it
    on the current stream and counts the kernel launches it holds."""

    def __init__(self, graph, launches: List[Callable[[], None]], **static):
        self.graph = graph
        self.launches = launches
        self.__dict__.update(static)

    def replay(self) -> None:
        self.graph.replay()
        record("graph_replays")
        for count in self.launches:
            count()


def capture(fn: Callable[[], object], device,
            prepare: Optional[Callable[[object], None]] = None) -> tuple:
    """(torch.cuda.CUDAGraph, fn's result inside it, its launch counts):
    fn runs once eagerly on a side stream (first-use set-up stays out of
    the graph), `prepare` (if given) gets that warm-up result on the
    caller's stream - where a caller sizes the graph's output tensors -
    then fn is captured on the side stream. The capture checks only
    this thread's calls: the scan's prefetch thread, and other tasks'
    threads, keep copying, launching and replaying on their streams
    meanwhile. One capture runs at a time in the process: entering
    torch.cuda.graph synchronises the whole device, which CUDA refuses
    while another thread's stream is capturing. A failure raises; no
    caller falls back to running eagerly."""
    import torch

    with _capture_lock:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm = fn()
        torch.cuda.current_stream(device).wait_stream(side)
        if prepare is not None:
            prepare(warm)
        del warm
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        launches: List[Callable[[], None]] = []
        _tls.capture = launches
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                out = fn()
        finally:
            _tls.capture = None
    record("graph_captures")
    return graph, out, launches


_capture_lock = threading.Lock()


class GraphCache:
    """Captured graphs by key, each lent to one caller at a time: a
    graph's static tensors belong to the batch it is replaying, so two
    tasks with one key each get a graph of their own. At most
    `max_keys` keys are kept, the least recently used dropped first."""

    def __init__(self, max_keys: int = 32):
        self.max_keys = max_keys
        self._free: "collections.OrderedDict[tuple, List[Graph]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def acquire(self, key: tuple, build: Callable[[], Graph]) -> Graph:
        with self._lock:
            free = self._free.get(key)
            if free:
                self._free.move_to_end(key)
                return free.pop()
        return build()

    def release(self, key: tuple, g: Graph) -> None:
        with self._lock:
            self._free.setdefault(key, []).append(g)
            self._free.move_to_end(key)
            while len(self._free) > self.max_keys:
                self._free.popitem(last=False)


#: the process's graph cache (ops/fused.py)
GRAPHS = GraphCache()
