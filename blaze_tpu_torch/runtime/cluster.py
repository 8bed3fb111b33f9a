"""Mini-cluster runner: multi-PROCESS stage execution over the file
fabric.

The multi-host story of this engine (SURVEY 2.4): hosts coordinate through
serialized TaskDefinitions and the segmented Arrow-IPC shuffle files -
exactly how a Spark cluster drives the reference (tasks arrive as protobuf
over JNI, shuffle moves as .data/.index files). This runner proves that
path with real process isolation: a driver serializes each map task to a
spool directory, worker PROCESSES (separate interpreters, each with its
own CUDA context - `python -m blaze_tpu_torch.runtime.cluster`) claim
tasks by atomic rename, execute them through
`runtime.executor.execute_task` on the device they were started for, and
write results as segmented IPC; the driver assembles. No state crosses
process boundaries except protobuf + IPC files, so the same layout scales
to real multi-host runs with a shared filesystem or object store.

The JAX package's module (blaze_tpu/runtime/cluster.py) without its
tracing and chaos hooks, which come with the second half of the
serving tier (ROADMAP 'Modules to port' item 8). A worker's device is
explicit (`MiniCluster(device=...)`, "cuda" by default); a worker asked
for cuda that finds none fails every task it claims, and never carries
on on the CPU. A worker's completion record carries its task's kernel
launches (`launches`), the task's wall (`wall_s`) and the worker's task
count before it (`task_index`: 0 for its first task, which pays for
CUDA init and the kernels' loading).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import List, Optional, Sequence

import pyarrow as pa

log = logging.getLogger("blaze_tpu_torch.cluster")


class Liveness:
    """Progress-aware liveness window: any sign of life resets the
    window, and `expired()` is true only when nothing progressed within
    it - "provably dead or wedged", never merely "slow"."""

    def __init__(self, clock=time.time):
        self._clock = clock
        self._last = clock()

    def note_progress(self, at: Optional[float] = None) -> None:
        self._last = max(
            self._last, self._clock() if at is None else at
        )

    def idle_s(self, now: Optional[float] = None) -> float:
        return (self._clock() if now is None else now) - self._last

    def expired(self, timeout: float,
                now: Optional[float] = None) -> bool:
        return self.idle_s(now) > timeout


class MiniCluster:
    """The control plane (task spool) is shared - it plays the driver
    RPC role - but every worker owns a PRIVATE data directory for its
    shuffle outputs, exported only through its BlockServer
    (runtime/transport.py). Remote reads therefore go over the network,
    never through the shared filesystem.

    `retries` counts the tasks re-spooled after a classified failure;
    `quarantined` lists the worker slots (pids) taken out of service."""

    # failure policy (errors.py): a failed task is re-spooled up to
    # TASK_MAX_ATTEMPTS in all unless its class is PLAN_INVALID; a worker
    # that reports QUARANTINE_AFTER FATAL_FOR_WORKER failures (INTERNAL /
    # RESOURCE_EXHAUSTED - the worker itself is suspect) gets a
    # quarantine marker and stops claiming
    TASK_MAX_ATTEMPTS = 2
    QUARANTINE_AFTER = 2

    def __init__(self, num_workers: int = 2,
                 spool_dir: Optional[str] = None,
                 device: str = "cuda"):
        self.num_workers = num_workers
        self.spool = spool_dir or tempfile.mkdtemp(prefix="blz-cluster-")
        for sub in ("tasks", "claimed", "out", "quarantine"):
            os.makedirs(os.path.join(self.spool, sub), exist_ok=True)
        self._procs: List[subprocess.Popen] = []
        self.device = device
        self._worker_failures: dict = {}
        self.quarantined: List[str] = []
        self.retries = 0

    # ------------------------------------------------------------------
    def start(self) -> None:
        env = dict(os.environ)
        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        for i in range(self.num_workers):
            data_dir = tempfile.mkdtemp(prefix=f"blz-worker{i}-",
                                        dir=self.spool)
            # stderr to a FILE, never a pipe: nothing drains a pipe, so
            # a chatty worker would fill its buffer and block
            with open(os.path.join(self.spool, f"worker{i}.stderr"),
                      "wb") as errlog:
                self._procs.append(subprocess.Popen(
                    [sys.executable, "-m", "blaze_tpu_torch.runtime.cluster",
                     self.spool, data_dir, "--device", self.device],
                    env=env,
                    stdout=subprocess.DEVNULL,
                    stderr=errlog,
                ))

    def stop(self) -> None:
        open(os.path.join(self.spool, "SHUTDOWN"), "w").close()
        for p in self._procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._procs.clear()

    # ------------------------------------------------------------------
    def _spool_task(self, tid: str, blob: bytes) -> None:
        tmp = os.path.join(self.spool, "tasks", f".{tid}.tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, os.path.join(self.spool, "tasks", tid))

    def run_tasks(self, task_blobs: Sequence[bytes],
                  timeout: float = 300.0,
                  return_metas: bool = False):
        """Submit serialized TaskDefinitions; wait for per-task results
        (tables decoded from segmented IPC). With return_metas, also
        return each task's worker-reported metadata (block-server
        address, shuffle output ranges, kernel launches, wall) - per
        call, so concurrent map stages on one cluster cannot clobber
        each other.

        Liveness is PROGRESS-AWARE, not a fixed wall-clock deadline: each
        worker heartbeats its claimed-task file's mtime while executing
        (_HEARTBEAT_S); `timeout` bounds INACTIVITY - the run only fails
        once no claimed task has heartbeat within the window and no
        completion arrived, i.e. when the workers are provably dead or
        wedged rather than merely slow (a first task that initialises
        CUDA and loads the kernels)."""
        from blaze_tpu_torch.io.ipc import decode_ipc_parts

        metas: List[Optional[dict]] = [None] * len(task_blobs)
        ids = []
        for blob in task_blobs:
            tid = uuid.uuid4().hex
            self._spool_task(tid, blob)
            ids.append(tid)
        live = Liveness()
        tables: List[Optional[pa.Table]] = [None] * len(ids)
        pending = set(range(len(ids)))
        attempts = [1] * len(ids)
        claimed_dir = os.path.join(self.spool, "claimed")
        out_dir = os.path.join(self.spool, "out")
        while pending:
            now = time.time()
            # any fresh heartbeat (claimed-file mtime) counts as progress
            for i in pending:
                try:
                    hb = os.path.getmtime(os.path.join(claimed_dir, ids[i]))
                except OSError:
                    continue  # not claimed yet (or just completed)
                live.note_progress(hb)
            if live.expired(timeout, now):
                raise TimeoutError(
                    f"tasks incomplete: {pending} (no worker progress "
                    f"for {live.idle_s(now):.0f}s)")
            if (len(self.quarantined) >= self.num_workers
                    and all(os.path.exists(
                        os.path.join(self.spool, "tasks", ids[i]))
                        for i in pending)):
                # every slot is quarantined and every pending task sits
                # unclaimed: nothing can make progress
                raise RuntimeError(
                    f"all {self.num_workers} worker slots quarantined "
                    f"with {len(pending)} tasks unclaimed")
            for i in list(pending):
                done = os.path.join(out_dir, ids[i] + ".done")
                err = os.path.join(out_dir, ids[i] + ".err")
                if os.path.exists(err):
                    with open(err) as f:
                        info = _parse_err(f.read())
                    # quarantine accounting FIRST, so a wedged worker
                    # stops claiming before the re-spooled task lands
                    # back in the pool
                    self._note_worker_failure(info)
                    if (info["class"] != "PLAN_INVALID"
                            and attempts[i] < self.TASK_MAX_ATTEMPTS):
                        # classified retry: PLAN_INVALID never retries
                        # (the task is bad, not the worker)
                        attempts[i] += 1
                        self.retries += 1
                        log.warning("task %s failed [%s] on worker %s "
                                    "(attempt %d): %s; re-spooled",
                                    ids[i], info["class"], info.get("pid"),
                                    attempts[i] - 1, info["error"])
                        os.unlink(err)
                        self._spool_task(ids[i], task_blobs[i])
                        live.note_progress()
                        continue
                    raise RuntimeError(
                        f"worker task failed [{info['class']}]: "
                        f"{info['error']}")
                if os.path.exists(done):
                    with open(os.path.join(out_dir, ids[i] + ".ipc"),
                              "rb") as f:
                        batches = list(decode_ipc_parts(f.read()))
                    tables[i] = (pa.Table.from_batches(batches)
                                 if batches else pa.table({}))
                    with open(os.path.join(
                            out_dir, ids[i] + ".meta.json")) as f:
                        metas[i] = json.load(f)
                    pending.discard(i)
                    live.note_progress()
            time.sleep(0.05)
        if return_metas:
            return tables, metas
        return tables

    def _note_worker_failure(self, info: dict) -> None:
        """Count classified-fatal failures per worker; after
        QUARANTINE_AFTER of them the worker slot is quarantined (a
        marker file its claim loop checks) - a wedged runtime must not
        keep eating tasks, the way a Spark executor blacklisted after
        repeated task failures would not."""
        from blaze_tpu_torch.errors import FATAL_FOR_WORKER, ErrorClass

        wid = info.get("pid")
        if wid is None:
            return
        try:
            fatal = ErrorClass(info["class"]) in FATAL_FOR_WORKER
        except ValueError:
            fatal = True
        if not fatal:
            return
        wid = str(wid)
        self._worker_failures[wid] = self._worker_failures.get(wid, 0) + 1
        if (self._worker_failures[wid] >= self.QUARANTINE_AFTER
                and wid not in self.quarantined):
            open(os.path.join(self.spool, "quarantine", wid), "w").close()
            self.quarantined.append(wid)
            log.warning("worker %s quarantined after %d fatal failures",
                        wid, self._worker_failures[wid])

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


def _parse_err(text: str) -> dict:
    """Decode a worker .err payload. Workers write JSON
    {pid, class, error, traceback}; plain text (a partial write)
    degrades to an INTERNAL classification."""
    try:
        info = json.loads(text)
        if isinstance(info, dict) and "class" in info:
            info.setdefault("error", "")
            return info
    except (ValueError, TypeError):
        pass
    return {"pid": None, "class": "INTERNAL", "error": text}


# ---------------------------------------------------------------------------
# worker loop (runs in its own interpreter, with its own CUDA context)
# ---------------------------------------------------------------------------

WORKER_LOCAL_PREFIX = "__WORKER_LOCAL__"

# worker -> driver liveness signal: the claimed-task file's mtime is
# bumped this often while the task executes, so the driver can tell
# "alive but slow" from "dead" (progress-aware run_tasks)
_HEARTBEAT_S = 2.0


class _Heartbeat:
    """Touch `path` every _HEARTBEAT_S seconds on a daemon thread for
    the duration of a `with` block."""

    def __init__(self, path: str):
        import threading

        self._path = path
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(_HEARTBEAT_S):
            try:
                os.utime(self._path)
            except OSError:
                return  # file gone: the task finished racing us

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=2 * _HEARTBEAT_S)
        return False


def _rewrite_worker_local(blob: bytes, data_dir: str):
    """Rewrite __WORKER_LOCAL__ shuffle paths in a TaskDefinition to this
    worker's private data directory; returns (new blob, local outputs).
    Drivers use the token when they cannot know which worker will claim
    the map task (disjoint data dirs, no shared data filesystem)."""
    from google.protobuf.message import Message

    from blaze_tpu_torch.plan import plan_pb2 as pb

    t = pb.TaskDefinitionProto()
    t.ParseFromString(blob)
    outputs = []

    def walk(plan):
        kind = plan.WhichOneof("kind")
        if kind is None:
            return
        node = getattr(plan, kind)
        if kind == "shuffle_writer":
            for attr in ("data_file", "index_file"):
                v = getattr(node, attr)
                if v.startswith(WORKER_LOCAL_PREFIX):
                    setattr(node, attr, os.path.join(
                        data_dir, v[len(WORKER_LOCAL_PREFIX):].lstrip("/")))
            outputs.append((node.data_file, node.index_file))
        for field, value in node.ListFields():
            if (field.message_type is None
                    or field.message_type.name != "PlanProto"):
                continue
            for sub in (value if not isinstance(value, Message)
                        else [value]):
                walk(sub)

    walk(t.plan)
    if not outputs:
        return blob, []
    return t.SerializeToString(), outputs


def _launch_counts() -> dict:
    """The process's kernel launch counters (each kernel wrapper adds one
    where it launches its kernel on the card)."""
    from blaze_tpu_torch.ops.kernels import compact, murmur3, segreduce, stats

    return {
        "masked_stats": stats.LAUNCHES,
        "compact_perm": compact.LAUNCHES,
        "segment_reduce": segreduce.LAUNCHES,
        "murmur3": murmur3.LAUNCHES,
        "murmur3_hashes": murmur3.HASH_LAUNCHES,
    }


def _claim(tasks_dir: str, claimed_dir: str):
    """Claim the first spooled task by atomic rename; None if none."""
    for name in sorted(os.listdir(tasks_dir)):
        if name.startswith("."):
            continue
        dst = os.path.join(claimed_dir, name)
        try:
            os.replace(os.path.join(tasks_dir, name), dst)
            return name, dst
        except FileNotFoundError:
            continue  # another worker won the race
    return None


def worker_main(spool: str, data_dir: Optional[str] = None,
                device: str = "cuda") -> int:
    from blaze_tpu_torch.io.ipc import encode_ipc_segment, partition_ranges
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import execute_task
    from blaze_tpu_torch.runtime.transport import BlockServer

    data_dir = data_dir or tempfile.mkdtemp(prefix="blz-worker-")
    os.makedirs(data_dir, exist_ok=True)
    # every worker shares the driver's machine: serve on loopback
    server = BlockServer([data_dir]).start()
    host, port = server.address

    tasks_dir = os.path.join(spool, "tasks")
    claimed_dir = os.path.join(spool, "claimed")
    out_dir = os.path.join(spool, "out")
    quarantine_marker = os.path.join(spool, "quarantine", str(os.getpid()))
    task_index = 0
    while not os.path.exists(os.path.join(spool, "SHUTDOWN")):
        if os.path.exists(quarantine_marker):
            # the driver quarantined this slot after repeated
            # classified-fatal failures: stop claiming, keep serving
            # already-written shuffle blocks until shutdown
            time.sleep(0.2)
            continue
        claimed = _claim(tasks_dir, claimed_dir)
        if claimed is None:
            time.sleep(0.05)
            continue
        name, path = claimed
        if os.path.exists(quarantine_marker):
            # quarantined between the loop-top check and the claim (the
            # driver writes the marker BEFORE re-spooling a failed
            # task): return the task for a healthy worker
            try:
                os.replace(path, os.path.join(tasks_dir, name))
            except OSError:
                pass
            continue
        try:
            with open(path, "rb") as f:
                blob = f.read()
            blob, outputs = _rewrite_worker_local(blob, data_dir)
            parts = bytearray()
            before = _launch_counts()
            t0 = time.perf_counter()
            with _Heartbeat(path):
                for rb in execute_task(blob, ExecContext(device=device)):
                    parts += encode_ipc_segment(rb)
                if device != "cpu":
                    import torch

                    torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = _launch_counts()
            with open(os.path.join(out_dir, name + ".ipc"), "wb") as f:
                f.write(bytes(parts))
            meta = {
                "host": host,
                "port": port,
                "pid": os.getpid(),
                "task_index": task_index,
                "wall_s": wall,
                "launches": {k: after[k] - before[k] for k in after},
                "outputs": [
                    {"data": data, "index": index,
                     "ranges": [list(r) for r in partition_ranges(index)]}
                    for data, index in outputs
                    if os.path.exists(index)
                ],
            }
            with open(os.path.join(out_dir, name + ".meta.json"),
                      "w") as f:
                json.dump(meta, f)
            open(os.path.join(out_dir, name + ".done"), "w").close()
        except Exception as e:  # report back to the driver, classified
            import traceback

            from blaze_tpu_torch.errors import classify

            payload = {
                "pid": os.getpid(),
                "class": classify(e).value,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc(),
            }
            # atomic publish (like the task spool): the driver polls
            # every 50 ms and a torn read would misclassify the failure
            tmp = os.path.join(out_dir, f".{name}.err.tmp")
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, os.path.join(out_dir, name + ".err"))
        task_index += 1
    server.stop()
    return 0


def main(argv: Sequence[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.runtime.cluster",
        description="A MiniCluster worker: claims spooled tasks and runs "
                    "them on its device.")
    ap.add_argument("spool")
    ap.add_argument("data_dir", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return worker_main(args.spool, args.data_dir, args.device)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
