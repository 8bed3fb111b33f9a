"""Shared helpers of the serving tier's port tests
(tests/test_torch_service*.py, test_torch_obs.py, test_torch_chaos.py,
test_torch_zerocopy.py).

`twin(name)` is the port copy of one of the JAX package's test modules
(`tests/<name>.py`): its source with the module name `blaze_tpu` (word
boundary) replaced by `blaze_tpu_torch`, executed as a new module, as
tests/torch_tpcds_support.py does for the TPC-DS matrix. A port test
file picks the copied tests it runs by name, so each runs the JAX
package's own assertions against the port. No source file is edited.
The copies build their services without a device, so the files that
run them set the port's config device to the CPU (`port_env`), and
every `EngineConfig(...)` a copy makes gets `device="cpu"`.

The differential helpers build TaskDefinition bytes once, with the
port's serde (the proto is the JAX package's, byte for byte), for both
packages' services: bench.py's q6 and grouped shapes and an INNER join
under a keyed aggregate, over zstd parquet files from a seeded numpy
generator.
"""

from __future__ import annotations

import os
import re
import sys
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

_HERE = os.path.dirname(os.path.abspath(__file__))


def twin(name: str, extra=()) -> types.ModuleType:
    """The port copy of tests/<name>.py (loaded once a process, with the
    `extra` (old, new) source replacements of its first load)."""
    mod_name = f"{name}_torch_twin"
    if mod_name in sys.modules:
        mod = sys.modules[mod_name]
        assert mod.__twin_extra__ == tuple(extra), (name, extra)
        return mod
    path = os.path.join(_HERE, f"{name}.py")
    with open(path) as f:
        src = f.read()
    src = re.sub(r"\bblaze_tpu\b", "blaze_tpu_torch", src)
    # the replica router comes with the second half of the serving
    # tier: its imports go (tests/test_router.py's helpers too), and no
    # test that uses it is picked
    src = re.sub(r"^from blaze_tpu_torch\.router[^\n]*\n", "", src,
                 flags=re.M)
    # every config the copy makes is on the CPU
    src = re.sub(r"\bEngineConfig\(", 'EngineConfig(device="cpu", ', src)
    # the port's counterpart of an XLA dispatch on the CPU: a fused
    # batch run op by op (Query.status()'s `dispatches` counts them)
    src = src.replace('"dispatch.dispatches"',
                      '"dispatch.graph_eager_batches"')
    # helpers imported from another JAX test module come from its twin
    for other in sorted(set(re.findall(r"^from tests\.(\w+) import", src,
                                       flags=re.M))):
        if other == "test_router":
            src = re.sub(r"^from tests\.test_router import[^\n]*\n", "",
                         src, flags=re.M)
            continue
        twin(other)
        src = src.replace(f"from tests.{other} import",
                          f"from {other}_torch_twin import")
    for old, new in extra:
        assert old in src, (name, old)
        src = src.replace(old, new)
    mod = types.ModuleType(mod_name)
    mod.__file__ = path
    mod.__twin_extra__ = tuple(extra)
    sys.modules[mod_name] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def pick(module_globals: dict, mod: types.ModuleType, names) -> None:
    """Bind the named tests (and fixtures) of a twin into a test
    module's namespace, where pytest collects them."""
    for n in names:
        module_globals[n] = getattr(mod, n)


def port_env():
    """Generator for an autouse fixture: one test's port state. The
    port's config goes on the CPU, and afterwards comes the hygiene
    tests/conftest.py gives the JAX package's globals: chaos
    uninstalled, tracing, contention accounting, the sampler, the
    metrics registry and the phase rollup reset, the memory pool and
    device tracker fresh for the test and restored after it."""
    import dataclasses

    from blaze_tpu_torch.config import get_config, set_config
    from blaze_tpu_torch.obs import contention, sampler, trace
    from blaze_tpu_torch.obs.metrics import REGISTRY
    from blaze_tpu_torch.obs.phases import ROLLUP
    from blaze_tpu_torch.runtime import memory
    from blaze_tpu_torch.testing import chaos

    old = get_config()
    saved = memory._POOL, memory._DEVICE_TRACKER
    memory._POOL = memory._DEVICE_TRACKER = None
    set_config(dataclasses.replace(old, device="cpu"))
    try:
        yield
    finally:
        set_config(old)
        memory._POOL, memory._DEVICE_TRACKER = saved
        if not os.environ.get("BLAZE_CHAOS"):
            chaos.uninstall()
        trace._reset_for_tests()
        contention._reset_for_tests()
        sampler._reset_for_tests()
        REGISTRY._reset_for_tests()
        ROLLUP._reset_for_tests()


# ---------------------------------------------------------------------------
# differential data and tasks
# ---------------------------------------------------------------------------

def write_sales(path, rows=6000, seed=7) -> str:
    rng = np.random.default_rng(seed)
    pq.write_table(pa.table({
        "item": rng.integers(0, 1 << 12, rows).astype(np.int32),
        "qty": rng.integers(1, 10, rows).astype(np.int32),
        "price": (rng.random(rows) * 100).astype(np.float32),
    }), str(path), compression="zstd", row_group_size=2048)
    return str(path)


def write_items(path, n=1 << 12, seed=8) -> str:
    rng = np.random.default_rng(seed)
    pq.write_table(pa.table({
        "i_item": np.arange(n, dtype=np.int32),
        "i_class": rng.integers(0, 16, n).astype(np.int32),
    }), str(path), compression="zstd")
    return str(path)


def tasks(sales: str, items: str) -> dict:
    """{name: TaskDefinition bytes}: q6 (keyless), grouped (bench.py's
    grouped_agg) and join_agg (an INNER hash join under a keyed
    aggregate), built with the port's serde."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
    from blaze_tpu_torch.ops import (
        AggMode,
        FileRange,
        FilterExec,
        HashAggregateExec,
        ParquetScanExec,
        ProjectExec,
    )
    from blaze_tpu_torch.ops.joins import HashJoinExec, JoinType
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.types import DataType

    def scan(p):
        return ParquetScanExec([[FileRange(p)]])

    q6 = HashAggregateExec(
        ProjectExec(
            FilterExec(scan(sales),
                       (Col("price") > 50.0) & (Col("qty") < 8)),
            [(Col("price") * Col("qty").cast(DataType.float32()),
              "rev")]),
        keys=[], aggs=[(AggExpr(AggFn.SUM, Col("rev")), "t"),
                       (AggExpr(AggFn.COUNT_STAR, None), "n")],
        mode=AggMode.COMPLETE)
    grouped = HashAggregateExec(
        ProjectExec(scan(sales), [(Col("item") % 512, "g"),
                                  (Col("price"), "price"),
                                  (Col("qty"), "qty")]),
        keys=[(Col("g"), "g")],
        aggs=[(AggExpr(AggFn.SUM, Col("price")), "s"),
              (AggExpr(AggFn.MIN, Col("qty")), "mn"),
              (AggExpr(AggFn.MAX, Col("price")), "mx"),
              (AggExpr(AggFn.COUNT_STAR, None), "n")],
        mode=AggMode.COMPLETE)
    join = HashJoinExec(
        scan(items),
        ProjectExec(scan(sales), [(Col("item"), "item"),
                                  (Col("price"), "price")]),
        ["i_item"], ["item"], JoinType.INNER)
    join_agg = HashAggregateExec(
        join, keys=[(Col("i_class"), "c")],
        aggs=[(AggExpr(AggFn.SUM, Col("price")), "s"),
              (AggExpr(AggFn.COUNT_STAR, None), "n")],
        mode=AggMode.COMPLETE)
    return {name: task_to_proto(plan, 0) for name, plan in
            (("q6", q6), ("grouped", grouped), ("join_agg", join_agg))}


def canonical(batches) -> pa.Table:
    """One table, rows sorted by every column (canonical row order)."""
    tbl = pa.Table.from_batches(batches)
    if tbl.num_rows == 0:
        return tbl
    return tbl.sort_by([(n, "ascending") for n in tbl.column_names])


def assert_results_equal(got: pa.Table, exp: pa.Table) -> None:
    """Integers, counts and groups equal; float sums within 1e-9
    relative, float minima and maxima equal."""
    assert got.schema.names == exp.schema.names
    assert got.num_rows == exp.num_rows
    for name in got.schema.names:
        g, e = got.column(name), exp.column(name)
        assert g.type == e.type, (name, g.type, e.type)
        if pa.types.is_floating(g.type) and name in ("s", "t"):
            np.testing.assert_allclose(g.to_numpy(), e.to_numpy(),
                                       rtol=1e-9, err_msg=name)
        else:
            assert g.equals(e), name


# ---------------------------------------------------------------------------
# one scripted serving scenario, run by either package
# ---------------------------------------------------------------------------

#: every chaos seam name of the JAX package's docstring; the scenario
#: arms each with a zero-length STALL, so the journal names the seams a
#: query passed without changing what it does
SEAMS = ("task.execute", "parquet.decode", "h2d.transfer",
         "kernel.dispatch", "device.memory", "gateway.stream",
         "stream.consume", "cache.spill", "cluster.heartbeat",
         "service.admit", "mesh.exchange", "router.membership",
         "router.journal", "zerocopy.map", "zerocopy.lease",
         "service.tenant")


def wait_for(cond, timeout=20.0, tick=0.005):
    import time

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(tick)
    return False


def shared_dir(tmp_path_factory, name: str):
    """A directory every xdist worker of the session sees."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / name
    d.mkdir(exist_ok=True)
    return d


def scenario_tasks(tmp_path_factory) -> dict:
    """The scenario's TaskDefinition bytes, over files in a shared
    directory (written once, the same bytes for every worker)."""
    import fcntl

    d = shared_dir(tmp_path_factory, "service-scenario")
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        sales, items = d / "sales.parquet", d / "items.parquet"
        if not items.exists():
            write_sales(d / "sales.tmp")
            os.replace(d / "sales.tmp", sales)
            write_items(d / "items.tmp")
            os.replace(d / "items.tmp", items)
    return tasks(str(sales), str(items))


def run_scenario(pkg: str, blobs: dict, **service_kw) -> dict:
    """Drive one scripted sequence through `pkg`'s QueryService
    ("blaze_tpu" or "blaze_tpu_torch"; `service_kw` gives the JAX side
    mesh_mode="off" and the port device="cpu") and return what both
    packages must agree on, as plain data:

    - `order`: the admission order of a blocker then four queued tasks
      at mixed priorities and deadlines (priority, then EDF, then FIFO);
    - `results`: each task's result in canonical row order;
    - `outcomes`: (state, error class) of a cancelled queued query, a
      queued query past its deadline, a submit past a full queue
      (REJECTED_OVERLOADED), an undecodable blob and a cancelled
      running query;
    - `families`: the metric families of the Prometheus exposition
      (less the mesh's);
    - `phases`: the phase keys of a traced q6's rollup;
    - `seams`: the chaos seams a traced q6 passed.
    """
    import importlib
    import threading

    svc_mod = importlib.import_module(f"{pkg}.service")
    batch_mod = importlib.import_module(f"{pkg}.batch")
    scan_mod = importlib.import_module(f"{pkg}.ops.memory_scan")
    chaos = importlib.import_module(f"{pkg}.testing.chaos")
    phases = importlib.import_module(f"{pkg}.obs.phases")
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    QueryState = svc_mod.QueryState

    def one_row():
        if pkg == "blaze_tpu_torch":
            import torch

            return batch_mod.ColumnBatch.from_pydict(
                {"a": [1]}, device=torch.device("cpu"))
        return batch_mod.ColumnBatch.from_pydict({"a": [1]})

    class Gated(scan_mod.MemoryScanExec):
        def __init__(self, release):
            cb = one_row()
            super().__init__([[cb]], cb.schema)
            self.release = release
            self.started = threading.Event()

        def execute(self, partition, ctx):
            self.started.set()
            while not self.release.wait(0.005):
                yield self.partitions[0][0]

    out = {}
    # admission order and results
    release = threading.Event()
    blocker = Gated(release)
    with svc_mod.QueryService(max_concurrency=1, **service_kw) as svc:
        qb = svc.submit_plan(blocker, estimated_bytes=0)
        assert wait_for(blocker.started.is_set)
        queued = {
            "q6": svc.submit_task(blobs["q6"], priority=0),
            "grouped": svc.submit_task(blobs["grouped"], priority=5),
            "join_agg": svc.submit_task(blobs["join_agg"], priority=0,
                                        deadline_s=300.0),
            "grouped_edf": svc.submit_task(blobs["grouped"], priority=0,
                                           deadline_s=200.0,
                                           use_cache=False),
        }
        release.set()
        res = {k: canonical(svc.result(q.query_id, timeout=120))
               for k, q in queued.items()}
        names = {q.query_id: k for k, q in queued.items()}
        names[qb.query_id] = "blocker"
        out["order"] = [names[i] for i in svc.admission_log]
        out["results"] = res
    # terminal states and error classes
    release = threading.Event()
    blocker = Gated(release)
    with svc_mod.QueryService(max_concurrency=1, max_queue_depth=2,
                              enable_cache=False, **service_kw) as svc:
        qr = svc.submit_plan(blocker, estimated_bytes=0)
        assert wait_for(blocker.started.is_set)
        qc = svc.submit_task(blobs["q6"])
        svc.cancel(qc.query_id)
        qd = svc.submit_task(blobs["grouped"], deadline_s=0.05)
        assert wait_for(lambda: qd.done)
        qa = svc.submit_task(blobs["q6"])
        qa2 = svc.submit_task(blobs["grouped"])
        qo = svc.submit_task(blobs["join_agg"])
        qi = svc.submit_task(b"\x00garbage")
        for q in (qa, qa2, qr):
            svc.cancel(q.query_id)
        assert wait_for(lambda: qr.done)
        release.set()
        out["outcomes"] = {
            k: (q.state.value, q.error_class) for k, q in (
                ("cancel_queued", qc), ("deadline_queued", qd),
                ("overload", qo), ("invalid_plan", qi),
                ("cancel_running", qr))}
    # a traced q6 with every seam armed: seams, phase keys, families
    # (the registry starts empty, so the exposition is this block's)
    metrics.REGISTRY._reset_for_tests()
    with svc_mod.QueryService(max_concurrency=1, enable_cache=False,
                              fold_phases=False, **service_kw) as svc:
        faults = [chaos.Fault(site=s, klass="STALL", times=0, stall_s=0.0)
                  for s in SEAMS]
        with chaos.active(faults) as plan:
            q = svc.submit_task(blobs["q6"])
            svc.result(q.query_id, timeout=120)
        assert q.state is QueryState.DONE
        out["seams"] = sorted({j["site"] for j in plan.journal})
        rollup = phases.PhaseRollup()
        rollup.fold_query(q)
        out["phases"] = sorted(rollup.snapshot()["_all"])
        text = metrics.REGISTRY.render_prometheus()
        out["families"] = sorted(
            ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ") and "mesh" not in ln)
    return out


def scenarios(tmp_path_factory):
    """(port, jax): `run_scenario` through each package's service, each
    computed once a session (tests/torch_support.computed_once) and
    shared by the test files that compare them."""
    from torch_support import computed_once

    blobs = scenario_tasks(tmp_path_factory)
    jax = computed_once(
        tmp_path_factory, "service-scenario-jax",
        lambda: run_scenario("blaze_tpu", blobs, mesh_mode="off"))
    port = computed_once(
        tmp_path_factory, "service-scenario-port",
        lambda: run_scenario("blaze_tpu_torch", blobs, device="cpu"))
    return port, jax
