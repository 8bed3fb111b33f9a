#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`blaze_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # the full run: 16,777,216 parquet rows
    python3 chip_smoke.py --rows N   # a smaller path phase

Phases, one JSON line each:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, whether pyarrow and protobuf import. No CUDA -> exit 2.
2. build: both CUDA kernels from blaze_tpu_torch/csrc/, one nvcc per
   source, all started together.
3. kernels: K1 (masked statistics) and K2 (compaction permutation) on
   the card against their plain PyTorch versions at the main path's
   shapes (a 16384-row batch and a 16M-row column), with NaN, +/-inf,
   all-masked, all-kept and int64-wrap inputs from a seeded numpy
   generator; then CUDA-event timings beside each kernel's bound.
4. path: a zstd parquet file of `--rows` rows (TPC-DS store_sales-shaped
   item/qty/price, as in bench.py) goes through the port's
   `execute_task` on cuda twice: the q6 task (filter, project, keyless
   SUM/COUNT(*)) against a numpy oracle, and the select task (the same
   filter and project, compacted per batch) against pyarrow's
   filter/multiply, row for row. Each kernel's launch count is zeroed
   before the task it serves and must be > 0 after it. Each task then
   runs once more under torch.profiler for its device busy time.

The line before the last is the per-kernel JSON summary; the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
This script imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM float32 outside the tensor cores (NVIDIA data sheet); the
# kernels' compares, adds and bit counts run on these CUDA cores
CUDA_CORE_OPS_PER_S = 67e12

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(torch, fn, iters: int = 50, reps: int = 5) -> float:
    """Time of one call: CUDA events around `iters` back-to-back calls,
    divided by `iters`; the median of `reps` such runs, after warm-up.
    Where launching costs more than the kernel runs, this is the launch
    rate - the profile phase gives device-only times."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return statistics.median(times)


def bound(nbytes: int, ops: int, ops_rate: float):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and
    operations / peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def k1_cases(rng, n: int):
    """(name, values, mask) host arrays covering the edge cases."""
    cases = []
    for dt in (np.float32, np.float64):
        v = ((rng.random(n) - 0.5) * 1e4).astype(dt)
        m = rng.random(n) < 0.5
        cases.append((f"{dt.__name__}_random", v, m))
        w = v.copy()
        w[rng.integers(0, n, 3)] = np.inf
        w[rng.integers(0, n, 3)] = -np.inf
        cases.append((f"{dt.__name__}_inf", w, m))
        w = v.copy()
        w[rng.integers(0, n, 5)] = np.nan
        cases.append((f"{dt.__name__}_nan", w, np.ones(n, bool)))
        cases.append((f"{dt.__name__}_all_masked", v, np.zeros(n, bool)))
        cases.append((f"{dt.__name__}_all_kept", v, np.ones(n, bool)))
    for dt in (np.int32, np.int64):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, dtype=dt)
        cases.append((f"{dt.__name__}_random", v, rng.random(n) < 0.5))
        cases.append((f"{dt.__name__}_all_masked", v, np.zeros(n, bool)))
    wrap = rng.integers(2 ** 62, 2 ** 63 - 1, n, dtype=np.int64)
    cases.append(("int64_wrap", wrap, np.ones(n, bool)))
    return cases


def same_value(torch, a, b) -> bool:
    """Exact equality with NaN equal to NaN."""
    if a.dtype.is_floating_point:
        both_nan = torch.isnan(a) & torch.isnan(b)
        return bool((both_nan | (a == b)).all())
    return bool((a == b).all())


def check_k1(torch, stats, rng, sizes):
    max_err = 0.0
    checked = 0
    for n in sizes:
        for name, v_np, m_np in k1_cases(rng, n):
            v = torch.from_numpy(v_np).cuda()
            m = torch.from_numpy(m_np).cuda()
            got = stats.masked_stats(v, m)
            exp = stats.masked_stats_plain(v, m)
            torch.cuda.synchronize()
            s, lo, hi, cnt = (t.cpu() for t in got)
            es, elo, ehi, ecnt = (t.cpu() for t in exp)
            ok = (same_value(torch, lo, elo) and same_value(torch, hi, ehi)
                  and int(cnt) == int(ecnt))
            if v.dtype.is_floating_point:
                sv, ev = float(s), float(es)
                if np.isfinite(ev):
                    sel = v_np[m_np].astype(np.float64)
                    tol = 1e-12 * float(np.abs(sel).sum())
                    err = abs(sv - ev)
                    max_err = max(max_err, err)
                    ok = ok and err <= tol
                else:
                    ok = ok and same_value(torch, s, es)
            else:
                ok = ok and int(s) == int(es)
            if not ok:
                raise AssertionError(
                    f"K1 masked_stats {name} n={n}: kernel "
                    f"{[t.tolist() for t in (s, lo, hi, cnt)]} vs plain "
                    f"{[t.tolist() for t in (es, elo, ehi, ecnt)]}")
            checked += 1
    return checked, max_err


def check_k2(torch, compact, rng, sizes):
    checked = 0
    max_err = 0
    for n in sizes:
        for name, keep_np in (
            ("p30", rng.random(n) < 0.3),
            ("p50", rng.random(n) < 0.5),
            ("all_kept", np.ones(n, bool)),
            ("none_kept", np.zeros(n, bool)),
            ("tail_only", np.arange(n) >= n - 7),
        ):
            keep = torch.from_numpy(keep_np).cuda()
            src, n_live = compact.compact_perm(keep)
            esrc, en = compact.compact_perm_plain(keep)
            torch.cuda.synchronize()
            exp = np.zeros(n, np.int32)
            idx = np.flatnonzero(keep_np).astype(np.int32)
            exp[: len(idx)] = idx
            max_err = max(max_err, int(
                (src.long() - esrc.long()).abs().max()) if n else 0)
            if not (torch.equal(src, esrc) and int(n_live) == int(en)
                    and np.array_equal(src.cpu().numpy(), exp)
                    and int(n_live) == len(idx)):
                raise AssertionError(
                    f"K2 compact_perm {name} n={n}: n_live "
                    f"{int(n_live)} vs {len(idx)}")
            checked += 1
    return checked, max_err


def time_kernels(torch, stats, compact, rng, n: int):
    """Kernel, plain and library times at one shape (f32 values, bool
    masks: the q6 path's dtypes)."""
    v = torch.from_numpy((rng.random(n) * 100).astype(np.float32)).cuda()
    m = torch.from_numpy(rng.random(n) < 0.5).cuda()
    keep = m
    k1_ms = cuda_ms(torch, lambda: stats.masked_stats(v, m))
    k1_plain = cuda_ms(torch, lambda: stats.masked_stats_plain(v, m))
    k2_ms = cuda_ms(torch, lambda: compact.compact_perm(keep))
    k2_plain = cuda_ms(torch, lambda: compact.compact_perm_plain(keep))
    k2_lib = cuda_ms(torch, lambda: torch.nonzero(keep))
    # K1 moves each value (4 B) and mask byte once and does ~4 operations
    # a row; K2 reads the mask byte and writes a 4 B index per row.
    k1_bytes = n * (4 + 1) + 8 + 4 + 4 + 8
    k1_bound, k1_by = bound(k1_bytes, 4 * n, CUDA_CORE_OPS_PER_S)
    k2_bytes = n * (1 + 4) + 4
    k2_bound, k2_by = bound(k2_bytes, 4 * n, CUDA_CORE_OPS_PER_S)
    return {
        "rows": n,
        "masked_stats": {"ms": k1_ms, "plain_ms": k1_plain,
                         "bound_ms": k1_bound, "bound_by": k1_by,
                         "bytes": k1_bytes, "library_ms": None},
        "compact_perm": {"ms": k2_ms, "plain_ms": k2_plain,
                         "bound_ms": k2_bound, "bound_by": k2_by,
                         "bytes": k2_bytes, "library_ms": k2_lib},
    }


# ---------------------------------------------------------------------------
# phase 4: the path
# ---------------------------------------------------------------------------

def write_store_sales(path: str, rows: int, seed: int):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    item = rng.integers(0, 1 << 17, rows).astype(np.int32)
    qty = rng.integers(1, 10, rows).astype(np.int32)
    price = (rng.random(rows) * 100).astype(np.float32)
    pq.write_table(
        pa.table({"item": item, "qty": qty, "price": price}), path,
        compression="zstd", row_group_size=1 << 20,
    )
    return qty, price


def q6_plan(scan, aggregate: bool):
    """bench.py's q6 shape on the port's operators."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
    from blaze_tpu_torch.ops import (
        AggMode,
        FilterExec,
        HashAggregateExec,
        ProjectExec,
    )
    from blaze_tpu_torch.types import DataType

    proj = ProjectExec(
        FilterExec(scan, (Col("price") > 50.0) & (Col("qty") < 8)),
        [(Col("price") * Col("qty").cast(DataType.float32()), "rev")],
    )
    if not aggregate:
        return proj
    return HashAggregateExec(
        proj, keys=[],
        aggs=[(AggExpr(AggFn.SUM, Col("rev")), "t"),
              (AggExpr(AggFn.COUNT_STAR, None), "n")],
        mode=AggMode.COMPLETE,
    )


def run_task(torch, blob, kernels):
    """Run one task on cuda with the kernels' counts zeroed just before;
    returns (batches, wall seconds, launches, transfer counts)."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime import dispatch
    from blaze_tpu_torch.runtime.executor import execute_task

    for k in kernels.values():
        k.LAUNCHES = 0
    ctx = ExecContext(device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dispatch.counting() as c:
        out = list(execute_task(blob, ctx))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.LAUNCHES for name, k in kernels.items()}
    transfers = {k: v for k, v in c.counts.items()
                 if not k.startswith("launch.")}
    return out, wall, launches, transfers


def profile_task(torch, blob, task: str, wall: float):
    """Run the task once more under torch.profiler: device busy time
    (every kernel and copy CUPTI saw, ours included) against the task's
    unprofiled wall gives the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import execute_task

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(execute_task(blob, ExecContext(device="cuda")))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    ours = [e for e in dev if any(
        k in e.key for k in ("stats_partial", "stats_final", "block_counts",
                             "scan_counts", "scatter_rows"))]
    emit({"phase": "profile", "task": task,
          "device_busy_ms": busy_ms if dev else "not measured",
          "device_calls": sum(e.count for e in dev),
          "wall_s": wall, "profiled_wall_s": prof_wall,
          "idle_share": 1 - busy_ms / (wall * 1e3) if dev
          else "not measured",
          "port_kernels": [{"name": e.key[:60], "calls": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in ours],
          "top_device": [{"name": e.key[:80], "calls": e.count,
                          "ms": e.self_device_time_total / 1e3}
                         for e in top]})


def path_phase(torch, rows: int, seed: int, kernels):
    import pyarrow as pa
    import pyarrow.compute as pc

    from blaze_tpu_torch.ops import FileRange, ParquetScanExec
    from blaze_tpu_torch.plan.serde import task_to_proto

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "store_sales.parquet")
    t0 = time.perf_counter()
    qty, price = write_store_sales(path, rows, seed)
    write_s = time.perf_counter() - t0
    results = {}
    try:
        # q6: filter -> project -> keyless SUM / COUNT(*)
        blob = task_to_proto(
            q6_plan(ParquetScanExec([[FileRange(path)]]), True), 0)
        out, wall, launches, transfers = run_task(torch, blob, kernels)
        live = (price > np.float32(50.0)) & (qty < 8)
        rev = np.where(live, price * qty.astype(np.float32),
                       np.float32(0))
        exp_sum = float(rev.sum(dtype=np.float64))
        exp_n = int(live.sum())
        got_sum = out[0].column(0)[0].as_py()
        got_n = out[0].column(1)[0].as_py()
        if got_n != exp_n or abs(got_sum - exp_sum) > 1e-9 * abs(exp_sum):
            raise AssertionError(
                f"q6: got ({got_sum}, {got_n}), numpy ({exp_sum}, {exp_n})")
        if launches["masked_stats"] <= 0:
            raise AssertionError("q6 did not launch K1 masked_stats")
        results["q6"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "path", "task": "q6", "rows": rows,
              "parquet_write_s": write_s, "wall_s": wall,
              "rows_per_s": rows / wall,
              "sum": got_sum, "count": got_n, "numpy_sum": exp_sum,
              "rel_err": abs(got_sum - exp_sum) / max(abs(exp_sum), 1.0),
              "launches": launches, "transfers": transfers})
        profile_task(torch, blob, "q6", wall)

        # select: filter -> project -> compacted Arrow batches
        blob = task_to_proto(
            q6_plan(ParquetScanExec([[FileRange(path)]]), False), 0)
        out, wall, launches, transfers = run_task(torch, blob, kernels)
        got = pa.Table.from_batches(out).column("rev").combine_chunks()
        tbl = pa.table({"qty": qty, "price": price})
        f = tbl.filter(pc.and_(pc.greater(tbl.column("price"), 50.0),
                               pc.less(tbl.column("qty"), 8)))
        exp = pc.multiply(f.column("price"),
                          pc.cast(f.column("qty"), pa.float32())
                          ).combine_chunks()
        if not (len(got) == len(exp) and got.null_count == 0
                and np.array_equal(got.to_numpy(), exp.to_numpy())):
            raise AssertionError(
                f"select: {len(got)} rows vs pyarrow {len(exp)}, or "
                "values differ")
        if launches["compact_perm"] <= 0:
            raise AssertionError("select did not launch K2 compact_perm")
        results["select"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "path", "task": "select", "rows": rows,
              "out_rows": len(got), "batches": len(out), "wall_s": wall,
              "rows_per_s": rows / wall, "launches": launches,
              "transfers": transfers})
        profile_task(torch, blob, "select", wall)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 24,
                    help="parquet rows of the path phase")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "blaze_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(blaze_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    # 1. device
    smi = smi_line()
    print(smi, flush=True)
    imports = {}
    for mod in ("pyarrow", "google.protobuf"):
        try:
            m = __import__(mod, fromlist=["__version__"])
            imports[mod] = m.__version__
        except ImportError as e:
            imports[mod] = f"missing: {e}"
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "imports": imports})

    # 2. build
    from blaze_tpu_torch.ops.kernels import _build, compact, stats

    t0 = time.perf_counter()
    libs = _build.build(["stats", "compact"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(str(p), REPO) for p in libs],
          "flags": _build.FLAGS})

    # 3. kernels against their plain versions, on the card
    rng = np.random.default_rng(args.seed)
    sizes = [16384, 1 << 24]
    n1, k1_err = check_k1(torch, stats, rng, sizes)
    n2, k2_err = check_k2(torch, compact, rng, sizes + [256, 1000])
    timings = [time_kernels(torch, stats, compact, rng, n) for n in sizes]
    emit({"phase": "kernels", "k1_cases": n1, "k1_max_abs_err": k1_err,
          "k2_max_abs_err": k2_err,
          "k1_tolerance": "counts, min, max, int sums exact; "
                          "f64 sum |d| <= 1e-12 * sum|x|",
          "k2_cases": n2, "k2_tolerance": "permutation, tail, count exact",
          "timings": timings, "nvidia_smi": smi,
          "k1_library": "none: no single PyTorch call gives "
                        "(sum, min, max, count) of a masked column",
          "k2_library": "torch.nonzero(keep); it syncs with the host for "
                        "its output size"})

    # 4. the path
    kernels = {"masked_stats": stats, "compact_perm": compact}
    res = path_phase(torch, args.rows, args.seed, kernels)

    # summary: timings at the main path's batch shape (16384 rows)
    main_t = timings[0]
    summary = []
    for name, src, replaces, task, err in (
        ("masked_stats", "blaze_tpu_torch/csrc/stats.cu",
         "blaze_tpu/ops/kernels/stats_pallas.py:75", "q6", k1_err),
        ("compact_perm", "blaze_tpu_torch/csrc/compact.cu",
         "blaze_tpu/ops/kernels/compact_pallas.py:78", "select", k2_err),
    ):
        t = main_t[name]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": res[task]["launches"][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
