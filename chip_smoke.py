#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`blaze_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # the full run: 16,777,216 parquet rows
                                     # (q6, select, expr_chain,
                                     # exchange_agg, grace, join_agg,
                                     # join_kr, window, sort_topk),
                                     # 4,194,304 (grouped, repartition,
                                     # join_sorted, sort_full)
    python3 chip_smoke.py --rows N --grouped-rows M   # smaller path phases
    python3 chip_smoke.py --compare DIR   # K1, K2, K3 and the q6 and
                                          # select tasks of another
                                          # checkout against this one,
                                          # timed

Phases, one JSON line each:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, whether pyarrow and protobuf import. No CUDA -> exit 2.
2. build: every CUDA kernel from blaze_tpu_torch/csrc/, one nvcc per
   source, all started together.
3. kernels: K1 (masked statistics), K2 (compaction permutation) and K3
   (segmented reduce) on the card against their plain PyTorch versions
   at the main paths' shapes, with NaN, +/-inf, all-masked, all-kept,
   out-of-range segment ids, empty segments and int64-wrap inputs from
   a seeded numpy generator. K1 for every column dtype (bool, int8-64,
   float32/64) and uint8 masks, with values and mask at storage offsets
   0..15 (lined up or not) in storages whose other rows would count if
   read, for n in 1, 15, 17, each width's largest one-block size and
   one row more, 16,383-16,385, 2^24 and 2^24 + 3; at forced grids of
   1, 133 and 1024 blocks; each call twice with equal bits (the ticket
   reset); calls in flight on two streams; a float64 sum at 2^24 rows
   twice, bit for bit. K2 also on uint8 masks holding 2..255, on
   masks that are views at storage offsets 1..15, with kept runs that
   span tiles and one kept row at each end, for n in 1, 15, 17, both
   tiles (4096 and 8192) and their neighbours, the last size without
   look-back (65,536) and the first with it, and 2^24 + 3; the look-back
   kernel also at grids of fewer and more blocks than tiles; all against
   numpy's flatnonzero. K3 for every operation and source dtype (bool,
   int8-64, float32/64), with and without a contrib mask, whole and at a
   slot list, in both variants (shared, global) the domain can run, at
   the grouped, PARTIAL and FINAL shapes, a 256 KiB domain past one
   block's copy and both domain ends (1024 and 2^23 segments). Then K4 (Spark murmur3
   partition ids), bit for bit: every fixed-width key type, nullable
   and not, one, three and nine key columns, int extremes, +/-0.0, NaNs
   of several payloads, subnormals and +/-inf, for n in 1, 2, 200, 1024
   and the grace moduli 32, 128, 512, at 4096, 16,384 and 2^24 rows;
   and K4's second entry, `hashes` (the chained hash itself, the sorted
   join core's bucketing), bit for bit against the torch chain for
   every key type alone, two and nine columns, at 1, 2, 200, 4096,
   16,384 and (five cases) 2^24 rows, 13 rows of padding in every
   other case.
   Then CUDA-event timings beside each kernel's bound and the PyTorch
   call for the same function (for K3 with its mask-and-widen pass; K1
   has none, and torch.sum over the unmasked column is its yardstick),
   K1's device time at forced grids, and the device operations one K1,
   K2 or K3 call puts on the card (torch.profiler).
3b. graphs: the fused keyless aggregate's CUDA graph (q6's filter and
   project, SUM/COUNT(*)/MIN/MAX/AVG) replayed on 1000 fresh packed
   batches (NaN, +/-0.0, +/-inf among the prices), its carry equal to
   the eager run's bit for bit after every replay; then a short batch
   (10,000 live rows of 16,384) through the same graph; a stream of
   16,384- and 3000-row batches (two layouts, the carry moved between
   two graphs) against the same batches run op by op; then K1 captured
   in two graphs, each with its own scratch, replayed 20 times on two
   streams at once at 2^24 rows, equal to the eager call bit for bit.
4. path: a zstd parquet file of `--rows` rows (TPC-DS store_sales-shaped
   item/qty/price, as in bench.py) goes through the port's
   `execute_task` on cuda three times: the q6 task (filter, project,
   keyless SUM/COUNT(*)) against a numpy oracle, the select task (the
   same filter and project, compacted per batch) against pyarrow's
   filter/multiply, row for row, and the expr_chain task (bench.py's
   ln(price * qty + 1) * sqrt(abs(price - 50)), keyless SUM/MAX) against
   bench.py's expr_cpu_numpy within 1e-4 and a numpy oracle in the
   plan's own types (SUM within 1e-9 relative, MAX within 4 ulp). Every
   decoded task is fused: q6 and expr_chain must replay one CUDA graph
   and make one H2D copy per batch, with no batch run op by op (their
   `fusion` counters). Then a file of `--grouped-rows` rows
   goes through the grouped task (project g = item % 4096, keyed
   COMPLETE SUM/MIN/MAX(price), AVG(qty); bench.py's grouped_agg) and
   through its map-side form (a PARTIAL task, then FINAL over its state
   batches), both against bench.py's numpy bincount/reduceat oracle in
   float64. Each kernel's launch count is zeroed before the task it
   serves and must be > 0 after it. Each task then runs once more under
   torch.profiler for its device busy time.
   Then the exchange, over the same `--rows` cut into 4 parquet splits:
   - exchange_agg: Spark's two-stage plan of bench.py's grouped_agg with
     spark.sql.shuffle.partitions 200: 4 map TaskDefinitions (scan ->
     project g -> PARTIAL -> ShuffleWriter hash g), then 200 reduce
     TaskDefinitions (IpcReader over the map outputs' file segments ->
     FINAL), all through execute_task; the union equals the numpy
     oracle and every group lies in the reducer its Spark hash names;
   - repartition: one map task (k = CAST(item AS BIGINT), hash k into
     200), then 200 reduce tasks (IpcReader -> Arrow); each partition
     holds exactly the rows numpy's Spark hash sends there, in order;
   - grace: one keyed COMPLETE GROUP BY item (131,072 keys) over all
     `--rows` rows, past max_materialize_rows, so grace buckets it
     through K4; equal to a numpy oracle; its bucket counters printed.
   Each prints its wall, rows/s, launches, transfers and syncs, and
   runs once more under torch.profiler. Then the joins:
   - join_agg: bench.py's join_agg (bench.py:970-1024) through
     execute_task: the `--rows` store_sales file probes the 131,072-row
     item dimension (i_item = arange, i_brand in [0, 4096) as bench.py
     draws it) in a hash join, then per brand SUM(price), COUNT(*); the
     aggregate holds the join's whole output (max_materialize_rows =
     the row count). Per brand COUNT equal to numpy's
     bincount(i_brand[item]), SUM within 1e-9 relative of float64
     numpy; the join must take the dense direct table;
   - join_kr: the same with both keys times 16 (the span past 8x the
     build rows): the fused key|row table;
   - join_sorted: `--grouped-rows` rows against the dimension with
     every row twice: the sorted core, K4's `hashes` on both sides;
     COUNT and SUM twice numpy's;
   - join types: INNER, LEFT, RIGHT, FULL, LEFT_SEMI, LEFT_ANTI through
     HashJoinExec and SortMergeJoinExec (and LEFT_ANTI_NULL_AWARE
     through the latter), 1,048,576 fact rows with NULL keys against
     131,072 dimension rows with NULL and repeated keys, as
     TaskDefinitions, against pyarrow's Table.join (NAAJ: numpy), row
     pair for row pair;
   - grace join: a FULL sort-merge join whose fact side holds one key
     300,000 times, max_materialize_rows 200,000: both sides bucket
     through K4, the hot bucket is bucketed again, then joined whole;
     equal to the unbucketed run; its counters printed.
   Then the window, sort, limit and union tasks (`window_phase`), over a
   `--rows` file of (item, qty, price, part) drawn as bench.py:880-886
   draws them:
   - window: bench.py's window shape (bench.py:1094-1138): keyless
     SUM(CAST(rk AS DOUBLE)), SUM(run) over row_number and the running
     SUM(price) per part (1024 partitions) ordered by price descending;
     it must decode to HostFinalAggExec(FusedWindowAggExec) and launch
     K1; rksum exact (the sum of n(n+1)/2 over the partitions), runsum
     within 1e-6 relative of numpy's float64 per-partition cumsums;
   - sort_topk: ORDER BY price DESC, item LIMIT 100 WHERE qty < 8 over
     the whole file: the top-k route, K2 compacting the filtered
     batches; equal to numpy's stable lexsort of the kept rows;
   - sort_full: ORDER BY qty, price DESC, item over 4,194,304 rows to
     Arrow, under sort_core scatter (the packed path) and sort (the
     lexsort path), each equal to numpy's lexsort row for row;
   - sort_spill: the same over 1,048,576 rows with max_materialize_rows
     262,144: the run merge over at least 4 spilled runs, equal to the
     in-memory sort;
   - union_limit: LIMIT 1000 over a filter over the UNION ALL of two
     1,048,576-row splits, one task a partition, each equal to
     pyarrow's filter and slice of its split;
   - window_all: 1,048,576 rows, every window function and frame kind in
     one WindowExec (59 outputs) to Arrow, against a numpy oracle:
     ranking, lag/lead, counts, integer sums and MIN/MAX exact; float
     SUM/AVG within 1e-9 of the frame's absolute sum.
   Each prints its route counters and syncs and runs once more under
   torch.profiler. The shape of every kernel launch on these paths is
   noted.
5. kernels_at_path_shapes: each kernel against its plain version, as in
   phase 3, at every launch shape of phase 4 that phase 3 did not check;
   then K1, K2 and K3 timed at the most launched of those shapes (K2 at
   the hash-table sizes).

The line before the last is the per-kernel JSON summary; the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
This script imports neither jax nor the JAX package.

--compare DIR times, in the order DIR, this checkout, this checkout,
DIR (one process each), the q6 and select tasks over one `--rows`
parquet file (three walls each, the fusion counters and a profiled
run), the keyless aggregate's SUM and MIN as
`_Scalar` makes them (K1 and whatever the checkout does around it, such
as a widening pass) and K1 alone, for a float32 and an int16 column at
16,384 and 2^24 rows; the grouped aggregate's keyed reductions as
`_SegOps` makes them (the masked SUM of a float32 column, the count of a
mask and the masked MIN, each taken at the occupied slots: K3 and
whatever the checkout does around it) at the grouped, PARTIAL and FINAL
shapes; and K2 at the path sizes: ms and device µs a call.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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
    """(name, values, mask) host arrays covering the edge cases, made one
    at a time: every column dtype (bool, int8-64, float32/64), NaN,
    +/-inf, signed zeros, all-masked, all-kept, int64 sums that wrap and
    uint8 masks whose kept bytes hold 2..255."""
    for dt in (np.float32, np.float64):
        v = ((rng.random(n) - 0.5) * 1e4).astype(dt)
        m = rng.random(n) < 0.5
        yield f"{dt.__name__}_random", v, m
        w = v.copy()
        w[rng.integers(0, n, 3)] = np.inf
        w[rng.integers(0, n, 3)] = -np.inf
        yield f"{dt.__name__}_inf", w, m
        w = v.copy()
        w[rng.integers(0, n, 5)] = np.nan
        yield f"{dt.__name__}_nan", w, np.ones(n, bool)
        yield f"{dt.__name__}_all_masked", v, np.zeros(n, bool)
        yield f"{dt.__name__}_all_kept", v, np.ones(n, bool)
        z = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(dt)
        yield f"{dt.__name__}_signed_zero", z, rng.random(n) < 0.5
    for dt in (np.int8, np.int16, np.int32, np.int64):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        yield f"{dt.__name__}_random", v, rng.random(n) < 0.5
        yield f"{dt.__name__}_all_masked", v, np.zeros(n, bool)
        if dt in (np.int8, np.int16):
            yield f"{dt.__name__}_all_kept", v, np.ones(n, bool)
    b = rng.random(n) < 0.5
    yield "bool_random", b, rng.random(n) < 0.5
    yield "bool_all_masked", b, np.zeros(n, bool)
    yield "bool_all_kept", b, np.ones(n, bool)
    yield "bool_true", np.ones(n, bool), rng.random(n) < 0.5
    wrap = rng.integers(2 ** 62, 2 ** 63 - 1, n, dtype=np.int64)
    yield "int64_wrap", wrap, np.ones(n, bool)
    u8 = np.where(rng.random(n) < 0.5, rng.integers(2, 256, n),
                  0).astype(np.uint8)
    yield "float32_uint8_mask", ((rng.random(n) - 0.5) * 1e4).astype(
        np.float32), u8
    yield "int16_uint8_mask", rng.integers(-2 ** 15, 2 ** 15, n).astype(
        np.int16), u8
    yield "bool_uint8_mask", rng.random(n) < 0.5, u8


def same_value(torch, a, b) -> bool:
    """Bit for bit, NaN equal to NaN (whatever its payload): -0.0 and
    +0.0 differ."""
    if a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        ints = torch.int32 if a.element_size() == 4 else torch.int64
        both_nan = torch.isnan(a) & torch.isnan(b)
        return bool((both_nan | (a.view(ints) == b.view(ints))).all())
    return bool((a == b).all())


def k1_view(torch, arr, offset: int, fill):
    """arr on the card as a view `offset` elements into a storage whose
    other elements hold `fill`: a kernel that read a row outside the
    view would take it (K1's checks fill the mask's storage with 1)."""
    n = len(arr)
    t = torch.from_numpy(arr)
    store = torch.full((n + 32,), fill, dtype=t.dtype, device="cuda")
    store[offset:offset + n] = t.cuda()
    view = store[offset:offset + n]
    assert view.storage_offset() == offset
    return view


# K1's forced grids: one block, one more than the SMs, the most the
# scratch holds (blaze_tpu_torch/csrc/stats.cu kMaxBlocks)
K1_GRIDS = (1, 133, 1024)
# K1's sizes: odd small sizes, the largest one-block size of each
# element width (8192 rows of 8 bytes ... 65,536 of 1) and one row more,
# and the q6 batch with its neighbours
K1_SIZES = [1, 15, 17, 8192, 8193, 16383, 16384, 16385, 32768, 32769,
            65536, 65537]


def check_k1(torch, stats, rng, sizes, offsets=(0,), grids=(None,)):
    """K1 against its plain version at each size for every case of
    k1_cases, each launch made twice in a row (equal bits: the ticket
    was reset). Case i takes its values `offsets[i]` elements and its
    mask `offsets[7 i + 3]` bytes into their storages (cycling), so the
    two line up on the 16-byte grid or not; the rows around each view
    hold a kept NaN or 1, which any read outside the view would count.
    Each case runs at each grid of `grids` (None: the wrapper's)."""
    max_err = 0.0
    checked = 0
    i = 0
    for n in sizes:
        for name, v_np, m_np in k1_cases(rng, n):
            off = offsets[i % len(offsets)]
            moff = offsets[(7 * i + 3) % len(offsets)]
            i += 1
            fill = float("nan") if v_np.dtype.kind == "f" else 1
            v = k1_view(torch, v_np, off, fill)
            m = k1_view(torch, m_np, moff, 1)
            exp = stats.masked_stats_plain(v, m)
            es, elo, ehi, ecnt = (t.cpu() for t in exp)
            for g in grids:
                got = stats._launch(v, m, g)
                again = stats._launch(v, m, g)
                torch.cuda.synchronize()
                s, lo, hi, cnt = (t.cpu() for t in got)
                ok = (same_value(torch, lo, elo)
                      and same_value(torch, hi, ehi)
                      and int(cnt) == int(ecnt)
                      and all(t.shape == (1,) for t in got)
                      and all(same_value(torch, a.cpu(), b.cpu())
                              for a, b in zip(got, again)))
                if v.dtype.is_floating_point:
                    sv, ev = float(s), float(es)
                    if np.isfinite(ev):
                        sel = v_np[m_np != 0].astype(np.float64)
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
                        f"K1 masked_stats {name} n={n} offsets={off}/{moff} "
                        f"grid={g}: kernel "
                        f"{[t.tolist() for t in (s, lo, hi, cnt)]} (again "
                        f"{[t.cpu().tolist() for t in again]}) vs plain "
                        f"{[t.tolist() for t in (es, elo, ehi, ecnt)]}")
                checked += 1
    return checked, max_err


def k1_two_streams(torch, stats, rng, n: int, rounds: int = 8) -> int:
    """Calls in flight on two streams at once (a float32 and an int16
    column, each stream with its own scratch), `rounds` on each: every
    result equal to the plain version's bits."""
    a = torch.from_numpy(((rng.random(n) - 0.5) * 1e4).astype(
        np.float32)).cuda()
    b = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, n).astype(
        np.int16)).cuda()
    ma = torch.from_numpy(rng.random(n) < 0.5).cuda()
    mb = torch.from_numpy(rng.random(n) < 0.7).cuda()
    exp = {"a": stats.masked_stats_plain(a, ma),
           "b": stats.masked_stats_plain(b, mb)}
    first = {"a": stats.masked_stats(a, ma), "b": stats.masked_stats(b, mb)}
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = []
    for _ in range(rounds):
        with torch.cuda.stream(streams[0]):
            outs.append(("a", stats.masked_stats(a, ma)))
        with torch.cuda.stream(streams[1]):
            outs.append(("b", stats.masked_stats(b, mb)))
    torch.cuda.synchronize()
    for key, got in outs:
        # the float sum against the same grid's first call, bit for bit;
        # min, max and count, and the int sum, against the plain version
        ok = same_value(torch, got[0], first[key][0]) and all(
            same_value(torch, g, e) for g, e in zip(got[1:], exp[key][1:]))
        if key == "b":
            ok = ok and same_value(torch, got[0], exp[key][0])
        if not ok:
            raise AssertionError(f"K1 masked_stats on two streams ({key}) "
                                 "differs")
    return len(outs)


def k1_repeatable(torch, stats, rng, n: int) -> bool:
    """Whether two float64 sums of the same 2^24-row input give the
    same bits."""
    v = torch.from_numpy(rng.random(n) * 100).cuda()
    m = torch.from_numpy(rng.random(n) < 0.5).cuda()
    a = stats.masked_stats(v, m)[0].clone()
    b = stats.masked_stats(v, m)[0]
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


# K2's rows per look-back tile, per tile of the kernel without
# look-back, and the most rows of that kernel (blaze_tpu_torch/csrc/
# compact.cu kTile, kPass, kSmallRows)
K2_TILE = 8192
K2_SMALL_TILE = 4096
K2_SMALL_ROWS = 65536
# K2 sizes: the select batch, 2^24 rows, odd small sizes, both tiles and
# their neighbours, both sides of the look-back threshold, and 2^24 + 3
# (a ragged last tile)
K2_SIZES = [16384, 1 << 24, 256, 1000, 32768, 1, 15, 17, K2_TILE - 1,
            K2_TILE, K2_TILE + 1, K2_SMALL_TILE - 1, K2_SMALL_TILE, 4097,
            K2_SMALL_ROWS, K2_SMALL_ROWS + 1, (1 << 24) + 3]
# the look-back kernel at forced grids: fewer blocks than tiles (a block
# claims many) and more (most claim none and wait)
K2_GRID_SIZES = [K2_SMALL_ROWS + 1, 1 << 18]
K2_GRIDS = [1, 3, 1000]


def k2_masks(rng, n: int):
    """(name, host mask) pairs: random densities, all and none kept, a
    kept tail, one kept row at each end, kept runs that span tiles, and
    a uint8 mask whose kept bytes hold 2..255."""
    i = np.arange(n)
    ends = np.zeros(n, bool)
    ends[[0, n - 1]] = True
    u8 = np.where(rng.random(n) < 0.5,
                  rng.integers(2, 256, n), 0).astype(np.uint8)
    return [
        ("p30", rng.random(n) < 0.3),
        ("p50", rng.random(n) < 0.5),
        ("all_kept", np.ones(n, bool)),
        ("none_kept", np.zeros(n, bool)),
        ("tail_only", i >= n - 7),
        ("ends_only", ends),
        # runs of one tile, half a tile off the tile grid, and short runs
        ("runs_across_tiles", (((i + K2_TILE // 2) // K2_TILE) % 2 == 0)
         | ((i // 37) % 3 == 0) & (i >= 3 * K2_TILE)),
        ("uint8_2_255", u8),
    ]


def k2_view(torch, mask_np, offset: int):
    """The mask on the card as a view starting `offset` bytes into its
    storage (a sliced batch column starts at any byte)."""
    n = len(mask_np)
    store = torch.zeros(n + 16, dtype=torch.from_numpy(mask_np).dtype,
                        device="cuda")
    store[offset:offset + n] = torch.from_numpy(mask_np).cuda()
    view = store[offset:offset + n]
    assert view.storage_offset() == offset
    return view


def check_k2(torch, compact, rng, sizes, all_offsets=(), grids=(None,)):
    """K2 against its plain version bit for bit and against numpy's
    flatnonzero, at each size for every mask of k2_masks; the cases of a
    size take storage offsets 0, 1, ... 15 in turn, and the sizes in
    `all_offsets` take every offset with the uint8 mask. Each case runs
    at each grid of `grids` (None: the wrapper's)."""
    checked = 0
    offset = 0
    cases = [(n, name, m) for n in sizes for name, m in k2_masks(rng, n)]
    for n in all_offsets:
        u8 = dict(k2_masks(rng, n))["uint8_2_255"]
        cases += [(n, "uint8_2_255", u8)] * 16
    cases = [(n, name, m, g) for n, name, m in cases for g in grids]
    for n, name, keep_np, grid in cases:
        keep = k2_view(torch, keep_np, offset)
        src, n_live = compact._launch(keep, grid)
        esrc, en = compact.compact_perm_plain(keep)
        torch.cuda.synchronize()
        exp = np.zeros(n, np.int32)
        idx = np.flatnonzero(keep_np).astype(np.int32)
        exp[: len(idx)] = idx
        if not (torch.equal(src, esrc) and int(n_live) == int(en)
                and np.array_equal(src.cpu().numpy(), exp)
                and int(n_live) == len(idx)):
            raise AssertionError(
                f"K2 compact_perm {name} n={n} offset={offset} "
                f"grid={grid}: n_live "
                f"{int(n_live)} vs {len(idx)}, or the permutation differs")
        checked += 1
        offset = (offset + 1) % 16
    return checked, 0


# source dtypes of K3's column, by operation: every fixed-width column
K3_SRC = (np.bool_, np.int8, np.int16, np.int32, np.int64, np.float32,
          np.float64)


def k3_base(rng, n: int, k: int):
    """Host arrays one K3 shape's cases share: in-range gids, a 70% mask,
    uniform floats and full-range int64 bits."""
    return {"gid": rng.integers(0, k, n).astype(np.int32),
            "contrib": rng.random(n) < 0.7,
            "f": rng.random(n), "i": rng.integers(
                -2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)}


def k3_inputs(base, k: int, op: str, dtype, case: str):
    """(gid, values, contrib) host arrays for one K3 case: "random"
    (every gid in range), "edges" (gids out of range, the odd segments
    empty; for floats a NaN in segment 4, +inf with -inf in segment 6,
    segments 8, 10 and 12 holding only zeros: +0/-0/+0, -0/+0 and -0
    alone, and a masked-out NaN in segment 2), "wrap" (int64 sums that
    overflow)."""
    n = len(base["gid"])
    gid = base["gid"].copy()
    contrib = base["contrib"].copy()
    if dtype == np.bool_:
        v = base["f"] < 0.5
    elif np.issubdtype(dtype, np.floating):
        v = ((base["f"] - 0.5) * 1e3).astype(dtype)
    elif op == "sum" and dtype == np.int64:
        v = base["i"] >> 23  # +-2^40: sums that do not wrap
    else:
        v = base["i"].astype(dtype)  # the low bits: the dtype's range
    if case == "edges":
        gid = (gid // 2) * 2
        out = base["f"] < 0.05
        gid[out] = np.array([-1, k, k + 7, 2 ** 31 - 1],
                            np.int32)[base["i"][out] & 3]
        if np.issubdtype(dtype, np.floating) and n >= 11:
            gid[(gid >= 2) & (gid <= 12)] = 14
            gid[:11] = [4, 4, 6, 6, 8, 8, 8, 10, 10, 12, 2]
            v[:11] = [np.nan, 1.0, np.inf, -np.inf,
                      0.0, -0.0, 0.0, -0.0, 0.0, -0.0, np.nan]
            contrib[:11] = [True] * 10 + [False]
    elif case == "wrap":
        v = (base["i"] | (1 << 62)) & ((1 << 63) - 1)  # in [2^62, 2^63)
    return gid, v, contrib


def k3_variants(segreduce, op: str, dtype, k: int):
    """Every variant a domain of k slots can run: global always, shared
    where a block's copy fits."""
    if k * segreduce.key_size(op, dtype) <= segreduce._SHARED_MAX_BYTES:
        return ["global", "shared"]
    return ["global"]


def check_k3(torch, segreduce, rng, shapes, variants: bool = True):
    """Every K3 operation and source dtype, with and without a contrib
    mask, against its plain version at each (rows, segments) shape, and
    at a random slot list (`at`) as the grouped aggregate calls it:
    float64 sums within 1e-12 * sum|x| per segment, everything else bit
    for bit (NaN equal to NaN). With `variants`, every variant the domain
    can run is held to the same, not only the one the wrapper picks."""
    checked = 0
    max_err = 0.0
    for n, k in shapes:
        base = k3_base(rng, n, k)
        at_np = rng.integers(0, k, min(k, 4096)).astype(np.int32)
        at = torch.from_numpy(at_np).cuda()
        at64 = at.long()
        for op in ("sum", "min", "max"):
            kern = getattr(segreduce, f"segment_{op}")
            plain = getattr(segreduce, f"segment_{op}_plain")
            for dt in K3_SRC:
                cases = ["random", "edges"]
                if op == "sum" and dt == np.int64:
                    cases.append("wrap")
                for case in cases:
                    g_np, v_np, c_np = k3_inputs(base, k, op, dt, case)
                    gid = torch.from_numpy(g_np).cuda()
                    v = torch.from_numpy(v_np).cuda()
                    for masked in (False, True):
                        c = torch.from_numpy(c_np).cuda() if masked else None
                        exp = plain(gid, v, k, c)
                        mag = plain(gid, v.abs(), k, c) if (
                            op == "sum" and v.dtype.is_floating_point) \
                            else None
                        runs = [("picked", kern(gid, v, k, c)),
                                ("picked at", kern(gid, v, k, c, at))]
                        if variants:
                            runs += [(kind, segreduce._launch(
                                op, gid, v, k, c, None, kind))
                                for kind in k3_variants(
                                    segreduce, op, v.dtype, k)]
                        torch.cuda.synchronize()
                        for variant, got in runs:
                            want, m = exp, mag
                            if variant == "picked at":
                                want = exp[at64]
                                m = None if mag is None else mag[at64]
                            if op == "sum" and v.dtype.is_floating_point:
                                fin = torch.isfinite(want)
                                err = (got - want).abs()[fin]
                                e = float(err.max()) if err.numel() else 0.0
                                max_err = max(max_err, e)
                                ok = bool((err <= 1e-12 * m[fin]).all()) \
                                    and same_value(torch, got[~fin],
                                                   want[~fin])
                            else:
                                ok = same_value(torch, got, want)
                            if not ok:
                                raise AssertionError(
                                    f"K3 segment_{op} {np.dtype(dt).name} "
                                    f"{case} masked={masked} rows={n} "
                                    f"segments={k} ({variant}): kernel "
                                    "differs from plain")
                            checked += 1
    return checked, max_err


def k3_repeatable(torch, segreduce, rng, n: int, k: int) -> bool:
    """Whether two float64 segment sums of the same input give the same
    bits (atomics add in an order that may vary)."""
    gid = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).cuda()
    v = torch.from_numpy(rng.random(n) * 100).cuda()
    a = segreduce.segment_sum(gid, v, k)
    b = segreduce.segment_sum(gid, v, k)
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


def time_k3(torch, segreduce, rng, n: int, k: int, variants: bool = True):
    """K3 at one (rows, segments) shape for the grouped aggregate's three
    kinds of reduction, each taking the column in its own dtype: the
    masked float64 SUM of a float32 column (SUM, AVG), the count of a
    bool mask (COUNT and the validity of every state), and the masked
    float32 MIN (MIN, MAX, FIRST, LAST). Beside the kernel: its plain
    version, the one PyTorch call for the same function with its
    mask-and-widen pass (index_add_, scatter_reduce_ over torch.where),
    and with `variants` every variant the domain can run, in ms and in
    device µs a call (the variant pick's evidence)."""
    gid = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).cuda()
    dev = gid.device
    gid64 = gid.long()
    contrib = torch.from_numpy(rng.random(n) < 0.9).cuda()
    price = torch.from_numpy((rng.random(n) * 100).astype(np.float32)).cuda()
    inf = float("inf")
    out = {"rows": n, "segments": k}
    for name, op, v, c, lib in (
        ("sum_float32_masked", "sum", price, contrib,
         lambda: torch.zeros(k, dtype=torch.float64, device=dev).index_add_(
             0, gid64, torch.where(contrib, price.double(), 0.0))),
        ("count_bool", "sum", contrib, None,
         lambda: torch.zeros(k, dtype=torch.int64, device=dev).index_add_(
             0, gid64, contrib.long())),
        ("min_float32_masked", "min", price, contrib,
         lambda: torch.full((k,), inf, device=dev).scatter_reduce_(
             0, gid64, torch.where(contrib, price, inf), "amin",
             include_self=True)),
    ):
        kern = getattr(segreduce, f"segment_{op}")
        plain = getattr(segreduce, f"segment_{op}_plain")
        keysize = segreduce.key_size(op, v.dtype)
        # each row's gid, value and mask byte read once, each segment
        # written once; one add or compare per row
        nbytes = n * (4 + v.element_size() + (c is not None)) + k * keysize
        b_ms, b_by = bound(nbytes, n, CUDA_CORE_OPS_PER_S)
        row = {
            "ms": cuda_ms(torch, lambda: kern(gid, v, k, c)),
            "plain_ms": cuda_ms(torch, lambda: plain(gid, v, k, c)),
            "library_ms": cuda_ms(torch, lib),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "variant": segreduce.variant(n, k, op, v.dtype)}
        if variants:
            for kind in k3_variants(segreduce, op, v.dtype, k):
                def call():
                    return segreduce._launch(op, gid, v, k, c, None, kind)
                row[f"{kind}_ms"] = cuda_ms(torch, call)
                row[f"{kind}_device_us"] = device_ops(
                    torch, call)["device_us_per_call"]
        out[name] = row
    return out


def time_k2(torch, compact, rng, n: int, p: float = 0.5):
    """K2, its plain version and torch.nonzero on a bool mask of n rows
    with a fraction p kept. Bound: the mask byte read and one 4-byte
    index (kept row or 0 tail) written per row."""
    keep = torch.from_numpy(rng.random(n) < p).cuda()
    nbytes = n * (1 + 4) + 4
    b_ms, b_by = bound(nbytes, 4 * n, CUDA_CORE_OPS_PER_S)
    return {"rows": n, "kept": p,
            "ms": cuda_ms(torch, lambda: compact.compact_perm(keep)),
            "plain_ms": cuda_ms(torch,
                                lambda: compact.compact_perm_plain(keep)),
            "library_ms": cuda_ms(torch, lambda: torch.nonzero(keep)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


def time_k1(torch, stats, rng, n: int, dtype=np.float32):
    """K1 and its plain version on a column of n rows (bool mask, half
    kept). Bound: each value and mask byte read once, the 32-byte result
    written once. No PyTorch call gives all four results; the yardstick
    is torch.sum(v, dtype=float64) over the same unmasked column, which
    reads fewer bytes than K1 does."""
    if np.dtype(dtype).kind == "f":
        v_np = (rng.random(n) * 100).astype(dtype)
    else:
        v_np = rng.integers(-2 ** 15, 2 ** 15, n).astype(dtype)
    v = torch.from_numpy(v_np).cuda()
    m = torch.from_numpy(rng.random(n) < 0.5).cuda()
    nbytes = n * (v.element_size() + 1) + 32
    b_ms, b_by = bound(nbytes, 4 * n, CUDA_CORE_OPS_PER_S)
    return {"rows": n, "dtype": np.dtype(dtype).name,
            "ms": cuda_ms(torch, lambda: stats.masked_stats(v, m)),
            "plain_ms": cuda_ms(torch,
                                lambda: stats.masked_stats_plain(v, m)),
            "sum_f64_ms": cuda_ms(torch, lambda: torch.sum(
                v, dtype=torch.float64)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes}


def k1_grid_sweep(torch, stats, rng):
    """Device µs a K1 call at forced grids (the evidence for `grid`):
    one block against a few at the q6 batch of float32 and float64 and
    at 65,536 float32 rows; one, two and four blocks an SM at 2^24
    float32 rows."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for n, dt, grids in ((16384, np.float32, (1, 2, 4)),
                         (16384, np.float64, (1, 2, 4, 8)),
                         (65536, np.float32, (1, 4, 8, 16)),
                         (1 << 24, np.float32, (sms, 2 * sms, 4 * sms))):
        v = torch.from_numpy((rng.random(n) * 100).astype(dt)).cuda()
        m = torch.from_numpy(rng.random(n) < 0.5).cuda()
        row = {"picked": stats.grid(n, v.element_size(), sms)}
        for g in grids:
            prof = device_ops(torch, lambda: stats._launch(v, m, g))
            row[str(g)] = prof["device_us_per_call"]
        out[f"{n}_{np.dtype(dt).name}"] = row
    return out


def time_kernels(torch, stats, compact, rng, n: int):
    """Kernel, plain and library times at one shape (f32 values, bool
    masks: the q6 path's dtypes)."""
    return {"rows": n, "masked_stats": time_k1(torch, stats, rng, n),
            "compact_perm": time_k2(torch, compact, rng, n)}


def device_ops(torch, fn, calls: int = 20):
    """What one call of fn puts on the card, from torch.profiler over
    `calls` calls after a warm-up: each device operation (kernel,
    memset, copy) by name with its count per call, and device µs per
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then sees no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        if ev:
            break
    else:
        return {"ops_per_call": "not measured",
                "device_us_per_call": "not measured"}
    return {"ops_per_call": sum(e.count for e in ev) / calls,
            "by_name": {e.key[:60]: e.count / calls for e in ev},
            "device_us_per_call": sum(e.self_device_time_total
                                      for e in ev) / calls}


def profile_kernel_calls(torch, stats, compact, segreduce, rng):
    """Device operations per call of K1 (the q6 batch of float32 and of
    int16, 2^24 float32 rows), K2 (the select batch, a reduce task's
    table, 2^24 rows) and K3 as the grouped aggregate calls it (the
    column, its mask and the occupied slots) at the grouped, PARTIAL and
    FINAL shapes."""
    out = {}
    for n, dt in ((16384, np.float32), (16384, np.int16),
                  (1 << 24, np.float32)):
        v = torch.from_numpy((rng.random(n) * 100).astype(dt)).cuda()
        m = torch.from_numpy(rng.random(n) < 0.5).cuda()
        out[f"masked_stats_{np.dtype(dt).name}_{n}"] = device_ops(
            torch, lambda: stats.masked_stats(v, m))
    for n in (16384, 1 << 18, 1 << 24):
        keep = torch.from_numpy(rng.random(n) < 0.5).cuda()
        out[f"compact_perm_{n}"] = device_ops(
            torch, lambda: compact.compact_perm(keep))
    for label, n, k, m in (("grouped", 1 << 22, 16384, 4096),
                           ("partial", 16384, 32768, 16384),
                           ("final", 1032192, 16384, 4096)):
        gid = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).cuda()
        c = torch.from_numpy(rng.random(n) < 0.9).cuda()
        price = torch.from_numpy(
            (rng.random(n) * 100).astype(np.float32)).cuda()
        at = torch.from_numpy(rng.permutation(k)[:m].astype(np.int32)).cuda()
        out[f"segment_sum_{label}"] = device_ops(
            torch, lambda: segreduce.segment_sum(gid, price, k, c, at))
        out[f"segment_min_{label}"] = device_ops(
            torch, lambda: segreduce.segment_min(gid, price, k, c, at))
    return out


# ---------------------------------------------------------------------------
# phase 3, continued: K4 (murmur3 partition ids)
# ---------------------------------------------------------------------------

# key types by name: (numpy storage dtype, port DataType constructor)
K4_TYPES = {
    "bool": (np.bool_, "bool_"), "int8": (np.int8, "int8"),
    "int16": (np.int16, "int16"), "int32": (np.int32, "int32"),
    "date32": (np.int32, "date32"), "int64": (np.int64, "int64"),
    "timestamp_us": (np.int64, "timestamp_us"),
    "decimal18": (np.int64, None), "float32": (np.float32, "float32"),
    "float64": (np.float64, "float64"),
}
# float keys whose Spark hash differs from a naive one: signed zeros,
# NaNs of several payloads and signs, subnormals, infinities, extremes
F32_EDGE_BITS = [0x00000000, 0x80000000, 0x7FC00000, 0xFFC00000,
                 0x7F800001, 0x7FFFFFFF, 0xFFFFFFFF, 0x00000001,
                 0x807FFFFF, 0x7F800000, 0xFF800000, 0x7F7FFFFF,
                 0x00800000]
F64_EDGE_BITS = [0x0, 0x8000000000000000, 0x7FF8000000000000,
                 0xFFF8000000000000, 0x7FF0000000000001,
                 0x7FFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF, 0x1,
                 0x800FFFFFFFFFFFFF, 0x7FF0000000000000,
                 0xFFF0000000000000, 0x7FEFFFFFFFFFFFFF,
                 0x0010000000000000]
# the partition counts the checks use: Spark's defaults and the grace
# moduli (external_buckets 32, then x4 per level)
K4_NS = (1, 2, 200, 1024, 32, 128, 512)


def k4_dtype(name: str):
    from blaze_tpu_torch.types import DataType

    ctor = K4_TYPES[name][1]
    return DataType.decimal(18, 2) if ctor is None \
        else getattr(DataType, ctor)()


def k4_column(rng, name: str, n: int, nullable: bool):
    """(values, validity or None) host arrays of one key column, with
    the type's edge values on the first rows."""
    np_dt = K4_TYPES[name][0]
    if np_dt == np.bool_:
        v = rng.random(n) < 0.5
    elif np.issubdtype(np_dt, np.integer):
        info = np.iinfo(np_dt)
        v = rng.integers(info.min, info.max, n, dtype=np_dt,
                         endpoint=True)
        edges = np.array([info.min, info.max, 0, -1, 1], np_dt)
        v[:len(edges)] = edges[:n]
    else:
        v = ((rng.random(n) - 0.5) * 1e6).astype(np_dt)
        ints, bits = ((np.uint32, F32_EDGE_BITS) if np_dt == np.float32
                      else (np.uint64, F64_EDGE_BITS))
        edges = np.array(bits, ints).view(np_dt)
        k = min(n, len(edges))
        v[:k] = edges[:k]
        # and some more, scattered
        pos = rng.integers(0, n, min(n, 64))
        v[pos] = edges[rng.integers(0, len(edges), len(pos))]
    m = (rng.random(n) < 0.8) if nullable else None
    return v, m


def k4_cases():
    """(case name, [(type, nullable), ...]): every key type nullable and
    not as one column, three-column mixes, and nine columns (more than
    one launch takes)."""
    cases = [(f"{t}{'_null' if null else ''}", [(t, null)])
             for t in K4_TYPES for null in (False, True)]
    cases += [
        ("int32+float64_null+int8", [("int32", False), ("float64", True),
                                      ("int8", False)]),
        ("int64_null+float32+bool_null", [("int64", True),
                                           ("float32", False),
                                           ("bool", True)]),
        ("date32+decimal18+int16_null", [("date32", False),
                                          ("decimal18", False),
                                          ("int16", True)]),
        ("nine_columns", [(t, i % 2 == 1) for i, t in enumerate(
            ["int32", "float64", "int64", "bool", "float32", "int16",
             "date32", "int8", "timestamp_us"])]),
    ]
    return cases


def k4_inputs(torch, rng, spec, n: int):
    return [(torch.from_numpy(np.ascontiguousarray(v)).cuda(),
             None if m is None else torch.from_numpy(m).cuda(),
             k4_dtype(t))
            for (t, null) in spec
            for v, m in [k4_column(rng, t, n, null)]]


def check_k4(torch, murmur3, rng, sizes, ns=K4_NS, cases=None):
    """K4 against its plain version, bit for bit, at each capacity for
    every case and partition count; every other case leaves 13 rows of
    padding, whose ids must be the sentinel n. Returns the cases
    checked and the (capacity, n, key signature) shapes covered."""
    checked = 0
    covered = set()
    for size in sizes:
        for i, (name, spec) in enumerate(cases or k4_cases()):
            cols = k4_inputs(torch, rng, spec, size)
            num_rows = size - 13 if i % 2 and size > 13 else size
            for n in ns:
                got = murmur3.partition_ids(cols, num_rows, n)
                exp = murmur3.murmur3_plain(cols, num_rows, n)
                torch.cuda.synchronize()
                if not torch.equal(got, exp):
                    bad = int((got != exp).sum())
                    raise AssertionError(
                        f"K4 partition_ids {name} rows={size} n={n}: "
                        f"{bad} ids differ from the plain version")
                checked += 1
                covered.add(k4_shape(size, n, cols))
    return checked, covered


def k4_shape(capacity: int, n: int, cols):
    """The shape of a K4 call: capacity, n and the key columns' storage
    dtypes with whether each has validity."""
    return (capacity, n, tuple((str(v.dtype).replace("torch.", ""),
                                m is not None) for v, m, *_ in cols))


def check_k4_at(torch, murmur3, rng, shapes):
    """K4 against its plain version at launch shapes noted on the paths
    (random keys of the noted storage dtypes and validity)."""
    checked = 0
    for cap, n, sig in shapes:
        # storage dtype names are K4_TYPES names too
        c, _ = check_k4(torch, murmur3, rng, [cap], ns=(n,),
                        cases=[("path_shape", list(sig))])
        checked += c
    return checked


def time_k4(torch, murmur3, rng, rows: int, key: str, nullable: bool,
            n: int):
    """K4 and its plain version on one key of type `key` at `rows` rows.
    Bound: each key (and validity byte) read once and one int32 id
    written per row; some 20 integer operations a word. No PyTorch call
    computes Spark's murmur3."""
    cols = k4_inputs(torch, rng, [(key, nullable)], rows)
    width = np.dtype(K4_TYPES[key][0]).itemsize
    nbytes = rows * (width + int(nullable) + 4)
    words = 2 if width == 8 else 1
    b_ms, b_by = bound(nbytes, rows * 20 * words, CUDA_CORE_OPS_PER_S)
    return {"rows": rows, "key": key, "nullable": nullable, "n": n,
            "ms": cuda_ms(torch, lambda: murmur3.partition_ids(
                cols, rows, n)),
            "plain_ms": cuda_ms(torch, lambda: murmur3.murmur3_plain(
                cols, rows, n)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "library_ms": None}


def k4_hash_cases():
    """`hashes`' cases: every key type alone (nullable and not), two
    columns, and nine (two launches)."""
    cases = [c for c in k4_cases() if len(c[1]) in (1, 9)]
    return cases + [("int32+float64_null", [("int32", False),
                                            ("float64", True)])]


def check_k4_hashes(torch, murmur3, rng, sizes, cases=None):
    """K4's `hashes` against its plain version (the torch chain), bit
    for bit, at each capacity; every other case leaves 13 rows of
    padding, which must hold HASH_PAD. Returns the cases checked and
    the (capacity, HASH_PAD, key signature) shapes covered."""
    checked = 0
    covered = set()
    for size in sizes:
        for i, (name, spec) in enumerate(cases or k4_hash_cases()):
            cols = k4_inputs(torch, rng, spec, size)
            num_rows = size - 13 if i % 2 and size > 13 else size
            got = murmur3.hashes(cols, num_rows)
            exp = murmur3.hashes_plain(cols, num_rows)
            torch.cuda.synchronize()
            if not torch.equal(got, exp):
                bad = int((got != exp).sum())
                raise AssertionError(
                    f"K4 hashes {name} rows={size}: {bad} hashes differ "
                    "from the plain version")
            checked += 1
            covered.add(k4_shape(size, murmur3.HASH_PAD, cols))
    return checked, covered


def check_k4_hashes_at(torch, murmur3, rng, shapes):
    """`hashes` against its plain version at launch shapes noted on the
    paths."""
    return sum(check_k4_hashes(torch, murmur3, rng, [cap],
                               [("path_shape", list(sig))])[0]
               for cap, _, sig in shapes)


def time_k4_hashes(torch, murmur3, rng, rows: int, key: str,
                   nullable: bool):
    """K4's `hashes` and its plain version on one key at `rows` rows;
    the bound as time_k4's (one int32 hash written per row)."""
    cols = k4_inputs(torch, rng, [(key, nullable)], rows)
    width = np.dtype(K4_TYPES[key][0]).itemsize
    nbytes = rows * (width + int(nullable) + 4)
    words = 2 if width == 8 else 1
    b_ms, b_by = bound(nbytes, rows * 20 * words, CUDA_CORE_OPS_PER_S)
    return {"rows": rows, "key": key, "nullable": nullable,
            "ms": cuda_ms(torch, lambda: murmur3.hashes(cols, rows)),
            "plain_ms": cuda_ms(torch, lambda: murmur3.hashes_plain(
                cols, rows)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "library_ms": None}


# ---------------------------------------------------------------------------
# phase 4: the path
# ---------------------------------------------------------------------------

def store_sales_columns(rows: int, seed: int):
    """(item, qty, price) as bench.py:880-897 makes them."""
    rng = np.random.default_rng(seed)
    item = rng.integers(0, 1 << 17, rows).astype(np.int32)
    qty = rng.integers(1, 10, rows).astype(np.int32)
    price = (rng.random(rows) * 100).astype(np.float32)
    return item, qty, price


def write_parquet(path: str, item, qty, price):
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(
        pa.table({"item": item, "qty": qty, "price": price}), path,
        compression="zstd", row_group_size=1 << 20,
    )


def write_store_sales(path: str, rows: int, seed: int):
    item, qty, price = store_sales_columns(rows, seed)
    write_parquet(path, item, qty, price)
    return item, qty, price


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


def expr_chain_plan(scan):
    """bench.py's expr_chain (bench.py:1141-1157) on the port's
    operators: ln(price * qty + 1) * sqrt(abs(price - 50)) as float64,
    then keyless SUM and MAX."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col, Literal, \
        ScalarFn
    from blaze_tpu_torch.ops import AggMode, HashAggregateExec, ProjectExec
    from blaze_tpu_torch.types import DataType

    f32 = DataType.float32()
    rev = Col("price") * Col("qty").cast(f32)
    score = ScalarFn("ln", (rev + Literal(1.0, f32),)) * ScalarFn(
        "sqrt", (ScalarFn("abs", (Col("price") - Literal(50.0, f32),)),))
    return HashAggregateExec(
        ProjectExec(scan, [(score.cast(DataType.float64()), "sc")]),
        keys=[], aggs=[(AggExpr(AggFn.SUM, Col("sc")), "s"),
                       (AggExpr(AggFn.MAX, Col("sc")), "m")],
        mode=AggMode.COMPLETE)


def expr_chain_oracles(qty, price):
    """((sum, max), (sum, max)): bench.py's expr_cpu_numpy
    (bench.py:1164-1169), and numpy in the plan's own types - rev and
    +1 in float32, ln and sqrt of the float32 values widened to float64,
    abs(price - 50) in float32, the product in float64."""
    r = price * qty.astype(np.float32)
    bench = (np.log(r + np.float32(1.0))
             * np.sqrt(np.abs(price - np.float32(50.0)))).astype(np.float64)
    typed = (np.log((r + np.float32(1.0)).astype(np.float64))
             * np.sqrt(np.abs(price - np.float32(50.0)).astype(np.float64)))
    return ((float(bench.sum()), float(bench.max())),
            (float(typed.sum()), float(typed.max())))


def ulps(a: float, b: float) -> int:
    ia, ib = (int(np.array([v], np.float64).view(np.int64)[0])
              for v in (a, b))
    return abs(ia - ib)


def fusion_counts(transfers, rows: int):
    """Per-task fusion counters: scan batches, graph captures and
    replays, batches run op by op, H2D copies per batch."""
    batches = -(-rows // 16384)
    h2d = transfers.get("h2d_copies", 0)
    return {"batches": batches,
            "graph_captures": transfers.get("graph_captures", 0),
            "graph_replays": transfers.get("graph_replays", 0),
            "graph_eager_batches": transfers.get("graph_eager_batches", 0),
            "h2d_copies": h2d, "h2d_per_batch": h2d / batches,
            "d2h_fetches": transfers.get("d2h_fetches", 0)}


def check_fused(task: str, counts) -> None:
    """A fused keyless task: one graph replay and one H2D copy a batch,
    no batch run op by op."""
    n = counts["batches"]
    if (counts["graph_replays"] != n or counts["h2d_copies"] != n
            or counts["graph_eager_batches"] != 0):
        raise AssertionError(f"{task}: {counts} - expected {n} graph "
                             f"replays, {n} H2D copies, no eager batch")


# ---------------------------------------------------------------------------
# the graph phase: CUDA graphs of the fused keyless aggregate
# ---------------------------------------------------------------------------

def graph_plan(scan):
    """q6's filter and project with every mergeable keyless state:
    SUM, COUNT(*), MIN, MAX and AVG of rev."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
    from blaze_tpu_torch.ops import AggMode, HashAggregateExec

    return HashAggregateExec(
        q6_plan(scan, False), keys=[],
        aggs=[(AggExpr(AggFn.SUM, Col("rev")), "s"),
              (AggExpr(AggFn.COUNT_STAR, None), "n"),
              (AggExpr(AggFn.MIN, Col("rev")), "lo"),
              (AggExpr(AggFn.MAX, Col("rev")), "hi"),
              (AggExpr(AggFn.AVG, Col("rev")), "avg")],
        mode=AggMode.COMPLETE)


def graph_batch(torch, rng, rows: int, staging):
    """A fresh packed batch of store_sales rows on the card, with NaN,
    +/-0.0 and +/-inf among the prices."""
    import pyarrow as pa

    from blaze_tpu_torch.batch import PackedColumnBatch

    item, qty, price = store_sales_columns(rows, int(rng.integers(1 << 30)))
    special = rng.integers(0, rows, 8)
    price[special] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 51.0, -51.0,
                      np.nan][:len(special)]
    rb = pa.record_batch({"item": item, "qty": qty, "price": price})
    return PackedColumnBatch.from_arrow(rb, device="cuda", staging=staging)


def graph_phase(torch, stats, rng, replays: int = 1000):
    """The fused keyless aggregate's graph against its eager run, bit
    for bit: one graph replayed on `replays` fresh batches, its carry
    accumulating (compared after every replay), then a short batch
    (10,000 live rows of 16,384) through the same graph; a stream of
    two layouts through FusedAggregateExec.execute (its carry moved
    between two graphs) against the same batches run op by op; K1
    captured in two graphs, each with its own scratch, replayed on two
    streams at once at 2^24 rows (its multi-block path: the ticket),
    against the eager call."""
    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.ops.fused import _Carry
    from blaze_tpu_torch.ops.project import batch_cvs
    from blaze_tpu_torch.planner.fuse import fuse_pipelines
    from blaze_tpu_torch.runtime import dispatch
    from blaze_tpu_torch.runtime.pack import Staging

    staging = Staging()
    first = graph_batch(torch, rng, 16384, staging)
    fused = fuse_pipelines(graph_plan(MemoryScanExec([[]], first.schema))
                           ).children[0]
    g = fused._capture(first)
    eager = _Carry(fused.agg.schema, first.device)

    def step(cb: ColumnBatch) -> None:
        g.inp.copy_(cb.buf)
        g.replay()
        cols, sel = fused.pipeline.run(batch_cvs(cb), cb.capacity,
                                       cb.device, None)
        eager.merge(fused.plan, fused._states(
            cols, cb.capacity, cb.device, cb.live_mask() & sel))
        if not torch.equal(g.carry.buf, eager.buf):
            raise AssertionError("graph: the replayed carry differs from "
                                 "the eager one")

    g.carry.buf.zero_()
    t0 = time.perf_counter()
    for _ in range(replays):
        step(graph_batch(torch, rng, 16384, staging))
    short = graph_batch(torch, rng, 10000, staging)
    if short.key != first.key:
        raise AssertionError("graph: the short batch has another layout")
    step(short)
    carry_s = time.perf_counter() - t0
    # a stream whose layout changes (16,384- and 4096-row capacities):
    # the carry moves between two graphs; against the same batches run
    # op by op (plain batches take no graph)
    from blaze_tpu_torch.ops.base import ExecContext

    mixed = [graph_batch(torch, rng, n, staging)
             for n in (16384, 3000, 16384, 3000)]

    def states(batches):
        fused.children = [MemoryScanExec([batches], first.schema)]
        with dispatch.counting() as c:
            (out,) = fused.execute(0, ExecContext(device="cuda"))
        return out, c.counts

    graphed, gc = states(mixed)
    eager_out, ec = states([ColumnBatch(b.schema, b.columns, b.num_rows)
                            for b in mixed])
    if gc.get("graph_replays") != 4 or ec.get("graph_eager_batches") != 4:
        raise AssertionError(f"graph: mixed stream counts {gc} / {ec}")
    for g_col, e_col in zip(graphed.columns, eager_out.columns):
        for gt, et in ((g_col.values, e_col.values),
                       (g_col.validity, e_col.validity)):
            if (gt is None) != (et is None) or (gt is not None and not
                                                torch.equal(gt.view(
                                                    torch.uint8),
                                                    et.view(torch.uint8))):
                raise AssertionError("graph: the carry moved between "
                                     "graphs differs from the eager run")
    # K1 in two graphs on two streams
    n = 1 << 24
    v = torch.from_numpy(rng.random(n) * 100).cuda()
    m = torch.from_numpy(rng.random(n) < 0.5).cuda()
    exp = torch.cat([t.view(torch.uint8) for t in stats.masked_stats(v, m)])
    graphs = []
    for _ in range(2):
        scratch = stats.new_scratch(v.device)
        graph, out, launches = dispatch.capture(
            lambda scratch=scratch: stats.masked_stats(v, m, scratch),
            v.device)
        graphs.append(dispatch.Graph(graph, launches, out=out,
                                     scratch=scratch))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    rounds = 20
    torch.cuda.synchronize()
    for _ in range(rounds):
        for gr, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                gr.replay()
        torch.cuda.synchronize()
        for gr in graphs:
            got = torch.cat([t.view(torch.uint8) for t in gr.out])
            if not torch.equal(got, exp):
                raise AssertionError("graph: K1 replayed on two streams "
                                     "differs from the eager call")
    emit({"phase": "graphs", "carry_replays": replays + 1,
          "carry_bit_equal": True, "short_batch_live_rows": 10000,
          "mixed_layout_stream": {"rows": [16384, 3000, 16384, 3000],
                                  "graph_captures":
                                      gc.get("graph_captures", 0),
                                  "bit_equal_to_eager": True},
          "carry_seconds": carry_s, "k1_two_stream_rounds": rounds,
          "k1_rows": n, "k1_bit_equal": True,
          "k1_grid_blocks": stats.grid(n, 8, torch.cuda.get_device_properties(
              0).multi_processor_count)})


# the shape of a launch, from the arguments of each wrapper module's
# `_launch`: rows for K1 and K2, (rows, segments) for K3 (every case of
# check_k3 runs at each)
LAUNCH_SHAPE = {
    "masked_stats": lambda values, mask, *_: values.numel(),
    "compact_perm": lambda keep: keep.numel(),
    "segment_reduce": lambda op, gid, values, k, *_: (values.numel(), k),
    "murmur3": lambda group, h_in, num_rows, cap, n, emit_hash:
        k4_shape(cap, n, group),
}


@contextlib.contextmanager
def launch_shapes(kernels):
    """Wrap each kernel module's `_launch` (which counts the launch) to
    note the shape of every launch; yields {name: Counter of shapes}."""
    seen = {name: collections.Counter() for name in kernels}
    saved = {name: mod._launch for name, mod in kernels.items()}

    def noting(name, launch):
        def wrapped(*args):
            seen[name][LAUNCH_SHAPE[name](*args)] += 1
            return launch(*args)
        return wrapped

    for name, mod in kernels.items():
        mod._launch = noting(name, saved[name])
    try:
        yield seen
    finally:
        for name, mod in kernels.items():
            mod._launch = saved[name]


def run_counted(torch, fn, kernels):
    """Run fn() with the kernels' launch counts zeroed just before and
    the card synchronised at both ends; returns (its result, wall
    seconds, launches, transfer and sync counts)."""
    from blaze_tpu_torch.runtime import dispatch

    for k in kernels.values():
        k.LAUNCHES = 0
        if hasattr(k, "HASH_LAUNCHES"):
            k.HASH_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dispatch.counting() as c:
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.LAUNCHES for name, k in kernels.items()}
    # K4's second wrapper counts apart: `hashes` (the sorted join core)
    launches.update({name + "_hashes": k.HASH_LAUNCHES
                     for name, k in kernels.items()
                     if hasattr(k, "HASH_LAUNCHES")})
    transfers = {k: v for k, v in c.counts.items()
                 if not k.startswith("launch.")}
    return out, wall, launches, transfers


def run_task(torch, blob, kernels):
    """One task through execute_task on cuda, counted (run_counted)."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import execute_task

    return run_counted(
        torch, lambda: list(execute_task(blob, ExecContext(device="cuda"))),
        kernels)


def profile_task(torch, blob, task: str, wall: float):
    """Run the task once more under torch.profiler (profile_run)."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import execute_task

    profile_run(torch, lambda: list(execute_task(
        blob, ExecContext(device="cuda"))), task, wall)


def profile_run(torch, fn, task: str, wall: float):
    """Run fn() once more under torch.profiler: device busy time (every
    kernel and copy CUPTI saw, ours included) against the unprofiled
    wall gives the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    ours = [e for e in dev if any(
        k in e.key for k in ("masked_stats_kernel", "compact_small",
                             "compact_lookback", "seg_shared", "seg_global",
                             "seg_decode", "partition_ids"))]
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
    _, qty, price = write_store_sales(path, rows, seed)
    write_s = time.perf_counter() - t0
    results = {}
    try:
        # q6: filter -> project -> keyless SUM / COUNT(*)
        blob = task_to_proto(
            q6_plan(ParquetScanExec([[FileRange(path)]]), True), 0)
        out, wall, launches, transfers = run_task(torch, blob, kernels)
        exp_sum, _ = q6_oracle(qty, price)
        got_sum, got_n = check_q6(out, qty, price, "q6")
        if launches["masked_stats"] <= 0:
            raise AssertionError("q6 did not launch K1 masked_stats")
        fusion = fusion_counts(transfers, rows)
        check_fused("q6", fusion)
        results["q6"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "path", "task": "q6", "rows": rows,
              "parquet_write_s": write_s, "wall_s": wall,
              "rows_per_s": rows / wall,
              "sum": got_sum, "count": got_n, "numpy_sum": exp_sum,
              "rel_err": abs(got_sum - exp_sum) / max(abs(exp_sum), 1.0),
              "launches": launches, "fusion": fusion,
              "transfers": transfers})
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
              "fusion": fusion_counts(transfers, rows),
              "transfers": transfers})
        profile_task(torch, blob, "select", wall)

        # expr_chain: the scalar-function chain -> keyless SUM / MAX
        blob = task_to_proto(
            expr_chain_plan(ParquetScanExec([[FileRange(path)]])), 0)
        out, wall, launches, transfers = run_task(torch, blob, kernels)
        got_s = out[0].column("s")[0].as_py()
        got_m = out[0].column("m")[0].as_py()
        bench, typed = expr_chain_oracles(qty, price)
        bench_ok = all(abs(g - e) / max(abs(e), 1) < 1e-4
                       for g, e in zip((got_s, got_m), bench))
        typed_ok = (abs(got_s - typed[0]) <= 1e-9 * abs(typed[0])
                    and ulps(got_m, typed[1]) <= 4)
        if not (bench_ok and typed_ok):
            raise AssertionError(
                f"expr_chain: got ({got_s}, {got_m}), bench.py's numpy "
                f"{bench}, typed numpy {typed}")
        if launches["masked_stats"] <= 0:
            raise AssertionError("expr_chain did not launch K1 masked_stats")
        fusion = fusion_counts(transfers, rows)
        check_fused("expr_chain", fusion)
        results["expr_chain"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "path", "task": "expr_chain", "rows": rows,
              "wall_s": wall, "rows_per_s": rows / wall,
              "sum": got_s, "max": got_m, "bench_numpy": bench,
              "typed_numpy": typed,
              "sum_rel_err": abs(got_s - typed[0]) / abs(typed[0]),
              "max_ulps": ulps(got_m, typed[1]),
              "tolerance": "bench.py's 1e-4; typed numpy: SUM 1e-9 "
                           "relative, MAX 4 ulp",
              "launches": launches, "fusion": fusion,
              "transfers": transfers})
        profile_task(torch, blob, "expr_chain", wall)
        column_orders(torch, work, min(rows, 1 << 20), seed + 1, kernels)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


def q6_oracle(qty, price):
    """q6's (SUM(rev), COUNT(*)) in numpy."""
    live = (price > np.float32(50.0)) & (qty < 8)
    rev = np.where(live, price * qty.astype(np.float32), np.float32(0))
    return float(rev.sum(dtype=np.float64)), int(live.sum())


def check_q6(out, qty, price, task: str):
    """q6's result row against q6_oracle: COUNT exact, SUM within 1e-9
    relative; returns (sum, count)."""
    exp_sum, exp_n = q6_oracle(qty, price)
    got_sum = out[0].column(0)[0].as_py()
    got_n = out[0].column(1)[0].as_py()
    if got_n != exp_n or abs(got_sum - exp_sum) > 1e-9 * abs(exp_sum):
        raise AssertionError(f"{task}: got ({got_sum}, {got_n}), numpy "
                             f"({exp_sum}, {exp_n})")
    return got_sum, got_n


def column_orders(torch, work: str, rows: int, seed: int, kernels):
    """One q6 plan over two files that hold the same columns, item and
    qty (both int32) swapped: one batch layout, so only the graph key's
    leaf schema and bound columns keep the tasks' graphs apart. The
    swapped task captures graphs of its own, the first order's rerun
    replays its cached ones, and each result matches its own numpy."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.ops import FileRange, ParquetScanExec
    from blaze_tpu_torch.plan.serde import task_to_proto

    item, qty, price = store_sales_columns(rows, seed)
    files = {"item_qty_price": {"item": item, "qty": qty, "price": price},
             "qty_item_price": {"qty": qty, "item": item, "price": price}}
    captures = {}
    for order in ("item_qty_price", "qty_item_price", "item_qty_price"):
        path = os.path.join(work, order + ".parquet")
        if not os.path.exists(path):
            pq.write_table(pa.table(files[order]), path,
                           row_group_size=1 << 20)
        blob = task_to_proto(
            q6_plan(ParquetScanExec([[FileRange(path)]]), True), 0)
        out, _, _, transfers = run_task(torch, blob, kernels)
        check_q6(out, qty, price, "q6 over " + order)
        captures.setdefault(order, []).append(
            transfers.get("graph_captures", 0))
    if captures["qty_item_price"][0] < 1 or captures["item_qty_price"][1]:
        raise AssertionError(f"column orders: graph captures {captures}: "
                             "expected new graphs for the swapped order "
                             "and none for the rerun")
    emit({"phase": "column_orders", "rows": rows,
          "orders": list(files), "graph_captures": captures,
          "each_matches_its_numpy": True})


# ---------------------------------------------------------------------------
# phase 4, continued: the grouped aggregate
# ---------------------------------------------------------------------------

GROUPS = 4096


def grouped_aggs():
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col

    return [(AggExpr(AggFn.SUM, Col("price")), "s"),
            (AggExpr(AggFn.MIN, Col("price")), "lo"),
            (AggExpr(AggFn.MAX, Col("price")), "hi"),
            (AggExpr(AggFn.AVG, Col("qty")), "aq")]


def grouped_plan(scan, mode):
    """bench.py's grouped_agg shape (bench.py:1026-1038) on the port's
    operators: g = item % 4096, keyed SUM/MIN/MAX(price), AVG(qty)."""
    from blaze_tpu_torch.exprs.ir import Col, Literal
    from blaze_tpu_torch.ops import HashAggregateExec, ProjectExec
    from blaze_tpu_torch.types import DataType

    proj = ProjectExec(scan, [
        (Col("item") % Literal(GROUPS, DataType.int32()), "g"),
        (Col("price"), "price"), (Col("qty"), "qty")])
    return HashAggregateExec(proj, keys=[(Col("g"), "g")],
                             aggs=grouped_aggs(), mode=mode)


def final_plan(states, state_schema, device):
    """FINAL over a PARTIAL task's Arrow state batches, as a reduce
    stage runs it: the batches back on the device in a
    MemoryScanExec."""
    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import AggMode, HashAggregateExec, MemoryScanExec

    cbs = [ColumnBatch.from_arrow(rb, device=device) for rb in states]
    return HashAggregateExec(MemoryScanExec([cbs], state_schema),
                             keys=[(Col("g"), "g")], aggs=grouped_aggs(),
                             mode=AggMode.FINAL)


def keyed_oracle(g, qty, price, groups: int, key: str = "g"):
    """bench.py's numpy oracle (bench.py:1059-1085) in float64: per
    non-empty group of the keys `g` in [0, groups), SUM, MIN and MAX of
    price and AVG of qty."""
    g = g.astype(np.int64)
    s = np.bincount(g, weights=price.astype(np.float64), minlength=groups)
    cnt = np.bincount(g, minlength=groups)
    qs = np.bincount(g, weights=qty.astype(np.float64), minlength=groups)
    order = np.argsort(g, kind="stable")
    gs = g[order]
    ps = price[order]
    bounds = np.searchsorted(gs, np.arange(groups + 1))
    starts = np.minimum(bounds[:-1], len(ps) - 1)
    lo = np.minimum.reduceat(ps, starts)
    hi = np.maximum.reduceat(ps, starts)
    nz = bounds[:-1] < bounds[1:]
    return {key: np.flatnonzero(nz), "s": s[nz], "lo": lo[nz],
            "hi": hi[nz], "aq": qs[nz] / cnt[nz]}


def grouped_oracle(item, qty, price):
    """The oracle of bench.py's grouped_agg: groups g = item % 4096."""
    return keyed_oracle(item.astype(np.int64) % GROUPS, qty, price, GROUPS)


def check_grouped(table, exp, task: str, key: str = "g"):
    """The group set, MIN, MAX and AVG(qty) exact; SUM within 1e-9
    relative per group. Returns the largest relative SUM error."""
    g = table.column(key).to_numpy()
    order = np.argsort(g)
    cols = {n: table.column(n).to_numpy()[order] for n in
            ("s", "lo", "hi", "aq")}
    if table.num_rows != len(exp[key]) or not np.array_equal(
            g[order], exp[key]):
        raise AssertionError(f"{task}: {table.num_rows} groups, numpy "
                             f"{len(exp[key])}, or the group sets differ")
    if any(table.column(n).null_count for n in table.column_names):
        raise AssertionError(f"{task}: null results")
    rel = np.abs(cols["s"] - exp["s"]) / np.maximum(np.abs(exp["s"]),
                                                    1e-300)
    for n in ("lo", "hi", "aq"):
        if not np.array_equal(cols[n], exp[n]):
            raise AssertionError(f"{task}: {n} differs from numpy")
    if not (rel <= 1e-9).all():
        raise AssertionError(f"{task}: SUM off by {rel.max()} relative")
    return float(rel.max())


def grouped_phase(torch, rows: int, seed: int, kernels):
    """The grouped task (COMPLETE), then its map-side form: a PARTIAL
    task and a FINAL over its state batches."""
    import pyarrow as pa

    from blaze_tpu_torch.ops import AggMode, FileRange, ParquetScanExec
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime.executor import execute_task, run_plan

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "store_sales_grouped.parquet")
    results = {}
    try:
        t0 = time.perf_counter()
        exp = grouped_oracle(*write_store_sales(path, rows, seed))
        write_s = time.perf_counter() - t0
        scan = ParquetScanExec([[FileRange(path)]])

        blob = task_to_proto(grouped_plan(scan, AggMode.COMPLETE), 0)
        out, wall, launches, transfers = run_task(torch, blob, kernels)
        err = check_grouped(pa.Table.from_batches(out), exp, "grouped")
        for name in ("segment_reduce", "compact_perm"):
            if launches[name] <= 0:
                raise AssertionError(f"grouped did not launch {name}")
        results["grouped"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "path", "task": "grouped", "rows": rows,
              "groups": len(exp["g"]), "parquet_write_s": write_s,
              "wall_s": wall, "rows_per_s": rows / wall,
              "sum_max_rel_err": err, "launches": launches,
              "transfers": transfers})
        profile_task(torch, blob, "grouped", wall)

        partial = grouped_plan(scan, AggMode.PARTIAL)
        blob = task_to_proto(partial, 0)

        def two_phase():
            ctx = ExecContext(device="cuda")
            states = list(execute_task(blob, ctx))
            final = final_plan(states, partial.schema, ctx.device)
            return states, run_plan(final, ctx)

        (states, table), wall, launches, transfers = run_counted(
            torch, two_phase, kernels)
        err = check_grouped(table, exp, "grouped_partial")
        for name in ("segment_reduce", "compact_perm"):
            if launches[name] <= 0:
                raise AssertionError(f"grouped_partial did not launch {name}")
        results["grouped_partial"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "path", "task": "grouped_partial", "rows": rows,
              "state_batches": len(states),
              "state_rows": sum(b.num_rows for b in states),
              "groups": table.num_rows, "wall_s": wall,
              "rows_per_s": rows / wall, "sum_max_rel_err": err,
              "launches": launches, "transfers": transfers})
        profile_run(torch, two_phase, "grouped_partial", wall)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# phase 4, continued: the shuffle exchange and grace aggregation
# ---------------------------------------------------------------------------

# spark.sql.shuffle.partitions' default
SHUFFLE_PARTITIONS = 200
# map tasks of the exchange: each reads one of this many splits
MAP_SPLITS = 4
ITEMS = 1 << 17  # distinct item keys of store_sales


def exchange_map_plan(scan, data: str, index: str,
                      partitions: int = SHUFFLE_PARTITIONS):
    """The map stage of Spark's plan for bench.py's grouped_agg:
    PARTIAL aggregate by g, then a hash exchange on g."""
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import AggMode
    from blaze_tpu_torch.ops.shuffle_writer import ShuffleWriterExec

    return ShuffleWriterExec(grouped_plan(scan, AggMode.PARTIAL),
                             [Col("g")], partitions, data, index)


def exchange_reduce_plan(state_schema, partitions: int = SHUFFLE_PARTITIONS):
    """The reduce stage: the partition's shuffle segments, then FINAL."""
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import AggMode, HashAggregateExec
    from blaze_tpu_torch.ops.ipc_reader import IpcReaderExec, IpcReadMode

    reader = IpcReaderExec("shuffle", state_schema, partitions,
                           IpcReadMode.CHANNEL_AND_FILE_SEGMENT)
    return HashAggregateExec(reader, keys=[(Col("g"), "g")],
                             aggs=grouped_aggs(), mode=AggMode.FINAL)


def repartition_map_plan(scan, data: str, index: str,
                         partitions: int = SHUFFLE_PARTITIONS):
    """The map side of repartition(n, k), or of a sort-merge join on k:
    k = CAST(item AS BIGINT), price, qty, hash-exchanged on k."""
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import ProjectExec
    from blaze_tpu_torch.ops.shuffle_writer import ShuffleWriterExec
    from blaze_tpu_torch.types import DataType

    proj = ProjectExec(scan, [(Col("item").cast(DataType.int64()), "k"),
                              (Col("price"), "price"), (Col("qty"), "qty")])
    return ShuffleWriterExec(proj, [Col("k")], partitions, data, index)


def repartition_reduce_plan(schema, partitions: int = SHUFFLE_PARTITIONS):
    from blaze_tpu_torch.ops.ipc_reader import IpcReaderExec, IpcReadMode

    return IpcReaderExec("shuffle", schema, partitions,
                         IpcReadMode.CHANNEL_AND_FILE_SEGMENT)


def grace_plan(scan):
    """GROUP BY item (131,072 keys), keyed COMPLETE SUM/MIN/MAX(price),
    AVG(qty): over max_materialize_rows it takes grace aggregation."""
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import AggMode, HashAggregateExec

    return HashAggregateExec(scan, keys=[(Col("item"), "item")],
                             aggs=grouped_aggs(), mode=AggMode.COMPLETE)


def reduce_tasks(plan, outputs, partitions: int):
    """One TaskDefinition per reduce partition: `plan` over that
    partition's non-empty segment of each map output (data, index), in
    map order, shipped as the task's file resources."""
    from blaze_tpu_torch.io.ipc import partition_ranges
    from blaze_tpu_torch.ops.ipc_reader import FileSegment
    from blaze_tpu_torch.plan.serde import task_to_proto

    ranges = [partition_ranges(index) for _, index in outputs]
    blobs = []
    for r in range(partitions):
        segs = [FileSegment(data, *rng_[r])
                for (data, _), rng_ in zip(outputs, ranges) if rng_[r][1]]
        blobs.append(task_to_proto(plan, r, file_resources={"shuffle": segs}))
    return blobs


def run_stage(torch, blobs):
    """Run TaskDefinitions one after another on cuda; returns each
    task's Arrow batches and the sum of their metric counters."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import execute_task

    outs, counters = [], {}
    for blob in blobs:
        ctx = ExecContext(device="cuda")
        outs.append(list(execute_task(blob, ctx)))
        for k, v in ctx.metrics.counters.items():
            counters[k] = counters.get(k, 0) + v
    return outs, counters


def spark_pids(keys: np.ndarray, n: int) -> np.ndarray:
    """Spark's partition id of int32 or int64 keys, by the port's numpy
    host twins (an implementation apart from K4 and its torch chain)."""
    from blaze_tpu_torch.exprs import hashing

    if keys.dtype == np.int64:
        h = hashing._np_hash_long(keys, np.uint32(42))
    else:
        h = hashing._np_hash_int(keys.astype(np.int32).view(np.uint32),
                                 np.uint32(42))
    r = h.view(np.int32).astype(np.int64) % n
    return r.astype(np.int32)


def path_line(task: str, rows: int, wall: float, launches, transfers,
              **extra):
    emit({"phase": "path", "task": task, "rows": rows, "wall_s": wall,
          "rows_per_s": rows / wall, "launches": launches,
          "transfers": transfers, **extra})


def exchange_phase(torch, rows: int, seed: int, kernels):
    """The exchange_agg, repartition and grace paths over one
    store_sales table of `rows` rows cut into MAP_SPLITS files."""
    import pyarrow as pa

    from blaze_tpu_torch.ops import FileRange, ParquetScanExec
    from blaze_tpu_torch.plan.serde import task_to_proto

    work = os.path.join(REPO, "build", "chip_smoke_exchange")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    results = {}
    try:
        t0 = time.perf_counter()
        item, qty, price = store_sales_columns(rows, seed)
        split = rows // MAP_SPLITS
        paths = []
        for i in range(MAP_SPLITS):
            sl = slice(i * split, (i + 1) * split)
            paths.append(os.path.join(work, f"store_sales_{i}.parquet"))
            write_parquet(paths[-1], item[sl], qty[sl], price[sl])
        item, qty, price = (a[:split * MAP_SPLITS] for a in (item, qty, price))
        write_s = time.perf_counter() - t0

        # the scan's partition i is split i, which map task i reads
        splits = ParquetScanExec([[FileRange(p)] for p in paths])

        # exchange_agg: MAP_SPLITS map tasks, then the reduce tasks
        outputs = [(os.path.join(work, f"agg_{i}.data"),
                    os.path.join(work, f"agg_{i}.index"))
                   for i in range(MAP_SPLITS)]
        maps = [exchange_map_plan(splits, *outputs[i])
                for i in range(MAP_SPLITS)]
        map_blobs = [task_to_proto(m, i) for i, m in enumerate(maps)]
        reduce_plan = exchange_reduce_plan(maps[0].schema)

        def exchange_agg():
            _, mc = run_stage(torch, map_blobs)
            outs, _ = run_stage(torch, reduce_tasks(
                reduce_plan, outputs, SHUFFLE_PARTITIONS))
            return outs, mc

        (outs, mc), wall, launches, transfers = run_counted(
            torch, exchange_agg, kernels)
        tables = [pa.Table.from_batches(o) for o in outs if o]
        table = pa.concat_tables(tables)
        err = check_grouped(table, grouped_oracle(item, qty, price),
                            "exchange_agg")
        for r, o in enumerate(outs):
            for rb in o:
                g = rb.column(0).to_numpy()
                if not (spark_pids(g, SHUFFLE_PARTITIONS) == r).all():
                    raise AssertionError(
                        f"exchange_agg: reducer {r} holds a group of "
                        "another partition")
        for name in ("murmur3", "segment_reduce", "compact_perm"):
            if launches[name] <= 0:
                raise AssertionError(f"exchange_agg did not launch {name}")
        results["exchange_agg"] = {"launches": launches, "wall_s": wall}
        path_line("exchange_agg", rows, wall, launches, transfers,
                  map_tasks=MAP_SPLITS, reduce_tasks=SHUFFLE_PARTITIONS,
                  groups=table.num_rows, sum_max_rel_err=err,
                  parquet_write_s=write_s,
                  shuffle_bytes_written=mc["shuffle_bytes_written"],
                  shuffle_rows_written=mc["shuffle_rows_written"])
        profile_run(torch, exchange_agg, "exchange_agg", wall)

        # repartition: one map task over the first split, reduce to Arrow
        rp_out = [(os.path.join(work, "rp.data"),
                   os.path.join(work, "rp.index"))]
        rp_map = repartition_map_plan(splits, *rp_out[0])
        rp_blob = task_to_proto(rp_map, 0)
        rp_reduce = repartition_reduce_plan(rp_map.schema)

        def repartition():
            _, mc = run_stage(torch, [rp_blob])
            outs, _ = run_stage(torch, reduce_tasks(
                rp_reduce, rp_out, SHUFFLE_PARTITIONS))
            return outs, mc

        (outs, mc), wall, launches, transfers = run_counted(
            torch, repartition, kernels)
        k = item[:split].astype(np.int64)
        pid = spark_pids(k, SHUFFLE_PARTITIONS)
        for r, o in enumerate(outs):
            idx = np.flatnonzero(pid == r)
            got = pa.Table.from_batches(o) if o else None
            n_got = got.num_rows if got is not None else 0
            if n_got != len(idx) or (n_got and not (
                    np.array_equal(got.column("k").to_numpy(), k[idx])
                    and np.array_equal(got.column("price").to_numpy(),
                                       price[idx])
                    and np.array_equal(got.column("qty").to_numpy(),
                                       qty[idx]))):
                raise AssertionError(
                    f"repartition: partition {r} holds {n_got} rows, "
                    f"numpy {len(idx)}, or other rows or order")
        if launches["murmur3"] <= 0:
            raise AssertionError("repartition did not launch murmur3")
        results["repartition"] = {"launches": launches, "wall_s": wall}
        path_line("repartition", split, wall, launches, transfers,
                  reduce_tasks=SHUFFLE_PARTITIONS,
                  shuffle_bytes_written=mc["shuffle_bytes_written"],
                  shuffle_rows_written=mc["shuffle_rows_written"])
        profile_run(torch, repartition, "repartition", wall)

        # grace: one keyed COMPLETE task over the whole table
        g_blob = task_to_proto(grace_plan(ParquetScanExec(
            [[FileRange(p) for p in paths]])), 0)
        (outs, gc), wall, launches, transfers = run_counted(
            torch, lambda: run_stage(torch, [g_blob]), kernels)
        table = pa.Table.from_batches(outs[0])
        err = check_grouped(table, keyed_oracle(item, qty, price, ITEMS,
                                                "item"), "grace", "item")
        if launches["murmur3"] <= 0 or gc.get("external_agg_buckets", 0) < 2:
            raise AssertionError("grace did not bucket through murmur3")
        for name in ("segment_reduce", "compact_perm"):
            if launches[name] <= 0:
                raise AssertionError(f"grace did not launch {name}")
        results["grace"] = {"launches": launches, "wall_s": wall}
        path_line("grace", rows, wall, launches, transfers,
                  groups=table.num_rows, sum_max_rel_err=err,
                  external_agg_buckets=gc.get("external_agg_buckets", 0),
                  external_agg_rebuckets=gc.get("external_agg_rebuckets", 0),
                  external_agg_hot_buckets=gc.get(
                      "external_agg_hot_buckets", 0))
        profile_run(torch, lambda: run_stage(torch, [g_blob]), "grace", wall)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# phase 4, continued: the equi-joins
# ---------------------------------------------------------------------------

BRANDS = 4096  # i_brand of bench.py's item dimension, in [0, 4096)
# join types against pyarrow's Table.join
ARROW_JOIN = {"INNER": "inner", "LEFT": "left outer",
              "RIGHT": "right outer", "FULL": "full outer",
              "LEFT_SEMI": "left semi", "LEFT_ANTI": "left anti"}


def item_brands(rows: int, seed: int) -> np.ndarray:
    """i_brand of bench.py's item dimension (bench.py:881-888): drawn
    after the fact's item, qty, price and part columns from one
    generator."""
    rng = np.random.default_rng(seed)
    rng.integers(0, ITEMS, rows)
    rng.integers(1, 10, rows)
    rng.random(rows)
    rng.integers(0, 1 << 10, rows)
    return rng.integers(0, BRANDS, ITEMS).astype(np.int32)


def join_agg_plan(fact, dim, scale: int = 1):
    """bench.py's join_agg (bench.py:970-1024) on the port's operators:
    per brand SUM(price) and COUNT(*) over store_sales joined with the
    item dimension (the build side). With `scale` > 1 both keys are
    multiplied by it (a sparse key domain)."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col, Literal
    from blaze_tpu_torch.ops import (AggMode, HashAggregateExec,
                                     HashJoinExec, JoinType, ProjectExec)
    from blaze_tpu_torch.types import DataType

    def key(name):
        c = Col(name)
        return c if scale == 1 else c * Literal(scale, DataType.int32())

    build = dim if scale == 1 else ProjectExec(
        dim, [(key("i_item"), "i_item"), (Col("i_brand"), "i_brand")])
    probe = ProjectExec(fact, [(key("item"), "item"),
                               (Col("price"), "price")])
    join = HashJoinExec(build, probe, ["i_item"], ["item"], JoinType.INNER)
    return HashAggregateExec(
        ProjectExec(join, [(Col("i_brand"), "brand"),
                           (Col("price"), "price")]),
        keys=[(Col("brand"), "brand")],
        aggs=[(AggExpr(AggFn.SUM, Col("price")), "rev"),
              (AggExpr(AggFn.COUNT_STAR, None), "cnt")],
        mode=AggMode.COMPLETE)


def check_join_agg(table, item, price, brands, task: str, times: int = 1):
    """COUNT per brand equal to numpy's bincount(i_brand[item]) (times
    `times`: a dimension with each key that often), SUM within 1e-9
    relative of the float64 numpy oracle. Returns the largest relative
    SUM error."""
    b = brands[item]
    cnt = np.bincount(b, minlength=BRANDS) * times
    rev = np.bincount(b, price.astype(np.float64), minlength=BRANDS) * times
    got_b = table.column("brand").to_numpy()
    nz = np.flatnonzero(cnt)
    if not np.array_equal(np.sort(got_b), nz):
        raise AssertionError(f"{task}: {len(got_b)} brands, numpy {len(nz)}"
                             ", or the brand sets differ")
    if not np.array_equal(table.column("cnt").to_numpy(), cnt[got_b]):
        raise AssertionError(f"{task}: COUNT differs from numpy")
    exp = rev[got_b]
    rel = np.abs(table.column("rev").to_numpy() - exp) / np.maximum(
        np.abs(exp), 1e-300)
    if not (rel <= 1e-9).all():
        raise AssertionError(f"{task}: SUM off by {rel.max()} relative")
    return float(rel.max())


def join_ctx(max_rows: int):
    """A cuda context whose aggregate holds the whole join output
    (max_materialize_rows = `max_rows`) instead of bucketing it to disk:
    16,777,216 rows of (brand, price) take 134 MB of the card's 80 GB."""
    from blaze_tpu_torch.config import EngineConfig
    from blaze_tpu_torch.ops.base import ExecContext

    return ExecContext(device="cuda",
                       config=EngineConfig(max_materialize_rows=max_rows))


def join_task_line(torch, task, blob, rows, kernels, core, check,
                   max_rows, **extra):
    """Run one join task through execute_task, check it, gate its core
    and kernels, print its path line and profile it once more."""
    import pyarrow as pa

    from blaze_tpu_torch.runtime.executor import execute_task

    def run():
        return list(execute_task(blob, join_ctx(max_rows)))

    out, wall, launches, transfers = run_counted(torch, run, kernels)
    err = check(pa.Table.from_batches(out))
    if transfers.get("join_core." + core, 0) != 1:
        raise AssertionError(f"{task}: join core {core} not taken: "
                             f"{transfers}")
    for name in ("segment_reduce", "compact_perm"):
        if launches[name] <= 0:
            raise AssertionError(f"{task} did not launch {name}")
    batches = -(-rows // 16384)
    path_line(task, rows, wall, launches, transfers, sum_max_rel_err=err,
              join_core=core, probe_batches=batches,
              syncs_per_batch=transfers.get("d2h_syncs", 0) / batches,
              join_syncs={k: v for k, v in transfers.items()
                          if k.startswith("d2h_syncs.join")}, **extra)
    profile_run(torch, run, task, wall)
    return {"launches": launches, "wall_s": wall}


def id_pairs(table, left: str, right: str) -> np.ndarray:
    """The sorted (left id, right id) pairs of a join's output, a NULL
    id (the padded side of an outer join) as -1, packed in int64."""
    def ids(name):
        if name not in table.column_names:
            return np.full(table.num_rows, -1, np.int64)
        return table.column(name).fill_null(-1).to_numpy().astype(np.int64)

    return np.sort((ids(left) + 1) << 32 | (ids(right) + 1))


def join_types_check(torch, work, seed, kernels):
    """Every join type through HashJoinExec (no null-aware anti join
    there) and SortMergeJoinExec on 1,048,576 fact rows with NULL keys
    against a 131,072-row dimension whose keys repeat (the sorted core),
    as TaskDefinitions, against pyarrow's Table.join (NAAJ: numpy). A
    join's output is compared as its (dimension row, fact row) pairs."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.ops import (FileRange, HashJoinExec, JoinType,
                                     ParquetScanExec, SortMergeJoinExec)
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime.executor import execute_task

    rng = np.random.default_rng(seed + 7)
    n_fact, n_dim = 1 << 20, ITEMS
    dim = pa.table({
        "a": pa.array(rng.integers(0, ITEMS, n_dim).astype(np.int32),
                      mask=rng.random(n_dim) < 0.05),
        "aid": np.arange(n_dim, dtype=np.int32)})
    fact = pa.table({
        "b": pa.array(rng.integers(0, ITEMS + 4096, n_fact).astype(np.int32),
                      mask=rng.random(n_fact) < 0.05),
        "bid": np.arange(n_fact, dtype=np.int32),
        "y": rng.random(n_fact)})
    dim_nn = dim.set_column(0, "a", dim.column("a").fill_null(0))
    paths = {}
    for name, t in (("dim", dim), ("fact", fact), ("dim_nn", dim_nn)):
        paths[name] = os.path.join(work, f"jt_{name}.parquet")
        pq.write_table(t, paths[name], row_group_size=1 << 20)

    def scan(name):
        return ParquetScanExec([[FileRange(paths[name])]])

    checked = []
    for jt in JoinType:
        for kind in ("hash", "smj"):
            if kind == "hash" and jt is JoinType.LEFT_ANTI_NULL_AWARE:
                continue
            d = "dim_nn" if jt is JoinType.LEFT_ANTI_NULL_AWARE else "dim"
            if kind == "hash":
                op = HashJoinExec(scan(d), scan("fact"), ["a"], ["b"], jt)
            else:
                op = SortMergeJoinExec(scan("fact"), scan(d), ["b"], ["a"],
                                       jt)
            blob = task_to_proto(op, 0)
            out, wall, launches, transfers = run_counted(
                torch, lambda: list(execute_task(blob, join_ctx(1 << 22))),
                kernels)
            got = id_pairs(pa.Table.from_batches(out) if out
                           else pa.table({}), "aid", "bid")
            if jt is JoinType.LEFT_ANTI_NULL_AWARE:
                b = fact.column("b")
                keep = b.is_valid().to_numpy(zero_copy_only=False) & \
                    ~np.isin(b.fill_null(0).to_numpy(),
                             dim_nn.column("a").to_numpy())
                exp = np.sort(np.flatnonzero(keep).astype(np.int64) + 1)
            else:
                left, right, lk, rk = (dim, fact, "a", "b") \
                    if kind == "hash" else (fact, dim, "b", "a")
                exp = id_pairs(left.join(right, keys=lk, right_keys=rk,
                                         join_type=ARROW_JOIN[jt.name]),
                               "aid", "bid")
            if not np.array_equal(got, exp):
                raise AssertionError(
                    f"join {kind} {jt.name}: {len(got)} rows, pyarrow "
                    f"{len(exp)}, or the row pairs differ")
            if transfers.get("join_core.sorted", 0) < 1 or \
                    launches["murmur3_hashes"] <= 0:
                raise AssertionError(f"join {kind} {jt.name}: not on the "
                                     f"sorted core with K4 hashes")
            checked.append({"join": kind, "type": jt.name,
                            "rows": int(len(got)), "wall_s": wall,
                            "murmur3_hashes": launches["murmur3_hashes"]})
    return checked, paths


def grace_join_check(torch, work, paths, seed, kernels):
    """A sort-merge join whose fact side holds one key 300,000 times,
    with max_materialize_rows 200,000: both sides bucket through K4,
    the hot key's bucket is bucketed again at each depth and joined
    whole at the last. Equal to the unbucketed run, pair for pair."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.config import EngineConfig
    from blaze_tpu_torch.ops import (FileRange, JoinType, ParquetScanExec,
                                     SortMergeJoinExec)
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime.executor import execute_task

    fact = pq.read_table(paths["fact"])
    b = fact.column("b").fill_null(0).to_numpy().copy()
    valid = fact.column("b").is_valid().to_numpy(zero_copy_only=False)
    hot = int(pq.read_table(paths["dim"]).column("a").drop_null()[0]
              .as_py())
    b[:300_000] = hot
    valid[:300_000] = True
    hot_path = os.path.join(work, "jt_fact_hot.parquet")
    pq.write_table(fact.set_column(0, "b", pa.array(b, mask=~valid)),
                   hot_path, row_group_size=1 << 20)
    op = SortMergeJoinExec(ParquetScanExec([[FileRange(hot_path)]]),
                           ParquetScanExec([[FileRange(paths["dim"])]]),
                           ["b"], ["a"], JoinType.FULL)
    blob = task_to_proto(op, 0)
    ctx = ExecContext(device="cuda",
                      config=EngineConfig(max_materialize_rows=200_000))
    out, wall, launches, transfers = run_counted(
        torch, lambda: list(execute_task(blob, ctx)), kernels)
    ref = list(execute_task(blob, join_ctx(1 << 22)))
    got = id_pairs(pa.Table.from_batches(out), "aid", "bid")
    exp = id_pairs(pa.Table.from_batches(ref), "aid", "bid")
    c = ctx.metrics.counters
    counters = {k: c.get(k, 0) for k in ("external_join_buckets",
                                         "external_join_rebuckets",
                                         "external_join_hot_buckets")}
    if not np.array_equal(got, exp):
        raise AssertionError(f"grace join: {len(got)} rows, unbucketed "
                             f"{len(exp)}, or the pairs differ")
    if counters["external_join_rebuckets"] < 1 or \
            counters["external_join_hot_buckets"] < 1 or \
            launches["murmur3"] <= 0:
        raise AssertionError(f"grace join did not re-bucket through K4: "
                             f"{counters}")
    return {"rows": int(len(got)), "wall_s": wall, **counters,
            "murmur3": launches["murmur3"],
            "murmur3_hashes": launches["murmur3_hashes"]}


def join_phase(torch, rows: int, sorted_rows_: int, seed: int, kernels):
    """join_agg, join_kr and join_sorted through execute_task, then the
    join types, the grace join."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.ops import FileRange, ParquetScanExec
    from blaze_tpu_torch.plan.serde import task_to_proto

    work = os.path.join(REPO, "build", "chip_smoke_join")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    results = {}
    try:
        t0 = time.perf_counter()
        fact_path = os.path.join(work, "store_sales.parquet")
        item, qty, price = write_store_sales(fact_path, rows, seed)
        brands = item_brands(rows, seed)
        dim_path = os.path.join(work, "item.parquet")
        pq.write_table(pa.table({"i_item": np.arange(ITEMS, dtype=np.int32),
                                 "i_brand": brands}), dim_path)
        twice_path = os.path.join(work, "item_twice.parquet")
        pq.write_table(pa.table({
            "i_item": np.tile(np.arange(ITEMS, dtype=np.int32), 2),
            "i_brand": np.tile(brands, 2)}), twice_path)
        small_path = os.path.join(work, "store_sales_sorted.parquet")
        write_parquet(small_path, item[:sorted_rows_], qty[:sorted_rows_],
                      price[:sorted_rows_])
        write_s = time.perf_counter() - t0

        def scan(p):
            return ParquetScanExec([[FileRange(p)]])

        for task, fact, dim, scale, core, n, times in (
                ("join_agg", fact_path, dim_path, 1, "table_direct", rows,
                 1),
                ("join_kr", fact_path, dim_path, 16, "table_kr", rows, 1),
                ("join_sorted", small_path, twice_path, 1, "sorted",
                 sorted_rows_, 2)):
            blob = task_to_proto(join_agg_plan(scan(fact), scan(dim),
                                               scale), 0)
            results[task] = join_task_line(
                torch, task, blob, n, kernels, core,
                lambda t, task=task, n=n, times=times: check_join_agg(
                    t, item[:n], price[:n], brands, task, times),
                max_rows=times * rows, build_rows=times * ITEMS,
                key_scale=scale, parquet_write_s=write_s)
        if results["join_sorted"]["launches"]["murmur3_hashes"] <= 0:
            raise AssertionError("join_sorted did not launch K4 hashes")

        t0 = time.perf_counter()
        checked, paths = join_types_check(torch, work, seed, kernels)
        grace = grace_join_check(torch, work, paths, seed, kernels)
        emit({"phase": "join_types", "fact_rows": 1 << 20,
              "dim_rows": ITEMS, "oracle": "pyarrow Table.join; NAAJ numpy",
              "joins": checked, "grace": grace,
              "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# phase 4, continued: the window, sort, limit and union tasks
# ---------------------------------------------------------------------------

WINDOW_PARTS = 1 << 10  # bench.py's n_part
WINDOW_ALL_ROWS = 1 << 20
SORT_FULL_ROWS = 1 << 22
SPILL_ROWS, SPILL_LIMIT = 1 << 20, 1 << 18
UNION_SPLIT_ROWS, UNION_LIMIT = 1 << 20, 1000
TOPK = 100


def window_columns(rows: int, seed: int):
    """(item, qty, price, part) as bench.py:880-886 draws them."""
    rng = np.random.default_rng(seed)
    item = rng.integers(0, 1 << 17, rows).astype(np.int32)
    qty = rng.integers(1, 10, rows).astype(np.int32)
    price = (rng.random(rows) * 100).astype(np.float32)
    part = rng.integers(0, WINDOW_PARTS, rows).astype(np.int32)
    return item, qty, price, part


def window_plan(scan):
    """bench.py's window shape (bench.py:1094-1113) on the port's
    operators: a keyless SUM of row_number and of the running SUM(price)
    per part, ordered by price descending."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
    from blaze_tpu_torch.ops import (
        AggMode,
        HashAggregateExec,
        ProjectExec,
        SortKey,
        WindowExec,
        WindowFn,
    )
    from blaze_tpu_torch.types import DataType

    win = WindowExec(
        ProjectExec(scan, [(Col("part"), "part"), (Col("price"), "price")]),
        partition_by=[Col("part")],
        order_by=[SortKey(Col("price"), ascending=False)],
        functions=[WindowFn("row_number", None, "rk"),
                   WindowFn("sum", Col("price"), "run",
                            frame=("rows", None, 0))])
    return HashAggregateExec(
        win, keys=[],
        aggs=[(AggExpr(AggFn.SUM, Col("rk").cast(DataType.float64())),
               "rksum"),
              (AggExpr(AggFn.SUM, Col("run")), "runsum")],
        mode=AggMode.COMPLETE)


def window_oracle(part, price):
    """(rksum, runsum): Σ n_p(n_p+1)/2 exactly, and the sum of the
    float64 cumsums of each partition in numpy's stable lexsort order by
    (part, price descending)."""
    order = np.lexsort((-price.astype(np.float64), part))
    ps, pr = part[order], price[order].astype(np.float64)
    starts = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
    ends = np.r_[starts[1:], len(ps)]
    runsum = sum(float(np.cumsum(pr[a:b]).sum())
                 for a, b in zip(starts, ends))
    sizes = np.bincount(part, minlength=WINDOW_PARTS).astype(np.int64)
    return float((sizes * (sizes + 1) // 2).sum()), runsum


WINDOW_ALL_FRAMES = [None, ("rows", None, 0), ("rows", 2, 1),
                     ("range", None, 0), ("range", 2, 3)]
WINDOW_ALL_FNS = [("row_number", None, 1, None), ("rank", None, 1, None),
                  ("dense_rank", None, 1, None), ("ntile", None, 4, None),
                  ("percent_rank", None, 1, None),
                  ("cume_dist", None, 1, None), ("lag", "vi", 1, None),
                  ("lead", "vf", 2, None), ("lag", "vf", 0, None)] + [
    (k, s, 1, fr) for k in ("sum", "min", "max", "count", "avg")
    for s in ("vi", "vf") for fr in WINDOW_ALL_FRAMES]


def window_all_columns(rows: int, seed: int):
    """p (1024 partitions), o (an order key with ties), nullable vi
    (int32) and vf (float64, no NaN), and the row id."""
    rng = np.random.default_rng(seed)
    cols = {"p": rng.integers(0, WINDOW_PARTS, rows).astype(np.int32),
            "o": rng.integers(0, 200, rows).astype(np.int32),
            "vi": rng.integers(-1000, 1000, rows).astype(np.int32),
            "vf": rng.standard_normal(rows) * 100,
            "rid": np.arange(rows, dtype=np.int32)}
    valid = {"vi": rng.random(rows) > 0.1, "vf": rng.random(rows) > 0.1}
    return cols, valid


def window_all_plan(scan):
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import SortKey, WindowExec, WindowFn

    return WindowExec(
        scan, partition_by=[Col("p")], order_by=[SortKey(Col("o"))],
        functions=[WindowFn(k, None if s is None else Col(s), f"f{i}", off,
                            fr)
                   for i, (k, s, off, fr) in enumerate(WINDOW_ALL_FNS)])


def _sparse_extreme(x, a, b, fn, neutral):
    """fn (np.minimum or np.maximum) of x over the spans [a, b] (b < a
    empty), by a numpy sparse table."""
    length = np.maximum(b - a + 1, 1)
    k = np.floor(np.log2(length)).astype(np.int64)
    k = np.where((1 << (k + 1)) <= length, k + 1, k)
    k = np.where((1 << k) > length, k - 1, k)
    out = np.full(len(x), neutral, x.dtype)
    level, width, j = x.copy(), 1, 0
    while True:
        sel = k == j
        r = b[sel] - width + 1
        out[sel] = fn(level[a[sel]], level[r])
        if width >= int(length.max()):
            break
        level = fn(level, np.r_[level[width:], np.full(width, neutral,
                                                       x.dtype)])
        width <<= 1
        j += 1
    return np.where(b >= a, out, neutral)


def span_sums(x, s, a, b, starts):
    """Sums of x over the spans [a, b] inside each row's partition
    (which starts at s): differences of per-partition cumsums, each
    partition's own, so a sum's error scales with its partition."""
    pre = np.concatenate([np.cumsum(x[i:j]) for i, j in
                          zip(starts, np.r_[starts[1:], len(x)])])
    before = np.where(a > s, pre[np.maximum(a - 1, 0)], 0)
    return np.where(b >= a, pre[b] - before, 0)


def window_all_oracle(cols, valid):
    """{output: (values, validity, tolerance scale)} of every function in
    numpy, over the rows in numpy's stable lexsort order by (p, o); the
    scale (float sums and averages) is the frame's absolute sum."""
    order = np.lexsort((cols["o"], cols["p"]))
    n = len(order)
    pos = np.arange(n)
    P, O = cols["p"][order], cols["o"][order]
    pf = np.r_[True, P[1:] != P[:-1]]
    rf = pf | np.r_[True, O[1:] != O[:-1]]

    def bounds(flags):
        st = np.flatnonzero(flags)
        g = np.cumsum(flags) - 1
        return st[g], np.r_[st[1:], n][g]

    s, e = bounds(pf)
    rs, re_ = bounds(rf)
    starts = np.flatnonzero(pf)
    size = e - s
    rn = pos - s + 1
    rank = rs - s + 1
    dr = np.cumsum(rf)
    key = P.astype(np.int64) << 32 | O.astype(np.int64)
    spans = {
        None: (s, e - 1), ("rows", None, 0): (s, pos),
        ("rows", 2, 1): (np.maximum(s, pos - 2), np.minimum(e - 1, pos + 1)),
        ("range", None, 0): (s, re_ - 1),
        ("range", 2, 3): (np.searchsorted(key, key - 2, "left"),
                          np.searchsorted(key, key + 3, "right") - 1)}
    src = {k: (cols[k][order], valid[k][order]) for k in ("vi", "vf")}
    out = {}
    for i, (kind, name, off, frame) in enumerate(WINDOW_ALL_FNS):
        ok = np.ones(n, bool)
        scale = None
        if kind == "row_number":
            v = rn
        elif kind == "rank":
            v = rank
        elif kind == "dense_rank":
            v = dr - dr[s] + 1
        elif kind == "ntile":
            base, rem = size // off, size % off
            cut = rem * (base + 1)
            v = np.where(rn <= cut, (rn - 1) // (base + 1),
                         rem + (rn - 1 - cut) // np.maximum(base, 1)) + 1
        elif kind == "percent_rank":
            v = np.where(size > 1, (rank - 1) / np.maximum(size - 1, 1), 0.0)
        elif kind == "cume_dist":
            v = (re_ - s) / size
        elif kind in ("lag", "lead"):
            x, m = src[name]
            j = pos - off if kind == "lag" else pos + off
            inside = (j >= s) & (j < e)
            jc = np.clip(j, 0, n - 1)
            v, ok = x[jc], inside & m[jc]
        else:
            x, m = src[name]
            a, b = spans[frame]
            cnt = np.r_[0, np.cumsum(m)]
            c = np.where(b >= a, cnt[b + 1] - cnt[a], 0)
            if kind == "count":
                v = c
            elif kind in ("min", "max"):
                fn = np.minimum if kind == "min" else np.maximum
                neutral = (np.inf if kind == "min" else -np.inf) \
                    if x.dtype.kind == "f" else \
                    (np.iinfo(x.dtype).max if kind == "min"
                     else np.iinfo(x.dtype).min)
                v = _sparse_extreme(np.where(m, x, neutral), a, b, fn,
                                    neutral)
                ok = c > 0
            else:
                wide = np.int64 if x.dtype.kind == "i" else np.float64
                xz = np.where(m, x, 0).astype(wide)
                tot = span_sums(xz, s, a, b, starts)
                scale = span_sums(np.abs(xz.astype(np.float64)), s, a, b,
                                  starts)
                ok = c > 0
                if kind == "sum":
                    v = tot
                    if x.dtype.kind == "i":
                        scale = None
                else:
                    v = tot / np.maximum(c, 1)
                    scale = scale / np.maximum(c, 1)
        out[f"f{i}"] = (np.asarray(v), ok, scale)
    return order, out


def check_window_all(table, cols, valid):
    """Every output against the numpy oracle: ranking, lag/lead, counts,
    integer sums and MIN/MAX exactly; float sums and averages within
    1e-9 of the frame's absolute sum (per row for averages). Returns the
    largest float error, so scaled."""
    order, want = window_all_oracle(cols, valid)
    rid = table.column("rid").to_numpy()
    if not np.array_equal(rid, order.astype(np.int32)):
        raise AssertionError("window_all: rows not in numpy's stable "
                             "lexsort order")
    worst = 0.0
    for name, (v, ok, scale) in want.items():
        col = table.column(name).combine_chunks()
        got_ok = ~np.asarray(col.is_null())
        if not np.array_equal(got_ok, ok):
            raise AssertionError(f"window_all {name}: validity differs")
        got = col.fill_null(0).to_numpy(zero_copy_only=False)[ok]
        exp = v[ok]
        if scale is None:
            if not np.array_equal(got, exp.astype(got.dtype)):
                raise AssertionError(f"window_all {name}: values differ")
            continue
        err = np.abs(got - exp) / np.maximum(scale[ok], 1e-300)
        worst = max(worst, float(err.max(initial=0.0)))
        if worst > 1e-9:
            raise AssertionError(f"window_all {name}: error {worst}")
    return worst


def sort_plan(scan, keys, fetch=None, where=None):
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import FilterExec, SortExec, SortKey

    if where is not None:
        scan = FilterExec(scan, where)
    return SortExec(scan, [SortKey(Col(n), asc, True) for n, asc in keys],
                    fetch=fetch)


FULL_KEYS = [("qty", True), ("price", False), ("item", True)]


def sorted_rows(item, qty, price):
    """numpy's stable lexsort by FULL_KEYS."""
    return np.lexsort((item, -price.astype(np.float64), qty))


def same_rows(table, item, qty, price, order, task: str) -> None:
    for name, col in (("item", item), ("qty", qty), ("price", price)):
        got = table.column(name).to_numpy()
        if not np.array_equal(got, col[order]):
            raise AssertionError(f"{task}: column {name} differs from "
                                 "numpy's lexsort order")


def window_phase(torch, rows: int, seed: int, kernels):
    """window, window_all, sort_topk, sort_full (both sort cores),
    sort_spill and union_limit through execute_task."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from blaze_tpu_torch.config import EngineConfig, get_config, set_config
    from blaze_tpu_torch.exprs.ir import Col, Literal
    from blaze_tpu_torch.ops import (
        FileRange,
        FilterExec,
        LimitExec,
        ParquetScanExec,
        UnionExec,
    )
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.fused import FusedWindowAggExec, HostFinalAggExec
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime.executor import decode_task, execute_task
    from blaze_tpu_torch.types import DataType

    work = os.path.join(REPO, "build", "chip_smoke_window")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    results = {}

    def scan(p, cols=None):
        return ParquetScanExec([[FileRange(p)]], None, cols)

    def counted(task, blob, n, ctx=None, **extra):
        """Run a task, print its path line, profile it once more."""
        def run():
            return list(execute_task(blob, ctx or ExecContext(
                device="cuda")))
        out, wall, launches, transfers = run_counted(torch, run, kernels)
        routes = {k: v for k, v in transfers.items()
                  if k.split(".")[0] in ("sort_route", "sort_core",
                                         "window_route", "sort_spilled_runs",
                                         "host_sorts")}
        path_line(task, n, wall, launches, transfers,
                  syncs=transfers.get("d2h_syncs", 0), routes=routes,
                  **extra)
        profile_run(torch, run, task, wall)
        results[task] = {"launches": launches, "wall_s": wall}
        return pa.Table.from_batches(out) if out else None, launches, \
            transfers

    try:
        t0 = time.perf_counter()
        big = os.path.join(work, "store_sales_window.parquet")
        item, qty, price, part = window_columns(rows, seed)
        pq.write_table(pa.table({"item": item, "qty": qty, "price": price,
                                 "part": part}), big, compression="zstd",
                       row_group_size=1 << 20)
        write_s = time.perf_counter() - t0

        # window: bench.py's shape, whole-task fused
        blob = task_to_proto(window_plan(scan(big)), 0)
        op, _ = decode_task(blob, ExecContext(device="cuda"))
        if not (isinstance(op, HostFinalAggExec)
                and isinstance(op.children[0], FusedWindowAggExec)):
            raise AssertionError(f"window: decoded as {op.display()}")
        t0 = time.perf_counter()
        rk_want, run_want = window_oracle(part, price)
        oracle_s = time.perf_counter() - t0
        table, launches, transfers = counted(
            "window", blob, rows, parquet_write_s=write_s,
            oracle_s=oracle_s, plan=op.display().splitlines()[:2])
        rk, run = table.column("rksum")[0].as_py(), \
            table.column("runsum")[0].as_py()
        run_err = abs(run - run_want) / run_want
        if rk != rk_want or run_err > 1e-6:
            raise AssertionError(f"window: rksum {rk} vs {rk_want}, runsum "
                                 f"{run} vs {run_want} ({run_err})")
        if transfers.get("window_route.fused_agg") != 1 \
                or launches["masked_stats"] <= 0 \
                or launches["compact_perm"] <= 0:
            raise AssertionError("window: not FusedWindowAggExec with K1 "
                                 "and K2")
        emit({"phase": "window_check", "task": "window", "rksum": rk,
              "rksum_oracle": rk_want, "runsum": run,
              "runsum_oracle": run_want, "runsum_rel_err": run_err,
              "tolerance": "rksum exact; runsum 1e-6 relative of the "
                           "float64 per-partition cumsums"})

        # sort_topk: ORDER BY price DESC, item LIMIT 100 WHERE qty < 8
        where = Col("qty") < Literal(8, DataType.int32())
        blob = task_to_proto(sort_plan(
            scan(big, ["item", "qty", "price"]),
            [("price", False), ("item", True)], TOPK, where), 0)
        limit = min(1 << 22, rows // 4)  # the default at full size
        table, launches, transfers = counted(
            "sort_topk", blob, rows, ctx=ExecContext(
                device="cuda", config=EngineConfig(
                    max_materialize_rows=limit)),
            max_materialize_rows=limit)
        kept = np.flatnonzero(qty < 8)
        top = kept[np.lexsort((item[kept],
                               -price[kept].astype(np.float64)))[:TOPK]]
        same_rows(table, item, qty, price, top, "sort_topk")
        if transfers.get("sort_route.topk") != 1 \
                or launches["compact_perm"] <= 0:
            raise AssertionError("sort_topk: not the top-k route with K2")

        # sort_full: ORDER BY qty, price DESC, item over 4,194,304 rows
        n = min(rows, SORT_FULL_ROWS)
        full = os.path.join(work, "sort_full.parquet")
        write_parquet(full, item[:n], qty[:n], price[:n])
        order = sorted_rows(item[:n], qty[:n], price[:n])
        blob = task_to_proto(sort_plan(scan(full), FULL_KEYS), 0)
        saved = get_config()
        try:
            for core in ("scatter", "sort"):
                set_config(EngineConfig(sort_core=core))
                table, _, transfers = counted(f"sort_full_{core}", blob, n,
                                              sort_core=core)
                same_rows(table, item, qty, price, order,
                          f"sort_full_{core}")
                want = "packed" if core == "scatter" else "lexsort"
                if transfers.get(f"sort_core.{want}", 0) <= 0:
                    raise AssertionError(f"sort_full: core {want} not run")
        finally:
            set_config(saved)

        # sort_spill: the run merge past max_materialize_rows
        n = min(rows, SPILL_ROWS)
        spill = os.path.join(work, "sort_spill.parquet")
        write_parquet(spill, item[:n], qty[:n], price[:n])
        blob = task_to_proto(sort_plan(scan(spill), FULL_KEYS), 0)
        table, _, transfers = counted(
            "sort_spill", blob, n, ctx=ExecContext(
                device="cuda", config=EngineConfig(
                    max_materialize_rows=SPILL_LIMIT)),
            max_materialize_rows=SPILL_LIMIT)
        whole = pa.Table.from_batches(list(execute_task(
            blob, ExecContext(device="cuda"))))
        if not table.equals(whole):
            raise AssertionError("sort_spill: differs from the in-memory "
                                 "sort")
        if transfers.get("sort_spilled_runs", 0) < 4:
            raise AssertionError(f"sort_spill: {transfers}")

        # union_limit: UNION ALL of two splits, LIMIT 1000 over a filter
        splits = []
        split_rows = min(UNION_SPLIT_ROWS, rows // 2)
        for i in range(2):
            a, b = i * split_rows, (i + 1) * split_rows
            p = os.path.join(work, f"split{i}.parquet")
            write_parquet(p, item[a:b], qty[a:b], price[a:b])
            splits.append(p)
        plan = LimitExec(FilterExec(
            UnionExec([scan(p) for p in splits]),
            Col("qty") < Literal(5, DataType.int32())), UNION_LIMIT)
        for i, p in enumerate(splits):
            table, launches, _ = counted(f"union_limit_{i}",
                                         task_to_proto(plan, i),
                                         split_rows, partition=i)
            tbl = pq.read_table(p)
            want = tbl.filter(pc.less(tbl.column("qty"), 5)).slice(
                0, UNION_LIMIT)
            if not table.equals(want.combine_chunks().cast(table.schema)):
                raise AssertionError(f"union_limit partition {i} differs "
                                     "from pyarrow")
            if launches["compact_perm"] <= 0:
                raise AssertionError("union_limit did not launch K2")

        # window_all: every function and frame, output to Arrow
        n = min(rows, WINDOW_ALL_ROWS)
        cols, valid = window_all_columns(n, seed)
        wpath = os.path.join(work, "window_all.parquet")
        pq.write_table(pa.table({
            k: pa.array(v, mask=None if k not in valid else ~valid[k])
            for k, v in cols.items()}), wpath, compression="zstd")
        blob = task_to_proto(window_all_plan(scan(wpath)), 0)
        table, _, transfers = counted("window_all", blob, n,
                                      functions=len(WINDOW_ALL_FNS))
        t0 = time.perf_counter()
        worst = check_window_all(table, cols, valid)
        emit({"phase": "window_check", "task": "window_all",
              "functions": len(WINDOW_ALL_FNS), "float_max_err": worst,
              "oracle_s": time.perf_counter() - t0,
              "tolerance": "ranking, lag/lead, counts, integer sums, "
                           "MIN/MAX exact; float SUM/AVG within 1e-9 of "
                           "the frame's absolute sum"})
        if transfers.get("window_route.window") != 1:
            raise AssertionError("window_all: not WindowExec")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


def time_tree(torch, tree: str, rows: int):
    """The --compare timings of the checkout `tree`, whose
    blaze_tpu_torch this process imports."""
    sys.path.insert(0, os.path.abspath(tree))
    from blaze_tpu_torch.ops.hash_aggregate import _Scalar, _SegOps
    from blaze_tpu_torch.ops.kernels import _build, compact, stats

    _build.build(["stats", "compact", "segreduce"])
    rng = np.random.default_rng(7)
    out = {"phase": "compare", "tree": tree}

    def timed(fn):
        try:
            fn()
        except TypeError as e:  # a dtype the tree's kernel does not take
            return f"unsupported: {e}"
        return {"ms": cuda_ms(torch, fn),
                "device_us": device_ops(torch, fn)["device_us_per_call"]}

    # K1 as the keyless aggregate calls it (SUM and MIN of a masked
    # column, with whatever the tree does around the kernel) and alone
    for n in (16384, 1 << 24):
        m = torch.from_numpy(rng.random(n) < 0.5).cuda()
        for dt in (np.float32, np.int16):
            v = torch.from_numpy((rng.random(n) * 100).astype(dt)).cuda()
            out[f"k1_{np.dtype(dt).name}_{n}"] = {
                "scalar_sum": timed(lambda: _Scalar().sum(v, m)),
                "scalar_min": timed(lambda: _Scalar().extreme(True, v, m)),
                "masked_stats": timed(lambda: stats.masked_stats(v, m))}

    # (rows, slots, occupied slots): the grouped, PARTIAL and FINAL shapes
    for n, k, m in ((1 << 22, 16384, 4096), (16384, 32768, 16384),
                    (1032192, 16384, 4096)):
        gid = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).cuda()
        c = torch.from_numpy(rng.random(n) < 0.9).cuda()
        price = torch.from_numpy(
            (rng.random(n) * 100).astype(np.float32)).cuda()
        at = torch.from_numpy(rng.permutation(k)[:m].astype(np.int32)).cuda()
        red = _SegOps(gid, k, at)
        out[f"{n}x{k}"] = {
            "sum_float32_masked": timed(lambda: red.sum(price, c)),
            "count_bool": timed(lambda: red._count(c)),
            "min_float32_masked": timed(lambda: red.extreme(True, price, c))}
    for n in (16384, 32768, 1 << 16, 1 << 18, 1 << 24):
        keep = torch.from_numpy(rng.random(n) < 0.5).cuda()
        out[f"compact_perm_{n}"] = timed(lambda: compact.compact_perm(keep))
    emit(out)
    compare_paths(torch, tree, rows)


def compare_paths(torch, tree: str, rows: int, runs: int = 3):
    """The q6 and select tasks (this script's plans) through the tree's
    execute_task over one parquet file of `rows` rows: each task's wall
    `runs` times, its transfer and graph counts, then a profiled run
    (its own line) for the device calls and busy time."""
    from blaze_tpu_torch.ops import FileRange, ParquetScanExec
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime.executor import execute_task

    path = os.path.join(REPO, "build", "chip_smoke_compare",
                        f"store_sales_{rows}.parquet")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_store_sales(path + ".tmp", rows, 42)
        os.replace(path + ".tmp", path)
    for task, agg in (("q6", True), ("select", False)):
        blob = task_to_proto(
            q6_plan(ParquetScanExec([[FileRange(path)]]), agg), 0)

        def run():
            return list(execute_task(blob, ExecContext(device="cuda")))

        walls = []
        for _ in range(runs):
            _, wall, _, transfers = run_counted(torch, run, {})
            walls.append(wall)
        emit({"phase": "compare_path", "tree": tree, "task": task,
              "rows": rows, "walls_s": walls,
              "fusion": fusion_counts(transfers, rows),
              "transfers": transfers})
        profile_run(torch, run, f"{task}@{tree}", statistics.median(walls))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 24,
                    help="parquet rows of the path phase")
    ap.add_argument("--grouped-rows", type=int, default=1 << 22,
                    help="parquet rows of the grouped tasks")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--compare", metavar="DIR",
                    help="another checkout of the repository: time its K1, "
                         "K2 and keyed and keyless reductions against this "
                         "one's")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
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
    if args.tree:
        time_tree(torch, args.tree, args.rows)
        return 0
    smi = smi_line()
    if args.compare:
        print(smi, flush=True)
        for tree in (args.compare, REPO, REPO, args.compare):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree, "--rows", str(args.rows)],
                           check=True)
        print(smi_line(), flush=True)
        return 0
    sys.path.insert(0, REPO)

    # 1. device
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
    from blaze_tpu_torch.ops.kernels import (
        _build,
        compact,
        murmur3,
        segreduce,
        stats,
    )

    t0 = time.perf_counter()
    libs = _build.build(_build.SOURCES)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(str(p), REPO) for p in libs],
          "flags": _build.FLAGS})

    # 3. kernels against their plain versions, on the card
    rng = np.random.default_rng(args.seed)
    sizes = [16384, 1 << 24]
    # K1 at every size with storage offsets 0..15, at 2^24 and 2^24 + 3,
    # and at forced grids
    n1, k1_err = check_k1(torch, stats, rng, K1_SIZES, offsets=range(16))
    for more in (check_k1(torch, stats, rng, [1 << 24, (1 << 24) + 3],
                          offsets=(0, 5, 0, 3)),
                 check_k1(torch, stats, rng, [17, 16385, 1 << 20],
                          offsets=range(16), grids=K1_GRIDS)):
        n1 += more[0]
        k1_err = max(k1_err, more[1])
    k1_streams = k1_two_streams(torch, stats, rng, 1 << 24)
    if not k1_repeatable(torch, stats, rng, 1 << 24):
        raise AssertionError("K1: two float64 sums of one 2^24-row column "
                             "differ in their bits")
    n2, k2_err = check_k2(torch, compact, rng, K2_SIZES,
                          all_offsets=(4097, K2_TILE + 1))
    n2 += check_k2(torch, compact, rng, K2_GRID_SIZES, grids=K2_GRIDS)[0]
    timings = [time_kernels(torch, stats, compact, rng, n) for n in sizes]
    emit({"phase": "kernels", "k1_cases": n1, "k1_max_abs_err": k1_err,
          "k2_max_abs_err": k2_err,
          "k1_tolerance": "counts, min, max, int sums exact; "
                          "f64 sum |d| <= 1e-12 * sum|x|; each call twice "
                          "with equal bits",
          "k1_sizes": K1_SIZES + [1 << 24, (1 << 24) + 3],
          "k1_forced_grids": {"sizes": [17, 16385, 1 << 20],
                              "blocks": K1_GRIDS},
          "k1_two_stream_calls": k1_streams,
          "k1_f64_sum_repeatable": True,
          "k1_int16": [time_k1(torch, stats, rng, n, np.int16)
                       for n in sizes],
          # expr_chain's K1 shape: a float64 column of 16,384 rows
          "k1_float64": [time_k1(torch, stats, rng, 16384, np.float64)],
          "k1_grids_device_us": k1_grid_sweep(torch, stats, rng),
          "k2_cases": n2, "k2_sizes": K2_SIZES,
          "k2_forced_grids": {"sizes": K2_GRID_SIZES, "blocks": K2_GRIDS},
          "k2_tolerance": "permutation, tail, count equal to the plain "
                          "version and to numpy's flatnonzero",
          "timings": timings, "nvidia_smi": smi,
          "k1_library": "none: no single PyTorch call gives "
                        "(sum, min, max, count) of a masked column",
          "k2_library": "torch.nonzero(keep); it syncs with the host for "
                        "its output size"})
    # K3 at both domain ends (1024 and 2^23 segments), at the grouped
    # task's, the PARTIAL batch's and the FINAL's (the PARTIAL states,
    # 16,384 slots) shapes, and at a dense 256 KiB domain past one block's
    # copy, in both variants; timed at the path shapes, at 1024 segments
    # and at 32 rows a slot
    grouped_shape, partial_shape = (1 << 22, 16384), (16384, 32768)
    final_shape = (1032192, 16384)
    k3_shapes = [(16384, 1024), (1 << 22, 1024), grouped_shape,
                 partial_shape, final_shape, (1 << 22, 32768),
                 (1 << 22, 1 << 23)]
    n3, k3_err = check_k3(torch, segreduce, rng, k3_shapes)
    k3_timed = [grouped_shape, partial_shape, final_shape, (1 << 22, 1024),
                (1 << 19, 16384)]
    k3_times = [time_k3(torch, segreduce, rng, *sh) for sh in k3_timed]
    emit({"phase": "kernels", "k3_cases": n3, "k3_max_abs_err": k3_err,
          "k3_tolerance": "f64 sums |d| <= 1e-12 * sum|x| per segment; "
                          "int sums, min, max exact",
          "k3_f64_sum_repeatable": k3_repeatable(torch, segreduce, rng,
                                                 *grouped_shape),
          "k3_timings": k3_times, "nvidia_smi": smi,
          "k3_library": "index_add_ (sum, count), scatter_reduce_ amin "
                        "(min), over torch.where(contrib, widened column)"})
    emit({"phase": "kernel_profile", "nvidia_smi": smi,
          "calls": profile_kernel_calls(torch, stats, compact, segreduce,
                                        rng)})

    # K4 at the batch shape (the largest batch of the three new paths),
    # at the first ladder tier's 4096 rows and at 2^24 rows, for every
    # key type and partition count; at 2^24 rows, Spark's partition
    # counts and the first grace modulus
    n4, k4_covered = check_k4(torch, murmur3, rng, [16384, 4096])
    n4b, cov_b = check_k4(torch, murmur3, rng, [1 << 24], ns=(200, 1024, 32))
    k4_covered |= cov_b
    # timed at each path's shape (exchange_agg's g is nullable: `%` by
    # zero is NULL), and at 2^24 rows
    k4_times = [time_k4(torch, murmur3, rng, *a) for a in (
        (16384, "int32", True, SHUFFLE_PARTITIONS),
        (16384, "int64", False, SHUFFLE_PARTITIONS),
        (16384, "int32", False, 32),
        (1 << 24, "int32", False, SHUFFLE_PARTITIONS),
        (1 << 24, "int64", False, SHUFFLE_PARTITIONS))]
    emit({"phase": "kernels", "k4_cases": n4 + n4b, "k4_max_abs_err": 0,
          "k4_tolerance": "partition ids equal, bit for bit",
          "k4_timings": k4_times, "nvidia_smi": smi,
          "k4_library": "none: no PyTorch call computes Spark's murmur3"})
    # K4's `hashes` (the sorted join core) at the probe batch's 16,384
    # rows, at 2^24 rows and at check_k4's ragged sizes, with 1, 2 and 9
    # key columns; timed at the sorted path's shape (16,384 int32 keys)
    n4h, k4h_covered = check_k4_hashes(torch, murmur3, rng,
                                       [16384, 4096, 200, 2, 1])
    big = [c for c in k4_hash_cases()
           if c[0] in ("int32", "int64_null", "float64_null",
                       "int32+float64_null", "nine_columns")]
    more = check_k4_hashes(torch, murmur3, rng, [1 << 24], big)
    n4h += more[0]
    k4h_covered |= more[1]
    k4h_times = [time_k4_hashes(torch, murmur3, rng, *a) for a in (
        (16384, "int32", False), (1 << 24, "int32", False),
        (1 << 24, "int64", False))]
    emit({"phase": "kernels", "k4_hashes_cases": n4h,
          "k4_hashes_tolerance": "hashes equal to the torch chain, bit for "
                                 "bit; HASH_PAD past num_rows",
          "k4_hashes_timings": k4h_times, "nvidia_smi": smi})

    # 3b. CUDA graphs of the fused keyless aggregate against its eager run
    graph_phase(torch, stats, rng)

    # 4. the paths, noting the shape of every kernel launch
    kernels = {"masked_stats": stats, "compact_perm": compact,
               "segment_reduce": segreduce, "murmur3": murmur3}
    with launch_shapes(kernels) as seen:
        res = path_phase(torch, args.rows, args.seed, kernels)
        res.update(grouped_phase(torch, args.grouped_rows, args.seed,
                                 kernels))
        res.update(exchange_phase(torch, args.rows, args.seed, kernels))
        res.update(join_phase(torch, args.rows, args.grouped_rows,
                              args.seed, kernels))
        res.update(window_phase(torch, args.rows, args.seed, kernels))

    # 5. each kernel against its plain version at the launch shapes of
    # the paths that phase 3 did not check, then timed at the most
    # launched of them
    new = {"masked_stats": sorted(set(seen["masked_stats"]) - set(sizes)),
           "compact_perm": sorted(set(seen["compact_perm"])
                                  - set(K2_SIZES)),
           "segment_reduce": sorted(set(seen["segment_reduce"])
                                    - set(k3_shapes)),
           "murmur3": sorted(sh for sh in set(seen["murmur3"]) - k4_covered
                             if sh[1] != murmur3.HASH_PAD),
           "murmur3_hashes": sorted(
               sh for sh in set(seen["murmur3"]) - k4h_covered
               if sh[1] == murmur3.HASH_PAD)}
    extra = {"masked_stats": check_k1(torch, stats, rng, new["masked_stats"]),
             "compact_perm": check_k2(torch, compact, rng,
                                      new["compact_perm"]),
             "segment_reduce": check_k3(torch, segreduce, rng,
                                        new["segment_reduce"],
                                        variants=False),
             "murmur3": (check_k4_at(torch, murmur3, rng, new["murmur3"]),
                         0),
             "murmur3_hashes": (check_k4_hashes_at(
                 torch, murmur3, rng, new["murmur3_hashes"]), 0)}
    k1_err = max(k1_err, extra["masked_stats"][1])
    k2_err = max(k2_err, extra["compact_perm"][1])
    k3_err = max(k3_err, extra["segment_reduce"][1])

    def most_launched(name, done):
        return [sh for sh, _ in seen[name].most_common(8) if sh not in done]

    path_times = {
        "masked_stats": [time_k1(torch, stats, rng, n)
                         for n in most_launched("masked_stats", sizes)],
        "compact_perm": [time_k2(torch, compact, rng, n)
                         for n in most_launched("compact_perm", sizes)],
        "segment_reduce": [
            time_k3(torch, segreduce, rng, n, k, variants=False)
            for n, k in most_launched("segment_reduce", k3_timed)],
    }
    emit({"phase": "kernels_at_path_shapes",
          "path_shapes": {name: [[sh, c] for sh, c in sorted(v.items())]
                          for name, v in seen.items()},
          "checked_here": new,
          "cases": {name: v[0] for name, v in extra.items()},
          "max_abs_err": {"masked_stats": k1_err, "compact_perm": k2_err,
                          "segment_reduce": k3_err, "murmur3": 0,
                          "murmur3_hashes": 0},
          "timings": path_times, "nvidia_smi": smi})

    # summary: timings at the main path's batch shape, 16384 rows
    # (K1, K2) and at the grouped task's shape, the masked float64 SUM of
    # a float32 column (K3)
    main_t = dict(timings[0])
    main_t["segment_reduce"] = k3_times[0]["sum_float32_masked"]
    # K4 at exchange_agg's map-side shape: 16,384 nullable int32 keys,
    # 200 partitions
    main_t["murmur3"] = k4_times[0]
    # K4's hashes at join_sorted's probe batch: 16,384 int32 keys
    main_t["murmur3_hashes"] = k4h_times[0]
    # this slice's tasks: their launches are added to each kernel's
    summary = []
    slice_tasks = [t for t in res if t.startswith(("window", "sort_",
                                                   "union_limit"))]
    for name, src, replaces, task, err in (
        ("masked_stats", "blaze_tpu_torch/csrc/stats.cu",
         "blaze_tpu/ops/kernels/stats_pallas.py:75", "q6", k1_err),
        ("compact_perm", "blaze_tpu_torch/csrc/compact.cu",
         "blaze_tpu/ops/kernels/compact_pallas.py:78", "select", k2_err),
        ("segment_reduce", "blaze_tpu_torch/csrc/segreduce.cu",
         "blaze_tpu/ops/kernels/segreduce_pallas.py:127", "grouped",
         k3_err),
        ("murmur3", "blaze_tpu_torch/csrc/murmur3.cu",
         "blaze_tpu/ops/kernels/murmur3_pallas.py:104", "exchange_agg", 0),
        ("murmur3_hashes", "blaze_tpu_torch/csrc/murmur3.cu",
         "blaze_tpu/ops/kernels/murmur3_pallas.py:104", "join_sorted", 0),
    ):
        t = main_t[name]
        by_task = {k: res[k]["launches"][name] for k in [task] + slice_tasks
                   if k == task or res[k]["launches"][name]}
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_task.values()),
            "launches_by_task": by_task,
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
