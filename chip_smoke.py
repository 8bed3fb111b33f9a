#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`blaze_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # the full run: 8,388,608 parquet rows
                                     # (q6, select, expr_chain,
                                     # exchange_agg, grace, join_agg,
                                     # join_kr, window, sort_topk, the
                                     # planner and cluster tasks),
                                     # --grouped-rows 4,194,304
                                     # (grouped, join_sorted,
                                     # dec_grouped, dec_exchange),
                                     # --string-rows 8,388,608 fact
                                     # rows (tpcds_brand,
                                     # tpcds_customer)
    python3 chip_smoke.py --rows N --grouped-rows M --string-rows S
                                     # other depths
    python3 chip_smoke.py --compare DIR   # K1, K2, K3 and the q6,
                                          # select, grouped,
                                          # grouped_partial, join_agg
                                          # and join_kr tasks of
                                          # another checkout against
                                          # this one, timed

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
   float64. The grouped task runs the grouped carry: one graph replay a
   batch, none op by op, at most one readback a batch (the overflow
   guard) and exactly one fetch; the PARTIAL task one replay a batch
   (`fusion`, `syncs_per_batch`). Each kernel's launch count is zeroed
   before the task it serves and must be > 0 after it (K2 and K3
   counted at each replay of the graphs that hold them). Each task then
   runs once more under torch.profiler for its device busy time.
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
     `--rows` rows: it starts in the grouped carry, whose 16,384 slots
     it outgrows, so the carry must demote (`carry_demotions` >= 1);
     the per-batch states then pass max_materialize_rows in the device
     FINAL, so grace buckets them through K4; equal to a numpy oracle;
     its bucket counters printed.
   Each prints its wall, rows/s, launches, transfers and syncs;
   exchange_agg and repartition (whose 200 reduce tasks dominate) run
   once, under torch.profiler (grace's profiled rerun is cut for the
   script's time since the planner slice). Then the joins:
   - join_agg: bench.py's join_agg (bench.py:970-1024) through
     execute_task: the `--rows` store_sales file probes the 131,072-row
     item dimension (i_item = arange, i_brand in [0, 4096) as bench.py
     draws it) in a hash join, then per brand SUM(price), COUNT(*); the
     aggregate holds the join's whole output (max_materialize_rows =
     the row count). Per brand COUNT equal to numpy's
     bincount(i_brand[item]), SUM within 1e-9 relative of float64
     numpy; the join must take the dense direct table, and the probe
     fold into the aggregate's graph: one replay a probe batch, none op
     by op, at most one readback a probe batch past the build's;
   - join_kr: the same with both keys times 16 (the span past 8x the
     build rows): the fused key|row table, with the same gates (and a
     replay a build batch for the build's Project) (not profiled again
     since the planner slice, for the script's time);
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
   torch.profiler.
   Then dictionary-encoded strings in TPC-DS shapes (`strings_phase`):
   - tpcds_brand (q42/q52/q55): a `--string-rows` store_sales file
     (8,388,608 rows by default since the decimal slice, 16,777,216
     before) JOIN an
     item table of 131,072 rows (i_item_sk over the fact's item range;
     i_brand of about 1000 values, TPC-DS's 10 i_category, 100 i_class;
     parquet of 4 row groups), WHERE i_category = 'Books' (lowered to
     the host over the dictionary), GROUP BY i_brand_id, i_brand
     SUM(price * qty), ORDER BY the sum DESC, i_brand, LIMIT 100,
     through execute_task, against pyarrow's Table.join, group_by and
     sort_by (keys and order exact, sums within 1e-9 relative);
   - tpcds_customer (q4/q11's year total): the same fact rows JOIN a
     customer table of 1,048,576 rows (16-character c_customer_id, all
     distinct, 4 row groups with their own dictionaries) on item * 8 +
     qty % 8, GROUP BY c_customer_id, ORDER BY it, LIMIT 100, against
     numpy; then the aggregate as Spark plans it over a hash exchange on
     c_customer_id: 2,097,152 rows (4,194,304 before the cluster
     slice) in 4 map tasks (PARTIAL, the
     ShuffleWriter hashing the strings on the host) and 200 reduce
     tasks (FINAL), every group against numpy, each group's reducer and
     the partition ids of 65,536 customer ids bit for bit against a
     plain-Python Spark murmur3;
   - tpcds99: the 99 queries of tests/test_torch_tpcds.py on the card,
     BHJ flavour, at 200,000 store_sales rows, against the pandas
     oracles of tests/test_tpcds_queries.py (both files loaded by the
     source rewrite of tests/torch_tpcds_support.py); q67 and q86, where
     they differ, against the reference's rank-tolerant comparisons
     (tests/test_tpcds_exchange.py, loaded by the same rewrite): all 99
     must hold.
   Each prints its wall, rows/s, device calls, syncs, d2h_fetches and
   the string tier's counters (`strings` lines) and runs once more under
   torch.profiler (but tpcds_brand, since the planner slice).
   Then decimal128 (`decimal_phase`), price as TPC-DS's decimal(7, 2)
   (bench.py's float price rounded to unscaled cents):
   - the int128 primitives over 2^20 random limb pairs with the edge
     values (0, +-1, +-2^63, +-2^64, +-(10^38 - 1), +-2^127) on the
     card, bit for bit against the same ops on the CPU, and add and the
     multiply with a HALF_UP rescale against Python ints;
   - dec_q6: `price > 50.00 AND qty < 8` -> price * qty -> keyless SUM,
     AVG and COUNT(*) over `--rows` rows on the fused carry (one graph
     replay and one H2D copy a batch, 0 syncs), exactly equal to numpy
     int64 sums of cents and AVG HALF_UP in Python ints;
   - dec_grouped: `--grouped-rows` rows, g = item % 4096, keyed SUM and
     AVG of price and of price * qty (K3 over the four int64 chunk
     columns), every group exact;
   - dec_exchange: the same aggregate as PARTIAL, 1 map task into 200
     hash partitions (K4 on the int32 key), 200 FINAL reduce tasks over
     the segmented-IPC parts: exact, each group in its Spark partition;
   - dec_wide: 1,048,576 decimal(38, 10) rows straddling +-2^64 and
     +-10^37, with NULLs: a filter against a decimal(38, 10) literal,
     d + 1 and d * 3 (NULL past decimal(38)), ORDER BY d on the packed
     core, the lexsort core and the top-k route, and SUM by group (one
     group past decimal(38): NULL), against Python ints per row and
     numpy's lexsort of the limbs.
   Each prints its wall, rows/s, device busy ms, idle share, H2D copies
   and syncs (a batch on the scans) and K1-K4 launches (`decimal`
   lines) and runs once more under torch.profiler.
   Then the planner tier (`planner_phase`), each task a `planner` line
   with its wall, native and host nodes, map tasks, reduce partitions,
   shuffle and broadcast bytes, each scan's decoded columns and pushed
   conjuncts, `pushdown_filtered_rows`, its task retries and degraded
   partitions and rows (each must be 0) and K1-K4 launches:
   - plan_join_agg: bench.py's join_agg as a PlanSpec (`join_agg_spec`:
     the `--rows` fact file as 4 FileRange partitions, the item
     dimension, a bhj join, a COMPLETE aggregate) through
     `convert_plan`, `insert_exchanges` (8 partitions) and
     `run_plan_parallel` (the 4 map tasks on threads): every node
     native, `qty` not decoded, equal to check_join_agg's oracle; run
     once more under device-only profiling (the phase's one profile);
   - plan_q6: q6 as a PlanSpec (`q6_spec`) over the same 4 partitions
     through the same three calls: the keyless carry a map task on
     threads, a single exchange, the FINAL; 0 host nodes, 2 of 3
     columns decoded, equal to numpy, one graph replay and one H2D
     copy a scan batch while the other tasks' threads capture, replay
     and copy;
   - plan_fallback: the same spec at 1,048,576 rows with the hash join
     off: the join on the host engine, the spec's tags equal
     PLAN_FALLBACK_TAGS (the JAX package's, pinned by
     tests/test_torch_planner.py), equal to the oracle;
   - range_sort: ORDER BY price DESC, item over a 16-partition range
     ShuffleExchangeExec of the 4 partitions, a SortExec a partition:
     row for row numpy's stable lexsort, each partition within its
     sampled bounds;
   - tpcds_exchange: tests/test_tpcds_exchange.py on the card, its 99
     EXCHANGE_QUERIES (smj) through insert_exchanges at 4 partitions
     at 200,000 rows and its 6 PARQUET_QUERIES over parquet files with
     the scan hints installed with filters, against the pandas oracles
     (q67 and q86 may hold by rank tolerance).
   The q6 task of the path phase decodes 2 of its 3 columns (its line
   also times q6 without hints, with pruning only and with pruning and
   pushdown, in turns, warm).
   Then the task-entry and cluster tier (`cluster_phase`, last), over
   one `--rows` store_sales file as 4 byte ranges, 200 shuffle
   partitions and a MiniCluster of 2 worker processes on the card,
   each a `cluster` line with its wall and K1-K4 launches:
   - ref_q6: q6 in the reference's wire format (FINAL <- PARTIAL <-
     projection <- filter <- parquet scan of the 4 ranges, keyless),
     encoded field by field as tests/test_refwire_corpus.py encodes its
     fixtures and pinned to the generated reference parser, sent by
     cpp/blaze_client.cpp --ref to the port's TaskGatewayServer:
     COUNT exact, SUM within 1e-9 relative of numpy;
   - ref_corpus, over byte range 0: bench.py's grouped_agg as PARTIAL
     -> FINAL, join_agg through the CollectLeft hash join and through
     the sort-merge join, and a shuffle writer (PARTIAL by g, hash g
     into 200) whose 200 ipc_reader -> FINAL reduce tasks get their
     file segments in the client's --manifest, two connections at
     once; each against numpy, every group in its Spark partition;
   - cluster_exchange: exchange_agg's keyed aggregate with its map
     stage (4 tasks) through ClusterShuffleExchangeExec on the workers
     and the 200 FINAL partitions in this process: exact; the map and
     reduce walls, each worker's first task apart from its later ones,
     the K4 and K3 launches the workers made (their completion
     records), shuffle_bytes_written, retries and quarantines (each
     gated at 0); then its map stage over a 32nd of the rows (4 byte
     ranges of a row group each) on the 2 workers and on 4 threads in
     this process, in turns (`map_stage_compare`);
   - remote_exchange: the same through RemoteClusterShuffleExchangeExec:
     each worker's private directory, every block fetched over its
     BlockServer (segments and bytes fetched, both above 0), exact;
   - a cProfile of one exchange map task over the file's first row
     group and one reduce task of its output (`host_profile` lines: the top entries by cumulative and by own
     time, and parquet decode, zstd, the IPC stream per part, the
     scatter's device-to-host copy);
   - shuffle_manager: map 0 written by write_map_native on the card,
     map 1 by write_map_batches on the host, one shuffle; every reduce
     partition reads both, holds only its keys, all rows exactly once;
     host_partition_ids equal to K4's ids bit for bit at 16,384 rows
     and n = 200, for three key sets;
   - embed: q6 through the port's C++ embed host (csrc/blaze_embed*.cpp,
     g++ and python3-config --embed), CPython hosted in the host
     process, on the card: its Arrow C-Data checksums against numpy.
   The shape of every kernel launch on these paths is noted.
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
_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries `t_s`, the script's
    seconds so far (where the script's time goes, against its limit)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _START, 1)}
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


def check_keyed_fused(task: str, counts, batches: int, syncs: int,
                      fetches=None, other_replays: int = 0) -> None:
    """A keyed fused task (the grouped carry or the fused join): one
    graph replay a batch (and `other_replays`: a join build chain's), no
    batch run op by op, at most one readback a batch (`syncs`: the
    task's readbacks beyond a join build's) and, when `fetches` is
    given, exactly that many D2H fetches."""
    replays = batches + other_replays
    if (counts["graph_replays"] != replays
            or counts["graph_eager_batches"] != 0 or syncs > batches
            or (fetches is not None and counts["d2h_fetches"] != fetches)):
        raise AssertionError(
            f"{task}: {counts}, {syncs} readbacks - expected {replays} "
            f"graph replays, no eager batch, at most {batches} readbacks"
            + ("" if fetches is None else f", {fetches} fetch"))


def check_replays(task: str, counts) -> None:
    """One graph replay a scan batch."""
    if counts["graph_replays"] != counts["batches"]:
        raise AssertionError(f"{task}: {counts} - expected "
                             f"{counts['batches']} graph replays")


#: a join build's readbacks: its key span, duplicate check, insert
#: rounds and the probe-round bound of its table
BUILD_SYNCS = ("d2h_syncs.join_keyspan", "d2h_syncs.join_dup",
               "d2h_syncs.join_insert_round", "d2h_syncs.join_chain_round")


def probe_syncs(transfers) -> int:
    """A join task's readbacks past its build's (BUILD_SYNCS)."""
    return transfers.get("d2h_syncs", 0) - sum(
        transfers.get(k, 0) for k in BUILD_SYNCS)


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


def run_task(torch, blob, kernels, ctx=None):
    """One task through execute_task on cuda, counted (run_counted);
    `ctx` (a cuda ExecContext) to read the task's metrics after."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import execute_task

    return run_counted(
        torch, lambda: list(execute_task(
            blob, ctx if ctx is not None else ExecContext(device="cuda"))),
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
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the line reads device events alone, and the
    # host ops of a long task cost the profiler's post-processing more
    # than the task (join_kr's 5 s run took 53 s to profile with them)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    return profile_line(prof, task, wall, prof_wall)


def counted_profiled(torch, fn, task: str, kernels):
    """run_counted over ONE run under torch.profiler, for a long task
    that runs once: its wall is the profiled wall (the line says so).
    Only device activity is recorded: the line reads device events
    alone, and the host ops of a 200-task stage cost the profiler's
    post-processing more than the stage itself (tpcds_customer_exchange:
    a 33 s run, then 85 s)."""
    from torch.profiler import ProfilerActivity, profile

    held = {}

    def under():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        held["prof"] = prof
        return out

    out, wall, launches, transfers = run_counted(torch, under, kernels)
    line = profile_line(held["prof"], task, wall, wall)
    return out, wall, launches, transfers, line


def profile_line(prof, task: str, wall: float, prof_wall: float):
    """The profile line of a finished torch.profiler run."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    ours = [e for e in dev if any(
        k in e.key for k in ("masked_stats_kernel", "compact_small",
                             "compact_lookback", "seg_shared", "seg_global",
                             "seg_decode", "partition_ids"))]
    line = {"phase": "profile", "task": task,
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
                           for e in top]}
    emit(line)
    return line


def path_phase(torch, rows: int, seed: int, kernels):
    import pyarrow as pa
    import pyarrow.compute as pc

    from blaze_tpu_torch.ops import FileRange, ParquetScanExec
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.plan.serde import task_to_proto

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "store_sales.parquet")
    t0 = time.perf_counter()
    _, qty, price = write_store_sales(path, rows, seed)
    write_s = time.perf_counter() - t0
    results = {}
    try:
        # q6: filter -> project -> keyless SUM / COUNT(*), decoded with
        # the scan hints (item is never read; the host row filter is off
        # by default, so the device filter drops every row)
        blob = task_to_proto(
            q6_plan(ParquetScanExec([[FileRange(path)]]), True), 0)
        q6_ctx = ExecContext(device="cuda")
        out, wall, launches, transfers = run_task(torch, blob, kernels,
                                                  q6_ctx)
        exp_sum, _ = q6_oracle(qty, price)
        got_sum, got_n = check_q6(out, qty, price, "q6")
        if launches["masked_stats"] <= 0:
            raise AssertionError("q6 did not launch K1 masked_stats")
        fusion = fusion_counts(transfers, rows)
        check_fused("q6", fusion)
        decoded = scan_columns(q6_ctx)
        if decoded != (2, 3):
            raise AssertionError(f"q6 decoded {decoded[0]} of {decoded[1]} "
                                 "columns, not 2 of 3")
        in_turns = q6_hint_walls(torch, blob, kernels, qty, price)
        results["q6"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "path", "task": "q6", "rows": rows,
              "parquet_write_s": write_s, "wall_s": wall,
              "rows_per_s": rows / wall,
              "sum": got_sum, "count": got_n, "numpy_sum": exp_sum,
              "rel_err": abs(got_sum - exp_sum) / max(abs(exp_sum), 1.0),
              "launches": launches, "fusion": fusion,
              "columns_decoded": decoded[0], "columns_in_schema": decoded[1],
              "pushdown_filtered_rows": q6_ctx.metrics.counters.get(
                  "pushdown_filtered_rows", 0),
              "hints_in_turns": in_turns, "transfers": transfers})
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


def scan_columns(ctx):
    """(columns decoded, columns in the scans' schemas) of a one-scan,
    one-partition task, from its metrics."""
    c = ctx.metrics.counters
    return c.get("columns_decoded", 0), c.get("columns_in_schema", 0)


def q6_hint_walls(torch, blob, kernels, qty, price):
    """q6 without the scan hints (as before the planner slice: every
    column read, the device filter sees every row), with column pruning
    only, and with pruning and pushdown (as decoded), in turns, twice,
    all warm. Each run checked against numpy and gated on one graph
    replay and one H2D copy a batch; returns each variant's walls and
    the columns and rows its scan decoded."""
    from blaze_tpu_torch.ops import ParquetScanExec
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import decode_task, \
        execute_partition

    from blaze_tpu_torch.config import EngineConfig

    variants = ("none", "pruning", "pruning_pushdown")
    out = {v: [] for v in variants}
    for v in variants * 2:
        ctx = ExecContext(device="cuda", config=EngineConfig(
            host_filter_pushdown=v == "pruning_pushdown"))
        op, part = decode_task(blob, ctx)
        for o in _ops(op):
            if isinstance(o, ParquetScanExec):
                if v == "none":
                    o._hint_required = None
                if v != "pruning_pushdown":
                    o._hint_filters = ()
        task = f"q6 with hints {v}"
        res, wall, _, transfers = run_counted(
            torch, lambda: list(execute_partition(op, part, ctx)), kernels)
        check_q6(res, qty, price, task)
        check_fused(task, fusion_counts(transfers, len(qty)))
        decoded = scan_columns(ctx)
        out[v].append({"wall_s": wall, "columns_decoded": decoded[0],
                       "pushdown_filtered_rows": ctx.metrics.counters.get(
                           "pushdown_filtered_rows", 0)})
    return out


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
        # the grouped carry: one replay a batch, the guard's readback a
        # batch, one fetch at the end
        fusion = fusion_counts(transfers, rows)
        check_keyed_fused("grouped", fusion, fusion["batches"],
                          transfers.get("d2h_syncs", 0), fetches=1)
        results["grouped"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "path", "task": "grouped", "rows": rows,
              "groups": len(exp["g"]), "parquet_write_s": write_s,
              "wall_s": wall, "rows_per_s": rows / wall,
              "sum_max_rel_err": err, "launches": launches,
              "transfers": transfers, "fusion": fusion,
              "syncs_per_batch": transfers.get("d2h_syncs", 0)
              / fusion["batches"]})
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
        # the PARTIAL task: one replay a batch (the FINAL runs no graph)
        fusion = fusion_counts(transfers, rows)
        check_replays("grouped_partial", fusion)
        results["grouped_partial"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "path", "task": "grouped_partial", "rows": rows,
              "state_batches": len(states),
              "state_rows": sum(b.num_rows for b in states),
              "groups": table.num_rows, "wall_s": wall,
              "rows_per_s": rows / wall, "sum_max_rel_err": err,
              "launches": launches, "transfers": transfers,
              "fusion": fusion, "syncs_per_batch":
              transfers.get("d2h_syncs", 0) / fusion["batches"]})
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


def run_stage(torch, blobs, device="cuda"):
    """Run TaskDefinitions one after another on the card (or the CPU,
    to rehearse); returns each task's Arrow batches and the sum of their
    metric counters."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.executor import execute_task

    outs, counters = [], {}
    for blob in blobs:
        ctx = ExecContext(device=device)
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

        # 4 + 200 tasks: one run, under the profiler
        (outs, mc), wall, launches, transfers, _ = counted_profiled(
            torch, exchange_agg, "exchange_agg", kernels)
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
                  parquet_write_s=write_s, profiled_wall=True,
                  shuffle_bytes_written=mc["shuffle_bytes_written"],
                  shuffle_rows_written=mc["shuffle_rows_written"])

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

        # 1 + 200 tasks: one run, under the profiler
        (outs, mc), wall, launches, transfers, _ = counted_profiled(
            torch, repartition, "repartition", kernels)
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
                  reduce_tasks=SHUFFLE_PARTITIONS, profiled_wall=True,
                  shuffle_bytes_written=mc["shuffle_bytes_written"],
                  shuffle_rows_written=mc["shuffle_rows_written"])

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
        # 131,072 groups outgrow the carry's 16,384 slots: it demotes
        if transfers.get("carry_demotions", 0) < 1:
            raise AssertionError(f"grace: the grouped carry did not demote: "
                                 f"{transfers}")
        results["grace"] = {"launches": launches, "wall_s": wall}
        path_line("grace", rows, wall, launches, transfers,
                  carry_demotions=transfers["carry_demotions"],
                  fusion=fusion_counts(transfers, rows),
                  groups=table.num_rows, sum_max_rel_err=err,
                  external_agg_buckets=gc.get("external_agg_buckets", 0),
                  external_agg_rebuckets=gc.get("external_agg_rebuckets", 0),
                  external_agg_hot_buckets=gc.get(
                      "external_agg_hot_buckets", 0))
        # grace's profiled rerun is cut for the script's time (PERF.md
        # section 4)
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
                   max_rows, profile=True, build_replays=0, **extra):
    """Run one join task through execute_task, check it, gate its core
    and kernels, print its path line and (`profile`) profile it once
    more."""
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
    fusion = fusion_counts(transfers, rows)
    if core != "sorted":
        # the fused join+aggregate: one replay a probe batch, at most
        # the carry's guard a batch beyond the build's readbacks
        check_keyed_fused(task, fusion, batches, probe_syncs(transfers),
                          other_replays=build_replays)
    path_line(task, rows, wall, launches, transfers, sum_max_rel_err=err,
              join_core=core, probe_batches=batches, fusion=fusion,
              syncs_per_batch=transfers.get("d2h_syncs", 0) / batches,
              probe_syncs_per_batch=probe_syncs(transfers) / batches,
              join_syncs={k: v for k, v in transfers.items()
                          if k.startswith("d2h_syncs.join")}, **extra)
    if profile:
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
                # a scaled key is a Project on the build side: a graph
                # replay a build batch
                build_replays=0 if scale == 1 else -(-times * ITEMS // 16384),
                key_scale=scale, parquet_write_s=write_s,
                # join_kr's profiled rerun is cut for the script's time
                # (PERF.md section 4)
                profile=task != "join_kr")
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


# ---------------------------------------------------------------------------
# phase 4, continued: dictionary-encoded strings in TPC-DS shapes
# ---------------------------------------------------------------------------

#: TPC-DS's ten item categories (the dsdgen `categories` distribution)
CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry", "Men",
              "Music", "Shoes", "Sports", "Women"]
BRAND_IDS = 1000  # about 1000 distinct i_brand
CLASSES = 100  # about 100 distinct i_class
CUSTOMERS = 1 << 20
ROW_GROUPS = 4
CUSTOMER_EXCHANGE_ROWS = 1 << 22
PID_SAMPLE = 1 << 16
TPCDS99_ROWS = 200_000
#: queries that rank float sums: K3 adds floats with atomics in the
#: card's order, so sums pandas finds tied can come out ulps apart and
#: rank splits them. Such a query that differs from its oracle is held
#: to the reference's rank-tolerant comparison instead
#: (tests/test_tpcds_exchange.py), each sum within 1e-6 and each rank
#: achievable under the ties
TPCDS99_RANK_TOLERANT = ("q67", "q86")
_SYLLABLES = ["amalg", "brand", "corp", "edu pack", "exporti", "importo",
              "maxi", "namel", "scholar", "univ"]


def item_strings_table(seed: int):
    """The item dimension with TPC-DS's string columns: i_item_sk =
    0 .. ITEMS - 1 (the fact's item range), i_brand_id in [1, 1000] with
    its i_brand name (the brand decides the category, as TPC-DS's names
    carry it), i_category (TPC-DS's 10) and i_class (100)."""
    import pyarrow as pa

    rng = np.random.default_rng(seed + 101)
    bid = rng.integers(1, BRAND_IDS + 1, ITEMS).astype(np.int32)
    names = np.array([f"{_SYLLABLES[b % 10]}{_SYLLABLES[b // 10 % 10]} #{b}"
                      for b in range(BRAND_IDS + 1)], dtype=object)
    cats = np.array(CATEGORIES, dtype=object)
    classes = np.array([f"class {c:02d}" for c in range(CLASSES)],
                       dtype=object)
    return pa.table({
        "i_item_sk": np.arange(ITEMS, dtype=np.int32),
        "i_brand_id": bid,
        "i_brand": pa.array(names[bid].tolist()),
        "i_category": pa.array(cats[(bid * 7) % 10].tolist()),
        "i_class": pa.array(classes[rng.integers(0, CLASSES, ITEMS)]
                            .tolist()),
    })


def customer_ids(n: int) -> np.ndarray:
    """TPC-DS's 16-character c_customer_id ("AAAAAAAA" then the key in
    base 26), all distinct, as an (n, 16) uint8 array."""
    out = np.full((n, 16), ord("A"), dtype=np.uint8)
    k = np.arange(n, dtype=np.int64)
    for j in range(15, 7, -1):
        out[:, j] = ord("A") + k % 26
        k //= 26
    return out


def customer_table(seed: int):
    """customer: c_customer_sk 0 .. 2^20 - 1 in a random row order (so
    each of the 4 row groups holds its own dictionary, in no sorted
    order) and its c_customer_id."""
    import pyarrow as pa

    perm = np.random.default_rng(seed + 202).permutation(CUSTOMERS)
    ids = customer_ids(CUSTOMERS)[perm]
    offsets = (np.arange(CUSTOMERS + 1, dtype=np.int32) * 16)
    cid = pa.StringArray.from_buffers(CUSTOMERS, pa.py_buffer(offsets),
                                      pa.py_buffer(ids.tobytes()))
    return pa.table({"c_customer_sk": perm.astype(np.int32),
                     "c_customer_id": cid}), ids, perm


def customer_key(item, qty):
    """The fact's customer key, item * 8 + qty % 8, in [0, 2^20)."""
    return item.astype(np.int64) * 8 + qty % 8


def _spark_bytes(b: bytes, seed: int = 42) -> int:
    """Spark's Murmur3_x86_32.hashUnsafeBytes in plain Python: whole
    little-endian words, then each byte sign-extended through the whole
    mix (an oracle apart from the port's C++ chain)."""
    m = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & m

    def mix(h, k):
        k = rotl((k * 0xCC9E2D51) & m, 15) * 0x1B873593 & m
        return (rotl(h ^ k, 13) * 5 + 0xE6546B64) & m

    h = seed
    aligned = len(b) - len(b) % 4
    for i in range(0, aligned, 4):
        h = mix(h, int.from_bytes(b[i:i + 4], "little"))
    for x in b[aligned:]:
        h = mix(h, (x - 256 if x >= 128 else x) & m)
    h ^= len(b)
    h ^= h >> 16
    h = h * 0x85EBCA6B & m
    h ^= h >> 13
    h = h * 0xC2B2AE35 & m
    h ^= h >> 16
    return h - (1 << 32) if h >= 1 << 31 else h


def strings_line(task: str, rows: int, wall: float, launches, transfers,
                 prof, **extra):
    """The phase's own line: wall, rows/s, device calls, syncs and
    d2h_fetches, with the string tier's counters."""
    emit({"phase": "strings", "task": task, "rows": rows, "wall_s": wall,
          "rows_per_s": rows / wall,
          "device_calls": prof["device_calls"],
          "idle_share": prof["idle_share"],
          "syncs": transfers.get("d2h_syncs", 0),
          "d2h_fetches": transfers.get("d2h_fetches", 0),
          "h2d_copies": transfers.get("h2d_copies", 0),
          "host_lower_dictionary": transfers.get("host_lower_dictionary", 0),
          "host_lower_rows": transfers.get("host_lower_rows", 0),
          "host_hash_batches": transfers.get("host_hash_batches", 0),
          "launches": launches, "transfers": transfers, **extra})


def tpcds_brand_plan(fact, item):
    """TPC-DS q42/q52/q55's shape: store_sales JOIN item WHERE i_category
    = 'Books', GROUP BY i_brand_id, i_brand SUM(price * qty), ORDER BY
    the sum DESC, i_brand, LIMIT 100."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col, Literal
    from blaze_tpu_torch.ops import (AggMode, FilterExec, HashAggregateExec,
                                     HashJoinExec, JoinType, LimitExec,
                                     ProjectExec, SortExec, SortKey)
    from blaze_tpu_torch.types import DataType

    f64 = DataType.float64()
    books = FilterExec(item, Col("i_category") == Literal("Books",
                                                          DataType.utf8()))
    j = HashJoinExec(books, fact, ["i_item_sk"], ["item"], JoinType.INNER)
    p = ProjectExec(j, [(Col("i_brand_id"), "i_brand_id"),
                        (Col("i_brand"), "i_brand"),
                        (Col("price").cast(f64) * Col("qty").cast(f64),
                         "ext")])
    agg = HashAggregateExec(
        p, keys=[(Col("i_brand_id"), "i_brand_id"),
                 (Col("i_brand"), "i_brand")],
        aggs=[(AggExpr(AggFn.SUM, Col("ext")), "ext_price")],
        mode=AggMode.COMPLETE)
    return LimitExec(SortExec(agg, [SortKey(Col("ext_price"), False, False),
                                    SortKey(Col("i_brand"))]), 100)


def check_brand(table, item, qty, price, items):
    """Against pyarrow: Table.join, group_by, sort_by. Keys and order
    equal, sums within 1e-9 relative."""
    import pyarrow as pa
    import pyarrow.compute as pc

    fact = pa.table({"item": item, "ext": price.astype(np.float64)
                     * qty.astype(np.float64)})
    books = items.filter(pc.equal(items.column("i_category"), "Books"))
    j = fact.join(books, keys="item", right_keys="i_item_sk",
                  join_type="inner")
    g = j.group_by(["i_brand_id", "i_brand"]).aggregate([("ext", "sum")])
    exp = g.sort_by([("ext_sum", "descending"),
                     ("i_brand", "ascending")]).slice(0, 100)
    for col in ("i_brand_id", "i_brand"):
        if table.column(col).to_pylist() != exp.column(col).to_pylist():
            raise AssertionError(f"tpcds_brand: {col} differs from pyarrow")
    got_s = table.column("ext_price").to_numpy()
    exp_s = exp.column("ext_sum").to_numpy()
    rel = np.abs(got_s - exp_s) / np.maximum(np.abs(exp_s), 1e-300)
    if not (rel <= 1e-9).all():
        raise AssertionError(f"tpcds_brand: sums off by {rel.max()}")
    return float(rel.max()), len(exp)


def tpcds_customer_plan(fact, customer, partial=False):
    """q4/q11's year-total shape: per c_customer_id SUM(price * qty) over
    store_sales JOIN customer; ORDER BY c_customer_id LIMIT 100 (or the
    PARTIAL aggregate of a map task)."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col, Literal
    from blaze_tpu_torch.ops import (AggMode, HashAggregateExec,
                                     HashJoinExec, JoinType, LimitExec,
                                     ProjectExec, SortExec, SortKey)
    from blaze_tpu_torch.types import DataType

    f64, i32 = DataType.float64(), DataType.int32()
    probe = ProjectExec(fact, [
        (Col("item") * Literal(8, i32) + Col("qty") % Literal(8, i32),
         "ss_customer_sk"),
        (Col("price").cast(f64) * Col("qty").cast(f64), "ext")])
    j = HashJoinExec(customer, probe, ["c_customer_sk"], ["ss_customer_sk"],
                     JoinType.INNER)
    p = ProjectExec(j, [(Col("c_customer_id"), "c_customer_id"),
                        (Col("ext"), "ext")])
    agg = HashAggregateExec(
        p, keys=[(Col("c_customer_id"), "c_customer_id")],
        aggs=[(AggExpr(AggFn.SUM, Col("ext")), "year_total")],
        mode=AggMode.PARTIAL if partial else AggMode.COMPLETE)
    if partial:
        return agg
    return LimitExec(SortExec(agg, [SortKey(Col("c_customer_id"))]), 100)


def customer_oracle(item, qty, price):
    """Per customer key: (row count, float64 sum of price * qty)."""
    key = customer_key(item, qty)
    ext = price.astype(np.float64) * qty.astype(np.float64)
    return (np.bincount(key, minlength=CUSTOMERS),
            np.bincount(key, ext, minlength=CUSTOMERS))


def check_customer_rows(ids_got, sums_got, cnt, tot, ids_by_key, task):
    """Each (c_customer_id, sum) against the oracle's key; returns the
    largest relative error."""
    lookup = {bytes(r): k for k, r in enumerate(ids_by_key)}
    keys = np.array([lookup[s.encode()] for s in ids_got], dtype=np.int64)
    if (cnt[keys] == 0).any():
        raise AssertionError(f"{task}: a group of no row")
    exp = tot[keys]
    rel = np.abs(np.asarray(sums_got) - exp) / np.maximum(np.abs(exp),
                                                          1e-300)
    if not (rel <= 1e-9).all():
        raise AssertionError(f"{task}: sums off by {rel.max()}")
    return float(rel.max()) if len(rel) else 0.0


def tpcds99_check(rows: int, device: str):
    """The CPU twin's query set (tests/test_torch_tpcds.py) on the card,
    BHJ flavour: all 99 queries of tests/tpcds_support.py against the
    pandas oracles of tests/test_tpcds_queries.py, loaded by the same
    source rewrite (no JAX); q67 and q86, where they differ, against
    the reference's rank-tolerant comparisons. Returns (the queries
    equal to their oracles, {query: why it passed by rank tolerance})."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_tpcds_support

    from blaze_tpu_torch.config import EngineConfig, get_config, set_config
    from blaze_tpu_torch.runtime.executor import run_plan

    support, queries = torch_tpcds_support.load(rows)
    tolerant = torch_tpcds_support.rank_tolerant(queries)
    old = get_config()
    by_rank = {}
    set_config(EngineConfig(
        device=device, batch_size=max(rows, 1 << 20),
        shape_buckets=(256, 1024, 4096, 16384, 65536, 262144, 1 << 20,
                       max(rows, 1 << 20))))
    passed, failed = [], {}
    try:
        tables = support.gen_tables()
        scans = support.scans_of(tables)
        for q in torch_tpcds_support.query_order(support.QUERIES):
            got = run_plan(support.QUERIES[q](scans, "bhj")).to_pandas()
            exp = queries.ORACLES[q](tables)
            exp.columns = list(got.columns)
            try:
                queries.assert_frames_match(got, exp, f"{q}/bhj")
                passed.append(q)
            except AssertionError as e:
                if q not in TPCDS99_RANK_TOLERANT:
                    failed[q] = repr(e)[:300]
                    continue
                try:
                    if len(got) != len(exp):
                        raise AssertionError(
                            f"{len(got)} rows, oracle {len(exp)}")
                    if q == "q67":
                        tolerant._assert_rank_tolerant_q67(
                            got, queries.q67_rolled_frame(tables))
                    else:
                        tolerant._assert_rank_tolerant_q86(
                            got, queries.q86_rolled_frame(tables))
                except AssertionError as e2:
                    failed[q] = repr(e2)[:300]
                    continue
                by_rank[q] = (
                    "differs from the oracle's frame at " + repr(e)[:120]
                    + "; every sum within 1e-6 of the oracle's and every "
                    "rank achievable under ties of float sums K3 adds in "
                    "the card's order (_assert_rank_tolerant_" + q + ")")
    finally:
        set_config(old)
    if failed:
        raise AssertionError(f"tpcds99: {len(failed)} queries differ from "
                             f"their oracles: {failed}")
    return passed, by_rank


def strings_phase(torch, rows: int, seed: int, kernels, device="cuda"):
    """tpcds_brand, tpcds_customer (one task over `rows`, then the
    exchange over CUSTOMER_EXCHANGE_ROWS) and tpcds99."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.config import EngineConfig
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
    from blaze_tpu_torch.ops import (AggMode, FileRange, HashAggregateExec,
                                     IpcReaderExec, IpcReadMode,
                                     ParquetScanExec, ShuffleWriterExec)
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.shuffle_writer import spark_partition_ids
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime.executor import execute_task

    work = os.path.join(REPO, "build", "chip_smoke_strings")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    results = {}

    def ctx():
        # the aggregate holds its whole input (max_materialize_rows =
        # the fact rows), as join_agg does
        return ExecContext(device=device, config=EngineConfig(
            device=device, max_materialize_rows=max(rows, 1 << 22)))

    def scan(p):
        return ParquetScanExec([[FileRange(p)]])

    def counted(task, blob, n, profile=True, **extra):
        def run():
            return list(execute_task(blob, ctx()))
        out, wall, launches, transfers = run_counted(torch, run, kernels)
        prof = profile_run(torch, run, task, wall) if profile else {
            "device_calls": "not measured", "idle_share": "not measured"}
        strings_line(task, n, wall, launches, transfers, prof, **extra)
        results[task] = {"launches": launches, "wall_s": wall}
        return pa.Table.from_batches(out) if out else None

    try:
        t0 = time.perf_counter()
        fact_path = os.path.join(work, "store_sales.parquet")
        item, qty, price = write_store_sales(fact_path, rows, seed)
        items = item_strings_table(seed)
        item_path = os.path.join(work, "item.parquet")
        pq.write_table(items, item_path, row_group_size=ITEMS // ROW_GROUPS)
        customers, ids, perm = customer_table(seed)
        cust_path = os.path.join(work, "customer.parquet")
        pq.write_table(customers, cust_path,
                       row_group_size=CUSTOMERS // ROW_GROUPS)
        ids_by_key = np.empty_like(ids)
        ids_by_key[perm] = ids
        write_s = time.perf_counter() - t0

        # tpcds_brand
        got = counted("tpcds_brand",
                      task_to_proto(tpcds_brand_plan(scan(fact_path),
                                                     scan(item_path)), 0),
                      rows, item_rows=ITEMS, row_groups=ROW_GROUPS,
                      parquet_write_s=write_s,
                      # its profiled rerun is cut for the script's time
                      # (PERF.md section 4)
                      profile=False)
        err, n_out = check_brand(got, item, qty, price, items)
        emit({"phase": "strings_check", "task": "tpcds_brand",
              "oracle": "pyarrow Table.join, group_by, sort_by",
              "rows_out": n_out, "sum_max_rel_err": err,
              "equal": "i_brand_id, i_brand and their order exactly"})

        # tpcds_customer: one task over every fact row
        got = counted("tpcds_customer",
                      task_to_proto(tpcds_customer_plan(
                          scan(fact_path), scan(cust_path)), 0),
                      rows, customer_rows=CUSTOMERS, row_groups=ROW_GROUPS)
        cnt, tot = customer_oracle(item, qty, price)
        present = np.flatnonzero(cnt)
        order = np.argsort(ids_by_key[present].view("S16").ravel(),
                           kind="stable")
        exp_ids = [bytes(ids_by_key[k]).decode()
                   for k in present[order][:100]]
        got_ids = got.column("c_customer_id").to_pylist()
        if got_ids != exp_ids:
            raise AssertionError("tpcds_customer: the first 100 "
                                 "c_customer_id differ from numpy's")
        err = check_customer_rows(got_ids,
                                  got.column("year_total").to_numpy(),
                                  cnt, tot, ids_by_key, "tpcds_customer")

        # the same aggregate over Spark's hash exchange on c_customer_id
        n_ex = min(rows, CUSTOMER_EXCHANGE_ROWS)
        split = n_ex // MAP_SPLITS
        paths = []
        for i in range(MAP_SPLITS):
            sl = slice(i * split, (i + 1) * split)
            paths.append(os.path.join(work, f"store_sales_{i}.parquet"))
            write_parquet(paths[-1], item[sl], qty[sl], price[sl])
        n_ex = split * MAP_SPLITS
        splits = ParquetScanExec([[FileRange(p)] for p in paths])
        outputs = [(os.path.join(work, f"cust_{i}.data"),
                    os.path.join(work, f"cust_{i}.index"))
                   for i in range(MAP_SPLITS)]
        partial = tpcds_customer_plan(splits, scan(cust_path), partial=True)
        map_blobs = [task_to_proto(ShuffleWriterExec(
            partial, [Col("c_customer_id")], SHUFFLE_PARTITIONS,
            *outputs[i]), i) for i in range(MAP_SPLITS)]
        reduce_plan = HashAggregateExec(
            IpcReaderExec("shuffle", partial.schema, SHUFFLE_PARTITIONS,
                          IpcReadMode.CHANNEL_AND_FILE_SEGMENT),
            keys=[(Col("c_customer_id"), "c_customer_id")],
            aggs=[(AggExpr(AggFn.SUM, Col("year_total")), "year_total")],
            mode=AggMode.FINAL)

        def exchange():
            _, written = run_stage(torch, map_blobs, device)
            outs, counters = run_stage(torch, reduce_tasks(
                reduce_plan, outputs, SHUFFLE_PARTITIONS), device)
            return outs, {**counters, **written}

        # 4 + 200 tasks: one run, under the profiler
        (outs, counters), wall, launches, transfers, prof = \
            counted_profiled(torch, exchange, "tpcds_customer_exchange",
                             kernels)
        cnt_ex, tot_ex = customer_oracle(item[:n_ex], qty[:n_ex],
                                         price[:n_ex])
        all_ids, all_sums, sample = [], [], []
        for r, batches in enumerate(outs):
            for rb in batches:
                cid = rb.column(0).to_pylist()
                all_ids += cid
                all_sums += rb.column(1).to_pylist()
                if len(sample) < PID_SAMPLE:
                    sample += [(c, r) for c in cid[:PID_SAMPLE
                                                   - len(sample)]]
        if len(all_ids) != int((cnt_ex > 0).sum()) or \
                len(set(all_ids)) != len(all_ids):
            raise AssertionError("tpcds_customer_exchange: groups differ "
                                 "from numpy's")
        ex_err = check_customer_rows(all_ids, all_sums, cnt_ex, tot_ex,
                                     ids_by_key, "tpcds_customer_exchange")
        bad = [c for c, r in sample
               if _spark_bytes(c.encode()) % SHUFFLE_PARTITIONS != r]
        if bad:
            raise AssertionError(f"tpcds_customer_exchange: {len(bad)} "
                                 "groups in a reducer Spark would not send "
                                 "them to")
        # and the map side's partition ids of 65,536 customer ids, bit for
        # bit against the Python oracle
        sample_rb = customers.slice(0, PID_SAMPLE).to_batches()[0]
        from blaze_tpu_torch.batch import ColumnBatch
        from blaze_tpu_torch.exprs.ir import BoundCol
        from blaze_tpu_torch.types import DataType

        cb = ColumnBatch.from_arrow(sample_rb, device=device)
        pid = spark_partition_ids(cb, [BoundCol(1, DataType.utf8())],
                                  SHUFFLE_PARTITIONS).cpu().numpy()
        exp_pid = [_spark_bytes(c.encode()) % SHUFFLE_PARTITIONS
                   for c in sample_rb.column(1).to_pylist()]
        if not np.array_equal(pid[:PID_SAMPLE], exp_pid):
            raise AssertionError("partition ids of c_customer_id differ "
                                 "from the Python Spark oracle")
        strings_line("tpcds_customer_exchange", n_ex, wall, launches,
                     transfers, prof, profiled_wall=True,
                     map_tasks=MAP_SPLITS,
                     partitions=SHUFFLE_PARTITIONS, groups=len(all_ids),
                     shuffle_bytes=counters.get("shuffle_bytes_written", 0))
        results["tpcds_customer_exchange"] = {"launches": launches,
                                              "wall_s": wall}
        emit({"phase": "strings_check", "task": "tpcds_customer",
              "oracle": "numpy bincount over the join key; ids by byte "
                        "order", "first_100_ids_equal": True,
              "sum_max_rel_err": err, "exchange_groups": len(all_ids),
              "exchange_sum_max_rel_err": ex_err,
              "pid_sample": PID_SAMPLE, "pid_reducers_checked": len(sample),
              "pid_oracle": "Python Murmur3_x86_32.hashUnsafeBytes, bit "
                            "for bit"})

        # tpcds99: the CPU twin's 99 queries on the card (the wall holds
        # the tables' generation and the pandas oracles too)
        def q99():
            return tpcds99_check(TPCDS99_ROWS, device)

        (passed, by_rank), wall, launches, transfers, prof = \
            counted_profiled(torch, q99, "tpcds99", kernels)
        if len(passed) + len(by_rank) != 99:
            raise AssertionError(f"tpcds99: {len(passed) + len(by_rank)} "
                                 "of 99 queries held")
        strings_line("tpcds99", TPCDS99_ROWS, wall, launches, transfers,
                     prof, profiled_wall=True, flavour="bhj",
                     queries_run=len(passed) + len(by_rank),
                     passed=len(passed) + len(by_rank),
                     equal_to_oracle=len(passed), rank_tolerant=by_rank,
                     oracle="pandas oracles of tests/test_tpcds_queries.py; "
                            "q67 and q86 where they differ: the rank-"
                            "tolerant comparisons of "
                            "tests/test_tpcds_exchange.py")
        results["tpcds99"] = {"launches": launches, "wall_s": wall}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# phase 4, continued: decimal128
# ---------------------------------------------------------------------------

DEC_WIDE_ROWS = 1 << 20
#: the wide filter's literal: decimal(38, 10) 500000000.0000000000, an
#: unscaled value inside the wire's int64 literal
DEC_WIDE_PIVOT = 5 * 10**18
DEC38 = 10**38 - 1
_U64 = (1 << 64) - 1


def decimal_array(unscaled, p: int, s: int, null=None):
    """A pyarrow decimal128(p, s) array of int64 unscaled values, or of
    (n, 2) [lo, hi] int64 limbs; `null` marks NULL rows."""
    import pyarrow as pa

    vals = np.asarray(unscaled, dtype=np.int64)
    if vals.ndim == 1:
        vals = np.stack([vals, vals >> 63], axis=1)
    validity = None if null is None else pa.array(~null).buffers()[1]
    return pa.Array.from_buffers(
        pa.decimal128(p, s), len(vals),
        [validity, pa.py_buffer(np.ascontiguousarray(vals).tobytes())])


def limbs_of(arr) -> np.ndarray:
    """(n, 2) int64 limbs of a decimal128 Arrow array (NULL rows hold
    whatever the buffer holds)."""
    import pyarrow as pa

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    raw = np.frombuffer(arr.buffers()[1], dtype=np.int64)
    return raw[2 * arr.offset: 2 * (arr.offset + len(arr))].reshape(-1, 2)


def limbs_to_ints(limbs: np.ndarray) -> np.ndarray:
    """Python ints (an object array) of (n, 2) limbs."""
    lo = limbs[:, 0].view(np.uint64).astype(object)
    return (limbs[:, 1].astype(object) << 64) + lo


def ints_to_limbs(vals) -> np.ndarray:
    """(n, 2) int64 limbs of Python ints in 128-bit two's complement."""
    t = np.mod(np.asarray(vals, dtype=object), 1 << 128)
    out = np.empty((len(t), 2), dtype=np.int64)
    for j, part in enumerate((t & _U64, t >> 64)):
        out[:, j] = np.where(part >= (1 << 63), part - (1 << 64),
                             part).astype(np.int64)
    return out


def half_up_div(num, den):
    """HALF_UP (away from zero) num / den of Python ints, elementwise
    over object arrays."""
    q = np.abs(num) // den
    r = np.abs(num) - q * den
    q = q + (2 * r >= den).astype(object)
    return np.where(num < 0, -q, q)


def store_sales_cents(rows: int, seed: int):
    """store_sales_columns with price as TPC-DS's decimal(7, 2): the
    float price rounded to unscaled cents."""
    item, qty, price = store_sales_columns(rows, seed)
    cents = np.floor(price.astype(np.float64) * 100 + 0.5).astype(np.int64)
    return item, qty, cents


def write_decimal_sales(path: str, item, qty, cents):
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"item": item, "qty": qty,
                             "price": decimal_array(cents, 7, 2)}), path,
                   compression="zstd", row_group_size=1 << 20)


def dec_q6_plan(scan):
    """q6 on decimal(7, 2) prices: WHERE price > 50.00 AND qty < 8,
    rev = price * qty, keyless SUM(rev), AVG(rev), COUNT(*)."""
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col, Literal
    from blaze_tpu_torch.ops import (AggMode, FilterExec, HashAggregateExec,
                                     ProjectExec)
    from blaze_tpu_torch.types import DataType

    proj = ProjectExec(
        FilterExec(scan, (Col("price") > Literal(5000, DataType.decimal(
            7, 2))) & (Col("qty") < 8)),
        [(Col("price") * Col("qty"), "rev")])
    return HashAggregateExec(proj, keys=[], aggs=[
        (AggExpr(AggFn.SUM, Col("rev")), "s"),
        (AggExpr(AggFn.AVG, Col("rev")), "a"),
        (AggExpr(AggFn.COUNT_STAR, None), "n")], mode=AggMode.COMPLETE)


def dec_q6_oracle(qty, cents):
    """(SUM(rev) in cents, AVG(rev) at scale 6 HALF_UP, COUNT) exactly,
    in numpy int64 and Python ints."""
    live = (cents > 5000) & (qty < 8)
    rev = cents[live] * qty[live].astype(np.int64)
    s, n = int(rev.sum()), int(live.sum())
    return s, int(half_up_div(np.array([s * 10**4], dtype=object), n)[0]), n


def dec_grouped_aggs():
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col

    return [(AggExpr(AggFn.SUM, Col("price")), "sp"),
            (AggExpr(AggFn.AVG, Col("price")), "ap"),
            (AggExpr(AggFn.SUM, Col("rev")), "sr"),
            (AggExpr(AggFn.AVG, Col("rev")), "ar")]


def dec_grouped_plan(scan, mode):
    """g = item % 4096, keyed SUM and AVG of price (decimal(7, 2)) and
    of rev = price * qty."""
    from blaze_tpu_torch.exprs.ir import Col, Literal
    from blaze_tpu_torch.ops import HashAggregateExec, ProjectExec
    from blaze_tpu_torch.types import DataType

    proj = ProjectExec(scan, [
        (Col("item") % Literal(GROUPS, DataType.int32()), "g"),
        (Col("price"), "price"), (Col("price") * Col("qty"), "rev")])
    return HashAggregateExec(proj, keys=[(Col("g"), "g")],
                             aggs=dec_grouped_aggs(), mode=mode)


def dec_grouped_oracle(item, qty, cents):
    """Per group: exact unscaled SUMs (every partial sum of these
    integers stays below 2^53, so float64 bincount is exact), AVGs at
    scale 6 HALF_UP in Python ints."""
    g = item.astype(np.int64) % GROUPS
    cnt = np.bincount(g, minlength=GROUPS)
    nz = np.flatnonzero(cnt)
    rev = cents * qty.astype(np.int64)
    out = {"g": nz}
    for name, v in (("p", cents), ("r", rev)):
        if int(np.abs(v).sum()) >= 1 << 53:
            raise AssertionError("dec_grouped: the oracle's float64 sums "
                                 "would round")
        tot = np.bincount(g, weights=v.astype(np.float64),
                          minlength=GROUPS)[nz].astype(np.int64)
        out["s" + name] = tot.astype(object)
        out["a" + name] = half_up_div(tot.astype(object) * 10**4,
                                      cnt[nz].astype(object))
    return out


def check_dec_grouped(table, exp, task: str) -> int:
    """Group set, SUMs and AVGs exactly equal to the oracle; returns the
    groups."""
    g = table.column("g").to_numpy()
    order = np.argsort(g)
    if not np.array_equal(g[order], exp["g"]):
        raise AssertionError(f"{task}: the group set differs from numpy's")
    for name, scale in (("sp", 2), ("ap", 6), ("sr", 2), ("ar", 6)):
        col = table.column(name)
        if col.null_count:
            raise AssertionError(f"{task}: NULL {name}")
        got = limbs_to_ints(limbs_of(col))[order]
        if table.schema.field(name).type.scale != scale or \
                not (got == exp[name]).all():
            raise AssertionError(f"{task}: {name} differs from the exact "
                                 "oracle")
    return len(g)


def dec_wide_limbs(rows: int, seed: int):
    """(limbs, null mask, g) of a decimal(38, 10) column: values that
    straddle +-2^64, values near +-10^37 that cancel in group 1, 10^38 -
    1 in group 0 (whose SUM overflows decimal(38)), one -(10^38 - 1) in
    group 2 among small values, and NULLs."""
    rng = np.random.default_rng(seed)
    i = np.arange(rows)
    lo = rng.integers(-(1 << 63), (1 << 63) - 1, rows, dtype=np.int64)
    hi = rng.integers(-2, 2, rows).astype(np.int64)  # +-2^65
    small = i % 2 == 1
    lo[small] = rng.integers(-(1 << 40), 1 << 40, int(small.sum()))
    hi[small] = lo[small] >> 63
    vals = limbs_to_ints(np.stack([lo, hi], axis=1))
    r = rng.integers(0, 1 << 62, rows)
    near = i % 4096 == 1
    sign = np.where((i // 4096) % 2 == 0, 1, -1)
    vals[near] = (sign[near].astype(object)
                  * (10**37 + r[near].astype(object)))
    vals[i % 4096 == 0] = DEC38
    if rows > 2:
        vals[2] = -DEC38
    g = np.where(i % 4096 == 0, 0, np.where(near, 1, 3 + i % 13))
    if rows > 2:
        g[2] = 2
    null = (i % 20 == 7) & (i % 4096 > 2)
    return ints_to_limbs(vals), null, g.astype(np.int32)


def check_int128(torch, rng, n: int, device: str):
    """int128's ops on the card against the same ops on the CPU, bit for
    bit, over n random limb pairs with the edge values; add, the
    multiply with a HALF_UP rescale and the rescales against Python
    ints. Returns the checked counts."""
    from blaze_tpu_torch.exprs import int128 as I

    edges = [0, 1, -1, 1 << 63, -(1 << 63), 1 << 64, -(1 << 64),
             DEC38, -DEC38, (1 << 127) - 1, -(1 << 127)]
    k = len(edges)
    lim = rng.integers(-(1 << 63), (1 << 63) - 1, (2, n, 2), dtype=np.int64)
    shift = rng.integers(0, 64, (2, n))
    lim[:, :, 1] >>= shift  # magnitudes from 2^64 to 2^127
    e = ints_to_limbs(edges)
    lim[0, :k * k] = np.repeat(e, k, axis=0)  # every pair of edges
    lim[1, :k * k] = np.tile(e, (k, 1))
    outs = {}
    for dev in ("cpu", device):
        a, b = (torch.from_numpy(lim[j]).to(dev) for j in range(2))
        ma = I.from_limbs(a[:, 0], a[:, 1])
        mb = I.from_limbs(b[:, 0], b[:, 1])
        res = {"add": I.signed_add(ma, mb),
               "mul2": I.signed_mul(ma, mb, 2),
               "mul19": I.signed_mul(ma, mb, 19),
               "up10": I.rescale_up(ma[0], ma[1], 10),
               "div28": I.div_pow10_half_up(ma[0], ma[1], 28),
               "float": (I.to_float64(a[:, 0], a[:, 1]),)}
        outs[dev] = {key: [t.cpu().numpy() for t in v]
                     for key, v in res.items()}
    for key in outs["cpu"]:
        for x, y in zip(outs["cpu"][key], outs[device][key]):
            if not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
                raise AssertionError(f"int128 {key}: the card's bits "
                                     "differ from the CPU's")
    av, bv = limbs_to_ints(lim[0]), limbs_to_ints(lim[1])
    cpu = outs["cpu"]

    def signed(mlo, mhi, neg):
        mag = limbs_to_ints(np.stack([mlo, mhi], axis=1)) % (1 << 128)
        return np.where(neg, -mag, mag)

    fits = (np.abs(av) <= DEC38) & (np.abs(bv) <= DEC38)
    want = av + bv
    mlo, mhi, neg, ok = cpu["add"]
    if not ((ok == (np.abs(want) <= DEC38)) | ~fits).all() or \
            not (signed(mlo, mhi, neg) == want)[fits & ok].all():
        raise AssertionError("int128 add differs from Python ints")
    for key, down in (("mul2", 2), ("mul19", 19)):
        p = av * bv
        small = np.abs(p) < (1 << 128)
        q = half_up_div(p, 10**down)
        mlo, mhi, neg, ok = cpu[key]
        if (ok & ~small).any() or not (ok[small] == (
                np.abs(q[small]) <= DEC38)).all() or \
                not (signed(mlo, mhi, neg) == q)[ok].all():
            raise AssertionError(f"int128 {key} differs from Python ints")
    return {"pairs": n, "edge_values": k, "ops_bit_equal": sorted(cpu),
            "python_checked": ["add", "mul2", "mul19"]}


def decimal_line(task: str, rows: int, wall: float, launches, transfers,
                 prof, batches=None, **extra):
    """The decimal phase's line: wall, rows/s, device busy ms, idle share,
    H2D copies and syncs (in all, and a batch for a task of one scan of
    `batches` batches) and K1-K4 launches."""
    h2d, syncs = transfers.get("h2d_copies", 0), transfers.get("d2h_syncs", 0)
    per = {} if batches is None else {"batches": batches,
                                      "h2d_per_batch": h2d / batches,
                                      "syncs_per_batch": syncs / batches}
    emit({"phase": "decimal", "task": task, "rows": rows, "wall_s": wall,
          "rows_per_s": rows / wall,
          "device_busy_ms": prof["device_busy_ms"],
          "idle_share": prof["idle_share"], "h2d_copies": h2d,
          "syncs": syncs, **per,
          "graph_replays": transfers.get("graph_replays", 0),
          "launches": launches, "transfers": transfers, **extra})


def decimal_phase(torch, rows: int, grouped_rows: int, seed: int, kernels,
                  device="cuda"):
    """dec_q6, dec_grouped, dec_exchange and dec_wide through
    execute_task, and the int128 primitives on the card."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.config import EngineConfig, get_config, set_config
    from blaze_tpu_torch.exprs.ir import (AggExpr, AggFn, BinaryOp, Col,
                                          Literal, Op)
    from blaze_tpu_torch.ops import (AggMode, FileRange, FilterExec,
                                     HashAggregateExec, ParquetScanExec,
                                     ProjectExec, ShuffleWriterExec, SortExec)
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.fused import FusedAggregateExec, HostFinalAggExec
    from blaze_tpu_torch.ops.ipc_reader import IpcReaderExec, IpcReadMode
    from blaze_tpu_torch.ops.sort import SortKey
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime.executor import decode_task, execute_task
    from blaze_tpu_torch.types import DataType

    work = os.path.join(REPO, "build", "chip_smoke_decimal")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    results = {}

    def scan(p):
        return ParquetScanExec([[FileRange(p)]])

    def counted(task, run, n, batches=None, once=False, **extra):
        """Run a task counted, then once more under the profiler; with
        `once`, a long one runs once, under the profiler."""
        if once:
            out, wall, launches, transfers, prof = counted_profiled(
                torch, run, task, kernels)
            extra["profiled_wall"] = True
        else:
            out, wall, launches, transfers = run_counted(torch, run,
                                                         kernels)
            prof = profile_run(torch, run, task, wall)
        decimal_line(task, n, wall, launches, transfers, prof, batches,
                     **extra)
        results[task] = {"launches": launches, "wall_s": wall}
        return out, launches, transfers

    def task_run(blob, config=None):
        return lambda: list(execute_task(blob, ExecContext(
            device=device, config=config or get_config())))

    try:
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        checked = check_int128(torch, rng, 1 << 20, device)
        emit({"phase": "decimal_int128", "device": device,
              "seconds": time.perf_counter() - t0, **checked})

        # dec_q6: the keyless decimal SUM/AVG on the fused carry
        t0 = time.perf_counter()
        path = os.path.join(work, "store_sales_dec.parquet")
        item, qty, cents = store_sales_cents(rows, seed)
        write_decimal_sales(path, item, qty, cents)
        write_s = time.perf_counter() - t0
        blob = task_to_proto(dec_q6_plan(scan(path)), 0)
        op, _ = decode_task(blob, ExecContext(device=device))
        if not (isinstance(op, HostFinalAggExec)
                and isinstance(op.children[0], FusedAggregateExec)):
            raise AssertionError(f"dec_q6 decoded to {op.describe()}, not "
                                 "the fused keyless carry")
        out, launches, transfers = counted(
            "dec_q6", task_run(blob), rows, -(-rows // 16384),
            parquet_write_s=write_s)
        row = out[0].to_pylist()[0]
        s, a, n = dec_q6_oracle(qty, cents)
        got = (int(row["s"].scaleb(2)), int(row["a"].scaleb(6)), row["n"])
        if got != (s, a, n):
            raise AssertionError(f"dec_q6: got {got}, exact oracle "
                                 f"{(s, a, n)}")
        fusion = fusion_counts(transfers, rows)
        check_fused("dec_q6", fusion)
        if transfers.get("d2h_syncs", 0) or launches["masked_stats"] <= 0:
            raise AssertionError(f"dec_q6: {transfers.get('d2h_syncs')} "
                                 "syncs, or K1 not launched")
        emit({"phase": "decimal_check", "task": "dec_q6", "sum": got[0],
              "avg_scale6": got[1], "count": n,
              "oracle": "numpy int64 sum of unscaled cents, AVG HALF_UP "
                        "in Python ints: equal", "fusion": fusion})

        # dec_grouped: keyed SUM/AVG through K3
        n_g = min(grouped_rows, rows)
        gpath = os.path.join(work, "store_sales_dec_grouped.parquet")
        write_decimal_sales(gpath, item[:n_g], qty[:n_g], cents[:n_g])
        exp = dec_grouped_oracle(item[:n_g], qty[:n_g], cents[:n_g])
        blob = task_to_proto(dec_grouped_plan(scan(gpath),
                                              AggMode.COMPLETE), 0)
        out, launches, _ = counted("dec_grouped", task_run(blob), n_g,
                                   -(-n_g // 16384))
        groups = check_dec_grouped(pa.Table.from_batches(out), exp,
                                   "dec_grouped")
        if launches["segment_reduce"] <= 0:
            raise AssertionError("dec_grouped did not launch K3")
        emit({"phase": "decimal_check", "task": "dec_grouped",
              "groups": groups, "k3_launches": launches["segment_reduce"],
              "oracle": "bincount of unscaled int64 (exact below 2^53), "
                        "AVG HALF_UP in Python ints: equal"})

        # dec_exchange: PARTIAL -> 200 hash partitions -> 200 FINAL tasks
        partial = dec_grouped_plan(scan(gpath), AggMode.PARTIAL)
        outputs = [(os.path.join(work, "dec.data"),
                    os.path.join(work, "dec.index"))]
        map_blob = task_to_proto(ShuffleWriterExec(
            partial, [Col("g")], SHUFFLE_PARTITIONS, *outputs[0]), 0)
        reduce_plan = HashAggregateExec(
            IpcReaderExec("shuffle", partial.schema, SHUFFLE_PARTITIONS,
                          IpcReadMode.CHANNEL_AND_FILE_SEGMENT),
            keys=[(Col("g"), "g")], aggs=dec_grouped_aggs(),
            mode=AggMode.FINAL)

        def exchange():
            run_stage(torch, [map_blob], device)
            return run_stage(torch, reduce_tasks(
                reduce_plan, outputs, SHUFFLE_PARTITIONS), device)[0]

        # 1 + 200 tasks: one run, under the profiler
        outs, launches, _ = counted("dec_exchange", exchange, n_g,
                                    once=True, map_tasks=1,
                                    partitions=SHUFFLE_PARTITIONS)
        table = pa.Table.from_batches([rb for o in outs for rb in o])
        check_dec_grouped(table, exp, "dec_exchange")
        for r, o in enumerate(outs):
            for rb in o:
                if (spark_pids(rb.column("g").to_numpy(),
                               SHUFFLE_PARTITIONS) != r).any():
                    raise AssertionError("dec_exchange: a group in a "
                                         "reducer Spark would not send it "
                                         "to")
        if launches["murmur3"] <= 0 or launches["segment_reduce"] <= 0:
            raise AssertionError("dec_exchange did not launch K4 and K3")
        emit({"phase": "decimal_check", "task": "dec_exchange",
              "groups": table.num_rows, "k3_launches":
              launches["segment_reduce"], "k4_launches": launches["murmur3"],
              "oracle": "the dec_grouped oracle: equal; each group in its "
                        "Spark partition"})

        # dec_wide: decimal(38, 10) filter, arithmetic, sorts and SUM
        t0 = time.perf_counter()
        limbs, null, g = dec_wide_limbs(DEC_WIDE_ROWS, seed)
        wpath = os.path.join(work, "wide.parquet")
        pq.write_table(pa.table({"d": decimal_array(limbs, 38, 10, null),
                                 "g": g}), wpath, row_group_size=1 << 18)
        vals = limbs_to_ints(limbs)
        wide_t = DataType.decimal(38, 10)
        proj = ProjectExec(
            FilterExec(scan(wpath), BinaryOp(Op.GT, Col("d"), Literal(
                DEC_WIDE_PIVOT, wide_t))),
            [(Col("d"), "d"), (Col("d") + 1, "p1"), (Col("d") * 3, "m3")])
        out, _, _ = counted("dec_wide_compute",
                            task_run(task_to_proto(proj, 0)), DEC_WIDE_ROWS)
        t1 = time.perf_counter()
        table = pa.Table.from_batches(out)
        keep = ~null & (vals > DEC_WIDE_PIVOT)
        if not np.array_equal(limbs_of(table.column("d")), limbs[keep]):
            raise AssertionError("dec_wide: the filter's rows differ from "
                                 "Python's comparison")
        kept = vals[keep]
        for name, times, plus in (("p1", 1, 1), ("m3", 3, 0)):
            # (d * times + plus) at the result's scale, HALF_UP
            scale = table.schema.field(name).type.scale
            want = half_up_div((kept * times + plus * 10**10)
                               * 10**scale, 10**10)
            ok = np.abs(want) <= DEC38
            col = table.column(name)
            valid = ~np.asarray(col.is_null())
            got = limbs_to_ints(limbs_of(col))
            if not np.array_equal(valid, ok) or \
                    not (got[ok] == want[ok]).all():
                raise AssertionError(f"dec_wide: {name} differs from "
                                     "Python ints")
        oracle_s = time.perf_counter() - t1
        # ORDER BY d: the packed core, the lexsort core, the top-k route
        order_np = np.lexsort((limbs[:, 0].view(np.uint64), limbs[:, 1]))
        order_np = order_np[~null[order_np]]
        n_null = int(null.sum())
        sorted_limbs = np.concatenate(
            [np.zeros((n_null, 2), np.int64), limbs[order_np]])
        saved = get_config()
        for core, fetch, task in (("scatter", None, "dec_wide_sort_packed"),
                                  ("sort", None, "dec_wide_sort_lexsort"),
                                  ("scatter", 100, "dec_wide_topk")):
            cfg = EngineConfig(device=device, sort_core=core,
                               max_materialize_rows=DEC_WIDE_ROWS // 4
                               if fetch else DEC_WIDE_ROWS)
            set_config(cfg)
            try:
                # ascending NULLS FIRST; the top-k descending NULLS LAST
                asc = fetch is None
                blob = task_to_proto(SortExec(
                    scan(wpath), [SortKey(Col("d"), asc, asc)], fetch), 0)
                out, _, transfers = counted(task, task_run(blob, cfg),
                                            DEC_WIDE_ROWS)
            finally:
                set_config(saved)
            col = pa.Table.from_batches(out).column("d")
            nulls = np.asarray(col.is_null())
            got = limbs_of(col)
            if fetch is None:
                route = transfers.get("sort_core." + (
                    "packed" if core == "scatter" else "lexsort"), 0)
                if not (nulls[:n_null].all() and not nulls[n_null:].any()
                        and np.array_equal(got[n_null:],
                                           sorted_limbs[n_null:])
                        and route):
                    raise AssertionError(f"{task}: order differs from "
                                         "numpy's lexsort of the limbs")
            else:
                want = limbs[order_np[::-1][:fetch]]
                if nulls.any() or not np.array_equal(got, want) or \
                        not transfers.get("sort_route.topk"):
                    raise AssertionError(f"{task}: the top {fetch} differ")
        # SUM by g: group 0 overflows decimal(38) to NULL
        blob = task_to_proto(HashAggregateExec(
            scan(wpath), keys=[(Col("g"), "g")],
            aggs=[(AggExpr(AggFn.SUM, Col("d")), "s")],
            mode=AggMode.COMPLETE), 0)
        out, _, _ = counted("dec_wide_sum", task_run(blob), DEC_WIDE_ROWS)
        table = pa.Table.from_batches(out)
        gs = table.column("g").to_numpy()
        sums = limbs_to_ints(limbs_of(table.column("s")))
        snull = np.asarray(table.column("s").is_null())
        for j, gv in enumerate(gs):
            t = sum(vals[(g == gv) & ~null])
            want_null = abs(t) > DEC38
            if bool(snull[j]) != want_null or (
                    not want_null and sums[j] != t):
                raise AssertionError(f"dec_wide_sum: group {gv} differs "
                                     "from Python ints")
        if not snull[gs == 0].all() or snull[gs != 0].any():
            raise AssertionError("dec_wide_sum: only group 0 overflows")
        emit({"phase": "decimal_check", "task": "dec_wide",
              "rows": DEC_WIDE_ROWS, "filter_rows": int(keep.sum()),
              "nulls": n_null, "groups": len(gs),
              "overflow_null_groups": int(snull.sum()),
              "oracle": "Python ints per row (filter, d + 1, d * 3 HALF_UP, "
                        "overflow NULL), numpy lexsort of the limbs, "
                        "Python int group sums: equal",
              "host_oracle_s": oracle_s,
              "phase_s": time.perf_counter() - t0})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# phase 4, continued: the planner tier
# ---------------------------------------------------------------------------

PLAN_SPLITS = 4  # FileRange partitions of the planner tasks' fact scan
PLAN_PARTITIONS = 8  # plan_join_agg's reduce partitions
FALLBACK_ROWS = 1 << 20
RANGE_PARTITIONS = 16
# plan_fallback's spec tags, as the JAX package's convert_plan sets them
# (tests/test_torch_planner.py pins them against it): the aggregate, the
# two projections and the fact scan native; the join (enable_bhj=False)
# and the dimension scan under it (the scan-parent heuristic) host
PLAN_FALLBACK_TAGS = {"native": 4, "host": 2}


def planner_package():
    """The port's planner, IR and FileRange: what the spec functions take
    (tests/test_torch_planner.py passes the JAX package's too)."""
    import types

    import blaze_tpu_torch.planner as planner
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.ops import FileRange

    return types.SimpleNamespace(planner=planner, ir=ir, FileRange=FileRange)


def byte_splits(file_range, path: str, n: int):
    """`path` as n byte ranges, one a partition: Spark's splits, where a
    row group belongs to the range that holds its midpoint."""
    size = os.path.getsize(path)
    step = -(-size // n)
    return [[file_range(path, i * step, min(step, size - i * step))]
            for i in range(n)]


def join_agg_spec(P, fact_groups, dim_path: str):
    """bench.py's join_agg (bench.py:970-1024) as a PlanSpec: store_sales
    (its item and price) joined to the item dimension (the build side)
    in a broadcast hash join, then per brand SUM(price), COUNT(*) in a
    COMPLETE aggregate. `P` holds a package's planner, IR and
    FileRange (planner_package)."""
    S, ir = P.planner, P.ir
    col = ir.Col
    fact = S.ProjectSpec(children=[S.ScanSpec(file_groups=fact_groups)],
                         exprs=[(col("item"), "item"),
                                (col("price"), "price")])
    dim = S.ScanSpec(file_groups=[[P.FileRange(dim_path)]])
    join = S.JoinSpec(children=[dim, fact], kind="bhj",
                      left_keys=["i_item"], right_keys=["item"],
                      join_type="inner")
    return S.AggSpec(
        children=[S.ProjectSpec(children=[join],
                                exprs=[(col("i_brand"), "brand"),
                                       (col("price"), "price")])],
        keys=[(col("brand"), "brand")],
        aggs=[(ir.AggExpr(ir.AggFn.SUM, col("price")), "rev"),
              (ir.AggExpr(ir.AggFn.COUNT_STAR, None), "cnt")],
        mode="complete")


def q6_spec(P, fact_groups):
    """q6 (q6_plan) as a PlanSpec over store_sales' FileRange groups:
    filter, project, keyless COMPLETE SUM(rev) and COUNT(*)."""
    S, ir = P.planner, P.ir
    col = ir.Col
    filt = S.FilterSpec(children=[S.ScanSpec(file_groups=fact_groups)],
                        predicate=(col("price") > 50.0) & (col("qty") < 8))
    proj = S.ProjectSpec(children=[filt], exprs=[
        (col("price") * col("qty").cast(ir.DataType.float32()), "rev")])
    return S.AggSpec(children=[proj], keys=[],
                     aggs=[(ir.AggExpr(ir.AggFn.SUM, col("rev")), "t"),
                           (ir.AggExpr(ir.AggFn.COUNT_STAR, None), "n")],
                     mode="complete")


def spec_tags(spec):
    """(node type, convertible tag) of every node, preorder."""
    out = [(type(spec).__name__, spec.convertible)]
    for c in spec.children:
        out += spec_tags(c)
    return out


def tag_counts(spec):
    tags = [t for _, t in spec_tags(spec)]
    return {"native": tags.count(True), "host": tags.count(False)}


def _ops(op):
    """Every operator of a built tree once (shared subtrees once)."""
    seen, out, stack = set(), [], [op]
    while stack:
        o = stack.pop()
        if id(o) not in seen:
            seen.add(id(o))
            out.append(o)
            stack.extend(o.children)
    return out


def op_nodes(op):
    """Native operators and planned host nodes (HostFallbackExec) of a
    built tree."""
    host = sum(type(o).__name__ == "HostFallbackExec" for o in _ops(op))
    return {"native": len(_ops(op)) - host, "host": host}


def scan_reads(op):
    """Each parquet scan of a built tree: its partitions, the columns it
    decodes under its hints, its schema's columns and its pushed
    conjuncts."""
    from blaze_tpu_torch.config import get_config
    from blaze_tpu_torch.ops import ParquetScanExec

    out = []
    for o in _ops(op):
        if isinstance(o, ParquetScanExec):
            cols = o.projection or [f.name for f in o.schema]
            filters = getattr(o, "_hint_filters", ()) \
                if get_config().host_filter_pushdown else ()
            out.append({"partitions": o.partition_count,
                        "decoded": o._read_plan(cols, filters)[0],
                        "schema": cols,
                        "pushed": [[n, c.name, v] for n, c, v in
                                   getattr(o, "_hint_filters", ())]})
    return out


def check_planned_fused(task: str, counts) -> None:
    """A fused keyless aggregate's PARTIAL over PLAN_SPLITS map tasks on
    threads: one graph replay and one H2D copy a scan batch, no batch
    run op by op; the FINAL's read of the map tasks' state rows adds
    at most two copies a map task. A task holds its graph for its whole
    stream, so two captures or more mean that tasks held graphs at once
    and captured while another thread replayed and copied."""
    n = counts["batches"]
    if (counts["graph_replays"] != n or counts["graph_eager_batches"]
            or not n <= counts["h2d_copies"] <= n + 2 * PLAN_SPLITS
            or counts["graph_captures"] < 2):
        raise AssertionError(f"{task}: {counts} - expected {n} graph "
                             f"replays, {n} H2D copies and at most "
                             f"{2 * PLAN_SPLITS} more, no eager batch, "
                             "2 captures or more")


FAILURE_COUNTERS = ("task_retries", "degraded_partitions", "degraded_rows")


def check_no_retries(task: str, counters) -> None:
    """A planner task on the card retried no task and degraded no
    partition to the host engine (the scheduler refuses that on the
    card; a retry would hide a fault)."""
    bad = {k: counters.get(k, 0) for k in FAILURE_COUNTERS
           if counters.get(k, 0)}
    if bad:
        raise AssertionError(f"{task}: {bad}")


def planner_line(task: str, rows: int, wall: float, launches, transfers,
                 op, counters, **extra):
    check_no_retries(task, counters)
    emit({"phase": "planner", "task": task, "rows": rows, "wall_s": wall,
          "rows_per_s": rows / wall, "nodes": op_nodes(op),
          "map_tasks": counters.get("exchange_map_tasks", 0),
          "reduce_partitions": op.partition_count,
          "shuffle_bytes_written": counters.get("shuffle_bytes_written", 0),
          "broadcast_bytes": counters.get("broadcast_bytes", 0),
          "scans": scan_reads(op),
          "pushdown_filtered_rows": counters.get("pushdown_filtered_rows",
                                                 0),
          **{k: counters.get(k, 0) for k in FAILURE_COUNTERS},
          "launches": launches, "transfers": transfers, **extra})


def planned_run(build, held=None, device="cuda", parallelism: int = 4):
    """A function that builds a plan (`build()` -> op) and runs it
    through the scheduler on the card (or the CPU, to rehearse), keeping
    its op and context in `held`."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime.scheduler import run_plan_parallel

    held = {} if held is None else held

    def run():
        op = held["op"] = build()
        held["ctx"] = ExecContext(device=device)
        return run_plan_parallel(op, ctx=held["ctx"],
                                 parallelism=parallelism)

    return run


def run_planned(torch, build, kernels, device="cuda"):
    """planned_run, counted: (table, op, its context, wall, launches,
    transfers)."""
    held = {}
    table, wall, launches, transfers = run_counted(
        torch, planned_run(build, held, device), kernels)
    return table, held["op"], held["ctx"], wall, launches, transfers


def exchange_partition_rows(ex, ctx):
    """Rows of each reduce partition of a run exchange, read back from
    its files."""
    from blaze_tpu_torch.io.ipc import read_file_segment

    return [sum(rb.num_rows for seg in ex.segments_for((r, r + 1), ctx)
                for rb in read_file_segment(seg.path, seg.offset,
                                            seg.length))
            for r in range(ex.num_partitions)]


def check_range_sort(table, item, qty, price, bounds, sizes):
    """The partitions, in order, equal numpy's stable lexsort by price
    descending, item ascending, row for row; each partition's rows
    (`sizes` of them) lie after the bound before it and at or before its
    own."""
    order = np.lexsort((item, -price.astype(np.float64)))
    for name, exp in (("price", price), ("item", item), ("qty", qty)):
        if not np.array_equal(table.column(name).to_numpy(), exp[order]):
            raise AssertionError(f"range_sort: column {name} differs from "
                                 "numpy's lexsort order")
    p = table.column("price").to_numpy()
    it = table.column("item").to_numpy()

    def after(sl, b):  # rows after bound b in (price DESC, item ASC)
        bp, bi = b
        return (p[sl] < bp) | ((p[sl] == bp) & (it[sl] > bi))

    if sum(sizes) != len(p):
        raise AssertionError(f"range_sort: partitions hold {sum(sizes)} "
                             f"rows of {len(p)}")
    start = 0
    for r, n in enumerate(sizes):
        sl = slice(start, start + n)
        if (r and not after(sl, bounds[r - 1]).all()) or (
                r < len(bounds) and after(sl, bounds[r]).any()):
            raise AssertionError(f"range_sort: partition {r} holds a row "
                                 "outside its bounds")
        start += n


def tpcds_exchange_check(rows: int, device: str, work: str):
    """tests/test_tpcds_exchange.py on the card: its EXCHANGE_QUERIES
    (smj flavour) through insert_exchanges at its N_EXCHANGE_PARTITIONS
    over in-memory tables, then its PARQUET_QUERIES over parquet files
    of the same tables with the scan hints installed with filters
    (pruning and pushdown), each against the pandas oracles of
    tests/test_tpcds_queries.py (all loaded by the source rewrite of
    tests/torch_tpcds_support.py); q67 and q86 where they differ by the
    rank-tolerant comparisons. Returns (exchange queries equal, their
    rank-tolerant ones, parquet queries equal, totals over the queries:
    native and host nodes, map tasks, shuffle and broadcast bytes,
    pushed-down rows, and the parquet scans' columns decoded and in
    their schemas)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_tpcds_support

    from blaze_tpu_torch.config import EngineConfig, get_config, set_config
    from blaze_tpu_torch.ops import FileRange, ParquetScanExec
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.planner.colprune import install
    from blaze_tpu_torch.planner.distribute import insert_exchanges
    from blaze_tpu_torch.runtime.executor import run_plan

    lists = torch_tpcds_support.exchange_queries()
    support, queries = torch_tpcds_support.load(rows)
    tolerant = torch_tpcds_support.rank_tolerant(queries)
    old = get_config()
    set_config(EngineConfig(
        device=device, batch_size=max(rows, 1 << 20),
        host_filter_pushdown=True,
        shape_buckets=(256, 1024, 4096, 16384, 65536, 262144, 1 << 20,
                       max(rows, 1 << 20))))
    passed, by_rank, failed, pq_passed = [], {}, {}, []
    totals = dict.fromkeys((
        "native", "host", "exchange_map_tasks", "shuffle_bytes_written",
        "broadcast_bytes", "pushdown_filtered_rows",
        "parquet_columns_decoded", "parquet_columns_in_schema",
        *FAILURE_COUNTERS), 0)
    try:
        tables = support.gen_tables()
        mem = support.scans_of(tables)
        files = {}
        for name, df in tables.items():
            files[name] = os.path.join(work, f"tpcds_{name}.parquet")
            pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                           files[name], row_group_size=1 << 16)
        pq_scans = {name: (lambda path=path: ParquetScanExec(
            [[FileRange(path)]])) for name, path in files.items()}

        def run(q, scans, parquet):
            shuffle = os.path.join(work, f"shuffle_{q}")
            os.makedirs(shuffle, exist_ok=True)
            try:
                plan = insert_exchanges(
                    support.QUERIES[q](scans, "smj"),
                    lists.N_EXCHANGE_PARTITIONS, shuffle_dir=shuffle)
                if parquet:
                    install(plan, with_filters=True)
                    for s in scan_reads(plan):
                        totals["parquet_columns_decoded"] += len(
                            s["decoded"])
                        totals["parquet_columns_in_schema"] += len(
                            s["schema"])
                for k, v in op_nodes(plan).items():
                    totals[k] += v
                ctx = ExecContext()
                out = run_plan(plan, ctx).to_pandas()
                for k in ("exchange_map_tasks", "shuffle_bytes_written",
                          "broadcast_bytes", "pushdown_filtered_rows",
                          *FAILURE_COUNTERS):
                    totals[k] += ctx.metrics.counters.get(k, 0)
                return out
            finally:
                shutil.rmtree(shuffle, ignore_errors=True)

        for q in lists.EXCHANGE_QUERIES:
            got = run(q, mem, False)
            exp = queries.ORACLES[q](tables)
            exp.columns = list(got.columns)
            try:
                queries.assert_frames_match(got, exp, f"{q}/shuffle")
                passed.append(q)
            except AssertionError as e:
                if q not in lists.RANK_TOLERANT:
                    failed[q] = repr(e)[:300]
                    continue
                try:
                    if len(got) != len(exp):
                        raise AssertionError(
                            f"{len(got)} rows, oracle {len(exp)}")
                    if q == "q67":
                        tolerant._assert_rank_tolerant_q67(
                            got, queries.q67_rolled_frame(tables))
                    else:
                        tolerant._assert_rank_tolerant_q86(
                            got, queries.q86_rolled_frame(tables))
                except AssertionError as e2:
                    failed[q] = repr(e2)[:300]
                    continue
                by_rank[q] = ("differs from the oracle's frame at "
                              + repr(e)[:120] + "; every sum within 1e-6 "
                              "and every rank achievable "
                              "(_assert_rank_tolerant_" + q + ")")
        for q in lists.PARQUET_QUERIES:
            got = run(q, pq_scans, True)
            exp = queries.ORACLES[q](tables)
            exp.columns = list(got.columns)
            try:
                queries.assert_frames_match(got, exp, f"{q}/parquet-shuffle")
                pq_passed.append(q)
            except AssertionError as e:
                failed[q + "/parquet"] = repr(e)[:300]
    finally:
        set_config(old)
    if failed:
        raise AssertionError(f"tpcds_exchange: {len(failed)} queries differ "
                             f"from their oracles: {failed}")
    return passed, by_rank, pq_passed, totals


def planner_phase(torch, rows: int, seed: int, kernels, device="cuda"):
    """The planner tier on the card: PlanSpecs through convert_plan,
    insert_exchanges and run_plan_parallel (plan_join_agg, plan_q6,
    plan_fallback), a range exchange under a per-partition sort
    (range_sort), and the TPC-DS queries through the exchanges
    (tpcds_exchange)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import FileRange, ParquetScanExec, SortExec
    from blaze_tpu_torch.ops.sort import SortKey
    from blaze_tpu_torch.parallel import ShuffleExchangeExec
    from blaze_tpu_torch.planner import ConvertStrategy, convert_plan
    from blaze_tpu_torch.planner.distribute import insert_exchanges

    work = os.path.join(REPO, "build", "chip_smoke_planner")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    P = planner_package()
    results = {}
    try:
        t0 = time.perf_counter()
        fact_path = os.path.join(work, "store_sales.parquet")
        item, qty, price = write_store_sales(fact_path, rows, seed)
        brands = item_brands(rows, seed)
        dim_path = os.path.join(work, "item.parquet")
        pq.write_table(pa.table({"i_item": np.arange(ITEMS, dtype=np.int32),
                                 "i_brand": brands}), dim_path)
        small_path = os.path.join(work, "store_sales_small.parquet")
        write_parquet(small_path, item[:FALLBACK_ROWS], qty[:FALLBACK_ROWS],
                      price[:FALLBACK_ROWS])
        write_s = time.perf_counter() - t0

        # plan_join_agg: every node native, 4 map tasks in threads
        tags = {}

        def build_join_agg(path=fact_path, strategy=None, key="join_agg"):
            def build():
                spec = join_agg_spec(P, byte_splits(FileRange, path,
                                                    PLAN_SPLITS), dim_path)
                op = convert_plan(spec, strategy)
                tags[key] = (tag_counts(spec), spec_tags(spec))
                return insert_exchanges(
                    op, PLAN_PARTITIONS,
                    shuffle_dir=os.path.join(work, "shuffle_" + key))
            return build

        table, op, ctx, wall, launches, transfers = run_planned(
            torch, build_join_agg(), kernels, device)
        counters = ctx.metrics.counters
        err = check_join_agg(table, item, price, brands, "plan_join_agg")
        nodes = op_nodes(op)
        fact_scan = [s for s in scan_reads(op) if "qty" in s["schema"]]
        if tags["join_agg"][0]["host"] or nodes["host"]:
            raise AssertionError(f"plan_join_agg: host nodes {tags}")
        if len(fact_scan) != 1 or "qty" in fact_scan[0]["decoded"]:
            raise AssertionError(f"plan_join_agg: qty decoded: {fact_scan}")
        if counters.get("exchange_map_tasks") != PLAN_SPLITS:
            raise AssertionError(f"plan_join_agg: {counters}")
        for name in ("murmur3", "segment_reduce"):
            if launches[name] <= 0:
                raise AssertionError(f"plan_join_agg did not launch {name}")
        results["plan_join_agg"] = {"launches": launches, "wall_s": wall}
        planner_line("plan_join_agg", rows, wall, launches, transfers, op,
                     counters, spec_tags=tags["join_agg"][0],
                     sum_max_rel_err=err, parquet_write_s=write_s,
                     threads=4)
        # the phase's one profiled run: device activity only
        counted_profiled(torch, planned_run(build_join_agg(
            key="join_agg_profiled"), device=device), "plan_join_agg",
            kernels)

        # plan_q6: q6 as a PlanSpec over the 4 partitions, its carry a
        # map task on threads: CUDA graphs captured and replayed while
        # other tasks' threads capture, replay and copy
        def build_q6():
            spec = q6_spec(P, byte_splits(FileRange, fact_path, PLAN_SPLITS))
            op = convert_plan(spec)
            tags["q6"] = tag_counts(spec)
            return insert_exchanges(op, PLAN_PARTITIONS,
                                    shuffle_dir=os.path.join(work, "q6"))

        table, op, ctx, wall, launches, transfers = run_planned(
            torch, build_q6, kernels, device)
        counters = ctx.metrics.counters
        got_sum, got_n = check_q6(table.to_batches(), qty, price, "plan_q6")
        fusion = fusion_counts(transfers, rows)
        (q6_scan,) = scan_reads(op)
        if tags["q6"]["host"] or op_nodes(op)["host"] or \
                sorted(q6_scan["decoded"]) != ["price", "qty"]:
            raise AssertionError(f"plan_q6: tags {tags['q6']}, nodes "
                                 f"{op_nodes(op)}, scan {q6_scan}")
        check_planned_fused("plan_q6", fusion)
        if counters.get("exchange_map_tasks") != PLAN_SPLITS:
            raise AssertionError(f"plan_q6: {counters}")
        if launches["masked_stats"] <= 0:
            raise AssertionError("plan_q6 did not launch K1 masked_stats")
        results["plan_q6"] = {"launches": launches, "wall_s": wall}
        planner_line("plan_q6", rows, wall, launches, transfers, op,
                     counters, spec_tags=tags["q6"], sum=got_sum,
                     count=got_n, fusion=fusion, threads=PLAN_SPLITS)

        # plan_fallback: the join on the host engine (enable_bhj=False)
        table, op, ctx, wall, launches, transfers = run_planned(
            torch, build_join_agg(small_path, ConvertStrategy(
                enable_bhj=False), "fallback"), kernels, device)
        counters = ctx.metrics.counters
        err = check_join_agg(table, item[:FALLBACK_ROWS],
                             price[:FALLBACK_ROWS], brands, "plan_fallback")
        host_nodes = [o for o in _ops(op)
                      if type(o).__name__ == "HostFallbackExec"]
        if tags["fallback"][0] != PLAN_FALLBACK_TAGS or len(host_nodes) != 1 \
                or type(host_nodes[0].node).__name__ != "JoinSpec":
            raise AssertionError(f"plan_fallback: tags {tags['fallback']}, "
                                 f"host nodes {host_nodes}")
        results["plan_fallback"] = {"launches": launches, "wall_s": wall}
        planner_line("plan_fallback", FALLBACK_ROWS, wall, launches,
                     transfers, op, counters,
                     spec_tags=tags["fallback"][0],
                     pinned_tags=PLAN_FALLBACK_TAGS,
                     tags=tags["fallback"][1], sum_max_rel_err=err)

        # range_sort: ORDER BY price DESC, item over a range exchange
        box = {}

        def build_range():
            scan = ParquetScanExec(byte_splits(FileRange, fact_path,
                                               PLAN_SPLITS))
            ex = box["ex"] = ShuffleExchangeExec(
                scan, [Col("price"), Col("item")], RANGE_PARTITIONS,
                mode="range", shuffle_dir=os.path.join(work, "range"),
                sort_ascending=[False, True])
            return SortExec(ex, [SortKey(Col("price"), False, False),
                                 SortKey(Col("item"))])

        table, op, ctx, wall, launches, transfers = run_planned(
            torch, build_range, kernels, device)
        counters = ctx.metrics.counters
        bounds = box["ex"].range_bounds(ctx)
        sizes = exchange_partition_rows(box["ex"], ctx)
        check_range_sort(table, item, qty, price, bounds, sizes)
        results["range_sort"] = {"launches": launches, "wall_s": wall}
        planner_line("range_sort", rows, wall, launches, transfers, op,
                     counters, bounds=[[float(b[0]), int(b[1])]
                                       for b in bounds],
                     partition_rows=sizes,
                     check="partitions in order equal numpy's stable "
                           "lexsort (price DESC, item), row for row; each "
                           "partition's keys within its bounds")

        # tpcds_exchange: the repo's exchange suite on the card
        def tpcds():
            return tpcds_exchange_check(TPCDS99_ROWS, device, work)

        (passed, by_rank, pq_passed, totals), wall, launches, transfers = \
            run_counted(torch, tpcds, kernels)
        n_ex = len(passed) + len(by_rank)
        if totals["host"]:
            raise AssertionError(f"tpcds_exchange: host nodes {totals}")
        check_no_retries("tpcds_exchange", totals)
        results["tpcds_exchange"] = {"launches": launches, "wall_s": wall}
        emit({"phase": "planner", "task": "tpcds_exchange",
              "rows": TPCDS99_ROWS, "wall_s": wall, "flavour": "smj",
              "exchange_queries": n_ex, "equal_to_oracle": len(passed),
              "rank_tolerant": by_rank, "parquet_queries": len(pq_passed),
              "totals_over_queries": totals,
              "oracle": "pandas oracles of tests/test_tpcds_queries.py; q67 "
                        "and q86 where they differ: the rank-tolerant "
                        "comparisons of tests/test_tpcds_exchange.py",
              "launches": launches, "transfers": transfers})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# phase 4, continued: the task-entry and cluster tier
# ---------------------------------------------------------------------------

CLUSTER_WORKERS = 2  # worker processes on the one card
CLUSTER_SPLITS = 4  # FileRange partitions of the fact file (map tasks)
HOST_ID_ROWS = 16384  # host_partition_ids against K4: one batch
HOST_ID_KEYS = (("item",), ("item", "price"), ("qty", "price", "item"))
PROFILE_TOP = 15  # cProfile entries printed a task


# The reference's wire format, encoded field by field from protobuf's
# wire rules (as tests/test_refwire_corpus.py encodes its fixtures, not
# by the generated encoder); field numbers are the reference's
# plan.proto: PhysicalPlanNode :26-43, TaskDefinition :508-513.

def _vint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _vint(field << 3 | 2) + _vint(len(payload)) + payload


def _uv(field: int, n: int) -> bytes:
    """A varint field; canonical proto3 leaves out zero."""
    return _vint(field << 3) + _vint(n) if n else b""


def _s(field: int, text: str) -> bytes:
    return _ld(field, text.encode()) if text else b""


REF_TYPES = {"int32": 8, "int64": 10, "float32": 12, "float64": 13}
REF_AGG = {"MIN": 0, "MAX": 1, "SUM": 2, "AVG": 3, "COUNT": 4}


def ref_schema(fields):
    """Schema{columns: Field{name, arrow_type, nullable}}."""
    return b"".join(_ld(1, _s(1, name) + _ld(2, _ld(REF_TYPES[t], b""))
                        + _uv(3, 1)) for name, t in fields)


def ref_col(name: str) -> bytes:
    return _ld(1, _s(1, name))


def ref_lit(kind: str, v) -> bytes:
    """ScalarValue int32_value (6) or float32_value (12)."""
    import struct

    if kind == "int32":
        return _ld(2, _uv(6, v))
    return _ld(2, _vint(12 << 3 | 5) + struct.pack("<f", v))


def ref_bin(op: str, left: bytes, right: bytes) -> bytes:
    return _ld(3, _ld(1, left) + _ld(2, right) + _s(3, op))


def ref_cast(e: bytes, t: str) -> bytes:
    return _ld(9, _ld(1, e) + _ld(2, _ld(REF_TYPES[t], b"")))


def ref_agg(fn: str, e: bytes) -> bytes:
    return _ld(4, _uv(1, REF_AGG[fn]) + _ld(2, e))


def ref_scan(ranges, fields) -> bytes:
    """parquet_scan (5) of one FileGroup of (path, start, length) byte
    ranges: partition 0 reads them all."""
    files = b"".join(_ld(1, _s(1, p) + _uv(2, os.path.getsize(p))
                         + _ld(5, _uv(1, start) + _uv(2, start + n)))
                     for p, start, n in ranges)
    return _ld(5, _ld(1, _ld(1, files) + _ld(2, ref_schema(fields))))


def ref_filter(inp: bytes, e: bytes) -> bytes:
    return _ld(8, _ld(1, inp) + _ld(2, e))


def ref_project(inp: bytes, named) -> bytes:
    return _ld(6, _ld(1, inp) + b"".join(_ld(2, e) for e, _ in named)
               + b"".join(_s(3, n) for _, n in named))


def ref_agg_node(inp: bytes, final: bool, keys, aggs, fields) -> bytes:
    """hash_aggregate (14): PARTIAL (0) or FINAL (1)."""
    return _ld(14, b"".join(_ld(1, e) for e, _ in keys)
               + b"".join(_ld(2, e) for e, _ in aggs) + _uv(3, int(final))
               + _ld(4, inp) + b"".join(_s(5, n) for _, n in keys)
               + b"".join(_s(6, n) for _, n in aggs)
               + _ld(7, ref_schema(fields)))


def ref_join(kind: str, left: bytes, right: bytes, lkey: str,
             rkey: str) -> bytes:
    """An INNER hash_join (11, CollectLeft) or sort_merge_join (10)."""
    on = _ld(3, _ld(1, _s(1, lkey)) + _ld(2, _s(1, rkey)))
    if kind == "hash_join":
        return _ld(11, _ld(1, left) + _ld(2, right) + on)
    return _ld(10, _ld(1, left) + _ld(2, right) + on + _ld(4, _uv(1, 1)))


def ref_shuffle_writer(inp: bytes, key: bytes, n: int, data: str,
                       index: str):
    """shuffle_writer (2) and its PhysicalHashRepartition."""
    rep = _ld(1, key) + _uv(2, n)
    return _ld(2, _ld(1, inp) + _ld(2, rep) + _s(3, data)
               + _s(4, index)), rep


def ref_ipc_reader(rid: str, fields, n: int) -> bytes:
    """ipc_reader (3), CHANNEL_AND_FILE_SEGMENT (2)."""
    return _ld(3, _uv(1, n) + _ld(2, ref_schema(fields)) + _uv(3, 2)
               + _s(4, rid))


def ref_task(plan: bytes, job: str, partition: int = 0,
             out_rep: bytes = b"") -> bytes:
    """TaskDefinition bytes, pinned: the generated reference parser
    reads them and writes them back byte for byte."""
    from blaze_tpu_torch.plan.refpb import refplan_pb2 as rp

    blob = (_ld(1, _s(1, job) + _uv(4, partition)) + _ld(2, plan)
            + (_ld(3, out_rep) if out_rep else b""))
    t = rp.TaskDefinition()
    t.ParseFromString(blob)
    if t.SerializeToString() != blob:
        raise AssertionError(f"{job}: the hand-encoded task is not "
                             "canonical reference wire")
    return blob


STORE_SALES = [("item", "int32"), ("qty", "int32"), ("price", "float32")]
ITEM_DIM = [("i_item", "int32"), ("i_brand", "int32")]


def ref_q6_task(ranges) -> bytes:
    """q6 as the reference plans it: FINAL <- PARTIAL <- projection <-
    filter <- parquet scan, keyless SUM(rev) and COUNT(rev)."""
    filt = ref_filter(ref_scan(ranges, STORE_SALES), ref_bin(
        "And", ref_bin("Gt", ref_col("price"), ref_lit("float32", 50.0)),
        ref_bin("Lt", ref_col("qty"), ref_lit("int32", 8))))
    proj = ref_project(filt, [(ref_bin(
        "Multiply", ref_col("price"), ref_cast(ref_col("qty"), "float32")),
        "rev")])
    partial = ref_agg_node(proj, False, [],
                           [(ref_agg("SUM", ref_col("rev")), "t"),
                            (ref_agg("COUNT", ref_col("rev")), "n")],
                           [("rev", "float32")])
    final = ref_agg_node(partial, True, [],
                         [(ref_agg("SUM", ref_col("t")), "t"),
                          (ref_agg("COUNT", ref_col("n")), "n")],
                         [("t", "float64"), ("n", "int64")])
    return ref_task(final, "ref-q6")


REF_GROUPED_AGGS = (("SUM", "price", "s"), ("MIN", "price", "lo"),
                    ("MAX", "price", "hi"), ("AVG", "qty", "aq"))


def ref_grouped_partial(inp: bytes) -> bytes:
    """bench.py's grouped_agg map side: g = item % 4096, PARTIAL
    SUM/MIN/MAX(price), AVG(qty) by g."""
    proj = ref_project(inp, [
        (ref_bin("Modulo", ref_col("item"), ref_lit("int32", GROUPS)), "g"),
        (ref_col("price"), "price"), (ref_col("qty"), "qty")])
    return ref_agg_node(proj, False, [(ref_col("g"), "g")],
                        [(ref_agg(fn, ref_col(c)), n)
                         for fn, c, n in REF_GROUPED_AGGS],
                        [("g", "int32"), ("price", "float32"),
                         ("qty", "int32")])


def ref_grouped_final(inp: bytes) -> bytes:
    return ref_agg_node(inp, True, [(ref_col("g"), "g")],
                        [(ref_agg(fn, ref_col(c)), n)
                         for fn, c, n in REF_GROUPED_AGGS],
                        [("g", "int32"), ("s", "float64"),
                         ("lo", "float32"), ("hi", "float32"),
                         ("aq", "float64")])


def ref_join_agg_task(kind: str, fact_ranges, dim_path: str) -> bytes:
    """bench.py's join_agg in the reference's plan: the item dimension
    (build, left) joined to store_sales, then per brand SUM(price) and
    COUNT(price), PARTIAL then FINAL."""
    join = ref_join(kind, ref_scan([(dim_path, 0,
                                     os.path.getsize(dim_path))], ITEM_DIM),
                    ref_scan(fact_ranges, STORE_SALES), "i_item", "item")
    aggs = [(ref_agg("SUM", ref_col("price")), "rev"),
            (ref_agg("COUNT", ref_col("price")), "cnt")]
    partial = ref_agg_node(join, False, [(ref_col("i_brand"), "brand")],
                           aggs, ITEM_DIM + STORE_SALES)
    final = ref_agg_node(partial, True, [(ref_col("brand"), "brand")],
                         aggs, [("brand", "int32"), ("rev", "float64"),
                                ("cnt", "int64")])
    return ref_task(final, f"ref-{kind}")


def build_client() -> str:
    """cpp/blaze_client.cpp (the client of both packages' gateways),
    built with g++ into build/blaze_tpu_torch/ at first use. Where
    <zstd.h> is missing but libzstd.so.1 is not (the card's machine),
    against the declarations of blaze_tpu_torch/csrc/zstd_abi/."""
    import hashlib

    src = os.path.join(REPO, "cpp", "blaze_client.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(REPO, "build", "blaze_tpu_torch",
                       f"blaze_client-{digest}")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        has_header = subprocess.run(
            ["g++", "-E", "-x", "c++", "-"], input="#include <zstd.h>\n",
            capture_output=True, text=True).returncode == 0
        zstd = (["-lzstd"] if has_header else
                ["-I", os.path.join(REPO, "blaze_tpu_torch", "csrc",
                                    "zstd_abi"), "-l:libzstd.so.1"])
        r = subprocess.run(["g++", "-O2", "-o", out + ".tmp", src, *zstd],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed for blaze_client.cpp:\n"
                               f"{r.stderr}")
        os.replace(out + ".tmp", out)
    return out


def gateway_call(client: str, address, blob: bytes, path: str,
                 manifest=None):
    """One task through the C++ client over the gateway (reference wire,
    `--ref`); returns its Arrow batches. The client must exit 0."""
    from blaze_tpu_torch.io.ipc import decode_ipc_parts

    with open(path + ".task", "wb") as f:
        f.write(blob)
    argv = [client, address[0], str(address[1]), path + ".task",
            path + ".out", "--ref"]
    if manifest is not None:
        with open(path + ".json", "w") as f:
            json.dump(manifest, f)
        argv += ["--manifest", path + ".json"]
    r = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"blaze_client exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    with open(path + ".out", "rb") as f:
        return list(decode_ipc_parts(f.read()))


def worker_launches(metas):
    """Kernel launches the map tasks made in the workers, summed from
    their completion records."""
    total = collections.Counter()
    for m in metas:
        total.update(m["launches"])
    return dict(total)


def add_launches(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def first_task_walls(metas):
    """Each worker's first task (CUDA init, the kernels' loading) apart
    from its later ones."""
    first = [m["wall_s"] for m in metas if m["task_index"] == 0]
    rest = [m["wall_s"] for m in metas if m["task_index"] > 0]
    return {"first_task_s": first, "later_task_s": rest}


def host_profile(fn, task: str, top: int = PROFILE_TOP, input_rows=None):
    """cProfile of one call of fn (one task, over `input_rows` rows where
    given): the entries with the most cumulative time, and the named
    costs of the exchange (parquet decode, zstd, the IPC stream per
    part, the scatter's device-to-host copy)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rows = []
    for (file, line, name), (cc, nc, tt, ct, _) in st.stats.items():
        rows.append({"fn": f"{os.path.basename(file)}:{line}:{name}",
                     "calls": nc, "tottime_s": tt, "cumtime_s": ct})
    named = {
        "parquet_decode": ("read_row_group", "iter_batches"),
        "zstd": ("compress",),
        "ipc_stream_per_part": ("ipc_stream_bytes",),
        "scatter_d2h": ("scatter_by_partition",),
        "to_arrow": ("to_arrow",),
        "from_arrow": ("from_arrow",),
    }
    costs = {}
    for label, names in named.items():
        hits = [r for r in rows if any(n in r["fn"] for n in names)]
        costs[label] = {"cumtime_s": max((r["cumtime_s"] for r in hits),
                                         default=0.0),
                        "calls": sum(r["calls"] for r in hits)}
    rows.sort(key=lambda r: -r["cumtime_s"])
    emit({"phase": "host_profile", "task": task, "rows": input_rows,
          "wall_s": wall,
          "named": costs, "top_cumulative": rows[:top],
          "top_self": sorted(rows, key=lambda r: -r["tottime_s"])[:top]})


def cluster_phase(torch, rows: int, seed: int, kernels, device="cuda"):
    """The task-entry and cluster tier on the card: reference-wire tasks
    through the C++ client and the gateway (ref_q6, ref_corpus), the
    exchange's map stage on a MiniCluster of worker processes with
    local and remote shuffle reads (cluster_exchange,
    remote_exchange), one shuffle written by both tiers of the shuffle
    manager, q6 through the C++ embed host in process, and a host
    profile of one map and one reduce task."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import AggMode, FileRange, HashAggregateExec
    from blaze_tpu_torch.ops import ParquetScanExec
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.parallel import (
        ClusterShuffleExchangeExec,
        RemoteClusterShuffleExchangeExec,
    )
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime.cluster import MiniCluster
    from blaze_tpu_torch.runtime.executor import execute_task, run_plan
    from blaze_tpu_torch.runtime.gateway import TaskGatewayServer

    work = os.path.join(REPO, "build", "chip_smoke_cluster")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    results = {}
    cluster = MiniCluster(CLUSTER_WORKERS,
                          spool_dir=os.path.join(work, "spool"),
                          device=device)
    # the workers import torch while the gateway tasks run
    cluster.start()
    try:
        t0 = time.perf_counter()
        fact = os.path.join(work, "store_sales.parquet")
        item, qty, price = write_store_sales(fact, rows, seed)
        brands = item_brands(rows, seed)
        dim = os.path.join(work, "item.parquet")
        pq.write_table(pa.table({"i_item": np.arange(ITEMS, dtype=np.int32),
                                 "i_brand": brands}), dim)
        groups = byte_splits(FileRange, fact, CLUSTER_SPLITS)
        ranges = [(g[0].path, g[0].start, g[0].length) for g in groups]
        # the rows of byte range 0 (its row groups, by the midpoint
        # rule), read on the host: the one-range reference tasks' oracle
        item0, qty0, price0 = range_columns(groups[0][0])
        write_s = time.perf_counter() - t0
        client = build_client()

        # ref_q6 and ref_corpus: reference-wire TaskDefinitions through
        # the C++ client and the port's TaskGatewayServer
        with TaskGatewayServer(device=device) as gw:
            out, wall, launches, transfers = run_counted(
                torch, lambda: gateway_call(client, gw.address,
                                            ref_q6_task(ranges),
                                            os.path.join(work, "q6")),
                kernels)
            got_sum, got_n = check_q6(out, qty, price, "ref_q6")
            if launches["masked_stats"] <= 0:
                raise AssertionError("ref_q6 did not launch masked_stats")
            results["ref_q6"] = {"launches": launches, "wall_s": wall}
            emit({"phase": "cluster", "task": "ref_q6", "rows": rows,
                  "wall_s": wall, "rows_per_s": rows / wall,
                  "wire": "reference (header bit 63)",
                  "client": "cpp/blaze_client.cpp", "launches": launches,
                  "transfers": transfers, "parquet_write_s": write_s})

            corpus = {}
            grouped = ref_task(ref_grouped_final(ref_grouped_partial(
                ref_scan(ranges[:1], STORE_SALES))), "ref-grouped")
            out, wall, launches, transfers = run_counted(
                torch, lambda: gateway_call(client, gw.address, grouped,
                                            os.path.join(work, "grouped")),
                kernels)
            check_grouped(pa.Table.from_batches(out),
                          grouped_oracle(item0, qty0, price0), "ref_grouped")
            corpus["grouped"] = (wall, launches)
            for kind in ("hash_join", "sort_merge_join"):
                blob = ref_join_agg_task(kind, ranges[:1], dim)
                out, wall, launches, transfers = run_counted(
                    torch, lambda: gateway_call(client, gw.address, blob,
                                                os.path.join(work, kind)),
                    kernels)
                check_join_agg(pa.Table.from_batches(out), item0, price0,
                               brands, f"ref_{kind}")
                corpus[kind] = (wall, launches)

            # a shuffle writer (PARTIAL by g, hash g into 200) over byte
            # range 0, then 200 ipc_reader -> FINAL reduce tasks whose
            # file segments ride in the manifest, two connections at once
            data = os.path.join(work, "ref.data")
            index = os.path.join(work, "ref.index")
            node, rep = ref_shuffle_writer(
                ref_grouped_partial(ref_scan(ranges[:1], STORE_SALES)),
                ref_col("g"), SHUFFLE_PARTITIONS, data, index)
            map_blob = ref_task(node, "ref-map", out_rep=rep)
            state = [("g", "int32"), ("s", "float64"), ("lo", "float32"),
                     ("hi", "float32"), ("aq", "float64")]

            def shuffle_stage():
                import concurrent.futures as cf

                from blaze_tpu_torch.io.ipc import partition_ranges

                if gateway_call(client, gw.address, map_blob,
                                os.path.join(work, "map")):
                    raise AssertionError("ref shuffle writer returned rows")
                segs = partition_ranges(index)

                def reduce(p):
                    off, n = segs[p]
                    manifest = {"shuffle": [
                        [{"file": data, "offset": off, "length": n}]
                        if q == p else [] for q in range(
                            SHUFFLE_PARTITIONS)]}
                    blob = ref_task(ref_grouped_final(ref_ipc_reader(
                        "shuffle", state, SHUFFLE_PARTITIONS)),
                        "ref-reduce", partition=p)
                    return gateway_call(client, gw.address, blob,
                                        os.path.join(work, f"r{p}"),
                                        manifest)

                with cf.ThreadPoolExecutor(2) as pool:
                    return list(pool.map(reduce, range(SHUFFLE_PARTITIONS)))

            outs, wall, launches, transfers = run_counted(
                torch, shuffle_stage, kernels)
            table = pa.concat_tables([pa.Table.from_batches(o)
                                      for o in outs if o])
            check_grouped(table, grouped_oracle(item0, qty0, price0),
                          "ref_shuffle")
            for r, o in enumerate(outs):
                for rb in o:
                    if not (spark_pids(rb.column(0).to_numpy(),
                                       SHUFFLE_PARTITIONS) == r).all():
                        raise AssertionError(
                            f"ref_shuffle: reducer {r} holds a group of "
                            "another partition")
            corpus["shuffle"] = (wall, launches)
            total = {}
            for _, l in corpus.values():
                total = add_launches(total, l)
            for name in ("segment_reduce", "murmur3"):
                if total[name] <= 0:
                    raise AssertionError(f"ref_corpus did not launch {name}")
            results["ref_corpus"] = {"launches": total,
                                     "wall_s": sum(w for w, _ in
                                                   corpus.values())}
            emit({"phase": "cluster", "task": "ref_corpus",
                  "rows": len(item0), "wire": "reference (header bit 63)",
                  "tasks": {k: {"wall_s": w, "launches": l}
                            for k, (w, l) in corpus.items()},
                  "shuffle_reduce_tasks": SHUFFLE_PARTITIONS,
                  "concurrent_connections": 2,
                  "manifest": "file segments (header bit 62)",
                  "launches": total})

        # cluster_exchange and remote_exchange: exchange_agg's keyed
        # aggregate, the map stage (PARTIAL by g, hash g into 200) on
        # the workers, the 200 FINAL reduce partitions in this process
        fact_scan = ParquetScanExec(groups)
        oracle = grouped_oracle(item, qty, price)

        def exchange_run(ex_cls, task, **kw):
            ex = ex_cls(grouped_plan(fact_scan, AggMode.PARTIAL),
                        [Col("g")], SHUFFLE_PARTITIONS, cluster, **kw)
            final = HashAggregateExec(ex, keys=[(Col("g"), "g")],
                                      aggs=grouped_aggs(),
                                      mode=AggMode.FINAL)
            ctx = ExecContext(device=device)
            retries = cluster.retries
            _, map_wall, _, _ = run_counted(
                torch, lambda: ex.map_output_statistics(ctx), kernels)
            table, red_wall, launches, transfers = run_counted(
                torch, lambda: run_plan(final, ctx), kernels)
            check_grouped(table, oracle, task)
            segs = ex.segments_for((0, SHUFFLE_PARTITIONS), ctx)
            wl = worker_launches(ex.map_metas)
            for name in ("murmur3", "segment_reduce"):
                if wl.get(name, 0) <= 0 and device != "cpu":
                    raise AssertionError(f"{task}: the workers did not "
                                         f"launch {name}")
            if cluster.retries != retries or cluster.quarantined:
                raise AssertionError(
                    f"{task}: {cluster.retries - retries} retries, "
                    f"quarantined {cluster.quarantined}")
            results[task] = {"launches": add_launches(launches, wl),
                             "wall_s": map_wall + red_wall}
            line = {"phase": "cluster", "task": task, "rows": rows,
                    "wall_s": map_wall + red_wall,
                    "map_stage_s": map_wall, "reduce_stage_s": red_wall,
                    "rows_per_s": rows / (map_wall + red_wall),
                    "workers": CLUSTER_WORKERS, "map_tasks": len(groups),
                    "reduce_partitions": SHUFFLE_PARTITIONS,
                    "groups": table.num_rows,
                    "shuffle_bytes_written": sum(
                        ex.map_output_statistics(ctx)),
                    "worker_launches": wl, "driver_launches": launches,
                    "transfers": transfers,
                    "retries": cluster.retries - retries,
                    "quarantined": len(cluster.quarantined),
                    **first_task_walls(ex.map_metas)}
            return ex, segs, line

        ex, segs, line = exchange_run(
            ClusterShuffleExchangeExec, "cluster_exchange",
            shuffle_dir=os.path.join(work, "cshuffle"))
        emit(line)
        map_stage_compare(torch, work, rows // 32, seed, cluster, kernels,
                          device)

        ex, segs, line = exchange_run(RemoteClusterShuffleExchangeExec,
                                      "remote_exchange")
        from blaze_tpu_torch.runtime.transport import RemoteSegment

        remote = [s for s in segs if isinstance(s, RemoteSegment)]
        if len(remote) != len(segs) or not sum(s.length for s in remote):
            raise AssertionError(f"remote_exchange: {len(remote)} of "
                                 f"{len(segs)} segments remote")
        line.update(remote_segments=len(remote),
                    remote_bytes=sum(s.length for s in remote),
                    block_servers=len({(s.host, s.port) for s in remote}))
        emit(line)

        # host profile: one exchange map task over the file's first row
        # group and one reduce task of its output, as TaskDefinitions
        # through execute_task in this process
        from blaze_tpu_torch.ops.parquet_scan import row_group_midpoint

        meta = pq.ParquetFile(fact).metadata
        one_group = ParquetScanExec([[FileRange(
            fact, 0, row_group_midpoint(meta.row_group(0)) + 1)]])
        mdata = os.path.join(work, "prof.data")
        mindex = os.path.join(work, "prof.index")
        map_blob = task_to_proto(exchange_map_plan(one_group, mdata, mindex),
                                 0)
        host_profile(lambda: list(execute_task(map_blob, ExecContext(
            device=device))), "exchange_map_task",
            input_rows=meta.row_group(0).num_rows)
        reduce_blob = reduce_tasks(exchange_reduce_plan(
            grouped_plan(fact_scan, AggMode.PARTIAL).schema),
            [(mdata, mindex)], SHUFFLE_PARTITIONS)[0]
        host_profile(lambda: list(execute_task(reduce_blob, ExecContext(
            device=device))), "exchange_reduce_task")
    finally:
        cluster.stop()

    try:
        # shuffle_manager: map 0 by the device tier, map 1 by the host
        # tier, one shuffle; every reduce partition reads both
        results.update(shuffle_manager_check(torch, work, fact, groups,
                                             kernels, device))
        # embed: q6 through the C++ embed host, in process on the card
        embed_check(work, fact, qty, price, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


def map_stage_compare(torch, work: str, rows: int, seed: int, cluster,
                      kernels, device="cuda"):
    """exchange_agg's map stage (PARTIAL by g, hash g into 200) over
    `rows` rows in 4 byte ranges of one row group each, in turns: on the
    MiniCluster's 2 (warm) worker processes, then on 4 threads in this
    process (the scheduler's way)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import AggMode, FileRange, ParquetScanExec
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.parallel import (
        ClusterShuffleExchangeExec,
        ShuffleExchangeExec,
    )

    path = os.path.join(work, "store_sales_compare.parquet")
    item, qty, price = store_sales_columns(rows, seed)
    pq.write_table(pa.table({"item": item, "qty": qty, "price": price}),
                   path, compression="zstd",
                   row_group_size=-(-rows // CLUSTER_SPLITS))
    scan = ParquetScanExec(byte_splits(FileRange, path, CLUSTER_SPLITS))
    walls = {}
    for name, make in (
            ("processes_2", lambda: ClusterShuffleExchangeExec(
                grouped_plan(scan, AggMode.PARTIAL), [Col("g")],
                SHUFFLE_PARTITIONS, cluster,
                shuffle_dir=os.path.join(work, "cmp_processes"))),
            ("threads_4", lambda: ShuffleExchangeExec(
                grouped_plan(scan, AggMode.PARTIAL), [Col("g")],
                SHUFFLE_PARTITIONS,
                shuffle_dir=os.path.join(work, "cmp_threads")))):
        ex = make()
        sizes, walls[name], _, _ = run_counted(
            torch, lambda: ex.map_output_statistics(
                ExecContext(device=device)), kernels)
        walls[name + "_bytes"] = sum(sizes)
    if walls["processes_2_bytes"] != walls["threads_4_bytes"]:
        raise AssertionError(f"map_stage_compare: {walls}")
    emit({"phase": "cluster", "task": "map_stage_compare", "rows": rows,
          "map_tasks": CLUSTER_SPLITS,
          "reduce_partitions": SHUFFLE_PARTITIONS,
          "processes_2_s": walls["processes_2"],
          "threads_4_s": walls["threads_4"],
          "shuffle_bytes_written": walls["threads_4_bytes"]})


def range_columns(file_range):
    """(item, qty, price) of the row groups a FileRange owns, read on
    the host with the scan's own rule."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.ops.parquet_scan import row_group_midpoint

    pf = pq.ParquetFile(file_range.path)
    end = file_range.start + file_range.length
    owned = [i for i in range(pf.metadata.num_row_groups)
             if file_range.start <= row_group_midpoint(
                 pf.metadata.row_group(i)) < end]
    t = pa.concat_tables([pf.read_row_group(i) for i in owned])
    return tuple(t.column(n).to_numpy() for n in ("item", "qty", "price"))


def shuffle_manager_check(torch, work: str, fact: str, groups, kernels,
                          device="cuda"):
    """One shuffle of the shuffle manager written by both producers: map
    0 (byte range 0) by write_map_native on the card, map 1 (byte range
    1) by write_map_batches on the host; every reduce partition reads
    both, holds only its Spark partition's keys, and the two maps' rows
    come back exactly once. Then host_partition_ids against K4's ids, bit
    for bit, at one batch of 16,384 rows and n = 200."""
    import pyarrow as pa

    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.exprs.optimize import bind_opt
    from blaze_tpu_torch.ops import ParquetScanExec
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.host_shuffle import host_partition_ids
    from blaze_tpu_torch.ops.shuffle_writer import spark_partition_ids
    from blaze_tpu_torch.parallel.shuffle_manager import ShuffleManager

    cols = [range_columns(groups[m][0]) for m in (0, 1)]
    host_batches = pa.table(dict(zip(("item", "qty", "price"),
                                     cols[1]))).to_batches(1 << 20)
    mgr = ShuffleManager(os.path.join(work, "shuffle_manager"))
    h = mgr.register_shuffle(2, SHUFFLE_PARTITIONS, ["item"])
    scan = ParquetScanExec([[groups[0][0]], [groups[1][0]]])
    _, native_wall, launches, _ = run_counted(
        torch, lambda: mgr.write_map_native(h, 0, scan,
                                            ExecContext(device=device)),
        kernels)
    t0 = time.perf_counter()
    mgr.write_map_batches(h, 1, iter(host_batches))
    host_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts = [list(mgr.read_partition(h, p))
             for p in range(SHUFFLE_PARTITIONS)]
    read_wall = time.perf_counter() - t0
    got = []
    for p, batches in enumerate(parts):
        for rb in batches:
            if not (spark_pids(rb.column(0).to_numpy(),
                               SHUFFLE_PARTITIONS) == p).all():
                raise AssertionError(f"shuffle_manager: partition {p} "
                                     "holds another partition's key")
            got.append(rb)
    t = pa.Table.from_batches(got)
    want = [np.concatenate(c) for c in zip(*cols)]
    have = [t.column(n).to_numpy() for n in ("item", "qty", "price")]
    order_w = np.lexsort(want[::-1])
    order_h = np.lexsort(have[::-1])
    if t.num_rows != len(want[0]) or not all(
            np.array_equal(a[order_h], b[order_w])
            for a, b in zip(have, want)):
        raise AssertionError(f"shuffle_manager: {t.num_rows} rows read, "
                             f"{len(want[0])} written, or other rows")
    if device != "cpu" and launches["murmur3"] <= 0:
        raise AssertionError("shuffle_manager: the device tier did not "
                             "launch murmur3")

    rb = pa.record_batch(dict(zip(("item", "qty", "price"),
                                  (c[:HOST_ID_ROWS] for c in cols[0]))))
    cb = ColumnBatch.from_arrow(rb, device=device)

    def device_ids(keys):
        return spark_partition_ids(
            cb, [bind_opt(Col(k), cb.schema) for k in keys],
            SHUFFLE_PARTITIONS)[:HOST_ID_ROWS].cpu().numpy()

    for keys in HOST_ID_KEYS:
        host = host_partition_ids(rb, keys, SHUFFLE_PARTITIONS)
        dev, _, k4, _ = run_counted(torch, lambda: device_ids(keys),
                                    kernels)
        if not np.array_equal(host, dev):
            raise AssertionError(f"host_partition_ids {keys}: "
                                 f"{int((host != dev).sum())} ids differ "
                                 "from K4's")
        if device != "cpu" and k4["murmur3"] != 1:
            raise AssertionError(f"{keys}: {k4['murmur3']} K4 launches")
    emit({"phase": "cluster", "task": "shuffle_manager",
          "rows": t.num_rows, "native_map_s": native_wall,
          "host_map_s": host_wall, "read_200_partitions_s": read_wall,
          "map_bytes": sum(mgr.map_statistics(h)),
          "host_ids_equal_k4": {"rows": HOST_ID_ROWS,
                                "partitions": SHUFFLE_PARTITIONS,
                                "key_sets": [list(k) for k in
                                             HOST_ID_KEYS]},
          "launches": launches})
    mgr.remove_shuffle(h)
    return {"shuffle_manager": {"launches": launches,
                                "wall_s": native_wall}}


def embed_check(work: str, fact: str, qty, price, device="cuda"):
    """q6 through the port's C++ embed host (csrc/blaze_embed_main.cpp):
    CPython hosted in the host process runs the task on the card and
    exports its batches as Arrow C-Data; the host's checksums equal
    q6's numpy oracle (COUNT exact, SUM within 1e-9 relative)."""
    from blaze_tpu_torch.ops import FileRange, ParquetScanExec
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime import embed

    t0 = time.perf_counter()
    host = embed.build_host()
    build_s = time.perf_counter() - t0
    path = os.path.join(work, "embed_q6.task")
    with open(path, "wb") as f:
        f.write(task_to_proto(q6_plan(ParquetScanExec([[FileRange(fact)]]),
                                      True), 0))
    t0 = time.perf_counter()
    r = embed.run_host([path], device=None if device == "cuda" else device)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"embed host exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    (rows, got_sum, got_n), = embed.parse_checksums(r.stdout)
    exp_sum, exp_n = q6_oracle(qty, price)
    if rows != 1 or got_n != exp_n or \
            abs(got_sum - exp_sum) > 1e-9 * abs(exp_sum):
        raise AssertionError(f"embed q6: got rows {rows}, ({got_sum}, "
                             f"{got_n}); numpy ({exp_sum}, {exp_n})")
    emit({"phase": "cluster", "task": "embed", "rows": len(qty),
          "wall_s": wall, "build_s": build_s,
          "host": os.path.relpath(host, REPO),
          "python_config": embed.python_config(),
          "checksums": [rows, got_sum, got_n],
          "note": "wall includes the embedded interpreter's start, "
                  "torch's import and the card's context"})


def time_tree(torch, tree: str, rows: int, grouped_rows: int):
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
    compare_paths(torch, tree, rows, grouped_rows)


def compare_paths(torch, tree: str, rows: int, grouped_rows: int,
                  runs: int = 3):
    """The q6, select, join_agg and join_kr tasks over one parquet file
    of `rows` rows, and grouped and grouped_partial (PARTIAL task and
    FINAL) over its first `grouped_rows` rows (this script's plans),
    through the tree's execute_task: each task's wall `runs` times, its
    transfer and graph counts, then a profiled run (its own line) for
    the device calls and busy time."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.ops import AggMode, FileRange, ParquetScanExec
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.plan.serde import task_to_proto
    from blaze_tpu_torch.runtime.executor import execute_task, run_plan

    work = os.path.join(REPO, "build", "chip_smoke_compare")
    path = os.path.join(work, f"store_sales_{rows}.parquet")
    small = os.path.join(work, f"store_sales_{grouped_rows}.parquet")
    dim = os.path.join(work, "item.parquet")
    if not os.path.exists(dim):
        os.makedirs(work, exist_ok=True)
        item, qty, price = write_store_sales(path + ".tmp", rows, 42)
        write_parquet(small + ".tmp", item[:grouped_rows],
                      qty[:grouped_rows], price[:grouped_rows])
        pq.write_table(pa.table({
            "i_item": np.arange(ITEMS, dtype=np.int32),
            "i_brand": item_brands(rows, 42)}), dim + ".tmp")
        for p in (path, small, dim):
            os.replace(p + ".tmp", p)

    def scan(p):
        return ParquetScanExec([[FileRange(p)]])

    def task_run(plan):
        blob = task_to_proto(plan, 0)
        return lambda: list(execute_task(blob, join_ctx(rows)))

    partial = grouped_plan(scan(small), AggMode.PARTIAL)
    partial_blob = task_to_proto(partial, 0)

    def two_phase():
        ctx = ExecContext(device="cuda")
        states = list(execute_task(partial_blob, ctx))
        return run_plan(final_plan(states, partial.schema, ctx.device), ctx)

    tasks = (
        ("q6", rows, task_run(q6_plan(scan(path), True))),
        ("select", rows, task_run(q6_plan(scan(path), False))),
        ("grouped", grouped_rows,
         task_run(grouped_plan(scan(small), AggMode.COMPLETE))),
        ("grouped_partial", grouped_rows, two_phase),
        ("join_agg", rows, task_run(join_agg_plan(scan(path), scan(dim)))),
        ("join_kr", rows, task_run(join_agg_plan(scan(path), scan(dim),
                                                 16))))
    for task, n, run in tasks:
        walls = []
        for _ in range(runs):
            _, wall, _, transfers = run_counted(torch, run, {})
            walls.append(wall)
        emit({"phase": "compare_path", "tree": tree, "task": task,
              "rows": n, "walls_s": walls,
              "fusion": fusion_counts(transfers, n),
              "syncs_per_batch": transfers.get("d2h_syncs", 0)
              / -(-n // 16384),
              "transfers": transfers})
        profile_run(torch, run, f"{task}@{tree}", statistics.median(walls))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 23,
                    help="parquet rows of the path phase")
    ap.add_argument("--grouped-rows", type=int, default=1 << 22,
                    help="parquet rows of the grouped tasks")
    ap.add_argument("--string-rows", type=int, default=1 << 23,
                    help="store_sales rows of tpcds_brand and "
                         "tpcds_customer")
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
        time_tree(torch, args.tree, args.rows, args.grouped_rows)
        return 0
    smi = smi_line()
    if args.compare:
        print(smi, flush=True)
        for tree in (args.compare, REPO, REPO, args.compare):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree, "--rows", str(args.rows),
                            "--grouped-rows", str(args.grouped_rows)],
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
        res.update(strings_phase(torch, args.string_rows, args.seed,
                                 kernels))
        res.update(decimal_phase(torch, args.rows, args.grouped_rows,
                                 args.seed, kernels))
        res.update(planner_phase(torch, args.rows, args.seed, kernels))
        res.update(cluster_phase(torch, args.rows, args.seed, kernels))

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
                                                   "union_limit", "tpcds",
                                                   "dec_", "plan_",
                                                   "range_sort", "ref_",
                                                   "cluster_", "remote_",
                                                   "shuffle_manager"))]
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
