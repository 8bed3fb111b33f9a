"""Window functions on the device.

A port of the JAX package's ops/window.py. The reference never offloads
Window (it plants a row barrier and leaves it to the JVM,
BlazeConverters.scala:93-107); here one stable sort by (partition keys,
order keys), boundary detection, then a few vectorized passes per
function:

- row_number, rank, dense_rank, ntile(n), percent_rank, cume_dist,
  lag/lead(offset k);
- sum/min/max/count/avg over the whole partition (frame None), ROWS
  BETWEEN a PRECEDING AND b FOLLOWING (("rows", lo, hi), None =
  UNBOUNDED), RANGE UNBOUNDED PRECEDING .. CURRENT ROW (("range", None,
  0): ties share the frame's result) and RANGE BETWEEN x PRECEDING AND
  y FOLLOWING over one <=32-bit order key (("range", lo, hi): frame
  bounds by searchsorted over packed int64 order keys).

Rows come out in (partition, order) order, as Spark's WindowExec gives
them. Where the JAX program differs:

- partition and run starts and ends come from kernel K2's packed
  boundary positions, gathered per row (no `nonzero`, so no host sync
  per call);
- float sums accumulate per partition in double-double (a segmented
  Hillis-Steele scan of error-free two-sums), then round to the output
  dtype: the JAX package's float32 SUM takes one float32 prefix over the
  whole sorted column and loses the low bits of every partition to the
  global prefix's ulp. Infinities and NaN are counted apart, so a
  frame after an infinity (not holding it) sums its own values, where
  the JAX package's prefix difference gives NaN. Integer sums and
  counts are exact int64 prefix differences, as in the JAX package;
- MIN and MAX, running, sliding or whole, propagate NaN and order -0.0
  below +0.0 on every frame, as kernel K1 does (the JAX package's
  running scan gives +0.0 where its other frames give -0.0);
- the scans and the sparse table take log2 of the longest partition
  steps: one host sync a call (`d2h_syncs.window_span`), only when a
  function needs them.

The sort permutation is cached across executions on the identity and
`_version` of the input tensors (an in-place write bumps the version).
A Project/Rename chain under the window folds into it
(planner/fuse.py): the chain's stages run on the concatenated input.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import torch

from blaze_tpu_torch.types import DataType, Field, Schema
from blaze_tpu_torch.batch import Column, ColumnBatch, torch_dtype
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.eval import CV, DeviceEvaluator, _fmax, _fmin
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.exprs.typing import infer_dtype
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.kernels.compact import compact_perm
from blaze_tpu_torch.ops.project import batch_cvs
from blaze_tpu_torch.ops.sort import SortKey, check_key_type
from blaze_tpu_torch.ops.util import (
    PACKED_MAX_ROWS,
    _order_key_u32,
    concat_batches,
    sort_indices,
)
from blaze_tpu_torch.runtime import dispatch

_RANKING = ("row_number", "rank", "dense_rank", "ntile",
            "percent_rank", "cume_dist")


@dataclasses.dataclass(frozen=True)
class WindowFn:
    kind: str  # ranking | lag | lead | frame aggs
    source: Optional[ir.Expr]  # for lag/lead/aggs
    output: str
    # lag/lead distance, or ntile bucket count
    offset: int = 1
    # None = whole partition; ("rows", lo, hi) with None = UNBOUNDED;
    # ("range", None, 0) = RANGE UNBOUNDED..CURRENT (ties share)
    frame: Optional[tuple] = None


def expr_refs(e: ir.Expr, schema: Schema) -> Set[int]:
    """Indices of the columns an expression reads."""
    if isinstance(e, ir.BoundCol):
        return {e.index}
    if isinstance(e, ir.Col):
        return {schema.index_of(e.name)}
    out: Set[int] = set()
    for c in ir.children(e):
        out |= expr_refs(c, schema)
    return out


class WindowExec(PhysicalOp):
    def __init__(self, child: PhysicalOp,
                 partition_by: Sequence[ir.Expr],
                 order_by: Sequence[SortKey],
                 functions: Sequence[WindowFn]):
        self.children = [child]
        schema = child.schema
        # window-input schema: fixed here even when the fusion pass later
        # rebases children[0] to the chain leaf (planner/fuse folds a
        # Project/Rename chain into this operator)
        self._in_schema = schema
        self._fused_pipeline = None
        self._sort_cache: Dict[tuple, tuple] = {}
        self.partition_by = [bind_opt(e, schema) for e in partition_by]
        self.order_by = [
            SortKey(bind_opt(k.expr, schema), k.ascending, k.nulls_first)
            for k in order_by
        ]
        self.functions = [
            WindowFn(f.kind,
                     bind_opt(f.source, schema)
                     if f.source is not None else None,
                     f.output, f.offset, f.frame)
            for f in functions
        ]
        for f in self.functions:
            if f.kind in ("lag", "lead") and f.offset < 0:
                raise NotImplementedError(
                    f"negative {f.kind} offset (use the mirror fn)")
            if f.kind == "ntile" and f.offset < 1:
                # SQL: NTILE(n) requires n >= 1
                raise NotImplementedError("ntile bucket count must be >= 1")
            if f.frame is None:
                continue
            ftype, lo, hi = f.frame
            if ftype == "range":
                if not (lo is None and hi == 0):
                    # RANGE with VALUE offsets: exactly one numeric
                    # order key narrow enough for the 32-bit order
                    # encoding the bound search packs
                    if len(self.order_by) != 1:
                        raise NotImplementedError(
                            "RANGE value offsets need exactly one "
                            "ORDER BY key")
                    odt = infer_dtype(self.order_by[0].expr, schema)
                    narrow = (
                        odt.id.value in ("int8", "int16", "int32",
                                         "date32", "float32")
                        or (odt.is_integer
                            and odt.physical_dtype().itemsize <= 4))
                    if not narrow:
                        raise NotImplementedError(
                            "RANGE value offsets over wide order "
                            "keys are host-tier work")
                    for off in (lo, hi):
                        if off is not None and off < 0:
                            raise NotImplementedError(
                                "negative RANGE offset")
            elif ftype == "rows":
                if lo is not None and lo < 0:
                    raise NotImplementedError("negative frame lo")
                if hi is not None and hi < 0:
                    raise NotImplementedError("negative frame hi")
            else:
                raise NotImplementedError(f"frame type {ftype}")
        for e in self.partition_by + [k.expr for k in self.order_by] + [
            f.source for f in self.functions if f.source is not None
        ]:
            dt = infer_dtype(e, schema)
            if dt.is_wide_decimal:
                raise NotImplementedError(
                    "window over decimal(>18) is host-tier work")
            check_key_type("window column", dt)
        out_fields = list(schema.fields)
        for f in self.functions:
            out_fields.append(
                Field(f.output, self._fn_dtype(f, schema), True))
        self._schema = Schema(out_fields)

    @staticmethod
    def _fn_dtype(f: WindowFn, schema: Schema) -> DataType:
        if f.kind in ("percent_rank", "cume_dist"):
            return DataType.float64()
        if f.kind in _RANKING or f.kind == "count":
            return DataType.int64()
        if f.kind in ("lag", "lead"):
            return infer_dtype(f.source, schema)
        if f.kind == "avg":
            return DataType.float64()
        st = infer_dtype(f.source, schema)
        if f.kind == "sum" and st.is_integer:
            return DataType.int64()
        return st

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        folded = "" if self._fused_pipeline is None \
            else f", folded {self._fused_pipeline.describe()}"
        return (f"WindowExec[{', '.join(f.kind for f in self.functions)}"
                f"{folded}]")

    def sort_keys(self) -> List[SortKey]:
        return [SortKey(e, True, True) for e in self.partition_by] \
            + list(self.order_by)

    def input_batch(self, partition: int, ctx: ExecContext) -> ColumnBatch:
        """The partition's input, concatenated (the chain leaf's output
        when a chain is folded)."""
        src = self.children[0]
        return concat_batches(list(src.execute(partition, ctx)),
                              src.schema, ctx.device)

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        cb = self.input_batch(partition, ctx)
        if cb.num_rows == 0:
            return
        dispatch.record("window_route.window")
        cols, outs = self.run(cb)
        out = [Column(f.dtype, v, m)
               for f, (v, m) in zip(self._schema, cols + outs)]
        yield ColumnBatch(self._schema, out, cb.num_rows)

    # ------------------------------------------------------------------
    def _cache_key(self, bufs, num_rows: int) -> tuple:
        return tuple((id(b), b._version) for b in bufs), num_rows

    def _cached_sort_idx(self, bufs, num_rows: int
                         ) -> Optional[torch.Tensor]:
        """The sort permutation of these very tensors, unmodified since
        (same objects, same `_version`), or None."""
        key = self._cache_key(bufs, num_rows)
        hit = self._sort_cache.get(key)
        if hit is None:
            return None
        refs, idx = hit
        if all(r() is b for r, b in zip(refs, bufs)):
            dispatch.record("window_sort_cache_hits")
            return idx
        self._sort_cache.pop(key, None)
        return None

    def _store_sort_idx(self, bufs, num_rows: int, idx) -> None:
        refs = tuple(weakref.ref(b) for b in bufs)
        self._sort_cache[self._cache_key(bufs, num_rows)] = (refs, idx)
        while len(self._sort_cache) > 2:  # device memory is precious
            self._sort_cache.pop(next(iter(self._sort_cache)))

    def run(self, cb: ColumnBatch, want_cols: Optional[Set[int]] = None,
            want_fns: Optional[Sequence[bool]] = None
            ) -> Tuple[List[CV], List[CV]]:
        """The folded chain, the shared (partition, order) argsort, the
        gather and every frame pass over one concatenated input batch:
        (sorted window-input columns, function outputs). Only the input
        columns in `want_cols` (default all) and the functions flagged
        in `want_fns` (default all) are produced; the others are
        (None, None)."""
        cap, dev, n = cb.capacity, cb.device, cb.num_rows
        schema = self._in_schema
        bufs = [t for c in cb.columns
                for t in (c.values, c.validity) if t is not None]
        cols = batch_cvs(cb)
        if self._fused_pipeline is not None:
            cols, _ = self._fused_pipeline.run(cols, cap, dev, None)
        if want_fns is None:
            want_fns = [True] * len(self.functions)
        if want_cols is None:
            want_cols = set(range(len(schema)))
        want = set(want_cols)
        for e in self.partition_by + [k.expr for k in self.order_by]:
            want |= expr_refs(e, schema)
        for f, w in zip(self.functions, want_fns):
            if w and f.source is not None:
                want |= expr_refs(f.source, schema)
        idx = self._cached_sort_idx(bufs, n)
        if idx is None:
            ev = DeviceEvaluator(schema, cols, cap, dev)
            lanes = []
            for k in self.sort_keys():
                v, m = ev.evaluate(k.expr)
                lanes.append((v, m, k.ascending, k.nulls_first))
            idx = sort_indices(lanes, n, cap, dev)
            self._store_sort_idx(bufs, n, idx)
        sorted_cols: List[CV] = [
            (v[idx], None if m is None else m[idx]) if i in want
            else (None, None)
            for i, (v, m) in enumerate(cols)]
        ev = DeviceEvaluator(schema, sorted_cols, cap, dev)
        frames = _Frames(ev, self.partition_by, self.order_by, n, cap, dev)
        outs = [frames.compute(f) if w else (None, None)
                for f, w in zip(self.functions, want_fns)]
        outs = [(v if v is None else v.to(torch_dtype(
                    self._fn_dtype(f, schema))), m)
                for f, (v, m) in zip(self.functions, outs)]
        return sorted_cols, outs


# ---------------------------------------------------------------------------
# frame passes over the sorted batch
# ---------------------------------------------------------------------------

def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """x[i - 1] at i, x[0] at 0."""
    return torch.cat([x[:1], x[:-1]])


def _gather(x: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """x at clamped positions (CUDA asserts on an out-of-range index)."""
    return x[at.clamp(0, x.shape[0] - 1)]


class _Segments:
    """Start and end (exclusive) of each row's segment from its start
    flags, with no host sync: kernel K2 packs the flagged positions to
    the front (their count stays on the device), and each row gathers
    its segment's start and the next segment's."""

    def __init__(self, flags: torch.Tensor, n: int,
                 seg: Optional[torch.Tensor] = None):
        self.flags = flags
        cap = flags.shape[0]
        starts, count = compact_perm(flags)
        starts = starts.to(torch.int64)
        if seg is None:
            seg = torch.cumsum(flags, 0, dtype=torch.int64) - 1
        seg = seg.clamp(0, cap - 1)
        self.start = starts[seg]
        nxt = seg + 1
        self.end = torch.where(nxt < count, starts[nxt.clamp(max=cap - 1)],
                               torch.full_like(nxt, n))


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _dd_add(ah, al, bh, bl):
    """Double-double a + b; a non-finite high part passes through."""
    s, e = _two_sum(ah, bh)
    e = e + (al + bl)
    h = s + e
    lo = e - (h - s)
    fin = torch.isfinite(s)
    return torch.where(fin, h, s), torch.where(fin, lo,
                                               torch.zeros_like(lo))


def _neutral(dtype: torch.dtype, is_min: bool):
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _red(is_min: bool):
    """MIN/MAX with K1's rule: NaN propagates, -0.0 below +0.0."""
    return _fmin if is_min else _fmax


class _Frames:
    """Every window function over one sorted batch (the JAX package's
    `_build_kernel` body)."""

    def __init__(self, ev: DeviceEvaluator, partition_by, order_by,
                 n: int, cap: int, device):
        self.ev = ev
        self.order_by = order_by
        self.n, self.cap, self.device = n, cap, device
        self.pos = torch.arange(cap, dtype=torch.int64, device=device)
        self.live = self.pos < n
        pb = (self._boundaries(partition_by) | (self.pos == 0)) & self.live
        self.pb = pb
        gid = torch.cumsum(pb, 0, dtype=torch.int64) - 1
        self.seg = _Segments(pb, n, gid)
        self.gid = torch.where(self.live, gid, torch.full_like(gid, cap - 1))
        self.size = self.seg.end - self.seg.start
        self.rn = self.pos - self.seg.start + 1
        self._run: Optional[_Segments] = None
        self._span: Optional[int] = None
        self._bounds: Dict[tuple, tuple] = {}

    # -- partition structure ---------------------------------------------
    def _boundaries(self, exprs) -> torch.Tensor:
        b = torch.zeros(self.cap, dtype=torch.bool, device=self.device)
        for e in exprs:
            v, m = self.ev.evaluate(e)
            extra = None
            if v.is_floating_point():
                # NaN partitions/runs group together (Spark normalizes
                # NaN), apart from +inf
                nan = torch.isnan(v)
                extra = nan != _shift_down(nan)
                v = v.masked_fill(nan, float("inf"))
            neq = v != _shift_down(v)
            if extra is not None:
                neq = neq | extra
            if m is not None:
                pm = _shift_down(m)
                neq = torch.where(m & pm, neq, m != pm)
            b = b | neq
        return b

    @property
    def run(self) -> _Segments:
        """Value runs (peers) within partitions."""
        if self._run is None:
            vb = (self._boundaries([k.expr for k in self.order_by])
                  | self.pb) & self.live
            self._run = _Segments(vb, self.n)
        return self._run

    @property
    def span(self) -> int:
        """The longest partition's row count (one host sync)."""
        if self._span is None:
            self._span = dispatch.host_int(
                (self.size * self.live).max(), "window_span")
        return self._span

    # -- prefix sums -------------------------------------------------------
    def _prefix_i64(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive int64 prefix sums reset at partition starts (exact:
        int64 wraps consistently)."""
        g = torch.cumsum(x.to(torch.int64), 0)
        gshift = torch.cat([g.new_zeros(1), g[:-1]])
        return g - _gather(gshift, self.seg.start)

    def _prefix_dd(self, x: torch.Tensor):
        """Inclusive float64 double-double prefix sums per partition:
        a segmented Hillis-Steele scan."""
        hi = x.to(torch.float64)
        lo = torch.zeros_like(hi)
        d = 1
        while d < self.span:
            ok = (self.pos[d:] - d) >= self.seg.start[d:]
            nh, nl = _dd_add(hi[:-d], lo[:-d], hi[d:], lo[d:])
            hi = torch.cat([hi[:d], torch.where(ok, nh, hi[d:])])
            lo = torch.cat([lo[:d], torch.where(ok, nl, lo[d:])])
            d <<= 1
        return hi, lo

    def _prefix(self, vals: torch.Tensor, contrib: torch.Tensor):
        """Partition prefix sums of vals where contrib, as lanes: one
        int64 lane; for floats, the double-double (hi, lo) of the finite
        values and int64 counts of +inf, -inf and NaN, so a frame's sum
        is right beside an infinity outside it."""
        x = torch.where(contrib, vals, torch.zeros_like(vals))
        if not vals.is_floating_point():
            return (self._prefix_i64(x),)
        fin = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        return self._prefix_dd(fin) + (
            self._prefix_i64(x == float("inf")),
            self._prefix_i64(x == float("-inf")),
            self._prefix_i64(torch.isnan(x)))

    @staticmethod
    def _value(pre) -> torch.Tensor:
        """The sums a prefix's lanes stand for."""
        if len(pre) == 1:
            return pre[0]
        s, _, pinf, ninf, nan = pre
        s = torch.where(pinf > 0, float("inf"), s)
        s = torch.where(ninf > 0, float("-inf"), s)
        return torch.where((nan > 0) | ((pinf > 0) & (ninf > 0)),
                           float("nan"), s)

    def _at(self, pre, at: torch.Tensor):
        return tuple(_gather(t, at) for t in pre)

    def _span_sum(self, pre, lo_idx, hi_idx) -> torch.Tensor:
        """Sum over row spans [lo_idx, hi_idx] (partition-clamped by the
        caller) from a partition prefix; empty spans sum to zero."""
        last = self._at(pre, hi_idx)
        before = lo_idx > self.seg.start
        prev = tuple(torch.where(before, t, torch.zeros_like(t))
                     for t in self._at(pre, lo_idx - 1))
        if len(pre) == 1:
            diff = (last[0] - prev[0],)
        else:
            diff = _dd_add(last[0], last[1], -prev[0], -prev[1]) + tuple(
                a - b for a, b in zip(last[2:], prev[2:]))
        s = self._value(diff)
        return torch.where(hi_idx >= lo_idx, s, torch.zeros_like(s))

    def _rows_span(self, lo, hi):
        """A ROWS frame's explicit clamped row spans (None = unbounded to
        the partition edge)."""
        lo_idx = self.seg.start if lo is None \
            else torch.maximum(self.pos - lo, self.seg.start)
        hi_idx = self.seg.end - 1 if hi is None \
            else torch.minimum(self.pos + hi, self.seg.end - 1)
        return lo_idx, hi_idx

    # -- min / max ---------------------------------------------------------
    def _running_extreme(self, v, contrib, is_min: bool) -> torch.Tensor:
        """Partition-reset running MIN/MAX: a segmented Hillis-Steele
        scan."""
        red = _red(is_min)
        x = torch.where(contrib, v, torch.full_like(
            v, _neutral(v.dtype, is_min)))
        d = 1
        while d < self.span:
            ok = (self.pos[d:] - d) >= self.seg.start[d:]
            x = torch.cat([x[:d],
                           torch.where(ok, red(x[:-d], x[d:]), x[d:])])
            d <<= 1
        return x

    def _rmq(self, v, contrib, lo_idx, hi_idx, is_min: bool,
             max_len: Optional[int]) -> torch.Tensor:
        """MIN/MAX over explicit spans through a sparse table: doubling
        levels up to the longest span, each consumed as it is built, the
        two power-of-two covers of a span combined."""
        red = _red(is_min)
        neutral = _neutral(v.dtype, is_min)
        x = torch.where(contrib, v, torch.full_like(v, neutral))
        length = torch.clamp(hi_idx - lo_idx + 1, min=1)
        k = torch.frexp(length.to(torch.float64)).exponent.to(
            torch.int64) - 1
        pow2 = torch.ones_like(k) << k
        left = lo_idx.clamp(0, self.cap - 1)
        right = (hi_idx - pow2 + 1).clamp(0, self.cap - 1)
        bound = min(max_len if max_len is not None else self.span, self.cap)
        out = torch.full_like(x, neutral)
        level, width, j = x, 1, 0
        while True:
            out = torch.where(k == j, red(level[left], level[right]), out)
            if width >= bound:
                break
            shifted = torch.cat([level[width:],
                                 torch.full_like(level[:width], neutral)])
            level = red(level, shifted)
            width <<= 1
            j += 1
        return torch.where(hi_idx >= lo_idx, out, torch.full_like(out,
                                                                  neutral))

    # -- RANGE value offsets -----------------------------------------------
    def _range_bounds(self, lo_off, hi_off):
        """Frame spans for RANGE with value offsets, one searchsorted a
        bound over (gid:30 | null rank:1 | order key:32) packed into a
        non-negative int64 (rows are sorted by partition, null rank and
        order value). NULL order values take their peer run: offsets
        are undefined on NULL."""
        key = (lo_off, hi_off)
        if key in self._bounds:
            return self._bounds[key]
        if self.cap >= PACKED_MAX_ROWS:
            raise NotImplementedError(
                f"RANGE value offsets over {self.cap} rows: the packed "
                f"bound search takes fewer than {PACKED_MAX_ROWS}")
        sk = self.order_by[0]
        ov, om = self.ev.evaluate(sk.expr)
        asc = sk.ascending
        null_rank = torch.zeros_like(self.pos)
        if om is not None:
            # physical order: nulls_first sorts nulls before values
            valid = 1 if sk.nulls_first else 0
            null_rank = torch.where(om, valid, 1 - valid).to(torch.int64)

        def packed(values):
            enc = _order_key_u32(values, asc)
            if om is not None:
                enc = enc.masked_fill(~om, 0)
            return (self.gid << 33) | (null_rank << 32) | enc

        def bound_val(off, toward_hi):
            # bound arithmetic in a wider domain so it cannot wrap: ints
            # in int64, saturated to the key's range; floats saturate to
            # +/-inf by themselves
            plus = toward_hi == asc
            if ov.is_floating_point():
                return ov + off if plus else ov - off
            w = ov.to(torch.int64)
            b = w + int(off) if plus else w - int(off)
            info = torch.iinfo(ov.dtype)
            return b.clamp(info.min, info.max).to(ov.dtype)

        keys_sorted = packed(ov)
        if lo_off is None:
            lo_idx = self.seg.start
        else:
            lo_idx = torch.searchsorted(
                keys_sorted, packed(bound_val(lo_off, False)))
        if hi_off is None:
            hi_idx = self.seg.end - 1
        else:
            hi_idx = torch.searchsorted(
                keys_sorted, packed(bound_val(hi_off, True)),
                right=True) - 1
        if om is not None:
            if lo_off is not None:
                lo_idx = torch.where(om, lo_idx, self.run.start)
            if hi_off is not None:
                hi_idx = torch.where(om, hi_idx, self.run.end - 1)
        self._bounds[key] = (lo_idx, hi_idx)
        return lo_idx, hi_idx

    # -- one function --------------------------------------------------------
    def compute(self, f: WindowFn) -> CV:
        kind = f.kind
        seg = self.seg
        if kind == "row_number":
            return self.rn, None
        if kind == "rank":
            return self.run.start - seg.start + 1, None
        if kind == "dense_rank":
            dr = torch.cumsum(self.run.flags, 0, dtype=torch.int64)
            return dr - _gather(dr, seg.start) + 1, None
        if kind == "ntile":
            nt = int(f.offset)  # >= 1, validated at init
            base = self.size // nt
            rem = self.size % nt
            cutoff = rem * (base + 1)
            tile = torch.where(
                self.rn <= cutoff,
                (self.rn - 1) // torch.clamp(base + 1, min=1),
                rem + (self.rn - 1 - cutoff) // torch.clamp(base, min=1))
            return tile + 1, None
        if kind == "percent_rank":
            rk = (self.run.start - seg.start + 1).to(torch.float64)
            pr = (rk - 1.0) / torch.clamp(self.size - 1, min=1).to(
                torch.float64)
            return torch.where(self.size > 1, pr, torch.zeros_like(pr)), None
        if kind == "cume_dist":
            return ((self.run.end - seg.start).to(torch.float64)
                    / torch.clamp(self.size, min=1).to(torch.float64)), None
        v, m = self.ev.evaluate(f.source)
        if kind in ("lag", "lead"):
            return self._lag_lead(kind, int(f.offset), v, m)
        contrib = self.live if m is None else (self.live & m)
        if v.dtype == torch.bool:
            v = v.to(torch.int64) if kind in ("sum", "avg") \
                else v.to(torch.uint8)
        cnt_pre = self._prefix(contrib.to(torch.int64), self.live)
        if f.frame is None:
            at = seg.end - 1
            c = self._value(self._at(cnt_pre, at))
            return self._finish(kind, v, contrib, c, at=at,
                                running=None)
        ftype, lo, hi = f.frame
        running = lo is None and hi == 0
        if ftype == "range" and running:
            # RANGE UNBOUNDED..CURRENT: the running value at the peer
            # run's end
            at = self.run.end - 1
            c = self._value(self._at(cnt_pre, at))
            return self._finish(kind, v, contrib, c, at=at, running=None)
        if ftype == "rows" and running:
            c = self._value(cnt_pre)
            return self._finish(kind, v, contrib, c, at=None, running=True)
        if ftype == "range":
            lo_idx, hi_idx = self._range_bounds(lo, hi)
            max_len = None
        else:
            lo_idx, hi_idx = self._rows_span(lo, hi)
            max_len = lo + hi + 1 if lo is not None and hi is not None \
                else None
        c = self._span_sum(cnt_pre, lo_idx, hi_idx)
        if kind in ("min", "max"):
            red = self._rmq(v, contrib, lo_idx, hi_idx, kind == "min",
                            max_len)
            return red, c > 0
        s = None
        if kind != "count":
            s = self._span_sum(self._prefix(v, contrib), lo_idx, hi_idx)
        return self._sumlike(kind, s, c)

    def _finish(self, kind, v, contrib, c, at, running) -> CV:
        """A frame that ends at the row itself (`running`) or whose
        result is the running value at `at`."""
        if kind in ("min", "max"):
            r = self._running_extreme(v, contrib, kind == "min")
            return (r if at is None else _gather(r, at)), c > 0
        s = None
        if kind != "count":
            s = self._value(self._prefix(v, contrib))
            if at is not None:
                s = _gather(s, at)
        return self._sumlike(kind, s, c)

    @staticmethod
    def _sumlike(kind, s, c) -> CV:
        if kind == "count":
            return c, None
        if kind == "sum":
            return s, c > 0
        return (s.to(torch.float64)
                / torch.clamp(c, min=1).to(torch.float64)), c > 0

    def _lag_lead(self, kind, k, v, m) -> CV:
        if k == 0:  # Spark lag/lead(v, 0) = the current row
            return v, self.live if m is None else (self.live & m)
        if kind == "lag":
            sv = torch.cat([v[:k], v[:-k]])
            sm = None if m is None else torch.cat([m[:k], m[:-k]])
            ok = self.rn > k
        else:
            sv = torch.cat([v[k:], v[-k:]])
            sm = None if m is None else torch.cat([m[k:], m[-k:]])
            ok = self.rn <= self.size - k
        valid = ok if sm is None else (ok & sm)
        return sv, valid & self.live
