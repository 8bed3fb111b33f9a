"""Pipeline fusion: a Filter -> Project chain, and a keyless aggregate
over it, as ONE CUDA graph replay per batch.

Counterpart of the JAX package's ops/fused.py, where `fuse_pipelines`
(planner/fuse.py) rewrites a chain into one jitted program per batch.
Eager PyTorch pays a host launch per torch op instead, about 20 a q6
batch; here a batch from the parquet scan (a PackedColumnBatch: one
device byte buffer with its live row count in the header) is copied
into the static input of a graph captured for its layout, and the
graph replays the whole chain. Capture and replay are the counterpart
of `dispatch.cached_kernel` (runtime/dispatch.GraphCache).

- `FusedPipelineExec`: the chain over the deferred selection; its
  outputs leave the graph in one copy (a graph's output tensors are
  overwritten by its next replay, and a consumer such as a keyed
  aggregate holds several batches).
- `FusedAggregateExec`, keyless carry only (the JAX package's
  `_execute_keyless_carry`, `_keyless_merge_plan`,
  `_build_carry_kernel`): each batch runs the chain, K1's partial
  statistics and a merge into a running carry, all in the one replay;
  the carry is fetched once, at end of stream.
- `FusedWindowAggExec`: a keyless aggregate over a window, one eager
  pass per task (ops/window.py does the window's work; no graph).
- `HostFinalAggExec`: finalizes the fetched state row on the host.

Whether a batch replays a graph is decided from the plan and the
batch, never by catching a failure: the chain's expressions must not
need the host (the JAX package's `_expr_needs_host`), and the batch
must be a packed CUDA batch, as the parquet scan makes them. Any other
batch - on the CPU, or from another leaf - runs the same code eagerly
and counts in `dispatch` `graph_eager_batches`. A capture or replay
error raises.

The grouped carry and the fused join wait for ROADMAP 'Modules to
port' item 1.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import (
    Column,
    ColumnBatch,
    PackedColumnBatch,
    torch_dtype,
)
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.eval import CV, DeviceEvaluator, _fmax, _fmin
from blaze_tpu_torch.exprs.ir import AggFn
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.filter import FilterExec
from blaze_tpu_torch.ops.project import ProjectExec, batch_cvs
from blaze_tpu_torch.ops.rename import RenameColumnsExec
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.pack import Layout, live_rows


def stage_needs_host(op: PhysicalOp) -> bool:
    """True when a stage lowers a node to the host (ops/host_lower.py):
    host pyarrow work cannot replay in a graph, so the fusion pass
    leaves such a stage out of every chain (the JAX package's
    `_expr_needs_host`)."""
    if isinstance(op, RenameColumnsExec):
        return False
    return op.host


def _stage_key(st: PhysicalOp) -> Tuple:
    """Structure of one stage as a graph-cache key part. The IR's `==`
    builds an expression, so keys hold the expressions' reprs: bound
    ones, each column as its position and type."""
    if isinstance(st, FilterExec):
        return ("F", repr(st.predicate))
    if isinstance(st, RenameColumnsExec):
        return ("R", tuple(st.names))
    return ("P", tuple(repr(e) for e, _ in st.exprs))


def _schema_key(schema: Schema) -> Tuple:
    """Each field's name, logical type and nullability."""
    return tuple((f.name, repr(f.dtype), f.nullable) for f in schema)


def _graph_batch(cb: ColumnBatch) -> bool:
    """A batch a graph can take: packed by the scan, on the card, with
    no pending selection."""
    return (isinstance(cb, PackedColumnBatch) and cb.device.type == "cuda"
            and cb.selection is None)


def _static_input(cb: PackedColumnBatch):
    """A copy of a packed batch's buffer and its columns as views of
    it: a graph's input, refilled for each batch. A pruned column keeps
    its shared placeholder (batch.placeholder_values)."""
    holes = set(cb.placeholders)
    lay = Layout([(t.dtype, t.shape)
                  for i, c in enumerate(cb.columns) if i not in holes
                  for t in (c.values, c.validity) if t is not None])
    if lay.nbytes != cb.buf.numel():
        raise ValueError("a packed batch's columns do not match its buffer")
    buf = cb.buf.clone()
    it = iter(lay.views(buf))
    return buf, [(c.values, None) if i in holes else
                 (next(it), next(it) if c.validity is not None else None)
                 for i, c in enumerate(cb.columns)]


def _flat(cols: List[CV], sel: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """A chain's outputs in packed order: each column's values and
    validity, then the selection."""
    out = [t for v, m in cols for t in (v, m) if t is not None]
    return out if sel is None else out + [sel]


def _graph_live(buf: torch.Tensor, cap: int) -> torch.Tensor:
    """Live rows of a packed batch, read from its header on the card."""
    return torch.arange(cap, dtype=torch.int64, device=buf.device) \
        < live_rows(buf)


class FusedPipelineExec(PhysicalOp):
    """A chain of Filter/Project/Rename stages run as one CUDA graph per
    batch (eagerly where no graph can take the batch). An empty chain
    is allowed: a fused aggregate directly over its leaf."""

    def __init__(self, leaf: PhysicalOp, stages: Sequence[PhysicalOp]):
        self.children = [leaf]
        self.stages = list(stages)  # bottom-up; stage i's child is i-1
        self._schema = self.stages[-1].schema if self.stages \
            else leaf.schema
        # decided from the plan: the chain has no host stage
        self.capturable = not any(stage_needs_host(s) for s in self.stages)
        # the leaf column each output passes through, if any: a string
        # output keeps that column's host dictionary (a graph replays
        # codes only; the dictionaries ride beside it)
        src: List[Optional[int]] = list(range(len(leaf.schema)))
        for st in self.stages:
            if isinstance(st, ProjectExec):
                src = [src[e.index] if isinstance(e, ir.BoundCol) else None
                       for e, _ in st.exprs]
        self._dict_src = src

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        inner = " -> ".join(type(s).__name__ for s in self.stages)
        return f"FusedPipelineExec[{inner}]"

    def structure_key(self) -> Tuple:
        """The leaf's schema and every stage: what a graph captured for
        one batch layout bakes in."""
        return (_schema_key(self.children[0].schema),
                tuple(_stage_key(s) for s in self.stages))

    def run(self, cols: List[CV], cap: int, device,
            sel: Optional[torch.Tensor]):
        """Evaluate every stage: (output columns, selection)."""
        schema = self.children[0].schema
        for st in self.stages:
            ev = DeviceEvaluator(schema, cols, cap, device)
            if isinstance(st, FilterExec):
                keep = ev.evaluate_predicate(st.predicate)
                sel = keep if sel is None else sel & keep
            elif isinstance(st, RenameColumnsExec):  # columns as they are
                schema = st.schema
            else:
                cols = [ev.evaluate(e) for e, _ in st.exprs]
                schema = st.schema
        return cols, sel

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        for cb in self.children[0].execute(partition, ctx):
            if self.capturable and _graph_batch(cb):
                yield self._replay(cb)
                continue
            dispatch.record("graph_eager_batches")
            cols, sel = self.run(batch_cvs(cb), cb.capacity, cb.device,
                                 cb.selection)
            yield self._batch(cols, sel, cb)

    def out_dictionaries(self, cb: ColumnBatch) -> List[Optional[object]]:
        """The host dictionaries of the chain's outputs for a leaf
        batch (the JAX package's `_out_dictionaries`)."""
        return [None if i is None else cb.columns[i].dictionary
                for i in self._dict_src]

    def _batch(self, cols: List[CV], sel, cb: ColumnBatch) -> ColumnBatch:
        return ColumnBatch(self._schema, [
            Column(f.dtype, v, m, d) for f, (v, m), d in
            zip(self._schema, cols, self.out_dictionaries(cb))
        ], cb.num_rows, sel)

    def _replay(self, cb: PackedColumnBatch) -> ColumnBatch:
        key = ("pipeline", self.structure_key(), cb.key, cb.device.index)
        g = dispatch.GRAPHS.acquire(key, lambda: self._capture(cb))
        try:
            g.inp.copy_(cb.buf)
            g.replay()
            # the next replay overwrites the graph's outputs: one copy
            out = g.out.clone()
        finally:
            dispatch.GRAPHS.release(key, g)
        it = iter(g.layout.views(out))
        cols = [(next(it), next(it) if has_m else None)
                for has_m in g.has_validity]
        sel = next(it) if g.has_selection else None
        return self._batch(cols, sel, cb)

    def _capture(self, cb: PackedColumnBatch) -> dispatch.Graph:
        inp, cols_in = _static_input(cb)
        cap, dev = cb.capacity, cb.device
        # the outputs, packed in one buffer: laid out from the warm-up
        # run, which copies nothing out
        out: dict = {}

        def body():
            cols, sel = self.run(cols_in, cap, dev, None)
            for dst, t in zip(out.get("views", ()), _flat(cols, sel)):
                dst.copy_(t)
            return cols, sel

        def prepare(warm):
            lay = out["layout"] = Layout(
                [(t.dtype, t.shape) for t in _flat(*warm)], header=0)
            out["buf"] = torch.empty(lay.nbytes, dtype=torch.uint8,
                                     device=dev)
            out["views"] = lay.views(out["buf"])

        graph, (cols, sel), launches = dispatch.capture(body, dev, prepare)
        return dispatch.Graph(
            graph, launches, inp=inp, out=out["buf"], layout=out["layout"],
            has_validity=[m is not None for _, m in cols],
            has_selection=sel is not None)


# ---------------------------------------------------------------------------
# keyless aggregate with a streaming carry
# ---------------------------------------------------------------------------

def keyless_merge_plan(aggs, in_schema: Schema) -> Optional[List[str]]:
    """Per state column, how the keyless carry merges a batch's partial
    state (the JAX package's `_keyless_merge_plan`): "add" for counts,
    sums, moments and decimal chunk sums, "min"/"max" for extremes;
    None for FIRST/LAST, whose states cannot tell "no row yet" from a
    first NULL. `aggs` are a PARTIAL or COMPLETE aggregate's, over
    `in_schema`."""
    from blaze_tpu_torch.ops.hash_aggregate import (
        AggMode,
        _state_width,
        dsum_scale,
    )

    plan: List[str] = []
    for a, _ in aggs:
        if a.fn in (AggFn.COUNT, AggFn.COUNT_STAR, AggFn.SUM, AggFn.AVG,
                    AggFn.VAR_SAMP, AggFn.VAR_POP, AggFn.STDDEV_SAMP,
                    AggFn.STDDEV_POP):
            chunked = dsum_scale(a, in_schema, AggMode.PARTIAL) is not None
            plan += ["add"] * _state_width(a.fn, chunked)
        elif a.fn is AggFn.MIN:
            plan.append("min")
        elif a.fn is AggFn.MAX:
            plan.append("max")
        else:
            return None
    return plan


class _Carry:
    """The running keyless state: one value and, for a nullable state
    field, one validity per state column, as views of one zeroed byte
    buffer (one reset, one fetch). A batch's state merges in place, so
    a graph can hold the carry among its static tensors."""

    def __init__(self, partial_schema: Schema, device):
        specs = []
        self.nullable = []
        for f in partial_schema:
            specs.append((torch_dtype(f.dtype), 1))
            self.nullable.append(f.nullable)
            if f.nullable:
                specs.append((torch.bool, 1))
        self.layout = Layout(specs, header=0)
        self.buf = torch.zeros(self.layout.nbytes, dtype=torch.uint8,
                               device=device)
        self.tensors = self.layout.views(self.buf)

    def columns(self, tensors) -> List[CV]:
        it = iter(tensors)
        return [(next(it), next(it) if nullable else None)
                for nullable in self.nullable]

    def merge(self, plan: List[str], states: List[CV]) -> None:
        """carry <- carry (op) state. A state with no contributing row
        holds K1's neutral values, so a merge under its validity leaves
        the carry as it was; min and max propagate NaN and order -0.0
        below +0.0, as K1 does. Only eager torch ops: a sum and a
        product are never contracted into one rounding."""
        for op, (cv, cm), (nv, nm) in zip(
                plan, self.columns(self.tensors), states):
            nv = nv.to(cv.dtype)
            if op == "add":
                v = cv + nv
            else:
                pick = _extreme(op, cv, nv)
                if cm is not None:
                    pick = torch.where(cm & nm, pick,
                                       torch.where(nm, nv, cv))
                v = pick
            cv.copy_(v)
            if cm is not None:
                cm.copy_(cm | nm)


def _extreme(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.bool:
        return a & b if op == "min" else a | b
    return _fmin(a, b) if op == "min" else _fmax(a, b)


class FusedAggregateExec(PhysicalOp):
    """A fused chain and a keyless aggregate over it, with a streaming
    carry: per batch one graph replay (chain, K1's partial statistics,
    merge into the carry), and one fetch of the carry at end of stream.
    With `fetch_host` the state row comes back to the host for
    HostFinalAggExec (the COMPLETE rewrite); without it (a PARTIAL
    task) it stays on the device as one state row for the whole
    stream."""

    def __init__(self, pipeline: FusedPipelineExec, agg,
                 fetch_host: bool = False):
        from blaze_tpu_torch.ops.hash_aggregate import AggMode

        if agg.keys or agg.mode is not AggMode.PARTIAL:
            raise ValueError("FusedAggregateExec takes a keyless PARTIAL "
                             "aggregate")
        plan = keyless_merge_plan(agg.aggs, agg.children[0].schema)
        if plan is None:
            raise ValueError("FIRST/LAST states do not merge in a carry")
        self.children = [pipeline.children[0]]
        self.pipeline = pipeline
        self.agg = agg
        self.plan = plan
        self.fetch_host = fetch_host
        self._schema = agg.schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        return f"FusedAggregateExec[{self.pipeline.describe()} -> carry]"

    def _states(self, cols: List[CV], cap: int, device, live: torch.Tensor,
                scratch=None) -> List[CV]:
        """One batch's PARTIAL state columns, K1 for every reduction."""
        from blaze_tpu_torch.ops.hash_aggregate import (
            AggMode,
            _Scalar,
            _agg_state,
        )

        ev = DeviceEvaluator(self.pipeline.schema, cols, cap, device)
        red = _Scalar(scratch)
        outs: List[CV] = []
        for a, _ in self.agg.aggs:
            outs.extend(_agg_state(a, ev, live, red, cap, AggMode.PARTIAL))
        return outs

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        carry: Optional[_Carry] = None
        held = {}
        try:
            for cb in self.children[0].execute(partition, ctx):
                if self.pipeline.capturable and _graph_batch(cb):
                    key = ("carry", self.pipeline.structure_key(),
                           repr(self.agg.aggs), cb.key, cb.device.index)
                    g = held.get(key)
                    if g is None:
                        g = held[key] = dispatch.GRAPHS.acquire(
                            key, lambda: self._capture(cb))
                    if g.carry is not carry:
                        # the running state moves into this graph's carry
                        if carry is None:
                            g.carry.buf.zero_()
                        else:
                            g.carry.buf.copy_(carry.buf)
                        carry = g.carry
                    g.inp.copy_(cb.buf)
                    g.replay()
                    continue
                dispatch.record("graph_eager_batches")
                if carry is None:
                    carry = _Carry(self.agg.schema, cb.device)
                cols, sel = self.pipeline.run(batch_cvs(cb), cb.capacity,
                                              cb.device, None)
                live = cb.live_mask()
                if sel is not None:
                    live = live & sel
                carry.merge(self.plan, self._states(
                    cols, cb.capacity, cb.device, live))
            if carry is None:
                return  # empty stream: HostFinalAggExec emits its row
            yield self._emit(carry)
        finally:
            for key, g in held.items():
                dispatch.GRAPHS.release(key, g)

    def _emit(self, carry: _Carry) -> ColumnBatch:
        return _state_row(carry, self._schema, self.fetch_host)

    def _capture(self, cb: PackedColumnBatch) -> dispatch.Graph:
        from blaze_tpu_torch.ops.kernels import stats

        inp, cols_in = _static_input(cb)
        cap, dev = cb.capacity, cb.device
        carry = _Carry(self.agg.schema, dev)
        scratch = stats.new_scratch(dev)

        def body():
            live = _graph_live(inp, cap)
            cols, sel = self.pipeline.run(cols_in, cap, dev, None)
            if sel is not None:
                live = live & sel
            carry.merge(self.plan,
                        self._states(cols, cap, dev, live, scratch))

        graph, _, launches = dispatch.capture(body, dev)
        return dispatch.Graph(graph, launches, inp=inp, carry=carry,
                              scratch=scratch)


def _state_row(carry: _Carry, schema: Schema, fetch_host: bool
               ) -> ColumnBatch:
    """The carry as one state row: fetched to the host in one copy, or
    a device copy of its own."""
    if fetch_host and carry.buf.device.type != "cpu":
        dispatch.record("d2h_fetches")
        buf = carry.buf.cpu()
    else:
        buf = carry.buf.clone()
    cols = carry.columns(carry.layout.views(buf))
    return ColumnBatch(schema, [
        Column(f.dtype, v, m) for f, (v, m) in zip(schema, cols)
    ], 1)


class FusedWindowAggExec(PhysicalOp):
    """A keyless aggregate over a window, whole-task (the JAX package's
    FusedWindowAggExec): the window's folded Project/Rename chain, the
    shared (partition, order) argsort, the gather of only the columns
    the window functions and the aggregate read, the frame passes of
    only the functions the aggregate reads, and the keyless PARTIAL
    states through `_Scalar` (kernel K1), eagerly, once per task. Emits
    one state row, fetched to the host in one copy, for
    HostFinalAggExec."""

    def __init__(self, window, agg):
        from blaze_tpu_torch.ops.hash_aggregate import AggMode

        if agg.keys or agg.mode is not AggMode.PARTIAL:
            raise ValueError("FusedWindowAggExec takes a keyless PARTIAL "
                             "aggregate")
        self.window = window
        self.children = window.children  # the window's own list
        self.agg = agg
        self._schema = agg.schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        return (f"FusedWindowAggExec[{self.window.describe()} -> keyless "
                "partial]")

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        from blaze_tpu_torch.ops.hash_aggregate import (
            AggMode,
            _Scalar,
            _agg_state,
        )
        from blaze_tpu_torch.ops.window import expr_refs

        win = self.window
        cb = win.input_batch(partition, ctx)
        if cb.num_rows == 0:
            return  # HostFinalAggExec emits the keyless global row
        dispatch.record("window_route.fused_agg")
        n_in = len(win._in_schema)
        reads = set()
        for a, _ in self.agg.aggs:
            if a.child is not None:
                reads |= expr_refs(a.child, win.schema)
        cols, outs = win.run(
            cb, want_cols={i for i in reads if i < n_in},
            want_fns=[n_in + j in reads
                      for j in range(len(win.functions))])
        cap, dev = cb.capacity, cb.device
        ev = DeviceEvaluator(win.schema, cols + outs, cap, dev)
        live = cb.live_mask()
        red = _Scalar()
        states: List[CV] = []
        for a, _ in self.agg.aggs:
            states.extend(_agg_state(a, ev, live, red, cap, AggMode.PARTIAL))
        carry = _Carry(self._schema, dev)
        for (cv, cm), (nv, nm) in zip(carry.columns(carry.tensors), states):
            cv.copy_(nv.reshape(1).to(cv.dtype))
            if cm is not None:
                if nm is None:
                    cm.fill_(True)
                else:
                    cm.copy_(nm.reshape(1))
        yield _state_row(carry, self._schema, fetch_host=True)


class HostFinalAggExec(PhysicalOp):
    """Finalizes the keyless carry's state row on the host: the other
    half of the COMPLETE rewrite (the JAX package's HostFinalAggExec,
    its one-batch `_finalize_host` and `_finalize_agg` with `n_live`).
    AVG divides, the variance family finishes its moments, a decimal
    SUM/AVG reassembles its chunk sums in Python ints, once per stream;
    the result row stays on the host, where the task boundary reads it.
    An empty stream gives the global row of an empty input (COUNT 0,
    the rest NULL)."""

    def __init__(self, child: PhysicalOp, template):
        # template: the original COMPLETE HashAggregateExec
        self.children = [child]
        self.template = template
        self._schema = template.schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        from blaze_tpu_torch.ops.hash_aggregate import _empty_global_row

        states = list(self.children[0].execute(partition, ctx))
        if not states:
            yield _empty_global_row(self.template, ctx.device)
            return
        (cb,) = states  # the carry is one state row
        yield self._finalize(cb)

    def _finalize(self, cb: ColumnBatch) -> ColumnBatch:
        from blaze_tpu_torch.ops.hash_aggregate import (
            _finalize_var,
            _reassemble_decimal,
            _state_width,
            parse_dsum_scale,
        )

        states = [(c.values, c.validity) for c in cb.columns]
        fields = self.children[0].schema.fields
        out: List[Column] = []
        pos = 0
        for (a, _), field in zip(self.template.aggs, self._schema.fields):
            dscale = parse_dsum_scale(fields[pos].name)
            w = _state_width(a.fn, dscale is not None)
            st = states[pos: pos + w]
            pos += w
            if dscale is not None:
                avg = a.fn is AggFn.AVG
                limbs, mask = _reassemble_decimal(
                    [x.cpu().numpy() for x, _ in st[:4]],
                    st[0][1].cpu().numpy(),
                    st[4][0].cpu().numpy() if avg else None, dscale, avg,
                    n_live=cb.num_rows)
                v, m = torch.from_numpy(limbs), torch.from_numpy(mask)
            elif a.fn is AggFn.AVG:
                (s, sm), (c, _) = st
                v = s.to(torch.float64) / c.clamp(min=1).to(torch.float64)
                m = (c > 0) if sm is None else sm & (c > 0)
            elif w == 3:
                v, m = _finalize_var(a.fn, *(x for x, _ in st))
            else:
                v, m = st[0]
            out.append(Column(field.dtype, v.to(torch_dtype(field.dtype)),
                              m))
        return ColumnBatch(self._schema, out, 1)


def fuse_pipelines(op: PhysicalOp) -> PhysicalOp:
    """The plan-level fusion pass (planner/fuse.py), re-exported."""
    from blaze_tpu_torch.planner.fuse import fuse_pipelines as _pass

    return _pass(op)
