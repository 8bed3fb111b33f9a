"""Pipeline fusion: a Filter -> Project chain, and an aggregate over it,
as ONE CUDA graph replay per batch.

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
- `FusedAggregateExec`, keyless (the JAX package's
  `_execute_keyless_carry`, `_keyless_merge_plan`,
  `_build_carry_kernel`): each batch runs the chain, K1's partial
  statistics and a merge into a running carry, all in the one replay;
  the carry is fetched once, at end of stream.
- `FusedAggregateExec`, keyed (`_execute_grouped_carry`, `_run_agg`,
  `_execute_join_fused`): each batch runs the chain, the scatter-core
  grouping (K2, K3) and, under a COMPLETE rewrite, the merge into a
  grouped carry of fixed slots, in one replay, the group count packed
  with the states; an INNER hash join under the aggregate folds its
  probe into the same replay.
- `FusedWindowAggExec`: a keyless aggregate over a window, one eager
  pass per task (ops/window.py does the window's work; no graph).
- `HostFinalAggExec`: finalizes the fetched states on the host, or
  merges several keyed state batches in a device FINAL.

Whether a batch replays a graph is decided from the plan and the
batch, never by catching a failure: the chain's expressions must not
need the host (the JAX package's `_expr_needs_host`), and the batch
must be a packed CUDA batch, as the parquet scan makes them. Any other
batch - on the CPU, or from another leaf - runs the same code eagerly
and counts in `dispatch` `graph_eager_batches`. A capture or replay
error raises.

A graph reads fixed addresses, so a keyed graph's output buffer is
overwritten by its next replay: a per-batch state batch leaves in a
copy, and the grouped carry keeps its running state in each graph's
input buffer, copied in before the replay, so a demotion still finds
the carry as it was before the batch that overflowed.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.types import Schema, TypeId
from blaze_tpu_torch.batch import (
    Column,
    ColumnBatch,
    PackedColumnBatch,
    torch_dtype,
    value_shape,
)
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.eval import CV, DeviceEvaluator, _fmax, _fmin
from blaze_tpu_torch.exprs.ir import AggFn
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.filter import FilterExec
from blaze_tpu_torch.ops.hash_aggregate import (
    GRAPH_ROUNDS,
    _TIER2_GROUPS as _AGG_GROUP_CAP,
)
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
    """A fused chain and a PARTIAL aggregate over it.

    Keyless: a streaming carry, per batch one graph replay (chain, K1's
    partial statistics, merge into the carry), and one fetch of the
    carry at end of stream. With `fetch_host` the state row comes back
    to the host for HostFinalAggExec (the COMPLETE rewrite); without it
    (a PARTIAL task) it stays on the device as one state row for the
    whole stream.

    Keyed (the JAX package's `_execute_grouped_carry`, `_run_agg` and
    `_execute_join_fused`): every batch is one graph replay of the
    chain, the grouping (`HashAggregateExec.partial_states`, K2 and K3)
    and the states packed with their group count into one buffer.

    - With `fetch_host` and a carry plan (add/min/max merges only), the
      states of each batch merge in the same replay into the carry's
      fixed slots (the first batch's slot count); a one-batch stream
      costs no readback, a longer one one readback a batch (the
      overflow guard, `d2h_syncs.carry_guard`), and the stream ends in
      one fetch of the packed (count, states). When the groups outgrow
      the slots the carry demotes (`carry_demotions`): it leaves as one
      device partial batch, and the batch that overflowed and the rest
      of the stream take the per-batch path, under a device FINAL
      (HostFinalAggExec).
    - Otherwise each batch climbs the group-capacity ladder, one replay
      a tier and the count read back (`d2h_syncs.n_groups`), and its
      states stay on the device; with `fetch_host` the first non-empty
      batch is fetched whole instead, count and states in one copy.
    - Over an INNER hash join (planner/fuse.py `_fuse_join_under_agg`)
      the probe side's leaf batch is the graph's input: the probe
      stages, key evaluation, the table lookup and the build gather run
      in the same replay. Duplicate build keys, the sorted core and
      string keys take the materialized pairs instead (the JAX
      package's fallback), each batch run eagerly.

    A grouping on one integer key first replays the direct arm alone
    (`HashAggregateExec.direct_keys`); a key range that does not fit
    gives the count -1, and that batch runs again with both arms (from
    the same carry), as does the rest of the stream.

    A batch no graph can take (the CPU, a batch not packed by the scan,
    FIRST/LAST or bool MIN/MAX, which the JAX package keeps out of its
    carry) runs the same body eagerly and counts in
    `graph_eager_batches`: on the CPU with the graph's fixed probe
    rounds, so the CPU tests count the card's readbacks; on the card
    with the eager grouping's readbacks (`_eager_rounds`)."""

    def __init__(self, pipeline: FusedPipelineExec, agg,
                 fetch_host: bool = False):
        from blaze_tpu_torch.ops.hash_aggregate import AggMode

        if agg.mode is not AggMode.PARTIAL:
            raise ValueError("FusedAggregateExec takes a PARTIAL aggregate")
        if agg.keys:
            plan = keyed_merge_plan(agg)
        else:
            plan = keyless_merge_plan(agg.aggs, agg.children[0].schema)
            if plan is None:
                raise ValueError("FIRST/LAST states do not merge in a carry")
        self.children = [pipeline.children[0]]
        self.pipeline = pipeline
        self.agg = agg
        self.plan = plan
        self.fetch_host = fetch_host
        self._schema = agg.schema
        # keyed: FIRST/LAST and bool MIN/MAX run eagerly (no merge plan)
        self.capturable = pipeline.capturable and (
            not agg.keys or plan is not None)
        # made at first use: the graph key, carry layouts, the merge
        self._key: Optional[Tuple] = None
        self._layouts: dict = {}
        self._merge = None

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        if not self.agg.keys:
            return f"FusedAggregateExec[{self.pipeline.describe()} -> carry]"
        tail = "grouped carry" if self._carry_plan() is not None \
            else "partial"
        return f"FusedAggregateExec[{self.pipeline.describe()} -> {tail}]"

    def _states(self, cols: List[CV], cap: int, device, live: torch.Tensor,
                scratch=None) -> List[CV]:
        """One batch's keyless PARTIAL state columns, K1 for every
        reduction."""
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
        from blaze_tpu_torch.ops.joins import HashJoinExec, JoinType

        if not self.agg.keys:
            yield from self._execute_keyless(partition, ctx)
            return
        leaf = self.children[0]
        stream = _Stream(self.agg.direct_keys())
        try:
            carry = self._carry_plan() is not None
            if isinstance(leaf, HashJoinExec) and \
                    leaf.join_type is JoinType.INNER:
                specs, folded = self._join_specs(leaf, partition, ctx)
                # the materialized pairs take the per-batch path, as in
                # the JAX package (`_join_batch`)
                carry = carry and folded
            else:
                specs = (self._spec(cb) for cb in leaf.execute(partition,
                                                                ctx))
            if carry:
                yield from self._execute_grouped_carry(specs, stream)
                return
            first = True
            for spec in specs:
                out, first = self._run_agg(spec, first, stream)
                if out is not None:
                    yield out
        finally:
            for key, g in stream.held.items():
                dispatch.GRAPHS.release(key, g)

    # ------------------------------------------------------------------
    # keyless
    def _execute_keyless(self, partition: int, ctx: ExecContext
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

    # ------------------------------------------------------------------
    # keyed: batch specs
    def _carry_plan(self) -> Optional[List[str]]:
        """The grouped carry's merge plan, or None when the stream takes
        the per-batch path (the JAX package's `_grouped_carry_plan`): a
        host-finalized (COMPLETE rewrite) keyed aggregate whose states
        merge by add, min and max."""
        return self.plan if self.fetch_host and self.agg.keys else None

    def _base_key(self) -> Tuple:
        """What every keyed graph of this node bakes in: the chain, the
        aggregate's keys and functions, the state fields (made once)."""
        if self._key is None:
            self._key = (self.pipeline.structure_key(),
                         repr(self.agg.keys), repr(self.agg.aggs),
                         _schema_key(self._schema))
        return self._key

    def _carry_layout(self, slots: int) -> "_CarryLayout":
        lay = self._layouts.get(slots)
        if lay is None:
            lay = self._layouts[slots] = _CarryLayout(self._schema, slots)
        return lay

    def _spec(self, cb: ColumnBatch) -> _Spec:
        """A leaf batch under the chain and the aggregate."""
        graphable = self.capturable and _graph_batch(cb)
        key = ("plain", cb.key, cb.device.index) if graphable else None
        return _Spec(cb, key, self._plain_body, graphable)

    def _plain_body(self, cols: List[CV], cap: int, dev,
                    live: torch.Tensor, group_cap: Optional[int],
                    rounds: Optional[int], direct: bool = False):
        """(states, count) of one leaf batch: the chain, then the
        grouping and the reductions, with no readback."""
        cols, sel = self.pipeline.run(cols, cap, dev, None)
        if sel is not None:
            live = live & sel
        return self.agg.partial_states(self.pipeline.schema, cols, cap, dev,
                                       live, group_cap, rounds, direct)

    def _join_specs(self, join, partition: int, ctx: ExecContext):
        """(the specs of a fused INNER join's probe batches, whether they
        are folded) (the JAX package's `_execute_join_fused`): one build
        relation and one table core for every partition and execution
        (`_fused_core`, made under the join's build lock), then either
        the folded form - the probe leaf batch through the probe stages,
        the table lookup and the build gather - or, where the core or
        the key types rule that out, the materialized pairs."""
        from blaze_tpu_torch.ops.joins import _JoinCore

        build = join._collect_build(ctx)
        with join._build_lock:
            core = getattr(join, "_fused_core", None)
            if core is None or core.build is not build:
                core = _JoinCore(build, join.left_keys, track_build=False)
                join._fused_core = core
        fused_probe = getattr(join, "_fused_probe", None)
        # no probe chain to fold: the probe child itself is the leaf of
        # an empty chain (the JAX package's one-dispatch join kernel)
        probe_pipe = fused_probe[1] if fused_probe is not None \
            else FusedPipelineExec(join.children[1], [])
        state = core.table_state_static(join.right_keys, probe_pipe.schema)
        if state is None:
            return (self._pairs_spec(core, join, build, pb)
                    for pb in join.children[1].execute(partition, ctx)), \
                False
        body = _JoinBody(self, join, core, probe_pipe, state)
        capturable = self.capturable and probe_pipe.capturable

        def specs():
            for cb in probe_pipe.children[0].execute(partition, ctx):
                graphable = capturable and _graph_batch(cb)
                key = ("join", body.key, cb.key, cb.device.index) \
                    if graphable else None
                yield _Spec(cb, key, body, graphable)

        return specs(), True

    def _pairs_spec(self, core, join, build, pb: ColumnBatch) -> _Spec:
        """A materialized probe batch joined by pairs (the sorted core,
        duplicate build keys, string keys): its joined batch, run
        eagerly under the chain and the aggregate."""
        state = core.probe(pb, join.right_keys)
        pb = state[1]
        out_cols, valid, pair_cap, _ = core.emit_pairs(
            state, list(build.columns), list(pb.columns), build_first=True)
        joined = ColumnBatch(join.schema, out_cols, pair_cap, valid)
        return _Spec(joined, None, self._plain_body, False)

    # ------------------------------------------------------------------
    # keyed: one batch
    def _launch(self, spec: _Spec, group_cap: Optional[int],
                stream: "_Stream"):
        """Run one batch's body at `group_cap` slots: (the packed
        buffer of [count, states], its layout, which states carry a
        validity). A graph batch replays its graph (the buffer is the
        graph's own: read it before the graph replays again); any
        other runs eagerly, counted."""
        direct = stream.direct
        if not spec.graphable:
            dispatch.record("graph_eager_batches")
            cb = spec.cb
            outs, n = spec.body(batch_cvs(cb), cb.capacity, cb.device,
                                cb.live_mask(), group_cap,
                                _eager_rounds(cb.device), direct)
            flat = [n] + _flat(outs, None)
            lay = Layout([(t.dtype, t.shape) for t in flat], header=0)
            buf = torch.empty(lay.nbytes, dtype=torch.uint8,
                              device=cb.device)
            for dst, t in zip(lay.views(buf), flat):
                dst.copy_(t)
            return buf, lay, [m is not None for _, m in outs]
        key = ("fagg", self._base_key(), spec.key, group_cap, GRAPH_ROUNDS,
               direct)
        g = self._graph(stream, key, lambda: self._capture_batch(
            spec, group_cap, direct))
        g.inp.copy_(spec.cb.buf)
        g.replay()
        return g.out, g.layout, g.has_validity

    def _graph(self, stream: "_Stream", key: Tuple, build
               ) -> dispatch.Graph:
        g = stream.held.get(key)
        if g is None:
            g = stream.held[key] = dispatch.GRAPHS.acquire(key, build)
        return g

    def _capture_batch(self, spec: _Spec, group_cap: Optional[int],
                       direct: bool) -> dispatch.Graph:
        cb = spec.cb
        inp, cols_in = _static_input(cb)
        cap, dev = cb.capacity, cb.device
        out: dict = {}

        def body():
            outs, n = spec.body(cols_in, cap, dev, _graph_live(inp, cap),
                                group_cap, GRAPH_ROUNDS, direct)
            for dst, t in zip(out.get("views", ()), [n] + _flat(outs, None)):
                dst.copy_(t)
            return outs, n

        def prepare(warm):
            outs, n = warm
            lay = out["layout"] = Layout(
                [(t.dtype, t.shape) for t in [n] + _flat(outs, None)],
                header=0)
            out["buf"] = torch.empty(lay.nbytes, dtype=torch.uint8,
                                     device=dev)
            out["views"] = lay.views(out["buf"])

        graph, (outs, _), launches = dispatch.capture(body, dev, prepare)
        return dispatch.Graph(graph, launches, inp=inp, out=out["buf"],
                              layout=out["layout"],
                              has_validity=[m is not None for _, m in outs],
                              keep=spec.body)

    def _batch_of(self, views: List[torch.Tensor], has_validity,
                  n: int) -> ColumnBatch:
        it = iter(views)
        return ColumnBatch(self._schema, [
            Column(f.dtype, next(it), next(it) if has_m else None)
            for f, has_m in zip(self._schema, has_validity)], n)

    def _run_agg(self, spec: _Spec, first: bool, stream: "_Stream"):
        """One batch under the group-capacity ladder (the JAX package's
        `_run_agg` and `run_grouped_kernel`): (its state batch or None
        when it has no group, `first` for the next batch). With
        `fetch_host` the first non-empty batch comes to the host with
        its count in one copy; every other batch reads its count back
        and keeps its states on the device. A count of -1 (the direct
        arm's key range did not fit) runs the tier again with both arms
        of the grouping, and so does every later batch of the stream.
        Past the top tier (the probe loop left rows after its rounds)
        the batch runs once more eagerly, probing until every row has a
        slot."""
        from blaze_tpu_torch.ops.hash_aggregate import group_tiers

        cap = spec.cb.capacity
        tiers = group_tiers(cap, min(cap, _AGG_GROUP_CAP))
        i = 0
        while i < len(tiers):
            gc = tiers[i]
            out_cap = cap if gc is None else gc
            buf, lay, has_m = self._launch(spec, gc, stream)
            if self.fetch_host and first:
                dispatch.record("d2h_fetches")
                buf = buf.cpu()
                n = int(lay.views(buf)[0][0])
            else:
                n = dispatch.host_int(lay.views(buf)[0][0], "n_groups")
            if n < 0:
                if not stream.direct:
                    raise RuntimeError(f"fused aggregate: group count {n}")
                stream.direct = False
                continue
            i += 1
            if n > out_cap:
                continue
            if n == 0:
                return None, first
            if self.fetch_host and first:
                return self._batch_of(lay.views(buf)[1:], has_m, n), False
            if spec.graphable:
                buf = buf.clone()  # the graph's buffer is its next output
            return self._batch_of(lay.views(buf)[1:], has_m, n), first
        dispatch.record("group_round_overflow")
        dispatch.record("graph_eager_batches")
        cb = spec.cb
        outs, n_dev = spec.body(batch_cvs(cb), cb.capacity, cb.device,
                                cb.live_mask(), None, None)
        n = dispatch.host_int(n_dev, "n_groups")
        if n == 0:
            return None, first
        return ColumnBatch(self._schema, [
            Column(f.dtype, v, m) for f, (v, m) in zip(self._schema, outs)
        ], n), first

    # ------------------------------------------------------------------
    # keyed: the grouped carry
    def _merge_agg(self):
        """The state-preserving merge (the JAX package's
        `_build_carry_merge_kernel`): a keyed PARTIAL aggregate over the
        (carry + batch) state rows, SUM for additive state columns and
        MIN/MAX for extremes, so it emits mergeable states again and the
        carry stays a fixed point."""
        from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, BoundCol
        from blaze_tpu_torch.ops.hash_aggregate import (
            AggMode,
            HashAggregateExec,
            _SchemaStub,
        )

        if self._merge is not None:
            return self._merge
        fields = self._schema.fields
        nk = len(self.agg.keys)
        fn = {"add": AggFn.SUM, "min": AggFn.MIN, "max": AggFn.MAX}
        m = self._merge = HashAggregateExec(
            _SchemaStub(self._schema),
            keys=[(BoundCol(i, fields[i].dtype), fields[i].name)
                  for i in range(nk)],
            aggs=[(AggExpr(fn[op], BoundCol(nk + j, fields[nk + j].dtype)),
                   f"m{j}") for j, op in enumerate(self.plan)],
            mode=AggMode.PARTIAL)
        return m

    def _carry_outputs(self, spec: _Spec, cols: List[CV], cap: int, dev,
                       live: torch.Tensor, s_b: int, carry, direct: bool,
                       rounds: Optional[int] = GRAPH_ROUNDS):
        """(count, states) of one batch merged into `carry` ((count,
        state columns) of the carry's slots, or None for the first
        batch), with no readback: the JAX package's
        `_build_grouped_carry_kernel`. The count is the carry's slots + 1
        when the batch or the merge outgrew its slots, and -1 when
        `direct` took the direct arm alone and a key range did not fit
        (the batch runs again with both arms)."""
        outs, n_b = spec.body(cols, cap, dev, live,
                              s_b if s_b < cap else None, rounds, direct)
        over_b = n_b > s_b
        if carry is None:
            return torch.where(over_b, torch.full_like(n_b, s_b + 1),
                               n_b), outs
        n_c, c_cols = carry
        slots = c_cols[0][0].shape[0]
        m_live = torch.cat([
            torch.arange(slots, device=dev) < n_c,
            torch.arange(s_b, device=dev) < torch.clamp(n_b, max=s_b)])
        merged = []
        for (cv, cm), (bv, bm) in zip(c_cols, outs):
            bm = torch.ones(s_b, dtype=torch.bool, device=dev) \
                if bm is None else bm
            merged.append((torch.cat([cv, bv.to(cv.dtype)]),
                           torch.cat([cm, bm])))
        mo, n_m = self._merge_agg().partial_states(
            self._schema, merged, slots + s_b, dev, m_live, slots, rounds,
            direct)
        n_out = torch.where(over_b, torch.full_like(n_m, slots + 1), n_m)
        if direct:
            n_out = torch.where((n_b < 0) | (n_m < 0),
                                torch.full_like(n_m, -1), n_out)
        return n_out, [(v.to(cv.dtype), m)
                       for (v, m), (cv, _) in zip(mo, c_cols)]

    def _carry_launch(self, spec: _Spec, s_b: int, slots: int,
                      carry_buf: Optional[torch.Tensor],
                      stream: "_Stream"):
        """One carry step: (the packed [count, states] after this batch,
        the carry before it - a buffer the step did not write - or
        None for the first batch)."""
        lay = self._carry_layout(slots)
        direct = stream.direct
        if not spec.graphable:
            dispatch.record("graph_eager_batches")
            cb = spec.cb
            out = lay.new_buffer(cb.device)
            carry = None if carry_buf is None else lay.views(carry_buf)
            n, outs = self._carry_outputs(
                spec, batch_cvs(cb), cb.capacity, cb.device, cb.live_mask(),
                s_b, carry, direct, _eager_rounds(cb.device))
            lay.pack(out, n, outs)
            return out, carry_buf
        with_carry = carry_buf is not None
        key = ("fagg_gcarry", self._base_key(), tuple(self.plan), spec.key,
               slots, s_b, with_carry, GRAPH_ROUNDS, direct)
        g = self._graph(stream, key, lambda: self._capture_carry(
            spec, s_b, lay, with_carry, direct))
        if with_carry:
            g.cin.copy_(carry_buf)
        g.inp.copy_(spec.cb.buf)
        g.replay()
        return g.out, (g.cin if with_carry else None)

    def _capture_carry(self, spec: _Spec, s_b: int, lay: "_CarryLayout",
                       with_carry: bool, direct: bool) -> dispatch.Graph:
        cb = spec.cb
        inp, cols_in = _static_input(cb)
        cap, dev = cb.capacity, cb.device
        cin = lay.new_buffer(dev) if with_carry else None
        out = lay.new_buffer(dev)

        def body():
            carry = lay.views(cin) if with_carry else None
            n, outs = self._carry_outputs(spec, cols_in, cap, dev,
                                          _graph_live(inp, cap), s_b, carry,
                                          direct)
            lay.pack(out, n, outs)

        graph, _, launches = dispatch.capture(body, dev)
        return dispatch.Graph(graph, launches, inp=inp, cin=cin, out=out,
                              keep=spec.body)

    def _execute_grouped_carry(self, specs, stream: "_Stream"
                               ) -> Iterator[ColumnBatch]:
        """Stream a keyed aggregate through the carry (class docstring;
        the JAX package's `_execute_grouped_carry`). The carry's slots
        are the first batch's; a replay reads the carry from its graph's
        input buffer and writes the merged carry to its output buffer,
        so the carry before a batch stays intact until the guard has
        read the batch's count. A count of -1 (the direct arm's key
        range did not fit) runs the batch again with both arms, from
        the same carry, and so does every later batch."""
        it = iter(specs)
        spec = next(it, None)
        carry_buf: Optional[torch.Tensor] = None
        carry_n = 0
        slots = 0
        demote = prev = None
        while spec is not None:
            s_b = min(spec.cb.capacity, _AGG_GROUP_CAP)
            if carry_buf is None:
                slots = s_b
            out, prev = self._carry_launch(spec, s_b, slots, carry_buf,
                                           stream)
            nxt = next(it, None)
            if carry_buf is None and nxt is None:
                # one batch: no readback, the count rides in the fetch
                n, batch = self._fetch_carry(out, slots)
                if n < 0:
                    stream.direct = False
                    out, _ = self._carry_launch(spec, s_b, slots, None,
                                                stream)
                    n, batch = self._fetch_carry(out, slots)
                if n > s_b:  # overflow: the per-batch ladder
                    batch, _ = self._run_agg(spec, True, stream)
                if batch is not None:
                    yield batch
                return
            n = dispatch.host_int(_CarryLayout.count(out), "carry_guard")
            if n < 0 and stream.direct:
                stream.direct = False
                out, prev = self._carry_launch(spec, s_b, slots, prev,
                                               stream)
                n = dispatch.host_int(_CarryLayout.count(out),
                                      "carry_guard")
            if n < 0 or n > slots:
                demote = spec
                if nxt is not None:
                    it = itertools.chain([nxt], it)
                break
            carry_buf, carry_n, spec = out, n, nxt
        if demote is None:
            if carry_buf is not None and carry_n > 0:
                _, batch = self._fetch_carry(carry_buf, slots)
                if batch is not None:
                    yield batch
            return
        # demotion: the carry before the batch that overflowed leaves as
        # one device partial batch (a copy: its buffer belongs to a
        # graph); that batch and the rest take the per-batch path
        dispatch.record("carry_demotions")
        first = True
        if prev is not None and carry_n > 0:
            lay = self._carry_layout(slots)
            _, cols = lay.views(prev.clone())
            yield ColumnBatch(self._schema, [
                Column(f.dtype, v, m) for f, (v, m) in zip(self._schema,
                                                           cols)], carry_n)
            first = False
        for spec in itertools.chain([demote], it):
            out_b, first = self._run_agg(spec, first, stream)
            if out_b is not None:
                yield out_b

    def _fetch_carry(self, buf: torch.Tensor, slots: int):
        """One fetch of a packed (count, states) buffer: (count, its
        state batch on the host, or None when the count is 0 or past
        the slots). The count travels inside the buffer: no readback."""
        dispatch.record("d2h_fetches")
        host = buf.cpu() if buf.device.type != "cpu" else buf.clone()
        lay = self._carry_layout(slots)
        n_t, cols = lay.views(host)
        n = int(n_t[0])
        if n <= 0 or n > slots:
            return n, None
        return n, ColumnBatch(self._schema, [
            Column(f.dtype, v, m) for f, (v, m) in zip(self._schema, cols)
        ], n)


def _eager_rounds(device) -> Optional[int]:
    """The probe rounds of a batch that runs eagerly: on the CPU the
    graph's own (the body runs as a graph would, readbacks and all, so
    the CPU tests count the card's budget); on the card None, the
    eager grouping, which reads the direct-or-hash branch and each probe
    round back instead of launching the graph form's fixed rounds."""
    return GRAPH_ROUNDS if device.type == "cpu" else None


class _Stream:
    """One stream's graphs, held from their first batch to its end,
    and whether its groupings still try the direct arm alone."""

    def __init__(self, direct: bool):
        self.held: dict = {}
        self.direct = direct


class _Spec:
    """One input batch of the keyed fused aggregate: the batch, its
    graph key part (None when it runs eagerly), and the body that turns
    its columns into (states, count) - `body(cols, cap, device, live,
    group_cap, rounds, direct)`."""

    __slots__ = ("cb", "key", "body", "graphable")

    def __init__(self, cb: ColumnBatch, key, body, graphable: bool):
        self.cb = cb
        self.key = key
        self.body = body
        self.graphable = graphable


class _JoinBody:
    """The folded INNER join under a keyed fused aggregate, as a batch
    body (the JAX package's `_build_join_probe_kernel`): the probe
    stages over the probe leaf batch, the probe keys (a NULL key never
    matches), the table lookup in the core's table - a fixed number of
    rounds, `probe_rounds`, so no readback - the build columns gathered
    at the matches, then the aggregate's chain and grouping over the
    joined columns, the unmatched rows dead. It holds the build and its
    table, whose addresses the graphs read; `key` names them."""

    def __init__(self, fused: FusedAggregateExec, join, core, probe_pipe,
                 state):
        self.fused = fused
        self.build = core.build
        self.build_keys = core._build_key_cols()
        self.probe_pipe = probe_pipe
        self.probe_keys = list(join.right_keys)
        self.mode, self.index, self.rounds = state
        self.expect = [torch_dtype(probe_pipe.schema.fields[i].dtype)
                       for i in self.probe_keys]
        self.key = (self.mode, self.rounds, core.token,
                    probe_pipe.structure_key())

    def __call__(self, cols: List[CV], cap: int, dev, live: torch.Tensor,
                 group_cap: Optional[int], rounds: Optional[int],
                 direct: bool = False):
        from blaze_tpu_torch.ops import hash_table as ht

        mid, sel = self.probe_pipe.run(cols, cap, dev, None)
        if sel is not None:
            live = live & sel
        pkeys = [mid[i] for i in self.probe_keys]
        got = [v.dtype for v, _ in pkeys]
        if got != self.expect:
            raise TypeError(f"fused join: probe keys evaluate to {got}, "
                            f"their fields say {self.expect}")
        for _, m in pkeys:
            if m is not None:
                live = live & m  # NULL join keys never match
        bcap = self.build.capacity
        if self.mode == "table_direct":
            tab, base, span = self.index
            match, matched = ht.lookup_direct(tab, base, span, pkeys[0][0],
                                              live)
        else:
            h = ht.cheap_hash(pkeys, cap)
            if self.mode == "table_kr":
                match, matched = ht.lookup_kr(
                    self.index, ht.key_u32(*pkeys[0]), h, live, self.rounds)
            else:
                match, matched = ht.lookup(
                    self.index, h, pkeys,
                    [(c.values, c.validity) for c in self.build_keys],
                    live, bcap, rounds=self.rounds)
        g = match.clamp(0, bcap - 1).to(torch.int64)
        joined = [(torch.index_select(c.values, 0, g),
                   None if c.validity is None
                   else torch.index_select(c.validity, 0, g))
                  for c in self.build.columns] + list(mid)
        return self.fused._plain_body(joined, cap, dev, matched, group_cap,
                                      rounds, direct)


class _CarryLayout:
    """The grouped carry's packed buffer: an int64 count, then every
    state column's values and a validity for each (a state without one
    keeps an all-true validity, written once), `slots` rows each; the
    JAX package's `pack_in_kernel` buffer, so one copy fetches it."""

    def __init__(self, schema: Schema, slots: int):
        specs = [(torch.int64, 1)]
        for f in schema:
            specs.append((torch_dtype(f.dtype), value_shape(f.dtype, slots)))
            specs.append((torch.bool, slots))
        self.layout = Layout(specs, header=0)

    @staticmethod
    def count(buf: torch.Tensor) -> torch.Tensor:
        return buf[:8].view(torch.int64)

    def new_buffer(self, device) -> torch.Tensor:
        buf = torch.zeros(self.layout.nbytes, dtype=torch.uint8,
                          device=device)
        for m in self.layout.views(buf)[2::2]:
            m.fill_(True)
        return buf

    def views(self, buf: torch.Tensor):
        """(count (1,), [(values, validity)] per state column)."""
        t = self.layout.views(buf)
        return t[0], [(t[i], t[i + 1]) for i in range(1, len(t), 2)]

    def pack(self, buf: torch.Tensor, n: torch.Tensor, outs: List[CV]
             ) -> None:
        n_v, cols = self.views(buf)
        n_v.copy_(n.reshape(1))
        for (dv, dm), (v, m) in zip(cols, outs):
            dv.copy_(v)
            if m is not None:
                dm.copy_(m)


def keyed_merge_plan(agg) -> Optional[List[str]]:
    """The grouped carry's merge plan of a keyed PARTIAL aggregate (the
    JAX package's `_grouped_carry_plan`, fused.py:339-371): per state
    column "add", "min" or "max"; None for FIRST/LAST (their states are
    order-sensitive) and for MIN/MAX of bool (the JAX merge has no bool
    lane). None also rules a graph out for the batch (`capturable`)."""
    plan = keyless_merge_plan(agg.aggs, agg.children[0].schema)
    if plan is None:
        return None
    states = agg.schema.fields[len(agg.keys):]
    for op, f in zip(plan, states):
        if op in ("min", "max") and f.dtype.id is TypeId.BOOL:
            return None
    return plan


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


class _IterChild(PhysicalOp):
    """A one-partition, one-shot child that replays a head of batches
    and then a live stream: the device FINAL of HostFinalAggExec reads
    the partial states through it without collecting them first."""

    def __init__(self, batches: List[ColumnBatch], schema: Schema,
                 rest=None):
        self.children = []
        self.batches = batches
        self.rest = rest
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def partition_count(self) -> int:
        return 1

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        yield from self.batches
        if self.rest is not None:
            yield from self.rest


class HostFinalAggExec(PhysicalOp):
    """The other half of the COMPLETE rewrite (the JAX package's
    HostFinalAggExec, its `_finalize_host` and `_finalize_agg` with
    `n_live`).

    Keyless: finalizes the carry's state row on the host. An empty
    stream gives the global row of an empty input (COUNT 0, the rest
    NULL).

    Keyed: a stream of one state batch (the grouped carry's fetch) holds
    unique groups, so it finalizes on the host, with no device work; a
    longer one (after a demotion, or per-batch states) streams into a
    device FINAL HashAggregateExec over `_IterChild`, whose `execute`
    keeps the `max_materialize_rows` cap and the grace spill.

    AVG divides, the variance family finishes its moments, a decimal
    SUM/AVG reassembles its chunk sums in Python ints. A host result
    stays on the host where the task boundary reads it; `to_device`
    (a HostFinalAggExec that is not the root of its plan, so another
    operator reads it on the card) copies a keyed one to the context's
    device."""

    def __init__(self, child: PhysicalOp, template, to_device: bool = False):
        # template: the original COMPLETE HashAggregateExec
        self.children = [child]
        self.template = template
        self.to_device = to_device
        self._schema = template.schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        from blaze_tpu_torch.ops.hash_aggregate import _empty_global_row

        if not self.template.keys:
            states = list(self.children[0].execute(partition, ctx))
            if not states:
                yield _empty_global_row(self.template, ctx.device)
                return
            (cb,) = states  # the carry is one state row
            yield self._finalize(cb)
            return
        stream = (cb for cb in self.children[0].execute(partition, ctx)
                  if cb.num_rows > 0)
        first = next(stream, None)
        if first is None:
            return
        second = next(stream, None)
        if second is None:
            out = self._finalize(first)
            if self.to_device and out.device != ctx.device:
                out = _to_device(out, ctx.device)
            yield out
            return
        yield from self._device_final(first, second, stream, ctx)

    def _device_final(self, first: ColumnBatch, second: ColumnBatch,
                      stream, ctx: ExecContext) -> Iterator[ColumnBatch]:
        """The FINAL of several keyed state batches on the device; a
        state batch fetched to the host goes back first."""
        from blaze_tpu_torch.exprs.ir import BoundCol
        from blaze_tpu_torch.ops.hash_aggregate import (
            AggMode,
            HashAggregateExec,
            _SchemaStub,
        )

        def on_device(cb):
            return cb if cb.device == ctx.device else _to_device(cb,
                                                                 ctx.device)

        partial_schema = self.children[0].schema
        final = HashAggregateExec(
            _SchemaStub(partial_schema),
            keys=[(BoundCol(i, partial_schema.fields[i].dtype), name)
                  for i, (_, name) in enumerate(self.template.keys)],
            aggs=list(self.template.aggs), mode=AggMode.FINAL)
        final.children = [_IterChild(
            [on_device(first), on_device(second)], partial_schema,
            rest=(on_device(cb) for cb in stream))]
        yield from final.execute(0, ctx)

    def _finalize(self, cb: ColumnBatch) -> ColumnBatch:
        from blaze_tpu_torch.ops.hash_aggregate import (
            _finalize_var,
            _reassemble_decimal,
            _state_width,
            parse_dsum_scale,
        )

        states = [(c.values, c.validity) for c in cb.columns]
        fields = self.children[0].schema.fields
        n_keys = len(self.template.keys)
        out: List[Column] = [
            Column(f.dtype, v, m)
            for f, (v, m) in zip(self._schema.fields, states[:n_keys])]
        pos = n_keys
        for (a, _), field in zip(self.template.aggs,
                                 self._schema.fields[n_keys:]):
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
                if cb.device.type != "cpu":
                    v, m = v.to(cb.device), m.to(cb.device)
            elif a.fn in (AggFn.COUNT, AggFn.COUNT_STAR):
                v, m = st[0][0], None
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
        return ColumnBatch(self._schema, out, cb.num_rows)


def _to_device(cb: ColumnBatch, device) -> ColumnBatch:
    """A batch's columns copied to `device`, each in one copy."""
    return ColumnBatch(cb.schema, [
        Column(c.dtype, c.values.to(device),
               None if c.validity is None else c.validity.to(device),
               c.dictionary) for c in cb.columns], cb.num_rows,
        None if cb.selection is None else cb.selection.to(device))


def fuse_pipelines(op: PhysicalOp) -> PhysicalOp:
    """The plan-level fusion pass (planner/fuse.py), re-exported."""
    from blaze_tpu_torch.planner.fuse import fuse_pipelines as _pass

    return _pass(op)
