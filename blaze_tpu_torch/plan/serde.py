"""Encode/decode between the protobuf wire schema (plan.proto) and the
engine's operator/expression objects.

Mirror of the reference's two-sided serde: the Scala builders
(NativeConverters.scala convertExpr / Native*Exec proto emission) and the
Rust decoder (`TryInto<Arc<dyn ExecutionPlan>>`, from_proto.rs:162-560).
The wire format is the JAX package's, unchanged: TaskDefinition bytes
from either package decode in the other. The port carries the
parquet_scan, ipc_reader, empty_partitions, filter, project, sort,
union, limit, hash_aggregate, hash_join, sort_merge_join (streaming or
not), shuffle_writer (hash, single, round_robin, and range with its
sampled bounds and sort directions), ipc_writer, rename_columns, debug
and window arms, and a task's file resources (the IpcReader inputs of
a reduce task: local FileSegments and RemoteSegments on another host's
BlockServer); every other plan arm raises NotImplementedError naming
the ROADMAP item that brings it.
"""

from __future__ import annotations

from blaze_tpu_torch.types import DataType, Field, Schema, TypeId
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.ir import AggFn, Op
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.ops.base import PhysicalOp
from blaze_tpu_torch.ops.debug import DebugExec
from blaze_tpu_torch.ops.empty import EmptyPartitionsExec
from blaze_tpu_torch.ops.filter import FilterExec
from blaze_tpu_torch.ops.hash_aggregate import AggMode, HashAggregateExec
from blaze_tpu_torch.ops.ipc_reader import (
    FileSegment,
    IpcReaderExec,
    IpcReadMode,
)
from blaze_tpu_torch.ops.ipc_writer import IpcWriterExec
from blaze_tpu_torch.ops.joins import (
    HashJoinExec,
    JoinType,
    SortMergeJoinExec,
)
from blaze_tpu_torch.ops.limit import LimitExec
from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec
from blaze_tpu_torch.ops.project import ProjectExec
from blaze_tpu_torch.ops.rename import RenameColumnsExec
from blaze_tpu_torch.ops.shuffle_writer import ShuffleWriterExec
from blaze_tpu_torch.ops.sort import SortExec, SortKey
from blaze_tpu_torch.ops.streaming_smj import StreamingSortMergeJoinExec
from blaze_tpu_torch.ops.union import UnionExec
from blaze_tpu_torch.ops.window import WindowExec, WindowFn
from blaze_tpu_torch.runtime.transport import RemoteSegment

_ROADMAP_OPS = "ROADMAP 'Modules to port'"

# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

_TID_TO_PB = {
    TypeId.NULL: pb.NULL,
    TypeId.BOOL: pb.BOOL,
    TypeId.INT8: pb.INT8,
    TypeId.INT16: pb.INT16,
    TypeId.INT32: pb.INT32,
    TypeId.INT64: pb.INT64,
    TypeId.FLOAT32: pb.FLOAT32,
    TypeId.FLOAT64: pb.FLOAT64,
    TypeId.UTF8: pb.UTF8,
    TypeId.BINARY: pb.BINARY,
    TypeId.DATE32: pb.DATE32,
    TypeId.TIMESTAMP_US: pb.TIMESTAMP_US,
    TypeId.DECIMAL: pb.DECIMAL,
}
_PB_TO_TID = {v: k for k, v in _TID_TO_PB.items()}


def dtype_to_proto(dt: DataType) -> pb.DataTypeProto:
    return pb.DataTypeProto(
        id=_TID_TO_PB[dt.id], precision=dt.precision, scale=dt.scale
    )


def dtype_from_proto(p: pb.DataTypeProto) -> DataType:
    return DataType(_PB_TO_TID[p.id], p.precision, p.scale)


def schema_to_proto(s: Schema) -> pb.SchemaProto:
    return pb.SchemaProto(
        fields=[
            pb.FieldProto(
                name=f.name, dtype=dtype_to_proto(f.dtype),
                nullable=f.nullable,
            )
            for f in s
        ]
    )


def schema_from_proto(p: pb.SchemaProto) -> Schema:
    return Schema(
        [
            Field(f.name, dtype_from_proto(f.dtype), f.nullable)
            for f in p.fields
        ]
    )


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

_OP_TO_PB = {
    Op.ADD: pb.ADD, Op.SUB: pb.SUB, Op.MUL: pb.MUL, Op.DIV: pb.DIV,
    Op.MOD: pb.MOD, Op.EQ: pb.EQ, Op.NEQ: pb.NEQ, Op.LT: pb.LT,
    Op.LTE: pb.LTE, Op.GT: pb.GT, Op.GTE: pb.GTE, Op.AND: pb.AND,
    Op.OR: pb.OR, Op.BITAND: pb.BITAND, Op.BITOR: pb.BITOR,
    Op.BITXOR: pb.BITXOR, Op.SHL: pb.SHL, Op.SHR: pb.SHR,
}
_PB_TO_OP = {v: k for k, v in _OP_TO_PB.items()}

_AGG_TO_PB = {
    AggFn.MIN: pb.MIN, AggFn.MAX: pb.MAX, AggFn.SUM: pb.SUM,
    AggFn.AVG: pb.AVG, AggFn.COUNT: pb.COUNT,
    AggFn.COUNT_STAR: pb.COUNT_STAR, AggFn.VAR_SAMP: pb.VAR_SAMP,
    AggFn.VAR_POP: pb.VAR_POP, AggFn.STDDEV_SAMP: pb.STDDEV_SAMP,
    AggFn.STDDEV_POP: pb.STDDEV_POP, AggFn.FIRST: pb.FIRST,
    AggFn.LAST: pb.LAST,
}
_PB_TO_AGG = {v: k for k, v in _AGG_TO_PB.items()}

_INT_LIKE = {
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
    TypeId.DATE32, TypeId.TIMESTAMP_US, TypeId.DECIMAL,
}


def expr_to_proto(e: ir.Expr) -> pb.ExprProto:
    p = pb.ExprProto()
    if isinstance(e, ir.Col):
        p.column = e.name
    elif isinstance(e, ir.BoundCol):
        p.bound_column = e.index
        p.bound_dtype.CopyFrom(dtype_to_proto(e.dtype))
    elif isinstance(e, ir.Literal):
        lit = p.literal
        lit.dtype.CopyFrom(dtype_to_proto(e.dtype))
        if e.value is None:
            lit.is_null = True
        elif e.dtype.id is TypeId.BOOL:
            lit.bool_value = bool(e.value)
        elif e.dtype.id in _INT_LIKE:
            lit.int_value = int(e.value)
        elif e.dtype.id in (TypeId.FLOAT32, TypeId.FLOAT64):
            lit.float_value = float(e.value)
        elif e.dtype.id is TypeId.UTF8:
            lit.string_value = e.value
        elif e.dtype.id is TypeId.BINARY:
            lit.bytes_value = e.value
        else:
            raise NotImplementedError(f"literal {e.dtype}")
    elif isinstance(e, ir.Cast):
        p.cast.child.CopyFrom(expr_to_proto(e.child))
        p.cast.to.CopyFrom(dtype_to_proto(e.to))
    elif isinstance(e, ir.BinaryOp):
        p.binary.op = _OP_TO_PB[e.op]
        p.binary.left.CopyFrom(expr_to_proto(e.left))
        p.binary.right.CopyFrom(expr_to_proto(e.right))
    elif isinstance(e, ir.Not):
        p.logical_not.CopyFrom(expr_to_proto(e.child))
    elif isinstance(e, ir.Negate):
        p.negate.CopyFrom(expr_to_proto(e.child))
    elif isinstance(e, ir.IsNull):
        p.is_null.CopyFrom(expr_to_proto(e.child))
    elif isinstance(e, ir.IsNotNull):
        p.is_not_null.CopyFrom(expr_to_proto(e.child))
    elif isinstance(e, ir.InList):
        p.in_list.child.CopyFrom(expr_to_proto(e.child))
        for v in e.values:
            p.in_list.values.append(expr_to_proto(v))
        p.in_list.negated = e.negated
    elif isinstance(e, ir.If):
        p.if_.cond.CopyFrom(expr_to_proto(e.cond))
        p.if_.then.CopyFrom(expr_to_proto(e.then))
        p.if_.otherwise.CopyFrom(expr_to_proto(e.otherwise))
    elif isinstance(e, ir.CaseWhen):
        for c, r in e.branches:
            b = p.case_.branches.add()
            b.cond.CopyFrom(expr_to_proto(c))
            b.result.CopyFrom(expr_to_proto(r))
        if e.otherwise is not None:
            p.case_.otherwise.CopyFrom(expr_to_proto(e.otherwise))
    elif isinstance(e, ir.ScalarFn):
        p.scalar_fn.name = e.name
        for a in e.args:
            p.scalar_fn.args.append(expr_to_proto(a))
    elif isinstance(e, ir.Coalesce):
        for a in e.args:
            p.coalesce.args.append(expr_to_proto(a))
    elif isinstance(e, ir.AggExpr):
        p.agg.fn = _AGG_TO_PB[e.fn]
        if e.child is not None:
            p.agg.child.CopyFrom(expr_to_proto(e.child))
    else:
        raise NotImplementedError(type(e))
    return p


def expr_from_proto(p: pb.ExprProto) -> ir.Expr:
    kind = p.WhichOneof("kind")
    if kind == "column":
        return ir.Col(p.column)
    if kind == "bound_column":
        return ir.BoundCol(p.bound_column, dtype_from_proto(p.bound_dtype))
    if kind == "literal":
        lit = p.literal
        dt = dtype_from_proto(lit.dtype)
        if lit.is_null:
            return ir.Literal(None, dt)
        return ir.Literal(getattr(lit, lit.WhichOneof("value")), dt)
    if kind == "cast":
        return ir.Cast(
            expr_from_proto(p.cast.child), dtype_from_proto(p.cast.to)
        )
    if kind == "binary":
        return ir.BinaryOp(
            _PB_TO_OP[p.binary.op],
            expr_from_proto(p.binary.left),
            expr_from_proto(p.binary.right),
        )
    if kind == "logical_not":
        return ir.Not(expr_from_proto(p.logical_not))
    if kind == "negate":
        return ir.Negate(expr_from_proto(p.negate))
    if kind == "is_null":
        return ir.IsNull(expr_from_proto(p.is_null))
    if kind == "is_not_null":
        return ir.IsNotNull(expr_from_proto(p.is_not_null))
    if kind == "in_list":
        return ir.InList(
            expr_from_proto(p.in_list.child),
            tuple(expr_from_proto(v) for v in p.in_list.values),
            p.in_list.negated,
        )
    if kind == "if_":
        return ir.If(
            expr_from_proto(p.if_.cond),
            expr_from_proto(p.if_.then),
            expr_from_proto(p.if_.otherwise),
        )
    if kind == "case_":
        return ir.CaseWhen(
            tuple(
                (expr_from_proto(b.cond), expr_from_proto(b.result))
                for b in p.case_.branches
            ),
            expr_from_proto(p.case_.otherwise)
            if p.case_.HasField("otherwise")
            else None,
        )
    if kind == "scalar_fn":
        return ir.ScalarFn(
            p.scalar_fn.name,
            tuple(expr_from_proto(a) for a in p.scalar_fn.args),
        )
    if kind == "coalesce":
        return ir.Coalesce(
            tuple(expr_from_proto(a) for a in p.coalesce.args)
        )
    if kind == "agg":
        return ir.AggExpr(
            _PB_TO_AGG[p.agg.fn],
            expr_from_proto(p.agg.child)
            if p.agg.HasField("child")
            else None,
        )
    raise NotImplementedError(kind)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

_MODE_TO_PB = {
    AggMode.PARTIAL: pb.PARTIAL, AggMode.FINAL: pb.FINAL,
    AggMode.COMPLETE: pb.COMPLETE,
}
_PB_TO_MODE = {v: k for k, v in _MODE_TO_PB.items()}

_IPC_TO_PB = {
    IpcReadMode.CHANNEL: pb.CHANNEL,
    IpcReadMode.CHANNEL_UNCOMPRESSED: pb.CHANNEL_UNCOMPRESSED,
    IpcReadMode.CHANNEL_AND_FILE_SEGMENT: pb.CHANNEL_AND_FILE_SEGMENT,
}
_PB_TO_IPC = {v: k for k, v in _IPC_TO_PB.items()}

_JT_TO_PB = {
    JoinType.INNER: pb.INNER, JoinType.LEFT: pb.LEFT,
    JoinType.RIGHT: pb.RIGHT, JoinType.FULL: pb.FULL,
    JoinType.LEFT_SEMI: pb.LEFT_SEMI, JoinType.LEFT_ANTI: pb.LEFT_ANTI,
    JoinType.LEFT_ANTI_NULL_AWARE: pb.LEFT_ANTI_NULL_AWARE,
}
_PB_TO_JT = {v: k for k, v in _JT_TO_PB.items()}

_SHUFFLE_TO_PB = {"hash": pb.HASH, "single": pb.SINGLE,
                  "round_robin": pb.ROUND_ROBIN, "range": pb.RANGE}
_PB_TO_SHUFFLE = {v: k for k, v in _SHUFFLE_TO_PB.items()}


def plan_from_proto(p: pb.PlanProto) -> PhysicalOp:
    kind = p.WhichOneof("kind")
    if kind == "parquet_scan":
        ps = p.parquet_scan
        groups = [
            [FileRange(fr.path, fr.start, fr.length) for fr in g.files]
            for g in ps.file_groups
        ]
        schema = (
            schema_from_proto(ps.schema) if ps.schema.fields else None
        )
        projection = (
            [schema.fields[i].name for i in ps.projection]
            if ps.projection and schema
            else (schema.names() if schema else None)
        )
        pruning = (
            expr_from_proto(ps.pruning_predicate)
            if ps.HasField("pruning_predicate")
            else None
        )
        return ParquetScanExec(groups, schema, projection, pruning)
    if kind == "ipc_reader":
        r = p.ipc_reader
        return IpcReaderExec(r.resource_id, schema_from_proto(r.schema),
                             r.num_partitions, _PB_TO_IPC[r.mode])
    if kind == "empty_partitions":
        return EmptyPartitionsExec(
            schema_from_proto(p.empty_partitions.schema),
            p.empty_partitions.num_partitions)
    if kind == "project":
        return ProjectExec(
            plan_from_proto(p.project.input),
            [
                (expr_from_proto(ne.expr), ne.name)
                for ne in p.project.exprs
            ],
        )
    if kind == "filter":
        return FilterExec(
            plan_from_proto(p.filter.input),
            expr_from_proto(p.filter.predicate),
        )
    if kind == "sort":
        return SortExec(
            plan_from_proto(p.sort.input),
            [SortKey(expr_from_proto(k.expr), k.ascending, k.nulls_first)
             for k in p.sort.keys],
            fetch=None if p.sort.fetch < 0 else p.sort.fetch)
    if kind == "union":
        return UnionExec([plan_from_proto(i) for i in p.union.inputs])
    if kind == "limit":
        return LimitExec(plan_from_proto(p.limit.input), p.limit.limit)
    if kind == "hash_aggregate":
        h = p.hash_aggregate
        return HashAggregateExec(
            plan_from_proto(h.input),
            keys=[(expr_from_proto(k.expr), k.name) for k in h.keys],
            aggs=[(expr_from_proto(a.expr), a.name) for a in h.aggs],
            mode=_PB_TO_MODE[h.mode],
        )
    if kind == "hash_join":
        h = p.hash_join
        return HashJoinExec(
            plan_from_proto(h.left), plan_from_proto(h.right),
            list(h.left_keys), list(h.right_keys),
            _PB_TO_JT[h.join_type],
        )
    if kind == "sort_merge_join":
        h = p.sort_merge_join
        left = plan_from_proto(h.left)
        right = plan_from_proto(h.right)
        if h.streaming:
            try:
                return StreamingSortMergeJoinExec(
                    left, right, list(h.left_keys), list(h.right_keys),
                    _PB_TO_JT[h.join_type],
                )
            except NotImplementedError:
                pass  # keys it cannot stream: the materializing join
        return SortMergeJoinExec(
            left, right, list(h.left_keys), list(h.right_keys),
            _PB_TO_JT[h.join_type],
        )
    if kind == "shuffle_writer":
        sw = p.shuffle_writer
        bounds = []
        for row in sw.range_bounds:
            vals = []
            for lp in row.values:
                wrap = pb.ExprProto()
                wrap.literal.CopyFrom(lp)
                vals.append(expr_from_proto(wrap).value)
            bounds.append(tuple(vals))
        return ShuffleWriterExec(
            plan_from_proto(sw.input),
            [expr_from_proto(k) for k in sw.keys],
            sw.num_partitions, sw.data_file, sw.index_file,
            _PB_TO_SHUFFLE[sw.mode], range_bounds=bounds or None,
            sort_ascending=list(sw.sort_ascending) or None)
    if kind == "ipc_writer":
        return IpcWriterExec(plan_from_proto(p.ipc_writer.input),
                             p.ipc_writer.resource_id)
    if kind == "rename_columns":
        return RenameColumnsExec(plan_from_proto(p.rename_columns.input),
                                 list(p.rename_columns.names))
    if kind == "debug":
        return DebugExec(plan_from_proto(p.debug.input), p.debug.debug_id)
    if kind == "window":
        return _window_from_proto(p.window)
    raise NotImplementedError(
        f"plan node {kind!r} waits for {_ROADMAP_OPS}"
    )


def _window_from_proto(w) -> WindowExec:
    return WindowExec(
        plan_from_proto(w.input),
        partition_by=[expr_from_proto(e) for e in w.partition_by],
        order_by=[SortKey(expr_from_proto(k.expr), k.ascending,
                          k.nulls_first) for k in w.order_by],
        functions=[
            WindowFn(
                f.kind,
                expr_from_proto(f.source) if f.HasField("source") else None,
                f.output,
                # the offset travels biased by +1, so proto3's 0 default
                # means "unset -> 1" while lag(v, 0) stays representable
                (f.offset - 1) if f.offset else 1,
                (f.frame,
                 None if f.frame_lo < 0 else f.frame_lo,
                 None if f.frame_hi < 0 else f.frame_hi)
                if f.frame else None)
            for f in w.functions])


def _window_to_proto(w, op: WindowExec) -> None:
    w.input.CopyFrom(plan_to_proto(op.children[0]))
    for e in op.partition_by:
        w.partition_by.add().CopyFrom(expr_to_proto(e))
    for k in op.order_by:
        w.order_by.add(expr=expr_to_proto(k.expr), ascending=k.ascending,
                       nulls_first=k.nulls_first)
    for f in op.functions:
        fp = w.functions.add(kind=f.kind, output=f.output)
        if f.source is not None:
            fp.source.CopyFrom(expr_to_proto(f.source))
        fp.offset = f.offset + 1  # +1 bias: see the decode side
        if f.frame is not None:
            fp.frame = f.frame[0]
            fp.frame_lo = -1 if f.frame[1] is None else f.frame[1]
            fp.frame_hi = -1 if f.frame[2] is None else f.frame[2]


def plan_to_proto(op: PhysicalOp) -> pb.PlanProto:
    p = pb.PlanProto()
    if isinstance(op, ParquetScanExec):
        ps = p.parquet_scan
        for g in op.file_groups:
            gp = ps.file_groups.add()
            for fr in g:
                gp.files.add(path=fr.path, start=fr.start,
                             length=fr.length)
        ps.schema.CopyFrom(schema_to_proto(op.schema))
        if op.pruning_predicate is not None:
            ps.pruning_predicate.CopyFrom(
                expr_to_proto(op.pruning_predicate)
            )
    elif isinstance(op, IpcReaderExec):
        r = p.ipc_reader
        r.resource_id = op.resource_id
        r.schema.CopyFrom(schema_to_proto(op.schema))
        r.num_partitions = op.partition_count
        r.mode = _IPC_TO_PB[op.mode]
    elif isinstance(op, EmptyPartitionsExec):
        p.empty_partitions.schema.CopyFrom(schema_to_proto(op.schema))
        p.empty_partitions.num_partitions = op.partition_count
    elif isinstance(op, ProjectExec):
        p.project.input.CopyFrom(plan_to_proto(op.children[0]))
        for e, name in op.exprs:
            p.project.exprs.add(expr=expr_to_proto(e), name=name)
    elif isinstance(op, FilterExec):
        p.filter.input.CopyFrom(plan_to_proto(op.children[0]))
        p.filter.predicate.CopyFrom(expr_to_proto(op.predicate))
    elif isinstance(op, SortExec):
        p.sort.input.CopyFrom(plan_to_proto(op.children[0]))
        for k in op.keys:
            p.sort.keys.add(expr=expr_to_proto(k.expr),
                            ascending=k.ascending,
                            nulls_first=k.nulls_first)
        p.sort.fetch = op.fetch if op.fetch is not None else -1
    elif isinstance(op, UnionExec):
        for c in op.children:
            p.union.inputs.add().CopyFrom(plan_to_proto(c))
    elif isinstance(op, LimitExec):
        p.limit.input.CopyFrom(plan_to_proto(op.children[0]))
        p.limit.limit = op.limit
    elif isinstance(op, HashAggregateExec):
        h = p.hash_aggregate
        h.input.CopyFrom(plan_to_proto(op.children[0]))
        for e, name in op.keys:
            h.keys.add(expr=expr_to_proto(e), name=name)
        for a, name in op.aggs:
            h.aggs.add(expr=expr_to_proto(a), name=name)
        h.mode = _MODE_TO_PB[op.mode]
    elif isinstance(op, HashJoinExec):
        _join_to_proto(p.hash_join, op)
    elif isinstance(op, (SortMergeJoinExec, StreamingSortMergeJoinExec)):
        _join_to_proto(p.sort_merge_join, op)
        p.sort_merge_join.streaming = isinstance(
            op, StreamingSortMergeJoinExec)
    elif isinstance(op, ShuffleWriterExec):
        sw = p.shuffle_writer
        sw.input.CopyFrom(plan_to_proto(op.children[0]))
        for k in op.key_exprs:
            sw.keys.add().CopyFrom(expr_to_proto(k))
        sw.num_partitions = op.num_partitions
        sw.data_file = op.data_file
        sw.index_file = op.index_file
        sw.mode = _SHUFFLE_TO_PB[op.mode]
        if op.mode == "range":
            from blaze_tpu_torch.exprs.typing import infer_dtype

            sw.sort_ascending.extend(op.sort_ascending)
            key_dtypes = [infer_dtype(e, op.children[0].schema)
                          for e in op.key_exprs]
            for bound in op.range_bounds:
                row = sw.range_bounds.add()
                for v, dt in zip(bound, key_dtypes):
                    row.values.add().CopyFrom(
                        expr_to_proto(ir.Literal(v, dt)).literal)
    elif isinstance(op, IpcWriterExec):
        p.ipc_writer.input.CopyFrom(plan_to_proto(op.children[0]))
        p.ipc_writer.resource_id = op.resource_id
    elif isinstance(op, RenameColumnsExec):
        p.rename_columns.input.CopyFrom(plan_to_proto(op.children[0]))
        p.rename_columns.names.extend(op.names)
    elif isinstance(op, DebugExec):
        p.debug.input.CopyFrom(plan_to_proto(op.children[0]))
        p.debug.debug_id = op.debug_id
    elif isinstance(op, WindowExec):
        _window_to_proto(p.window, op)
    else:
        raise NotImplementedError(
            f"plan node {type(op).__name__} waits for {_ROADMAP_OPS}"
        )
    return p


def _join_to_proto(h, op: PhysicalOp) -> None:
    """The fields a hash join and a sort-merge join share."""
    left, right = op.children
    h.left.CopyFrom(plan_to_proto(left))
    h.right.CopyFrom(plan_to_proto(right))
    h.left_keys.extend(left.schema.fields[i].name for i in op.left_keys)
    h.right_keys.extend(right.schema.fields[i].name for i in op.right_keys)
    h.join_type = _JT_TO_PB[op.join_type]


def task_to_proto(op: PhysicalOp, partition: int, task_id: str = "task",
                  file_resources=None) -> bytes:
    """TaskDefinition bytes. `file_resources` is {resource_id:
    [FileSegment | RemoteSegment, ...]}: the segments an IpcReader leaf
    of the task reads, shipped with it; list order is the read order."""
    t = pb.TaskDefinitionProto(partition=partition, task_id=task_id)
    t.plan.CopyFrom(plan_to_proto(op))
    for rid, segments in (file_resources or {}).items():
        rp = t.file_resources.add(resource_id=rid)
        for seg in segments:
            o = rp.ordered.add()
            if isinstance(seg, RemoteSegment):
                o.remote.host = seg.host
                o.remote.port = seg.port
                o.remote.path = seg.path
                o.remote.start = seg.offset
                o.remote.length = seg.length
            elif isinstance(seg, FileSegment):
                o.local.path = seg.path
                o.local.start = seg.offset
                o.local.length = seg.length
            else:
                raise TypeError(
                    f"file resource of type {type(seg).__name__}")
    return t.SerializeToString()


def task_from_proto(data: bytes):
    """(op, partition, task_id, resources) from TaskDefinition bytes;
    `resources` maps each file resource's id to a provider giving its
    segments for any partition."""
    t = pb.TaskDefinitionProto()
    t.ParseFromString(data)
    resources = {}
    for rp in t.file_resources:
        # the legacy local-only field first, then the ordered list
        segs = [FileSegment(s.path, s.start, s.length) for s in rp.segments]
        for o in rp.ordered:
            if o.WhichOneof("kind") == "remote":
                r = o.remote
                segs.append(RemoteSegment(r.host, r.port, r.path, r.start,
                                          r.length))
            else:
                segs.append(FileSegment(o.local.path, o.local.start,
                                        o.local.length))
        resources[rp.resource_id] = (lambda ss: (lambda p: ss))(segs)
    return plan_from_proto(t.plan), t.partition, t.task_id, resources
