"""Plan-level fusion pass: operator chains -> one CUDA graph replay per
batch.

Counterpart of the JAX package's planner/fuse.py (`fuse_pipelines`),
restricted to the nodes the port has. It walks a physical plan top
down and rewrites:

- a stateless Filter/Project/Rename chain of two or more stages into a
  `FusedPipelineExec` (ops/fused.py);
- a keyless PARTIAL aggregate into a `FusedAggregateExec` over its
  chain (one state row for the stream, from the keyless carry);
- a keyless COMPLETE aggregate into that carry plus a
  `HostFinalAggExec`, as the JAX package's COMPLETE rewrite does; a
  keyless one with FIRST or LAST, whose states do not merge in a carry,
  keeps its `HashAggregateExec` over a `FusedPipelineExec` of its chain;
- a keyed PARTIAL aggregate over a chain of one stage or more into a
  `FusedAggregateExec` (one graph replay a batch, its states on the
  device); with no chain it stays as it is, as in the JAX package;
- a keyed COMPLETE aggregate into a keyed `FusedAggregateExec` with
  `fetch_host` (the grouped carry) under a `HostFinalAggExec`, even
  over an empty chain (the JAX package's keyed COMPLETE rewrite);
- an aggregate whose keys or arguments are strings (dictionary codes),
  or lower a node to the host (ops/host_lower.py), is never folded:
  host pyarrow work cannot replay in a graph, and the JAX package's
  `_agg_exprs_fusable` refuses them the same way;
- an INNER hash join directly under a fused aggregate's chain
  (`_fuse_join_under_agg`): its build chain becomes one pipeline, even
  of one stage, and its probe chain a pipeline recorded on the join as
  `_fused_probe`, which the aggregate folds into its own graph (the
  probe, the table lookup and the build gather in the aggregate's
  replay);
- every other join (hash, sort-merge, streaming sort-merge) stays in
  place, and the Filter/Project chain under each child becomes a
  `FusedPipelineExec`: on the build side even a single stage, on the
  probe side a chain of two or more;
- a keyless COMPLETE aggregate directly over a window becomes
  `HostFinalAggExec(FusedWindowAggExec)`: the whole task in one pass
  (the JAX package's COMPLETE-over-Window rewrite);
- a window folds the Project/Rename chain under it
  (`WindowExec._fused_pipeline`; no Filter, since the window's sort
  sees every input row).

Every other node is left in place with its children rewritten. A keyed
`HostFinalAggExec` that is not the root of the plan copies its host
result to the device for the operator above it (`to_device`).
"""

from __future__ import annotations

from typing import List, Tuple

from blaze_tpu_torch.ops.base import PhysicalOp
from blaze_tpu_torch.ops.filter import FilterExec
from blaze_tpu_torch.ops.project import ProjectExec
from blaze_tpu_torch.ops.rename import RenameColumnsExec


def _collect_chain(op: PhysicalOp, allow_filter: bool = True
                   ) -> Tuple[List[PhysicalOp], PhysicalOp]:
    """The longest fusable Filter/Project/Rename chain from `op` down,
    top first, and the node below it. `allow_filter=False` keeps to the
    stages that keep every row (what a window can fold)."""
    from blaze_tpu_torch.ops.fused import stage_needs_host

    stages = (FilterExec, ProjectExec, RenameColumnsExec) if allow_filter \
        else (ProjectExec, RenameColumnsExec)
    chain: List[PhysicalOp] = []
    t = op
    while isinstance(t, stages) and not stage_needs_host(t):
        chain.append(t)
        t = t.children[0]
    return chain, t



def _fuse_chain(op: PhysicalOp, min_stages: int) -> PhysicalOp:
    """`op`'s Filter/Project chain as a FusedPipelineExec when it has at
    least `min_stages` stages; the pass below it either way."""
    from blaze_tpu_torch.ops.fused import FusedPipelineExec

    chain, leaf = _collect_chain(op)
    if len(chain) >= min_stages:
        return FusedPipelineExec(_fuse(leaf),
                                 list(reversed(chain)))
    return _fuse(op)


def _agg_exprs_fusable(agg) -> bool:
    """Whether an aggregate's keys and arguments can run in a graph (the
    JAX package's `_agg_exprs_fusable`, planner/fuse.py:67): none lowers
    a node to the host and none is a string (the port's dictionary
    codes, which the JAX package refuses as dictionary-encoded)."""
    from blaze_tpu_torch.exprs.typing import infer_dtype

    if agg._host:
        return False
    schema = agg.children[0].schema
    exprs = [e for e, _ in agg.keys] + [
        a.child for a, _ in agg.aggs if a.child is not None]
    return not any(infer_dtype(e, schema).is_string_like for e in exprs)


def _fuse_join_under_agg(join) -> None:
    """An INNER hash join that feeds a fused aggregate (the JAX package's
    `_fuse_join_under_agg`): the build side's chain becomes one
    FusedPipelineExec, even of one stage (the build relation is
    collected once); the probe side's chain becomes a FusedPipelineExec
    that is both the join's probe child and `_fused_probe = (leaf,
    pipeline)`, which the aggregate folds into its own graph. The join
    itself stays in place for the paths that read no attachment."""
    from blaze_tpu_torch.ops.fused import FusedPipelineExec

    bchain, bleaf = _collect_chain(join.children[0])
    if bchain:
        join.children[0] = FusedPipelineExec(_fuse(bleaf),
                                             list(reversed(bchain)))
    else:
        join.children[0] = _fuse(join.children[0])
    pchain, pleaf = _collect_chain(join.children[1])
    if pchain:
        pleaf = _fuse(pleaf)
        pipe = FusedPipelineExec(pleaf, list(reversed(pchain)))
        join.children[1] = pipe
        join._fused_probe = (pleaf, pipe)
    else:
        join.children[1] = _fuse(join.children[1])


def _fuse_agg_leaf(leaf: PhysicalOp) -> PhysicalOp:
    """The pass below a fused aggregate's chain: an INNER hash join gets
    its chains fused around it (`_fuse_join_under_agg`), anything else
    the generic pass."""
    from blaze_tpu_torch.ops.joins import HashJoinExec, JoinType

    if isinstance(leaf, HashJoinExec) and leaf.join_type is JoinType.INNER:
        _fuse_join_under_agg(leaf)
        return leaf
    return _fuse(leaf)


def fuse_pipelines(op: PhysicalOp) -> PhysicalOp:
    """The pass over a plan whose root is `op` (module docstring)."""
    from blaze_tpu_torch.ops.fused import HostFinalAggExec

    out = _fuse(op)
    if isinstance(out, HostFinalAggExec):
        out.to_device = False  # the task boundary reads it on the host
    return out


def _fuse(op: PhysicalOp) -> PhysicalOp:
    from blaze_tpu_torch.ops.fused import (
        FusedAggregateExec,
        FusedPipelineExec,
        HostFinalAggExec,
        keyless_merge_plan,
    )
    from blaze_tpu_torch.ops.fused import FusedWindowAggExec
    from blaze_tpu_torch.ops.hash_aggregate import AggMode, HashAggregateExec
    from blaze_tpu_torch.ops.window import WindowExec

    if isinstance(op, HashAggregateExec) and \
            op.mode in (AggMode.PARTIAL, AggMode.COMPLETE):
        chain, leaf = _collect_chain(op.children[0])
        if op.keys and _agg_exprs_fusable(op) and (
                chain or op.mode is AggMode.COMPLETE):
            pipeline = FusedPipelineExec(_fuse_agg_leaf(leaf),
                                         list(reversed(chain)))
            if op.mode is AggMode.PARTIAL:
                return FusedAggregateExec(pipeline, op)
            partial = HashAggregateExec(pipeline, keys=list(op.keys),
                                        aggs=list(op.aggs),
                                        mode=AggMode.PARTIAL)
            return HostFinalAggExec(
                FusedAggregateExec(pipeline, partial, fetch_host=True), op,
                to_device=True)
        if op.mode is AggMode.COMPLETE and not op.keys and not chain \
                and not op._host and isinstance(leaf, WindowExec):
            # a keyless rollup directly over a window: the whole task -
            # the window's folded chain, argsort, frames and the
            # aggregate - in one pass. (The JAX package first checks
            # that the window's sort needs no host; the port's
            # WindowExec refuses such keys when it is built.)
            win = _fuse(leaf)
            partial = HashAggregateExec(win, keys=[], aggs=list(op.aggs),
                                        mode=AggMode.PARTIAL)
            return HostFinalAggExec(FusedWindowAggExec(win, partial), op)
        if not op.keys and not op._host \
                and keyless_merge_plan(op.aggs,
                                       op.children[0].schema) is not None:
            pipeline = FusedPipelineExec(_fuse(leaf),
                                         list(reversed(chain)))
            partial = HashAggregateExec(pipeline, keys=[],
                                        aggs=list(op.aggs),
                                        mode=AggMode.PARTIAL)
            if op.mode is AggMode.PARTIAL:
                return FusedAggregateExec(pipeline, partial)
            return HostFinalAggExec(
                FusedAggregateExec(pipeline, partial, fetch_host=True), op)
        if chain:
            op.children = [FusedPipelineExec(_fuse(leaf),
                                             list(reversed(chain)))]
            return op
    if isinstance(op, WindowExec) and op._fused_pipeline is None:
        chain, leaf = _collect_chain(op.children[0], allow_filter=False)
        if chain:
            leaf = _fuse(leaf)
            op.children = [leaf]
            op._fused_pipeline = FusedPipelineExec(leaf,
                                                   list(reversed(chain)))
            return op
    build_child = getattr(op, "build_child", None)
    if build_child is not None:
        op.children = [
            _fuse_chain(c, 1 if i == build_child else 2)
            for i, c in enumerate(op.children)]
        return op
    chain, t = _collect_chain(op)
    if len(chain) >= 2:
        return FusedPipelineExec(_fuse(t), list(reversed(chain)))
    op.children = [_fuse(c) for c in op.children]
    return op
