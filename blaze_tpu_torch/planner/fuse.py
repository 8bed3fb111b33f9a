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
  `HostFinalAggExec`, as the JAX package's COMPLETE rewrite does;
- a keyed aggregate keeps its `HashAggregateExec` over a
  `FusedPipelineExec` of its chain: grouping syncs with the host
  (`d2h_syncs.group_branch`, `.insert_round`, `.n_groups`), so a keyed
  batch is not one graph yet (ROADMAP 'Modules to port' item 1, the
  grouped carry). So does a keyless aggregate with FIRST or LAST,
  whose states do not merge in a carry;
- a join (hash, sort-merge, streaming sort-merge) stays in place, and
  the Filter/Project chain under each child becomes a
  `FusedPipelineExec`: on the build side even a single stage, as the
  JAX package's `_fuse_join_under_agg` does (the build relation is
  collected once), on the probe side a chain of two or more. The
  JAX package's fused join+aggregate program (the probe folded into
  the aggregate's kernel) waits for item 1 with the grouped carry;
- a keyless COMPLETE aggregate directly over a window becomes
  `HostFinalAggExec(FusedWindowAggExec)`: the whole task in one pass
  (the JAX package's COMPLETE-over-Window rewrite);
- a window folds the Project/Rename chain under it
  (`WindowExec._fused_pipeline`; no Filter, since the window's sort
  sees every input row).

Every other node is left in place with its children rewritten.
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
        return FusedPipelineExec(fuse_pipelines(leaf),
                                 list(reversed(chain)))
    return fuse_pipelines(op)


def fuse_pipelines(op: PhysicalOp) -> PhysicalOp:
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
        if op.mode is AggMode.COMPLETE and not op.keys and not chain \
                and isinstance(leaf, WindowExec):
            # a keyless rollup directly over a window: the whole task -
            # the window's folded chain, argsort, frames and the
            # aggregate - in one pass. (The JAX package first checks
            # that the window's sort needs no host; the port's
            # WindowExec refuses such keys when it is built.)
            win = fuse_pipelines(leaf)
            partial = HashAggregateExec(win, keys=[], aggs=list(op.aggs),
                                        mode=AggMode.PARTIAL)
            return HostFinalAggExec(FusedWindowAggExec(win, partial), op)
        if not op.keys and keyless_merge_plan(op.aggs) is not None:
            pipeline = FusedPipelineExec(fuse_pipelines(leaf),
                                         list(reversed(chain)))
            partial = HashAggregateExec(pipeline, keys=[],
                                        aggs=list(op.aggs),
                                        mode=AggMode.PARTIAL)
            if op.mode is AggMode.PARTIAL:
                return FusedAggregateExec(pipeline, partial)
            return HostFinalAggExec(
                FusedAggregateExec(pipeline, partial, fetch_host=True), op)
        if chain:
            op.children = [FusedPipelineExec(fuse_pipelines(leaf),
                                             list(reversed(chain)))]
            return op
    if isinstance(op, WindowExec) and op._fused_pipeline is None:
        chain, leaf = _collect_chain(op.children[0], allow_filter=False)
        if chain:
            leaf = fuse_pipelines(leaf)
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
        return FusedPipelineExec(fuse_pipelines(t), list(reversed(chain)))
    op.children = [fuse_pipelines(c) for c in op.children]
    return op
