"""Zero-copy serve path (docs/ARCHITECTURE.md).

Two data-plane caches that remove the decode/copy phases from the
serving hot path on both tiers:

  plan_cache -- content-addressed decoded-plan cache keyed by the
                blake2b digest of the raw SUBMIT blob (the same digest
                the router's AffinityMap computes), so a repeat plan
                skips protobuf decode and plan translation entirely.
  arena      -- shared-memory Arrow arena: finalized, already-encoded
                result part frames live in mmap'd segment files with
                refcounted TTL leases. Co-located clients FETCH a
                handle and map the bytes instead of reading them off
                the socket; remote clients are served the SAME frames
                as a scatter-gather buffer list (no re-encode, no
                concatenated reply).

Both degrade: any mmap/lease failure (chaos seams `zerocopy.map` and
`zerocopy.lease`) falls back to the socket byte path with zero
client-visible failures.
"""

from blaze_tpu_torch.zerocopy.arena import ArrowArena, map_handle_frames
from blaze_tpu_torch.zerocopy.plan_cache import (
    DecodedPlanCache,
    PlanEntry,
    plan_digest,
)

__all__ = [
    "ArrowArena",
    "DecodedPlanCache",
    "PlanEntry",
    "map_handle_frames",
    "plan_digest",
]
