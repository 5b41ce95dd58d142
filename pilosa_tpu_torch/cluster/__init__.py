"""The cluster layer: placement, membership, hinted handoff and
anti-entropy.  A copy of ``pilosa_tpu/cluster/__init__.py``."""

from .cluster import (
    STATE_DEGRADED,
    STATE_NORMAL,
    STATE_RESIZING,
    STATE_STARTING,
    Cluster,
    Node,
    fnv1a64,
    jump_hash,
    place_partition,
)

__all__ = [
    "Cluster",
    "Node",
    "STATE_DEGRADED",
    "STATE_NORMAL",
    "STATE_RESIZING",
    "STATE_STARTING",
    "fnv1a64",
    "jump_hash",
    "place_partition",
]
