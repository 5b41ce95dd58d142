"""Row — a query-result bitmap spanning shards.

Mirror of the reference's Row (row.go:26-257): a list of per-shard segments
with set algebra that aligns segments by shard.  Here a segment is a dense
``int32[WORDS]`` word tensor instead of a roaring bitmap, so algebra lowers
onto the row ops of ``ops.bitops``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import ops
from ..ops import bitops
from ..parallel.mesh import resolve_device


class Row:
    """Per-shard dense segments + result metadata (attrs, key)."""

    __slots__ = ("segments", "attrs", "key", "keys")

    def __init__(self, segments: Optional[Dict[int, object]] = None):
        # shard -> int32[WORDS] word tensor
        self.segments: Dict[int, object] = segments or {}
        self.attrs: Optional[dict] = None
        self.key: Optional[str] = None
        # Translated column keys when the index has keys enabled
        # (row.go Row.Keys).
        self.keys: Optional[List[str]] = None

    @classmethod
    def from_columns(cls, columns, device=None) -> "Row":
        """Build from absolute column IDs (test/import convenience), on
        the card unless ``device`` names another."""
        device = resolve_device(device)
        columns = np.asarray(sorted(columns), dtype=np.uint64)
        shards = (columns // np.uint64(ops.SHARD_WIDTH)).astype(np.int64)
        segs: Dict[int, object] = {}
        for shard in np.unique(shards):
            in_shard = columns[shards == shard] % np.uint64(ops.SHARD_WIDTH)
            segs[int(shard)] = bitops.to_tensor(
                ops.positions_to_words(in_shard), device
            )
        return cls(segs)

    def shards(self) -> List[int]:
        return sorted(self.segments)

    def segment(self, shard: int):
        return self.segments.get(shard)

    # -- algebra (aligned by shard, as row.go:46-160) ----------------------

    def merge(self, other: "Row"):
        """In-place segment merge used by the executor's shard reduce: keep
        both rows' segments (shards never overlap across mappers)."""
        for shard, seg in other.segments.items():
            mine = self.segments.get(shard)
            self.segments[shard] = seg if mine is None else ops.row_or(mine, seg)

    def union(self, *others: "Row") -> "Row":
        out = dict(self.segments)
        for other in others:
            for shard, seg in other.segments.items():
                mine = out.get(shard)
                out[shard] = seg if mine is None else ops.row_or(mine, seg)
        return Row(out)

    def intersect(self, *others: "Row") -> "Row":
        shards = set(self.segments)
        for other in others:
            shards &= set(other.segments)
        out = {}
        for shard in shards:
            seg = self.segments[shard]
            for other in others:
                seg = ops.row_and(seg, other.segments[shard])
            out[shard] = seg
        return Row(out)

    def difference(self, *others: "Row") -> "Row":
        out = dict(self.segments)
        for other in others:
            for shard, seg in other.segments.items():
                mine = out.get(shard)
                if mine is not None:
                    out[shard] = ops.row_andnot(mine, seg)
        return Row(out)

    def xor(self, *others: "Row") -> "Row":
        out = dict(self.segments)
        for other in others:
            for shard, seg in other.segments.items():
                mine = out.get(shard)
                out[shard] = seg if mine is None else ops.row_xor(mine, seg)
        return Row(out)

    def intersection_count(self, other: "Row") -> int:
        total = 0
        for shard in set(self.segments) & set(other.segments):
            total += int(ops.popcount_and(self.segments[shard], other.segments[shard]))
        return total

    # -- materialization ---------------------------------------------------

    def count(self) -> int:
        return sum(int(ops.popcount(seg)) for seg in self.segments.values())

    def any(self) -> bool:
        return any(int(ops.popcount(seg)) > 0 for seg in self.segments.values())

    def columns(self) -> np.ndarray:
        """Absolute column IDs, sorted (row.go Columns :246)."""
        out = []
        for shard in sorted(self.segments):
            pos = ops.words_to_positions(bitops.to_numpy(self.segments[shard]))
            out.append(pos + np.uint64(shard * ops.SHARD_WIDTH))
        if not out:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(out)

    def includes_column(self, col: int) -> bool:
        shard, pos = divmod(col, ops.SHARD_WIDTH)
        seg = self.segments.get(shard)
        if seg is None:
            return False
        word = int(seg[pos >> 5]) & 0xFFFFFFFF
        return bool((word >> (pos & 31)) & 1)

    def __repr__(self) -> str:
        return f"Row(shards={self.shards()})"
