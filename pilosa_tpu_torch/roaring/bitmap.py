"""Host-side roaring bitmap: the storage/interchange representation.

Mirrors the behavior of the reference Bitmap (roaring/roaring.go:115) — add,
remove, set algebra, count-range, offset-range, serialization with op-log —
but keeps values as one sorted unique ``np.uint64`` vector instead of a
container tree.  The compute representation is dense words on the device
(pilosa_tpu_torch.ops); this class is the codec-facing form used for files,
imports and interchange.
"""

from __future__ import annotations

import io
from typing import Iterable, Optional

import numpy as np

from . import codec


class Bitmap:
    """Sorted-unique-u64-vector bitmap with pilosa-roaring serialization."""

    __slots__ = ("values", "op_writer", "op_n")

    def __init__(self, values: Optional[Iterable[int]] = None):
        if values is None:
            self.values = np.empty(0, dtype=np.uint64)
        else:
            arr = np.asarray(list(values) if not isinstance(values, np.ndarray) else values, dtype=np.uint64)
            self.values = np.unique(arr)
        self.op_writer: Optional[io.RawIOBase] = None
        self.op_n = 0

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_sorted(cls, values: np.ndarray) -> "Bitmap":
        b = cls()
        b.values = np.asarray(values, dtype=np.uint64)
        return b

    @classmethod
    def from_bytes(cls, data: bytes) -> "Bitmap":
        dec = codec.deserialize(data)
        b = cls.from_sorted(dec.values)
        b.op_n = dec.op_n
        return b

    def clone(self) -> "Bitmap":
        return Bitmap.from_sorted(self.values.copy())

    # -- mutation ----------------------------------------------------------

    def _write_op(self, typ: int, value: int):
        # op_n only grows when an op actually lands in the log (the
        # fragment snapshot trigger counts logged ops, not mutations).
        if self.op_writer is not None:
            self.op_writer.write(codec.encode_op(typ, value))
            self.op_n += 1

    def add(self, *values: int) -> bool:
        """Add values, logging each to the op-writer. Returns True if changed."""
        changed = False
        for v in values:
            self._write_op(codec.OP_TYPE_ADD, v)
            if self.direct_add(v):
                changed = True
        return changed

    def direct_add(self, v: int) -> bool:
        v = np.uint64(v)
        i = int(np.searchsorted(self.values, v))
        if i < self.values.size and self.values[i] == v:
            return False
        self.values = np.insert(self.values, i, v)
        return True

    def remove(self, *values: int) -> bool:
        changed = False
        for v in values:
            self._write_op(codec.OP_TYPE_REMOVE, v)
            v = np.uint64(v)
            i = int(np.searchsorted(self.values, v))
            if i < self.values.size and self.values[i] == v:
                self.values = np.delete(self.values, i)
                changed = True
        return changed

    def add_many(self, values: np.ndarray) -> int:
        """Bulk add without op-logging (import path). Returns #new bits."""
        values = np.asarray(values, dtype=np.uint64)
        before = self.values.size
        self.values = np.union1d(self.values, values)
        return self.values.size - before

    def remove_many(self, values: np.ndarray) -> int:
        values = np.asarray(values, dtype=np.uint64)
        before = self.values.size
        self.values = np.setdiff1d(self.values, values, assume_unique=False)
        return before - self.values.size

    # -- queries -----------------------------------------------------------

    def contains(self, v: int) -> bool:
        v = np.uint64(v)
        i = int(np.searchsorted(self.values, v))
        return i < self.values.size and self.values[i] == v

    def count(self) -> int:
        return int(self.values.size)

    def max(self) -> int:
        return int(self.values[-1]) if self.values.size else 0

    def count_range(self, start: int, end: int) -> int:
        """Number of set bits in [start, end)."""
        lo = int(np.searchsorted(self.values, np.uint64(start), side="left"))
        hi = int(np.searchsorted(self.values, np.uint64(end), side="left"))
        return hi - lo

    def slice_range(self, start: int, end: int) -> np.ndarray:
        lo = int(np.searchsorted(self.values, np.uint64(start), side="left"))
        hi = int(np.searchsorted(self.values, np.uint64(end), side="left"))
        return self.values[lo:hi]

    def offset_range(self, offset: int, start: int, end: int) -> "Bitmap":
        """Mirror of roaring.Bitmap.OffsetRange (roaring.go:320): slice
        [start,end) and rebase to offset.  All three must be container-width
        (2^16) aligned in the reference; we only need bit arithmetic."""
        vals = self.slice_range(start, end)
        return Bitmap.from_sorted(
            (vals - np.uint64(start)) + np.uint64(offset)
        )

    # -- set algebra -------------------------------------------------------

    def union(self, other: "Bitmap") -> "Bitmap":
        return Bitmap.from_sorted(np.union1d(self.values, other.values))

    def intersect(self, other: "Bitmap") -> "Bitmap":
        return Bitmap.from_sorted(
            np.intersect1d(self.values, other.values, assume_unique=True)
        )

    def difference(self, other: "Bitmap") -> "Bitmap":
        return Bitmap.from_sorted(
            np.setdiff1d(self.values, other.values, assume_unique=True)
        )

    def xor(self, other: "Bitmap") -> "Bitmap":
        return Bitmap.from_sorted(
            np.setxor1d(self.values, other.values, assume_unique=True)
        )

    def intersection_count(self, other: "Bitmap") -> int:
        return int(
            np.intersect1d(self.values, other.values, assume_unique=True).size
        )

    def flip(self, start: int, end: int) -> "Bitmap":
        """Flip bits in [start, end] (inclusive, as the reference's Flip).

        Processed in bounded chunks so memory stays proportional to the
        output, not to one giant arange over the range.  (The output is
        inherently O(range) positions for sparse inputs — callers flip
        within a shard, as the reference's executor does.)
        """
        chunk = 1 << 22
        pieces = [self.values[: int(np.searchsorted(self.values, np.uint64(start)))]]
        for lo in range(start, end + 1, chunk):
            hi = min(lo + chunk - 1, end)
            rng = np.arange(lo, hi + 1, dtype=np.uint64)
            inside = self.slice_range(lo, hi + 1)
            pieces.append(np.setdiff1d(rng, inside, assume_unique=True))
        pieces.append(
            self.values[int(np.searchsorted(self.values, np.uint64(end) + np.uint64(1))):]
        )
        return Bitmap.from_sorted(np.concatenate(pieces))

    def shift(self, n: int = 1) -> "Bitmap":
        """Shift all values up by n (reference supports shift by 1).
        Values that would overflow 2^64 are carried out and dropped."""
        keep = self.values <= np.uint64(2**64 - 1 - n)
        return Bitmap.from_sorted(self.values[keep] + np.uint64(n))

    # -- self-check --------------------------------------------------------

    def check(self) -> list:
        """Invariant validation (roaring.go Bitmap.Check :1015): sorted,
        unique, u64 dtype.  Returns a list of problems; empty = sound."""
        problems = []
        if self.values.dtype != np.uint64:
            problems.append(f"dtype {self.values.dtype} != uint64")
        if self.values.size > 1:
            if not np.all(self.values[:-1] <= self.values[1:]):
                problems.append("values not sorted")
            elif not np.all(self.values[:-1] < self.values[1:]):
                problems.append("duplicate values")
        return problems

    # -- serialization -----------------------------------------------------

    def to_bytes(self) -> bytes:
        return codec.serialize(self.values)

    def write_to(self, f) -> int:
        data = self.to_bytes()
        f.write(data)
        return len(data)

    def __len__(self) -> int:
        return self.count()

    def __iter__(self):
        return iter(self.values.tolist())

    def __eq__(self, other) -> bool:
        return isinstance(other, Bitmap) and np.array_equal(self.values, other.values)

    def __repr__(self) -> str:
        return f"Bitmap(n={self.values.size})"
