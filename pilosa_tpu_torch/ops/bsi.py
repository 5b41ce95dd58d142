"""BSI (bit-sliced index) row ops on int32 word tensors, in plain PyTorch.

The port of ``pilosa_tpu/ops/bsi.py``.  An int field stores bit_depth + 1
rows: rows 0..bit_depth-1 are the value's bit planes (of the value minus
the field's min), row bit_depth is the not-null plane (fragment.go:716-985).
``planes`` is ``int32[bit_depth + 1, ..., W]``; a range condition walks the
planes high bit first with keep/exclude sets and returns one row of words.

The predicate bits (``to_bits``) are host ints here, so each step's branch
is taken on the host: the same walk as the reference's branch-free selects
over traced bits, and as the card's range leaf (``csrc/tree_eval.cuh``),
whose predicate bits are launch parameters.  These functions are the host
bitmap lane's per-fragment ops and the plain versions the card's kernels
(the range leaf, K6 ``sum_tree`` and K7 ``minmax_tree``) are held against.
Counts come back as int64 (the reference's are int32).
"""

from __future__ import annotations

import numpy as np
import torch

from .bitops import popcount_words


def to_bits(value: int, depth: int) -> np.ndarray:
    """Predicate value -> uint32[max(depth, 1)] bit vector, bit i first."""
    return np.array([(value >> i) & 1 for i in range(max(depth, 1))], dtype=np.uint32)


def _bit(pred_bits, i: int) -> int:
    return int(pred_bits[i])


def range_eq(planes: torch.Tensor, pred_bits) -> torch.Tensor:
    """Columns whose value == predicate."""
    depth = planes.shape[0] - 1
    b = planes[depth]
    for i in range(depth - 1, -1, -1):
        row = planes[i]
        b = b & row if _bit(pred_bits, i) else b & ~row
    return b


def range_neq(planes: torch.Tensor, pred_bits) -> torch.Tensor:
    depth = planes.shape[0] - 1
    return planes[depth] & ~range_eq(planes, pred_bits)


def range_lt(planes: torch.Tensor, pred_bits, allow_equality: bool) -> torch.Tensor:
    """Columns whose value < predicate (<= when allow_equality):
    fragment.go rangeLT's leading-zeros + keep-set walk."""
    depth = planes.shape[0] - 1
    b = planes[depth]
    keep = torch.zeros_like(b)
    lz = True  # still in the predicate's leading zeros
    for i in range(depth - 1, -1, -1):
        row = planes[i]
        bit = _bit(pred_bits, i)
        if i == 0 and not allow_equality:
            return keep if bit == 0 else b & ~(row & ~keep)
        if bit == 0:
            b = b & ~row if lz else b & ~(row & ~keep)
        elif i > 0:
            keep = keep | (b & ~row)
        lz = lz and bit == 0
    return b


def range_gt(planes: torch.Tensor, pred_bits, allow_equality: bool) -> torch.Tensor:
    """Columns whose value > predicate (>= when allow_equality)."""
    depth = planes.shape[0] - 1
    b = planes[depth]
    keep = torch.zeros_like(b)
    for i in range(depth - 1, -1, -1):
        row = planes[i]
        bit = _bit(pred_bits, i)
        if i == 0 and not allow_equality:
            return keep if bit == 1 else b & ~((b & ~row) & ~keep)
        if bit == 1:
            b = b & ~((b & ~row) & ~keep)
        elif i > 0:
            keep = keep | (b & row)
    return b


def range_between(planes: torch.Tensor, pred_bits_min, pred_bits_max) -> torch.Tensor:
    """Columns with predicate_min <= value <= predicate_max
    (fragment.go rangeBetween's fused GTE/LTE walk)."""
    depth = planes.shape[0] - 1
    b = planes[depth]
    keep1 = torch.zeros_like(b)  # the >= side
    keep2 = torch.zeros_like(b)  # the <= side
    for i in range(depth - 1, -1, -1):
        row = planes[i]
        if _bit(pred_bits_min, i) == 1:
            b = b & ~((b & ~row) & ~keep1)
        elif i > 0:
            keep1 = keep1 | (b & row)
        if _bit(pred_bits_max, i) == 0:
            b = b & ~(row & ~keep2)
        elif i > 0:
            keep2 = keep2 | (b & ~row)
    return b


def not_null(planes: torch.Tensor) -> torch.Tensor:
    return planes[planes.shape[0] - 1]


# Range-leaf kinds, in the order of csrc/tree_eval.cuh's RANGE_* values.
RANGE_KINDS = ("eq", "neq", "lt", "lte", "gt", "gte", "between")


def range_rows(kind: str, planes: torch.Tensor, lo: int, hi: int = 0) -> torch.Tensor:
    """One range condition of the engine's lowering (``kind`` in
    RANGE_KINDS, ``lo`` the rebased predicate, ``hi`` BETWEEN's upper
    bound) over ``planes``."""
    depth = planes.shape[0] - 1
    bits = to_bits(lo, depth)
    if kind == "eq":
        return range_eq(planes, bits)
    if kind == "neq":
        return range_neq(planes, bits)
    if kind in ("lt", "lte"):
        return range_lt(planes, bits, kind == "lte")
    if kind in ("gt", "gte"):
        return range_gt(planes, bits, kind == "gte")
    if kind == "between":
        return range_between(planes, bits, to_bits(hi, depth))
    raise ValueError(f"bad range kind: {kind!r}")


def sum_counts(planes: torch.Tensor, filter_row: torch.Tensor):
    """Per-plane intersection counts with (not-null & filter): (counts
    int64[depth], considered int64).  The weighted sum
    sum(counts[i] << i) is assembled on the host in Python ints
    (fragment.go sum :716-742)."""
    depth = planes.shape[0] - 1
    consider = planes[depth] & filter_row
    n = popcount_words(consider).sum()
    if depth == 0:  # max == min: no value planes, the total is n * min
        return torch.zeros(0, dtype=torch.int64, device=planes.device), n
    counts = torch.stack([popcount_words(planes[i] & consider).sum() for i in range(depth)])
    return counts, n


def minmax_valcount_nd(planes: torch.Tensor, filter_row: torch.Tensor, is_min: bool):
    """The word-local min/max walk, reduced over the last axis: (value
    int64, count int64) per leading batch cell (the shard axis of a
    [depth+1, S, W] stack).

    Inside each 32-bit word the walk keeps the candidate columns where
    ``sel = keep & ~plane`` (min) or ``keep & plane`` (max) is not zero and
    sets the result bit where it is not (min) or is (max), which gives the
    word's extreme value and the count of its columns holding it; the
    cells' extreme over the words, with the counts of the words that hold
    it summed, is the answer.  The reference returns the value as (hi, lo)
    halves, value = (hi << 31) | lo; here it is one int64 (bit_depth <=
    63).  Count 0 means no column considered, and the value is then 0."""
    depth = planes.shape[0] - 1
    keep0 = planes[depth] & filter_row
    keep = keep0
    val = torch.zeros(keep.shape, dtype=torch.int64, device=planes.device)
    for i in range(depth - 1, -1, -1):
        sel = keep & (~planes[i] if is_min else planes[i])
        has = sel != 0
        keep = torch.where(has, sel, keep)
        bit_on = ~has if is_min else has
        val = val | (bit_on.to(torch.int64) << i)
    valid = keep0 != 0
    cnt_w = torch.where(valid, popcount_words(keep), torch.zeros_like(val))
    if is_min:
        best = torch.where(valid, val, torch.full_like(val, torch.iinfo(torch.int64).max)).amin(-1)
    else:
        best = torch.where(valid, val, torch.full_like(val, -1)).amax(-1)
    count = torch.where(valid & (val == best[..., None]), cnt_w, torch.zeros_like(cnt_w)).sum(-1)
    return torch.where(count > 0, best, torch.zeros_like(best)), count


def min_valcount(planes: torch.Tensor, filter_row: torch.Tensor):
    """Single-shard min -> (value, count) 0-d tensors."""
    return minmax_valcount_nd(planes, filter_row, True)


def max_valcount(planes: torch.Tensor, filter_row: torch.Tensor):
    """Single-shard max -> (value, count) 0-d tensors."""
    return minmax_valcount_nd(planes, filter_row, False)
