"""Hybrid sparse/dense host storage for shard rows.

The host half of the residency story (the device half is the engine's
field stacks).  Upstream Pilosa pages sparse rows cheaply because roaring
stores them as array/run containers in an mmap'd file (roaring.go:926-946,
fragment.go:190-247).  Our device format is dense — but the
host truth doesn't have to be: rows at or below ``SPARSE_MAX`` bits live as
sorted ``uint32`` in-row position arrays (4 B/bit), denser rows as dense
``uint64[16384]`` word vectors (128 KiB).  A 10-bit row costs ~40 bytes
instead of 128 KiB; densification happens on promotion past the threshold
and on device upload only.

All positions are in-row (0 .. SHARD_WIDTH).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np

from ..ops import bitops

WORDS64 = bitops.WORDS64

# The native sparse-merge library (native/sparse_merge.cpp), resolved at
# first use: None = not yet, False = unavailable.  The numpy
# implementations below are the
# fallback and the differential oracle; both give bit-identical stores.
_MERGE = None
_ERR_RANGE = -(1 << 63)  # sm_apply_dense's out-of-range answer


def _merge_lib():
    global _MERGE
    if _MERGE is None:
        from .. import native

        _MERGE = native.load_merge() or False
    return _MERGE or None

# Rows with more set bits than this are stored dense.  At the threshold a
# sparse row costs 16 KiB vs 128 KiB dense (8x); above it dense wins on
# mutation cost and converges to the device layout.
SPARSE_MAX = 4096
# Dense rows whose count drops to this demote back to sparse on compact().
DEMOTE_AT = SPARSE_MAX // 2

_ONE = np.uint64(1)
_M63 = np.uint64(63)


def scatter_or(words: np.ndarray, positions: np.ndarray) -> None:
    """Set bits at ``positions`` in a dense uint64 word vector, in place."""
    idx = (positions >> np.uint64(6)).astype(np.int64)
    np.bitwise_or.at(words, idx, _ONE << (positions.astype(np.uint64) & _M63))


def scatter_andnot(words: np.ndarray, positions: np.ndarray) -> None:
    """Clear bits at ``positions`` in a dense uint64 word vector, in place."""
    idx = (positions >> np.uint64(6)).astype(np.int64)
    mask = np.zeros(len(words), dtype=np.uint64)
    np.bitwise_or.at(mask, idx, _ONE << (positions.astype(np.uint64) & _M63))
    np.bitwise_and(words, ~mask, out=words)


def densify(positions: np.ndarray) -> np.ndarray:
    out = np.zeros(WORDS64, dtype=np.uint64)
    scatter_or(out, positions)
    return out


class RowStore:
    """Per-fragment hybrid row storage with maintained cardinalities."""

    __slots__ = ("sparse", "dense", "counts")

    def __init__(self):
        self.sparse: Dict[int, np.ndarray] = {}
        self.dense: Dict[int, np.ndarray] = {}
        self.counts: Dict[int, int] = {}

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self.sparse) + len(self.dense)

    def __contains__(self, row_id: int) -> bool:
        return row_id in self.sparse or row_id in self.dense

    def row_ids(self) -> List[int]:
        return sorted(
            r for r in (self.sparse.keys() | self.dense.keys())
            if self.counts.get(r, 0) > 0
        )

    def count(self, row_id: int) -> int:
        return self.counts.get(row_id, 0)

    def nbytes(self) -> int:
        """Host bytes held by row payloads (memory-blowup test hook)."""
        return sum(a.nbytes for a in self.sparse.values()) + sum(
            a.nbytes for a in self.dense.values()
        )

    # -- single-bit ops ----------------------------------------------------

    def test(self, row_id: int, pos: int) -> bool:
        sp = self.sparse.get(row_id)
        if sp is not None:
            i = int(np.searchsorted(sp, np.uint32(pos)))
            return i < len(sp) and int(sp[i]) == pos
        d = self.dense.get(row_id)
        if d is None:
            return False
        return bool((int(d[pos >> 6]) >> (pos & 63)) & 1)

    def set(self, row_id: int, pos: int) -> bool:
        sp = self.sparse.get(row_id)
        if sp is not None:
            p32 = np.uint32(pos)
            i = int(np.searchsorted(sp, p32))
            if i < len(sp) and int(sp[i]) == pos:
                return False
            if len(sp) + 1 > SPARSE_MAX:
                d = densify(sp)
                d[pos >> 6] |= _ONE << np.uint64(pos & 63)
                # Publish dense before dropping sparse: lock-free readers
                # must never find the row in neither dict.
                self.dense[row_id] = d
                del self.sparse[row_id]
            else:
                self.sparse[row_id] = np.insert(sp, i, p32)
            self.counts[row_id] = self.counts.get(row_id, 0) + 1
            return True
        d = self.dense.get(row_id)
        if d is None:
            self.sparse[row_id] = np.array([pos], dtype=np.uint32)
            self.counts[row_id] = 1
            return True
        w, b = pos >> 6, pos & 63
        if (int(d[w]) >> b) & 1:
            return False
        d[w] |= _ONE << np.uint64(b)
        self.counts[row_id] = self.counts.get(row_id, 0) + 1
        return True

    def clear(self, row_id: int, pos: int) -> bool:
        sp = self.sparse.get(row_id)
        if sp is not None:
            i = int(np.searchsorted(sp, np.uint32(pos)))
            if i >= len(sp) or int(sp[i]) != pos:
                return False
            self.sparse[row_id] = np.delete(sp, i)
            self.counts[row_id] = self.counts.get(row_id, 1) - 1
            return True
        d = self.dense.get(row_id)
        if d is None:
            return False
        w, b = pos >> 6, pos & 63
        if not (int(d[w]) >> b) & 1:
            return False
        d[w] &= ~(_ONE << np.uint64(b))
        self.counts[row_id] = self.counts.get(row_id, 1) - 1
        return True

    # -- bulk ops ----------------------------------------------------------

    def union(self, row_id: int, positions: np.ndarray) -> int:
        """OR sorted-unique in-row positions into a row; returns new count."""
        positions = np.asarray(positions, dtype=np.uint32)
        sp = self.sparse.get(row_id)
        if sp is not None or row_id not in self.dense:
            merged = (
                positions if sp is None else np.union1d(sp, positions)
            )
            if len(merged) <= SPARSE_MAX:
                self.sparse[row_id] = merged
                self.counts[row_id] = len(merged)
                return len(merged)
            self.dense[row_id] = densify(merged)
            self.sparse.pop(row_id, None)
            self.counts[row_id] = len(merged)
            return len(merged)
        d = self.dense[row_id]
        # Count delta from the TOUCHED words only: popcounting all 16K
        # words for a point write costs more than the write itself
        # (maintained counts stay exact — before/after on the same
        # word subset).
        idx = np.unique((positions >> np.uint32(6)).astype(np.int64))
        before = bitops.popcount_np(d[idx])
        scatter_or(d, positions)
        n = self.counts[row_id] + bitops.popcount_np(d[idx]) - before
        self.counts[row_id] = n
        return n

    def difference(self, row_id: int, positions: np.ndarray) -> int:
        """ANDNOT sorted-unique in-row positions out of a row; new count."""
        positions = np.asarray(positions, dtype=np.uint32)
        sp = self.sparse.get(row_id)
        if sp is not None:
            kept = np.setdiff1d(sp, positions, assume_unique=True)
            self.sparse[row_id] = kept
            self.counts[row_id] = len(kept)
            return len(kept)
        d = self.dense.get(row_id)
        if d is None:
            return 0
        idx = np.unique((positions >> np.uint32(6)).astype(np.int64))
        before = bitops.popcount_np(d[idx])
        scatter_andnot(d, positions)
        n = self.counts[row_id] + bitops.popcount_np(d[idx]) - before
        self.counts[row_id] = n
        return n

    def bulk_merge(
        self,
        rows: np.ndarray,
        bounds: np.ndarray,
        positions: np.ndarray,
        clear: bool = False,
        packed: np.ndarray = None,
    ):
        """Multi-row union/difference — the sort-once bulk-ingest
        primitive.  ``rows[i]`` receives ``positions[bounds[i]:bounds[i+1]]``
        (sorted unique uint32 in-row positions) OR'd in, or with
        ``clear`` ANDNOT'd out.

        Dense rows take a word-delta path: ``np.bitwise_or.reduceat``
        over the slice's word-grouped bit masks yields one uint64 delta
        per touched word, and the count update popcounts ONLY those
        words (before/after on the same subset — maintained counts stay
        exact).  Sparse rows — existing AND fresh — merge in ONE global
        O(n+m) pass over packed (row, pos) keys (_merge_sparse): both
        sides arrive sorted, so searchsorted+insert/delete replaces the
        per-row union1d sorts that dominated sustained ingest.

        Returns ``(new_counts, changed, touched)``: per-row int64 new
        cardinality, int64 bits actually flipped, and a bool mask that
        is False only for a no-op (empty slice, or a difference against
        an absent row) the caller should not dirty-track."""
        n_rows = len(rows)
        new_counts = np.empty(n_rows, dtype=np.int64)
        changed = np.zeros(n_rows, dtype=np.int64)
        touched = np.ones(n_rows, dtype=bool)
        counts = self.counts
        sparse = self.sparse
        dense = self.dense
        if not clear and not dense:
            # No dense rows in the store at all (pure sparse ingest):
            # every row goes through the one global merge — no per-row
            # classification pass.
            self._merge_sparse(
                rows,
                bounds,
                positions,
                None,
                clear,
                new_counts,
                changed,
                b_packed=packed,
            )
            return new_counts, changed, touched
        row_list = rows.tolist()
        bounds_list = bounds.tolist()
        sp_sel: List[int] = []
        for i in range(n_rows):
            r = row_list[i]
            pos = positions[bounds_list[i] : bounds_list[i + 1]]
            if pos.size == 0:
                new_counts[i] = counts.get(r, 0)
                touched[i] = False
                continue
            d = dense.get(r)
            if d is not None:
                before = counts.get(r, 0)
                n = before + self._apply_dense(d, pos, clear)
                counts[r] = n
                new_counts[i] = n
                changed[i] = abs(n - before)
            elif clear:
                if r in sparse:
                    sp_sel.append(i)
                else:
                    new_counts[i] = counts.get(r, 0)
                    touched[i] = False
            elif r in sparse:
                sp_sel.append(i)
            else:
                # Fresh row: keep the slice VIEW — the positions array
                # is materialized per batch by the caller and sparse
                # arrays are copy-on-write everywhere, so rows
                # collectively own the batch's array without copies.
                n = pos.size
                if n > SPARSE_MAX:
                    dense[r] = densify(pos)
                else:
                    sparse[r] = pos
                counts[r] = n
                new_counts[i] = n
                changed[i] = n
        if sp_sel:
            self._merge_sparse(
                rows, bounds, positions, sp_sel, clear, new_counts, changed
            )
        return new_counts, changed, touched

    def _merge_sparse(
        self,
        rows,
        bounds,
        positions,
        sp_sel,
        clear,
        new_counts,
        changed,
        b_packed=None,
    ):
        """Global sparse merge over packed ``row << EXP | pos`` keys.
        Existing rows' arrays concatenate to one sorted vector (rows
        ascend, positions ascend within each), the batch side is sorted
        by construction — ``b_packed`` IS that side when the caller
        already holds the full packed batch — and one searchsorted +
        merge (union) or delete (difference) produces the merged keys,
        re-split into per-row VIEWS of the merged array (sparse arrays
        are copy-on-write everywhere, so shared backing is safe).
        ``sp_sel`` is the selected row indices, or None for ALL rows."""
        exp = bitops.SHARD_WIDTH_EXP
        counts = self.counts
        sparse = self.sparse
        sel_arr = rows if sp_sel is None else rows[sp_sel]
        sel_list = sel_arr.tolist()
        if sp_sel is None and b_packed is not None:
            b = (
                b_packed.view(np.int64)
                if b_packed.dtype == np.uint64
                else b_packed
            )
        else:
            sel = slice(None) if sp_sel is None else sp_sel
            sel_rows = rows[sel].astype(np.int64)
            b_lens = np.diff(bounds)[sel]
            sel_idx = range(len(rows)) if sp_sel is None else sp_sel
            b = (
                np.repeat(sel_rows << exp, b_lens)
                | np.concatenate(
                    [positions[bounds[i] : bounds[i + 1]] for i in sel_idx]
                ).astype(np.int64)
            )
        get = sparse.get
        a_rows, a_chunks, a_lens = [], [], []
        befores_l = []
        for r in sel_list:
            sp = get(r)
            if sp is not None and sp.size:
                a_rows.append(r)
                a_chunks.append(sp)
                # len(sparse[r]) IS the maintained count for sparse
                # rows, so this single pass also yields the
                # before-counts.
                a_lens.append(sp.size)
                befores_l.append(sp.size)
            else:
                befores_l.append(0)
        lib = _merge_lib()
        if lib is not None:
            m_rows, m_pos, m_bounds_arr = self._merge_native(
                lib, a_rows, a_chunks, a_lens, b, clear, exp, len(sel_list))
        else:
            m_rows, m_pos, m_bounds_arr = self._merge_np(
                a_rows, a_chunks, a_lens, b, clear, exp
            )
        befores = np.asarray(befores_l, dtype=np.int64)
        lens = np.diff(m_bounds_arr)
        if not clear and len(m_rows) == len(sel_list) and (
            not lens.size or int(lens.max()) <= SPARSE_MAX
        ):
            # Union keeps every selected row (merged rows == sel rows in
            # order) and nothing promoted: assign views + counts through
            # C-speed dict.update, no per-row branches.
            m_b = m_bounds_arr.tolist()
            sparse.update(
                zip(
                    sel_list,
                    (m_pos[m_b[j] : m_b[j + 1]] for j in range(len(sel_list))),
                )
            )
            counts.update(zip(sel_list, lens.tolist()))
            if sp_sel is None:
                new_counts[:] = lens
                changed[:] = lens - befores
            else:
                new_counts[sp_sel] = lens
                changed[sp_sel] = lens - befores
            return
        m_bounds = m_bounds_arr.tolist()
        n_m = len(m_rows)
        j = 0
        sel_idx_iter = range(len(rows)) if sp_sel is None else sp_sel
        for k, i in enumerate(sel_idx_iter):
            r = sel_list[k]
            before = befores[k]
            if j < n_m and m_rows[j] == r:
                seg = m_pos[m_bounds[j] : m_bounds[j + 1]]
                j += 1
            else:
                seg = m_pos[:0]
            n = seg.size
            if n > SPARSE_MAX:
                # Publish dense before dropping sparse (lock-free
                # reader rule, same as set()).
                self.dense[r] = densify(seg)
                sparse.pop(r, None)
            else:
                sparse[r] = seg
            counts[r] = n
            new_counts[i] = n
            changed[i] = abs(n - before)

    @staticmethod
    def _merge_np(a_rows, a_chunks, a_lens, b, clear, exp):
        """Numpy merge backend: packs
        the existing side into sorted int64 keys, merges (union) or
        deletes (difference) against the sorted batch, and re-splits.
        Returns ``(row_ids list, positions uint32, bounds int64)``."""
        if a_rows:
            a = np.repeat(
                np.asarray(a_rows, dtype=np.int64) << exp, a_lens
            ) | np.concatenate(a_chunks).astype(np.int64)
        else:
            a = np.empty(0, dtype=np.int64)
        idx = np.searchsorted(a, b)
        hit = np.zeros(len(b), dtype=bool)
        if a.size:
            inb = idx < a.size
            hit[inb] = a[idx[inb]] == b[inb]
        if clear:
            keep = np.ones(a.size, dtype=bool)
            keep[idx[hit]] = False
            merged = a[keep]
        else:
            # Manual sorted merge (np.insert pays ~5x this in dtype and
            # index gymnastics): place the new keys at their shifted
            # offsets, the old keys everywhere else.
            add = b[~hit]
            merged = np.empty(a.size + add.size, dtype=a.dtype)
            at = idx[~hit] + np.arange(add.size)
            mask = np.ones(merged.size, dtype=bool)
            mask[at] = False
            merged[at] = add
            merged[mask] = a
        m_pos = (merged & (bitops.SHARD_WIDTH - 1)).astype(np.uint32)
        m_rowkeys = merged >> exp
        if merged.size:
            m_starts = np.flatnonzero(
                np.r_[True, m_rowkeys[1:] != m_rowkeys[:-1]]
            )
        else:
            m_starts = np.empty(0, dtype=np.int64)
        m_bounds_arr = np.append(m_starts, merged.size)
        return m_rowkeys[m_starts].tolist(), m_pos, m_bounds_arr

    @staticmethod
    def _merge_native(lib, a_rows, a_chunks, a_lens, b, clear, exp, n_sel):
        """``_merge_np``'s contract in one linear C pass over both sides
        (native/sparse_merge.cpp): the existing rows' arrays reach it
        through a pointer table, with no packed keys built.  ``a_chunks``
        must stay alive across the call (the caller's locals hold them)."""
        a_rows_arr = np.asarray(a_rows, dtype=np.int64)
        a_lens_arr = np.asarray(a_lens, dtype=np.int64)
        # Per-row sparse arrays are contiguous (np.insert/delete/unique, or
        # slices of a merged parent).
        ptrs = np.fromiter((c.ctypes.data for c in a_chunks), dtype=np.uintp,
                           count=len(a_rows))
        nb = int(b.size)
        n_a_rows = a_rows_arr.size
        cap_pos = max(int(sum(a_lens)) + (0 if clear else nb), 1)
        cap_rows = n_a_rows + n_sel + 1
        pos_out = np.empty(cap_pos, dtype=np.uint32)
        rows_out = np.empty(cap_rows, dtype=np.int64)
        bounds_out = np.empty(cap_rows + 1, dtype=np.int64)
        n_merged = ctypes.c_int64(0)
        fn = lib.sm_diff_split if clear else lib.sm_union_split
        nr = fn(a_rows_arr.ctypes.data, ptrs.ctypes.data, a_lens_arr.ctypes.data, n_a_rows,
                b.ctypes.data, nb, int(exp), bitops.SHARD_WIDTH - 1, pos_out.ctypes.data,
                rows_out.ctypes.data, bounds_out.ctypes.data, ctypes.byref(n_merged))
        if nr < 0:  # bad arguments never happen in-tree; do not limp on
            raise RuntimeError(f"sparse_merge kernel rejected its arguments: {nr}")
        m = n_merged.value
        m_pos = pos_out[:m]
        if m * 2 < cap_pos:
            # Long-lived row views must not pin a parent twice their size.
            m_pos = m_pos.copy()
        return rows_out[:nr].tolist(), m_pos, bounds_out[: nr + 1]

    @staticmethod
    def _apply_dense(d: np.ndarray, pos: np.ndarray, clear: bool) -> int:
        """Apply sorted unique in-row positions to a dense word vector in
        place; returns the signed cardinality delta: one native pass where
        the library loads (popcounting only the touched words), else numpy
        reduceat with the same result."""
        lib = _merge_lib()
        if lib is not None:
            delta = lib.sm_apply_dense(d.ctypes.data, WORDS64, pos.ctypes.data, pos.size,
                                       1 if clear else 0)
            if delta != _ERR_RANGE:
                return int(delta)
        widx = (pos >> np.uint32(6)).astype(np.int64)
        starts = np.flatnonzero(np.r_[True, widx[1:] != widx[:-1]])
        uw = widx[starts]
        deltas = np.bitwise_or.reduceat(
            _ONE << (pos.astype(np.uint64) & _M63), starts
        )
        pc_before = bitops.popcount_np(d[uw])
        if clear:
            d[uw] &= ~deltas
        else:
            d[uw] |= deltas
        return int(bitops.popcount_np(d[uw]) - pc_before)

    def set_dense(self, row_id: int, words: np.ndarray) -> int:
        """Overwrite a row with a dense uint64 word vector (SetRow path)."""
        self.sparse.pop(row_id, None)
        self.dense[row_id] = words
        n = bitops.popcount_np(words)
        self.counts[row_id] = n
        return n

    def drop(self, row_id: int) -> bool:
        """Remove a row; True only if it actually held bits."""
        had = self.counts.get(row_id, 0) > 0
        self.sparse.pop(row_id, None)
        self.dense.pop(row_id, None)
        self.counts[row_id] = 0
        return had

    # -- materialization ---------------------------------------------------

    def positions(self, row_id: int) -> np.ndarray:
        """Sorted uint32 in-row positions (empty array if absent)."""
        sp = self.sparse.get(row_id)
        if sp is not None:
            return sp
        d = self.dense.get(row_id)
        if d is None:
            return np.empty(0, dtype=np.uint32)
        return bitops.words_to_positions(d.view("<u4")).astype(np.uint32)

    def words_u64(self, row_id: int) -> np.ndarray:
        """Dense uint64[WORDS64] materialization (zeros if absent).  Sparse
        rows are densified into a fresh buffer — mutate only dense rows."""
        d = self.dense.get(row_id)
        if d is not None:
            return d
        sp = self.sparse.get(row_id)
        if sp is None:
            return np.zeros(WORDS64, dtype=np.uint64)
        return densify(sp)

    def words_u32(self, row_id: int) -> np.ndarray:
        return self.words_u64(row_id).view("<u4")

    def words64_at(self, row_id: int, widxs: np.ndarray) -> np.ndarray:
        """The row's uint64 words at the given SORTED word indexes —
        O(selected) for both storage shapes (no densify): the write
        path's delta capture (core/delta.py) and the repair layer's
        word-restricted re-evaluation read exactly the touched words,
        never the 128 KiB row."""
        widxs = np.asarray(widxs, dtype=np.int64)
        d = self.dense.get(row_id)
        if d is not None:
            return d[widxs]
        out = np.zeros(len(widxs), dtype=np.uint64)
        sp = self.sparse.get(row_id)
        if sp is None or sp.size == 0:
            return out
        w = (sp >> np.uint32(6)).astype(np.int64)
        idx = np.searchsorted(widxs, w)
        np.minimum(idx, len(widxs) - 1, out=idx)
        hit = widxs[idx] == w
        np.bitwise_or.at(
            out, idx[hit], _ONE << (sp[hit].astype(np.uint64) & _M63)
        )
        return out

    def occupancy64(self, row_id: int) -> int:
        """Block-occupancy bitmap of a row (bitops.occupancy64): bit b
        set iff occupancy block b holds a set bit.  Sparse rows compute
        it from their position array (no densify)."""
        sp = self.sparse.get(row_id)
        if sp is not None:
            return bitops.occupancy64_from_positions(sp)
        d = self.dense.get(row_id)
        if d is None:
            return 0
        return bitops.occupancy64(d)

    def compact(self) -> None:
        """Demote dense rows that shrank below the hysteresis threshold."""
        demote = [
            r for r, d in self.dense.items()
            if self.counts.get(r, 0) <= DEMOTE_AT
        ]
        for r in demote:
            pos = bitops.words_to_positions(self.dense[r].view("<u4")).astype(
                np.uint32
            )
            self.sparse[r] = pos
            del self.dense[r]
