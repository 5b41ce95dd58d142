"""TopN row-count caches: ranked, LRU, none.

Behavioral mirror of the reference's cache.go: a per-fragment cache of
row-id -> column count used by TopN's approximate phase 1.  The ranked cache
keeps up to maxEntries sorted pairs, admits new entries above the current
threshold value, and trims at thresholdFactor (1.1) * maxEntries
(cache.go:30-31,145-290).  The LRU variant evicts by recency
(cache.go:57-131).

``RankCache`` is array-native: entries live as contiguous
id-sorted (ids, counts) int64 columns, bulk imports merge whole sorted
batches in vectorized passes, and recalculation is a C-speed lexsort (or,
after monotone bulk updates, an incremental merge of the touched batch
into the standing rankings — O(batch + top-k) instead of re-ranking every
entry).  A zero count always POPS the entry, on the scalar and both bulk
paths — a row cleared during a bulk import must evict its stale pair.

TopN's candidate walk (``Fragment.top``) and the engine's candidate union
read these caches.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

THRESHOLD_FACTOR = 1.1

DEFAULT_CACHE_SIZE = 50000

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"

VALID_CACHE_TYPES = {CACHE_TYPE_RANKED, CACHE_TYPE_LRU, CACHE_TYPE_NONE}

_EMPTY_I64 = np.empty(0, dtype=np.int64)

# Incremental-rank bookkeeping: beyond this many unflushed touched-id
# batches a full re-rank is cheaper than the merge.
_PENDING_MAX = 64


def pair_sort_key(pair: Tuple[int, int]):
    """Sort pairs by count desc, then id desc (matches the reference's
    bitmapPairs ordering used for ranked caches and TopN merges)."""
    return (-pair[1], -pair[0])


class RankCache:
    """Sorted row-count cache with admission threshold (array-native)."""

    cache_type = CACHE_TYPE_RANKED

    def __init__(self, max_entries: int = DEFAULT_CACHE_SIZE, debounce_seconds: float = 10.0):
        self.max_entries = max_entries
        self.threshold_buffer = int(THRESHOLD_FACTOR * max_entries)
        self.threshold_value = 0
        # Entry store: parallel int64 columns, ids ascending, counts > 0.
        self._ids = _EMPTY_I64
        self._counts = _EMPTY_I64
        # O(1) scalar-write overlay, folded into the columns before any
        # bulk/whole-store operation; a 0 value marks a pending pop.
        self._extra: Dict[int, int] = {}
        # Rankings: ONE tuple of parallel columns in (count desc,
        # id desc) order, swapped atomically — top() runs on executor
        # threads without the fragment lock, so it must never read two
        # attributes that a concurrent recalculate updates separately.
        self._rank: Tuple[np.ndarray, np.ndarray] = (_EMPTY_I64, _EMPTY_I64)
        self._top_cache = None  # (rank tuple identity, materialized list)
        # Touched-id batches since the last recalculate, for the
        # incremental merge path; None = merge invalid (non-monotone
        # update or overflow), full re-rank required.
        self._pending: list = []
        self._update_time = 0.0
        # The reference hard-codes a 10s invalidation debounce
        # (cache.go:236-240); configurable here so tests are deterministic.
        self.debounce_seconds = debounce_seconds

    # -- scalar ops --------------------------------------------------------

    def add(self, row_id: int, n: int):
        # Below-threshold counts are ignored unless zero (zero POPS).
        if n < self.threshold_value and n > 0:
            return
        self._extra[row_id] = n
        self.invalidate()

    def bulk_add(self, row_id: int, n: int):
        # Same admission as add() — including the zero-pops rule, which
        # the pre-array implementation dropped on this path (a row
        # cleared mid-bulk-import could never evict its stale entry).
        if n < self.threshold_value and n > 0:
            return
        self._extra[row_id] = n

    def get(self, row_id: int) -> int:
        n = self._extra.get(row_id)
        if n is not None:
            return n
        i = int(np.searchsorted(self._ids, row_id))
        if i < self._ids.size and self._ids[i] == row_id:
            return int(self._counts[i])
        return 0

    # -- bulk ops ----------------------------------------------------------

    def bulk_update(self, row_ids, counts):
        """Vectorized bulk_add: merge a whole import batch's (id, count)
        pairs into the entry columns in sorted array passes (admission
        threshold applied as a mask; zero counts pop their entries).
        Caller invalidates once afterwards, same as bulk_add."""
        ids = np.asarray(row_ids, dtype=np.int64)
        cnts = np.asarray(counts, dtype=np.int64)
        if ids.size == 0:
            return
        if ids.size > 1 and not np.all(ids[1:] > ids[:-1]):
            # General input: sort by id, last write per id wins.
            order = np.argsort(ids, kind="stable")
            ids, cnts = ids[order], cnts[order]
            last = np.r_[ids[1:] != ids[:-1], True]
            ids, cnts = ids[last], cnts[last]
        if self.threshold_value > 0:
            keep = (cnts >= self.threshold_value) | (cnts == 0)
            if not keep.all():
                ids, cnts = ids[keep], cnts[keep]
        if ids.size == 0:
            return
        self._flush_extra()
        self._merge_entries(ids, cnts)

    def _flush_extra(self):
        """Fold the scalar overlay into the sorted columns."""
        if not self._extra:
            return
        items = sorted(self._extra.items())
        self._extra = {}
        self._merge_entries(
            np.fromiter((k for k, _ in items), dtype=np.int64, count=len(items)),
            np.fromiter((v for _, v in items), dtype=np.int64, count=len(items)),
        )

    def _merge_entries(self, ids: np.ndarray, cnts: np.ndarray):
        """Merge an id-sorted unique batch into the entry columns;
        zeros delete.  Tracks the touched ids (and whether the update
        was monotone) for the incremental rank merge."""
        eids, ecnts = self._ids, self._counts
        if ids.size == 1:
            # Scalar-write shape (set_bit -> add -> flush): almost
            # always an in-place count update of an existing entry.
            i = int(np.searchsorted(eids, ids[0]))
            hit1 = i < eids.size and eids[i] == ids[0]
            n1 = int(cnts[0])
            if self._pending is not None:
                if (hit1 and n1 < ecnts[i]) or (hit1 and n1 == 0) or (
                    len(self._pending) >= _PENDING_MAX
                ):
                    self._pending = None
                elif n1 != 0:
                    self._pending.append(ids)
            if hit1:
                if n1 == 0:
                    self._ids = np.delete(eids, i)
                    self._counts = np.delete(ecnts, i)
                else:
                    ecnts[i] = n1
            elif n1 != 0:
                self._ids = np.insert(eids, i, ids[0])
                self._counts = np.insert(ecnts, i, n1)
            return
        idx = np.searchsorted(eids, ids)
        hit = np.zeros(ids.size, dtype=bool)
        inb = idx < eids.size
        hit[inb] = eids[idx[inb]] == ids[inb]
        zero = cnts == 0
        upd = hit & ~zero
        fresh = ~hit & ~zero
        dead = hit & zero
        if self._pending is not None:
            # Monotone = counts only grew and nothing was popped: the
            # standing rankings plus the touched ids then provably
            # contain the new top-k (see recalculate).
            if dead.any() or bool(np.any(cnts[upd] < ecnts[idx[upd]])):
                self._pending = None
            elif len(self._pending) >= _PENDING_MAX:
                self._pending = None
            else:
                self._pending.append(ids[upd | fresh])
        if upd.any():
            ecnts[idx[upd]] = cnts[upd]
        if fresh.any() or dead.any():
            keep = np.ones(eids.size, dtype=bool)
            keep[idx[dead]] = False
            all_ids = np.concatenate([eids[keep], ids[fresh]])
            all_cnts = np.concatenate([ecnts[keep], cnts[fresh]])
            order = np.argsort(all_ids)
            self._ids = all_ids[order]
            self._counts = all_cnts[order]

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        # Deliberately non-mutating: a reader off the fragment lock must
        # not race locked writers by folding the overlay.  Count the
        # overlay against a one-shot snapshot of the sorted ids instead.
        ids = self._ids
        n = ids.size
        for k, v in list(self._extra.items()):
            i = int(np.searchsorted(ids, k))
            hit = i < ids.size and ids[i] == k
            if v == 0:
                n -= 1 if hit else 0
            elif not hit:
                n += 1
        return n

    def ids(self) -> List[int]:
        self._flush_extra()
        return self._ids.tolist()

    @property
    def entries(self) -> Dict[int, int]:
        """Dict view of the entry store (tests/compat; not a hot path)."""
        self._flush_extra()
        return dict(zip(self._ids.tolist(), self._counts.tolist()))

    # -- ranking -----------------------------------------------------------

    def invalidate(self):
        if time.monotonic() - self._update_time < self.debounce_seconds:
            return
        self.recalculate()

    def recalculate(self):
        self._flush_extra()
        pending = self._pending
        if pending is not None and self._update_time and len(pending) > 0:
            touched = (
                np.unique(np.concatenate(pending))
                if len(pending) > 1
                else pending[0]
            )
            self._recalculate_merge(touched)
        else:
            order = np.lexsort((self._ids, self._counts))[::-1]
            self._finish_rank(self._ids[order], self._counts[order])
        self._pending = []
        self._update_time = time.monotonic()

    def _recalculate_merge(self, touched: np.ndarray):
        """Incremental re-rank: merge the touched ids' current counts
        into the standing rankings — O((batch + k) log(batch + k))
        instead of re-sorting every entry.  Valid because every update
        since the last full rank was monotone (enforced by
        _merge_entries): entries outside rankings ∪ touched were below
        the old k-th pair and nothing above them shrank, so the new
        top-k is contained in the candidates.  The admission threshold
        is still computed over ALL entries (linear select) so it never
        diverges from the full path."""
        rk_ids, rk_cnts = self._rank
        if rk_ids.size:
            stale = np.isin(rk_ids, touched)
            if stale.any():
                rk_ids, rk_cnts = rk_ids[~stale], rk_cnts[~stale]
        pos = np.searchsorted(self._ids, touched)
        inb = pos < self._ids.size
        alive = np.zeros(touched.size, dtype=bool)
        alive[inb] = self._ids[pos[inb]] == touched[inb]
        cand_ids = np.concatenate([rk_ids, touched[alive]])
        cand_cnts = np.concatenate([rk_cnts, self._counts[pos[alive]]])
        order = np.lexsort((cand_ids, cand_cnts))[::-1]
        self._finish_rank(cand_ids[order], cand_cnts[order], all_entries=False)

    def _finish_rank(
        self, s_ids: np.ndarray, s_cnts: np.ndarray, all_entries: bool = True
    ):
        """Install rankings from (count desc, id desc)-sorted candidate
        columns; set the admission threshold and trim the entry store at
        threshold_buffer, exactly like the reference (cache.go:261-290):
        threshold = the (max_entries+1)-th pair's count over ALL
        entries, 1 when everything fits."""
        k = self.max_entries
        n_all = self._ids.size
        if n_all > k:
            if all_entries:
                self.threshold_value = int(s_cnts[k])
            else:
                # Candidates are a subset: take the (k+1)-th largest
                # count over the whole store (linear partition select).
                self.threshold_value = int(
                    np.partition(self._counts, n_all - 1 - k)[n_all - 1 - k]
                )
            self._rank = (s_ids[:k], s_cnts[:k])
            if n_all > self.threshold_buffer:
                # Trim: only the ranked pairs survive in the store.
                rk_ids, rk_cnts = self._rank
                order = np.argsort(rk_ids)
                self._ids = rk_ids[order]
                self._counts = rk_cnts[order]
        else:
            self.threshold_value = 1
            self._rank = (s_ids, s_cnts)

    def top(self) -> List[Tuple[int, int]]:
        rank = self._rank
        cached = self._top_cache
        if cached is not None and cached[0] is rank:
            return cached[1]
        lst = list(zip(rank[0].tolist(), rank[1].tolist()))
        # Identity-tagged cache: a racing recalculate swaps self._rank
        # first, so a stale write here misses the tag and self-corrects
        # on the next call.
        self._top_cache = (rank, lst)
        return lst

    def rank_columns(self) -> Tuple[np.ndarray, np.ndarray]:
        """The standing rankings as (ids, counts) int64 columns in
        (count desc, id desc) order — ONE atomic snapshot (self._rank is
        swapped whole by recalculate), zero per-pair Python.  This is
        the array-native feed for the device TopN slab's candidate
        build: np ops consume the columns directly instead of looping
        top()'s pair list."""
        rk_ids, rk_cnts = self._rank
        return rk_ids, rk_cnts

    def counts_for(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized entry-store lookup: int64 counts for an id array,
        0 for ids not in the store.  searchsorted over the id-ascending
        entry columns plus the O(overlay) _extra pass — the bulk twin of
        per-id dict probing for the TopN candidate matrices."""
        ids = np.asarray(ids, dtype=np.int64)
        eids, ecnts = self._ids, self._counts
        out = np.zeros(ids.size, dtype=np.int64)
        if eids.size:
            pos = np.searchsorted(eids, ids)
            inb = pos < eids.size
            hit = np.zeros(ids.size, dtype=bool)
            hit[inb] = eids[pos[inb]] == ids[inb]
            out[hit] = ecnts[pos[hit]]
        for k, v in self._extra.items():
            m = ids == k
            if m.any():
                out[m] = v
        return out


class LRUCache:
    """Recency-evicting row-count cache."""

    cache_type = CACHE_TYPE_LRU

    def __init__(self, max_entries: int = DEFAULT_CACHE_SIZE, **_):
        self.max_entries = max_entries
        self._od: OrderedDict[int, int] = OrderedDict()

    def add(self, row_id: int, n: int):
        if n == 0:
            # Zero pops, matching RankCache's clear semantics.
            self._od.pop(row_id, None)
            return
        if row_id in self._od:
            self._od.move_to_end(row_id)
        self._od[row_id] = n
        if self.max_entries and len(self._od) > self.max_entries:
            self._od.popitem(last=False)

    bulk_add = add

    def bulk_update(self, row_ids, counts):
        for r, n in zip(
            np.asarray(row_ids).tolist(), np.asarray(counts).tolist()
        ):
            self.add(r, n)

    def get(self, row_id: int) -> int:
        n = self._od.get(row_id, 0)
        if row_id in self._od:
            self._od.move_to_end(row_id)
        return n

    def __len__(self) -> int:
        return len(self._od)

    def ids(self) -> List[int]:
        return sorted(self._od)

    def invalidate(self):
        pass

    def recalculate(self):
        pass

    def top(self) -> List[Tuple[int, int]]:
        return sorted(self._od.items(), key=pair_sort_key)


class NopCache:
    """No cache (cacheType: none)."""

    cache_type = CACHE_TYPE_NONE

    def __init__(self, *_, **__):
        pass

    def add(self, row_id: int, n: int):
        pass

    bulk_add = add

    def bulk_update(self, row_ids, counts):
        pass

    def get(self, row_id: int) -> int:
        return 0

    def __len__(self) -> int:
        return 0

    def ids(self) -> List[int]:
        return []

    def invalidate(self):
        pass

    def recalculate(self):
        pass

    def top(self) -> List[Tuple[int, int]]:
        return []


def new_cache(cache_type: str, size: int, debounce_seconds: float = 10.0):
    if cache_type == CACHE_TYPE_RANKED:
        return RankCache(size, debounce_seconds=debounce_seconds)
    if cache_type == CACHE_TYPE_LRU:
        return LRUCache(size)
    if cache_type == CACHE_TYPE_NONE:
        return NopCache()
    raise ValueError(f"invalid cache type: {cache_type}")


def merge_pairs(lists: List[List[Tuple[int, int]]]) -> List[Tuple[int, int]]:
    """K-way merge of (id, count) pair lists, summing counts per id
    (reference: Pairs.Add heap merge, cache.go:356-397)."""
    acc: Dict[int, int] = {}
    for pairs in lists:
        for row_id, n in pairs:
            acc[row_id] = acc.get(row_id, 0) + n
    return sorted(acc.items(), key=pair_sort_key)
