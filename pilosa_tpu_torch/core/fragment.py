"""Fragment: the unit of storage and compute — (index, field, view, shard).

The port's copy of ``pilosa_tpu/core/fragment.py``, cut to what the Count
slice calls (upstream Pilosa: fragment.go:87-2492):

- Host truth: a hybrid sparse/dense RowStore — rows below a density
  threshold are sorted position arrays, denser rows dense ``uint64[16384]``
  word vectors.  Roaring is the file codec only.
- Device mirror: a version-tracked ``int32[n_rows, 32768]`` tensor on the
  fragment's device, rebuilt lazily after writes; the host bitmap lane of
  the executor runs its row algebra over it.
- Durability: a pilosa-roaring snapshot file plus an appended op-log
  replayed on open (roaring.go:812-974), positions encoded as
  ``row*ShardWidth + col%ShardWidth`` (fragment.go:987), snapshot
  compaction after ``max_op_n`` logged ops via temp file + rename.
- Mutex fields: a column -> row occupancy vector gives the O(1) owner
  lookup (fragment.go:398-427).

- TopN: ``top()`` is fragment.go's candidate walk, with every
  candidate's src intersection count scored up front in one batched
  ``bitops.popcount_and_rows`` (K3's P2 entry on the card).

Left for later slices (ROADMAP.md Queue 1): the write logs behind the
engine's in-place scatter-sync (every write here rebuilds the engine's
stack), the write-delta hub, anti-entropy checksums, the row-attribute
store behind TopN's attribute filter, and the roaring/value bulk-import
paths.
"""

from __future__ import annotations

import functools
import heapq
import json
import math
import os
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..ops import bitops
from ..parallel.mesh import resolve_device
from ..roaring import codec
from . import cache as cache_mod
from .row import Row
from .rowstore import RowStore

SHARD_WIDTH = ops.SHARD_WIDTH
WORDS64 = bitops.WORDS64

DEFAULT_MAX_OP_N = 2000

# -- ingest ack/durability policy ([storage] ack) ----------------------------
#   received — applied to host memory and buffered toward the op-log;
#   logged   — op-log bytes are flushed to the OS before the call returns;
#   fsynced  — flush + fsync before return (and snapshots fsync the temp
#              file before the rename).
ACK_RECEIVED = "received"
ACK_LOGGED = "logged"
ACK_FSYNCED = "fsynced"
ACK_LEVELS = (ACK_RECEIVED, ACK_LOGGED, ACK_FSYNCED)
DEFAULT_ACK = ACK_LOGGED

# Row ids used for bool fields (fragment.go:82-84).
FALSE_ROW_ID = 0
TRUE_ROW_ID = 1


def fsync_dir(path: Optional[str]):
    """fsync the directory containing ``path`` so a rename is durable."""
    if not path:
        return
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sorted_unique_u64(values: np.ndarray) -> np.ndarray:
    """uint64 view of ``values``, sorted-unique (O(n) check when the
    producer already sorted, one np.unique otherwise)."""
    v = np.asarray(values, dtype=np.uint64)
    if v.size > 1 and not np.all(v[1:] > v[:-1]):
        v = np.unique(v)
    return v


def _locked(fn):
    """Run under the fragment mutex (fragment.go:88 RWMutex discipline)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._mu:
            return fn(self, *args, **kwargs)

    return wrapper


class Fragment:
    """One shard of one view of one field."""

    def __init__(
        self,
        index: str,
        field: str,
        view: str,
        shard: int,
        path: Optional[str] = None,
        cache_type: str = cache_mod.CACHE_TYPE_RANKED,
        cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
        max_op_n: int = DEFAULT_MAX_OP_N,
        mutex: bool = False,
        on_touch=None,
        ack: str = DEFAULT_ACK,
        device=None,
    ):
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.path = path
        self.mutex = mutex
        self.max_op_n = max_op_n
        if ack not in ACK_LEVELS:
            raise ValueError(f"unknown ack level: {ack!r}")
        self.ack = ack
        # Device of the row mirror (the holder's device).
        self.device = resolve_device(device)
        # Owning view's version bump: the engine's stack invalidation token.
        self._on_touch = on_touch

        self._store = RowStore()
        self.row_counts = self._store.counts
        self.cache = cache_mod.new_cache(cache_type, cache_size, debounce_seconds=0.0)
        self.cache_type = cache_type

        self.op_n = 0
        self._op_file = None
        self._closed = False
        # Serializes host-truth mutation, snapshot, and device-mirror sync.
        self._mu = threading.RLock()

        # Device mirror state.
        self._version = 0
        self._dev_version = -1
        self._dev_matrix: Optional[torch.Tensor] = None
        self._dev_index: Dict[int, int] = {}

        # Lazily-built mutex occupancy vector: column -> owning row (-1 none).
        self._mutex_owners: Optional[np.ndarray] = None

        if path is not None:
            self._open_storage()

    # -- persistence -------------------------------------------------------

    def _open_storage(self):
        data = b""
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                data = f.read()
        if data:
            try:
                dec = codec.deserialize(data)
            except ValueError:
                # Torn op-log tail (crash mid-append): keep the intact
                # prefix and truncate the file there.  A corrupt snapshot
                # section still raises — nothing is safe to keep.
                dec, valid_len = codec.deserialize_recover(data)
                with open(self.path, "r+b") as tf:
                    tf.truncate(valid_len)
            self._load_positions(dec.values)
            self.op_n = dec.op_n
        else:
            # New file: an empty snapshot header, so the file always
            # starts with a valid roaring section followed by the op-log.
            with open(self.path, "wb") as f:
                f.write(codec.serialize(np.empty(0, dtype=np.uint64)))
        self._op_file = open(self.path, "ab")
        self._load_cache_file()

    def _load_positions(self, positions: np.ndarray):
        """Storage positions (row*ShardWidth + in-shard col) -> rows,
        through the same multi-row merge as the bulk-import path."""
        if positions.size == 0:
            return
        rows, bounds, pos = self._split_packed(_sorted_unique_u64(positions))
        new_counts, _, _ = self._store.bulk_merge(rows, bounds, pos)
        self.cache.bulk_update(rows, new_counts)
        self.cache.invalidate()
        self._mutex_owners = None
        self._touch()

    def positions(self) -> np.ndarray:
        """All storage positions, sorted (for snapshot serialization)."""
        chunks = []
        for r in self._store.row_ids():
            pos = self._store.positions(r)
            if pos.size:
                chunks.append(pos.astype(np.uint64) + np.uint64(r * SHARD_WIDTH))
        if not chunks:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(chunks)

    @_locked
    def snapshot(self):
        """Compact: write a fresh roaring snapshot, truncate the op-log
        (atomic temp-file + rename, fragment.go:1737-1776)."""
        self._check_open()
        self._store.compact()
        if self.path is None:
            self.op_n = 0
            return
        data = codec.serialize(self.positions())
        tmp = self.path + ".snapshotting"
        with open(tmp, "wb") as f:
            f.write(data)
            if self.ack == ACK_FSYNCED:
                f.flush()
                os.fsync(f.fileno())
        if self._op_file is not None:
            self._op_file.close()
        os.replace(tmp, self.path)
        if self.ack == ACK_FSYNCED:
            fsync_dir(self.path)
        self._op_file = open(self.path, "ab")
        self.op_n = 0

    def flush_cache(self):
        """Persist the TopN cache ids atomically (temp file + fsync +
        os.replace), in the JAX package's file format."""
        if self.path is None:
            return
        pairs = [[int(i), int(n)] for i, n in self.cache.top()]
        p = self.path + ".cache"
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"pairs": pairs}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def _load_cache_file(self):
        """Best-effort cache warm from disk: an unreadable or corrupt file
        is ignored (the ranked cache rebuilds from row counts)."""
        p = (self.path or "") + ".cache"
        if self.path is None or not os.path.exists(p):
            return
        try:
            with open(p) as f:
                doc = json.loads(f.read())
            for row_id, _ in doc.get("pairs", []):
                self.cache.bulk_add(int(row_id), self.row_count(int(row_id)))
        except (OSError, ValueError, TypeError, AttributeError):
            pass
        finally:
            self.cache.invalidate()

    @_locked
    def close(self):
        """Locked, and marks the fragment CLOSED: a write racing close
        either completes durably (it held the lock first) or raises."""
        self._closed = True
        self.flush_cache()
        if self._op_file is not None:
            try:
                self._op_file.flush()
                if self.ack == ACK_FSYNCED:
                    os.fsync(self._op_file.fileno())
            except (OSError, ValueError):
                pass
            self._op_file.close()
            self._op_file = None

    def _check_open(self):
        """Every mutation path calls this first: a write racing close()
        must raise, never ack."""
        if self._closed:
            raise RuntimeError(
                f"fragment {self.index}/{self.field}/{self.view}/"
                f"{self.shard} is closed"
            )

    def _append_op(self, typ: int, pos: int):
        self._check_open()
        if self._op_file is not None:
            self._op_file.write(codec.encode_op(typ, pos))
            self.op_n += 1
            if self.ack != ACK_RECEIVED:
                self._op_file.flush()
                if self.ack == ACK_FSYNCED:
                    os.fsync(self._op_file.fileno())
            if self.op_n > self.max_op_n:
                self._op_file.flush()
                self.snapshot()

    # -- position math -----------------------------------------------------

    def pos(self, row_id: int, column_id: int) -> int:
        """fragment.go:987 — row*ShardWidth + col%ShardWidth; col must fall
        inside this fragment's shard."""
        min_col = self.shard * SHARD_WIDTH
        if not (min_col <= column_id < min_col + SHARD_WIDTH):
            raise ValueError(
                f"column:{column_id} out of bounds for shard {self.shard}"
            )
        return row_id * SHARD_WIDTH + (column_id % SHARD_WIDTH)

    # -- bit mutation ------------------------------------------------------

    def _touch(self):
        """Record a mutation: bump this fragment's version (the device
        mirror's staleness check) and the owning view's version (the
        engine's stack token)."""
        self._version += 1
        if self._on_touch is not None:
            self._on_touch()

    @_locked
    def set_bit(self, row_id: int, column_id: int) -> bool:
        self._check_open()
        if self.mutex:
            self._handle_mutex(row_id, column_id)
        return self._set_bit(row_id, column_id)

    def _handle_mutex(self, row_id: int, column_id: int):
        """Clear any other row's bit at this column (fragment.go:414-427)."""
        existing = self.row_containing(column_id)
        if existing is not None and existing != row_id:
            self._clear_bit(existing, column_id)

    def _owners(self) -> np.ndarray:
        """column -> owning row occupancy vector (mutex fields), built
        lazily and maintained by the single-bit and bulk mutex paths."""
        if self._mutex_owners is None:
            own = np.full(SHARD_WIDTH, -1, dtype=np.int64)
            for r in self._store.row_ids():
                own[self._store.positions(r).astype(np.int64)] = r
            self._mutex_owners = own
        return self._mutex_owners

    def row_containing(self, column_id: int) -> Optional[int]:
        """The row with a bit set at column — O(1) occupancy lookup."""
        r = int(self._owners()[column_id % SHARD_WIDTH])
        return None if r < 0 else r

    def _set_bit(self, row_id: int, column_id: int) -> bool:
        p = self.pos(row_id, column_id)
        in_row = column_id % SHARD_WIDTH
        if not self._store.set(row_id, in_row):
            return False
        if self._mutex_owners is not None:
            self._mutex_owners[in_row] = row_id
        self._append_op(codec.OP_TYPE_ADD, p)
        self._touch()
        self.cache.add(row_id, self._store.count(row_id))
        return True

    @_locked
    def clear_bit(self, row_id: int, column_id: int) -> bool:
        self._check_open()
        return self._clear_bit(row_id, column_id)

    def _clear_bit(self, row_id: int, column_id: int) -> bool:
        p = self.pos(row_id, column_id)
        in_row = column_id % SHARD_WIDTH
        if not self._store.clear(row_id, in_row):
            return False
        if (
            self._mutex_owners is not None
            and self._mutex_owners[in_row] == row_id
        ):
            self._mutex_owners[in_row] = -1
        self._append_op(codec.OP_TYPE_REMOVE, p)
        self._touch()
        self.cache.add(row_id, self._store.count(row_id))
        return True

    def bit(self, row_id: int, column_id: int) -> bool:
        return self._store.test(row_id, column_id % SHARD_WIDTH)

    # -- row access --------------------------------------------------------

    def row_words(self, row_id: int) -> np.ndarray:
        """Dense host uint32[WORDS] words of a row (zeros if absent)."""
        return self._store.words_u32(row_id)

    def row_positions(self, row_id: int) -> np.ndarray:
        """Sorted uint32 in-row positions of a row."""
        return self._store.positions(row_id)

    def row_occupancy(self, row_id: int) -> int:
        """Exact block-occupancy bitmap of a row (bitops.occupancy64)."""
        return self._store.occupancy64(row_id)

    def row(self, row_id: int) -> Row:
        return Row({self.shard: self.device_row(row_id)})

    def row_count(self, row_id: int) -> int:
        return self._store.count(row_id)

    def counts_for(self, row_ids) -> np.ndarray:
        """Bulk row_count: int64 STORE counts for an id sequence (0 for
        absent rows) — the TopN candidate build calls it once per shard.
        Ranked-cache counts are no substitute: the cache legally keeps
        stale counts for updates below its admission threshold."""
        get = self._store.counts.get
        return np.fromiter(
            (get(int(r), 0) for r in row_ids), dtype=np.int64, count=len(row_ids)
        )

    def row_ids(self) -> List[int]:
        return self._store.row_ids()

    def max_row_id(self) -> int:
        ids = self.row_ids()
        return ids[-1] if ids else 0

    # -- device mirror -----------------------------------------------------

    @_locked
    def _sync_device(self):
        if self._dev_version == self._version and self._dev_matrix is not None:
            return
        ids = self._store.row_ids()
        if not ids:
            mat = np.zeros((1, bitops.WORDS), dtype=np.uint32)
            self._dev_index = {}
        else:
            mat = np.stack([self._store.words_u32(r) for r in ids])
            self._dev_index = {r: i for i, r in enumerate(ids)}
        self._dev_matrix = bitops.to_tensor(mat, self.device)
        self._dev_version = self._version

    def device_matrix(self):
        """int32[n_rows, WORDS] device matrix + row index map."""
        self._sync_device()
        return self._dev_matrix, self._dev_index

    def device_row(self, row_id: int) -> torch.Tensor:
        self._sync_device()
        idx = self._dev_index.get(row_id)
        if idx is None:
            return bitops.empty_row(self.device)
        return self._dev_matrix[idx]

    def device_planes(self, bit_depth: int) -> torch.Tensor:
        """int32[bit_depth+1, WORDS] BSI plane matrix (rows 0..bit_depth)."""
        self._sync_device()
        idxs = [self._dev_index.get(r) for r in range(bit_depth + 1)]
        if None not in idxs and idxs == list(range(idxs[0], idxs[0] + bit_depth + 1)):
            return self._dev_matrix[idxs[0] : idxs[0] + bit_depth + 1]
        return torch.stack([self.device_row(r) for r in range(bit_depth + 1)])

    # -- BSI value ops ------------------------------------------------------

    def value(self, column_id: int, bit_depth: int) -> Tuple[int, bool]:
        """Read a BSI value from a column of bits (fragment.go:597-618)."""
        if not self.bit(bit_depth, column_id):
            return 0, False
        value = 0
        for i in range(bit_depth):
            if self.bit(i, column_id):
                value |= 1 << i
        return value, True

    @_locked
    def set_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        """Write a BSI value + not-null bit (fragment.go:634-689)."""
        self._check_open()
        return self._write_value(column_id, bit_depth, value, clear=False)

    @_locked
    def clear_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        """Clear a BSI value: every value plane and the not-null bit
        (fragment.go clearValue :700).  ``value`` is accepted for
        signature compatibility and ignored."""
        self._check_open()
        return self._write_value(column_id, bit_depth, 0, clear=True)

    def _write_value(
        self, column_id: int, bit_depth: int, value: int, clear: bool
    ) -> bool:
        """Masked multi-plane write under one lock hold, one touch."""
        self.pos(0, column_id)  # bounds check once, not per plane
        in_row = column_id % SHARD_WIDTH
        store = self._store
        owners = self._mutex_owners
        changed_rows: List[int] = []
        for i in range(bit_depth + 1):
            setting = (not clear) if i == bit_depth else bool((value >> i) & 1)
            if setting:
                if not store.set(i, in_row):
                    continue
                if owners is not None:
                    owners[in_row] = i
                self._append_op(codec.OP_TYPE_ADD, i * SHARD_WIDTH + in_row)
            else:
                if not store.clear(i, in_row):
                    continue
                if owners is not None and owners[in_row] == i:
                    owners[in_row] = -1
                self._append_op(codec.OP_TYPE_REMOVE, i * SHARD_WIDTH + in_row)
            changed_rows.append(i)
        if not changed_rows:
            return False
        self._touch()
        for r in changed_rows:
            self.cache.add(r, store.count(r))
        return True

    # -- bulk import -------------------------------------------------------

    @staticmethod
    def _split_packed(packed: np.ndarray):
        """Sorted unique packed ``row << SHARD_WIDTH_EXP | pos`` keys ->
        ``(rows int64[R], bounds int64[R+1], positions uint32[N])``."""
        row_keys = (packed >> ops.SHARD_WIDTH_EXP).astype(np.int64)
        starts = np.flatnonzero(np.r_[True, row_keys[1:] != row_keys[:-1]])
        rows = row_keys[starts]
        bounds = np.append(starts, packed.size)
        positions = (packed & (SHARD_WIDTH - 1)).astype(np.uint32)
        return rows, bounds, positions

    def _apply_packed(self, packed: np.ndarray, clear: bool) -> int:
        """Apply sorted unique packed (row, pos) keys as ONE multi-row
        RowStore.bulk_merge + ONE touch.  Returns bits changed."""
        rows, bounds, positions = self._split_packed(packed)
        new_counts, changed, touched = self._store.bulk_merge(
            rows, bounds, positions, clear=clear, packed=packed
        )
        if self._mutex_owners is not None:
            idx = positions.astype(np.int64)
            rep = np.repeat(rows, np.diff(bounds))
            if clear:
                mine = self._mutex_owners[idx] == rep
                self._mutex_owners[idx[mine]] = -1
            else:
                self._mutex_owners[idx] = rep
        if touched.any():
            self._touch()
            keep = np.flatnonzero(touched)
            self.cache.bulk_update(rows[keep], new_counts[keep])
        return int(changed.sum())

    @_locked
    def bulk_import(
        self,
        row_ids: Iterable[int],
        column_ids: Iterable[int],
        clear: bool = False,
    ) -> int:
        """Set (or with ``clear`` remove) many bits at once: ONE sort over
        packed (row, col) keys, ONE multi-row store merge, ONE snapshot —
        bypassing the op-log (fragment.go:1445-1533).  Mutex fragments
        clear each column's previous owner first (bulkImportMutex
        :1538); a clear import bypasses that."""
        self._check_open()
        row_ids = np.asarray(row_ids, dtype=np.int64)
        column_ids = np.asarray(column_ids, dtype=np.int64)
        if row_ids.size == 0:
            return 0
        if self.mutex and not clear:
            changed = self._bulk_import_mutex(row_ids, column_ids)
        else:
            packed = np.unique(
                (row_ids << np.int64(ops.SHARD_WIDTH_EXP))
                | (column_ids % SHARD_WIDTH)
            )
            changed = self._apply_packed(packed, clear)
        self.cache.invalidate()
        self.snapshot()
        return changed

    def _bulk_import_mutex(self, row_ids: np.ndarray, column_ids: np.ndarray) -> int:
        """Last write per column wins; previous owners are cleared in one
        multi-row difference, the fresh assignments land in one union."""
        in_row = (column_ids % SHARD_WIDTH).astype(np.int64)
        cols, rws = self._last_write_wins(in_row, row_ids)
        own = self._owners()
        prev = own[cols]
        changed = 0
        exp = np.uint64(ops.SHARD_WIDTH_EXP)
        stale = (prev >= 0) & (prev != rws)
        if stale.any():
            packed = np.sort(
                (prev[stale].astype(np.uint64) << exp)
                | cols[stale].astype(np.uint64)
            )
            self._apply_packed(packed, clear=True)
        fresh = prev != rws
        if fresh.any():
            packed = np.sort(
                (rws[fresh].astype(np.uint64) << exp)
                | cols[fresh].astype(np.uint64)
            )
            changed = self._apply_packed(packed, clear=False)
        own[cols] = rws
        return changed

    @staticmethod
    def _last_write_wins(cols: np.ndarray, *parallel: np.ndarray):
        """Dedup columns keeping the LAST occurrence (later writes win)."""
        _, first_in_rev = np.unique(cols[::-1], return_index=True)
        keep = cols.size - 1 - first_in_rev
        return (cols[keep],) + tuple(a[keep] for a in parallel)

    @_locked
    def load_row_words(self, row_id: int, words_u64: np.ndarray):
        """Install a dense row wholesale — the bulk load path for
        benchmarks and restores (no op-log, no snapshot; the caller
        snapshots if it wants the row on disk).  The array is kept as the
        row's storage, not copied, when it is already contiguous uint64."""
        self._check_open()
        n = self._store.set_dense(
            row_id, np.ascontiguousarray(words_u64, dtype=np.uint64)
        )
        self._mutex_owners = None
        self.cache.bulk_add(row_id, n)
        self._touch()

    # -- TopN (fragment.go top :1018-1150) ---------------------------------

    def top(
        self,
        n: int = 0,
        src: Optional[Row] = None,
        row_ids: Optional[List[int]] = None,
        min_threshold: int = 0,
        filter_name: str = "",
        filter_values: Optional[list] = None,
        tanimoto_threshold: int = 0,
        src_counts: Optional[Dict[int, int]] = None,
        src_count_total: Optional[int] = None,
    ) -> List[Tuple[int, int]]:
        """fragment.go top :1018-1150, exactly — the candidate walk with its
        min-heap, threshold early-exits and Tanimoto window — except that
        the per-candidate src intersection counts (the reference's hot loop
        :1089, :1133) are computed for ALL candidates in one batched
        popcount up front.  Callers that score across shards pass
        ``src_counts`` (and ``src_count_total``) precomputed.  The attribute
        filter needs the row-attribute store, which is not ported."""
        if filter_name and filter_values:
            raise NotImplementedError(
                "TopN attribute filters are not ported to pilosa_tpu_torch yet: "
                "ROADMAP.md Queue 1 item 2 (attributes)"
            )
        if row_ids:
            pairs = [(r, self.row_count(r)) for r in row_ids]
            n = 0  # explicit ids: never truncate
        else:
            pairs = list(self.cache.top())

        has_src = src is not None or src_counts is not None
        src_count = 0
        min_tan = max_tan = 0.0
        if tanimoto_threshold > 0 and has_src:
            src_count = (
                src_count_total if src_count_total is not None else src.count()
            )
            min_tan = src_count * tanimoto_threshold / 100.0
            max_tan = src_count * 100.0 / tanimoto_threshold

        if src_counts is None:
            src_counts = {}
            if src is not None:
                seg = src.segment(self.shard)
                _, idx = self.device_matrix()
                present = [r for r, _ in pairs if r in idx]
                if seg is not None and present:
                    sel = self._dev_matrix[
                        torch.tensor([idx[r] for r in present], dtype=torch.long,
                                     device=self.device)
                    ]
                    counts = bitops.popcount_and_rows(sel, seg)
                    src_counts = dict(zip(present, counts.tolist()))

        # heap of (count, id): smallest count on top (pairHeap is a min-heap).
        heap: List[Tuple[int, int]] = []
        for row_id, cnt in pairs:
            if cnt <= 0:
                continue
            if tanimoto_threshold > 0:
                if cnt <= min_tan or cnt >= max_tan:
                    continue
            elif cnt < min_threshold:
                continue

            if n == 0 or len(heap) < n:
                count = src_counts.get(row_id, 0) if has_src else cnt
                if count == 0:
                    continue
                if tanimoto_threshold > 0:
                    tan = math.ceil(count * 100 / (cnt + src_count - count))
                    if tan <= tanimoto_threshold:
                        continue
                elif count < min_threshold:
                    continue
                heapq.heappush(heap, (count, row_id))
                if n > 0 and len(heap) == n and not has_src:
                    break
                continue

            threshold = heap[0][0]
            if threshold < min_threshold or cnt < threshold:
                break
            count = src_counts.get(row_id, 0)
            if count < threshold:
                continue
            heapq.heappush(heap, (count, row_id))

        out = [(rid, c) for c, rid in heap]
        out.sort(key=cache_mod.pair_sort_key)
        return out

    def __repr__(self) -> str:
        return (
            f"Fragment({self.index}/{self.field}/{self.view}/{self.shard}, "
            f"rows={len(self._store)})"
        )
