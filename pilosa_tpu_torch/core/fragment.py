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

- Rows/GroupBy: ``rows_filtered`` and ``row_iterator`` (``RowIterator``)
  are the host lane's row scans; Store/ClearRow: ``set_row`` and
  ``clear_row`` overwrite a whole row, which reaches ``sync_snapshot`` as
  a row entry.
- TopN: ``top()`` is fragment.go's candidate walk, with every
  candidate's src intersection count scored up front in one batched
  ``bitops.popcount_and_rows`` (P2 on the card).
- Write logs: every write records its rows (``_mutlog``) and its changed
  device words (the tiered word log), and ``sync_snapshot(version)``
  hands the engine what changed since a sync point, words and exact
  block occupancy read under one lock: the engine scatters only those
  into its resident stacks (``parallel/engine.py``).

- Bulk writes: ``bulk_import``, ``import_values`` and ``import_roaring``
  apply sorted packed keys in one multi-row merge each.

Left for later slices (ROADMAP.md Queue 1): the write-delta hub and the
anti-entropy checksums.
"""

from __future__ import annotations

import bisect
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
from .delta import HUB as _DELTA
from .row import Row
from .rowstore import SPARSE_MAX, RowStore

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


class _WriteSeq:
    """Process-global write sequence, bumped on every fragment mutation (a
    copy of ``pilosa_tpu/core/fragment.py:147 _WriteSeq``).  Read-your-
    writes for singleflight request collapsing: a flight key holds the
    value at key time, so a caller whose own completed write bumped it
    never joins a flight computed before that write.  Racy increments may
    coalesce, but any write CHANGES the value, which is all the keys
    need."""

    __slots__ = ("v",)

    def __init__(self):
        self.v = 0


WRITE_SEQ = _WriteSeq()


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
        row_attr_store=None,
        on_touch=None,
        ack: str = DEFAULT_ACK,
        device=None,
        view_gen: int = 0,
    ):
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.path = path
        self.mutex = mutex
        self.max_op_n = max_op_n
        # The field's row attributes: TopN's attribute filter reads them.
        self.row_attr_store = row_attr_store
        if ack not in ACK_LEVELS:
            raise ValueError(f"unknown ack level: {ack!r}")
        self.ack = ack
        # Device of the row mirror (the holder's device).
        self.device = resolve_device(device)
        # Owning view's version bump (engine stack invalidation) and its
        # process-unique generation token (the delta-bus log key part
        # that survives drop/recreate of a same-named view).
        self._on_touch = on_touch
        self._view_gen = view_gen
        # Delta capture staging (core/delta.py): an instrumented write
        # path stashes (rows, widxs, before-words) here just before its
        # _touch/_touch_rows call, which consumes it into one packet
        # stamped with the bump's version.  Un-instrumented paths leave
        # it None and publish OPAQUE — the repair layer then falls back.
        self._delta_pending = None

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
        # Mutation log {row_id: last touched version}: what the engine's
        # incremental sync replays into its resident stacks.  Bounded by
        # the row count, so it never overflows.  ``_mut_floor`` is the
        # last version bump with no row attribution (a storage load):
        # syncs reaching back past it must rebuild.
        self._mutlog: Dict[int, int] = {}
        self._mut_floor = 0
        # Word-level dirty tracking as whole-batch records [(version,
        # packed ``row << 15 | word`` int64 keys)], so a point write syncs
        # a few changed 4-byte words instead of the 128 KiB row.  Past
        # WORD_LOG_RECORDS fresh records the tail compacts into one record
        # stamped at the newest version (over-stamping only reships
        # idempotent words), which becomes a tier that keeps its stamp;
        # only a log past WORD_LOG_GLOBAL_MAX keys dedups everything, and
        # rows with more than WORD_LOG_MAX dirty words then turn whole-row
        # dirty.  ``_word_floor[row]`` is a row's last whole-row-dirty
        # version (a dense load, log overflow): syncs reaching back past
        # it ship the whole row.
        self._word_log: List[tuple] = []
        self._word_log_tiers = 0
        self._word_floor: Dict[int, int] = {}

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
        by_rows = None
        if data:
            try:
                # A snapshot with no op-log loads its dense rows as words.
                by_rows = codec.decode_rows(data, SPARSE_MAX)
            except ValueError:
                by_rows = None
        if by_rows is not None:
            self._load_positions(by_rows.positions, by_rows)
        elif data:
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

    def _load_positions(self, positions: np.ndarray, by_rows=None):
        """Storage positions (row*ShardWidth + in-shard col) -> rows,
        through the same multi-row merge as the bulk-import path; and the
        dense rows of ``by_rows`` (``codec.decode_rows``) as they are."""
        if positions.size == 0 and not (by_rows and by_rows.rows):
            return
        if by_rows is not None and by_rows.rows:
            counts = [self._store.set_dense(r, w) for r, w in zip(by_rows.rows, by_rows.words)]
            self.cache.bulk_update(np.asarray(by_rows.rows, dtype=np.int64),
                                   np.asarray(counts, dtype=np.int64))
        if positions.size:
            rows, bounds, pos = self._split_packed(_sorted_unique_u64(positions))
            new_counts, _, _ = self._store.bulk_merge(rows, bounds, pos)
            self.cache.bulk_update(rows, new_counts)
        self.cache.invalidate()
        self._mutex_owners = None
        self._version += 1
        WRITE_SEQ.v += 1
        self._mut_floor = self._version  # a load is unattributed: no sync past it
        self._note_touch()

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

    def serialized(self) -> bytes:
        """The fragment's bits as pilosa-roaring bytes, as
        ``codec.serialize(self.positions())`` gives them; dense rows are
        written from their words."""
        store = self._store
        return codec.serialize_rows(
            (r, store.dense.get(r), store.sparse.get(r)) for r in store.row_ids())

    @_locked
    def snapshot(self):
        """Compact: write a fresh roaring snapshot, truncate the op-log
        (atomic temp-file + rename, fragment.go:1737-1776)."""
        self._check_open()
        self._store.compact()
        if self.path is None:
            self.op_n = 0
            return
        data = self.serialized()
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

    # Dirty words tracked per row before the whole row ships instead
    # (2048 words = 8 KiB of scatter payload against the row's 128 KiB).
    WORD_LOG_MAX = 2048
    # Fresh records before the tail compacts, and the packed-key budget
    # past which compaction dedups the whole log.
    WORD_LOG_RECORDS = 16
    WORD_LOG_GLOBAL_MAX = 1 << 20

    def _touch(self, row_id: int, cols=None):
        """Record a mutation of one row: bump this fragment's version (the
        device mirror's staleness check and the sync point), log the row
        and its changed device words — ``cols``, the in-row column
        position(s) written (int or array), or None for a whole-row
        change — and bump the owning view's version (the engine's stack
        token)."""
        self._version += 1
        WRITE_SEQ.v += 1
        v = self._version
        self._mutlog[row_id] = v
        if cols is None:
            self._word_floor[row_id] = v
        else:
            base = np.int64(row_id << 15)
            if isinstance(cols, (int, np.integer)):
                packed = np.asarray([base | (int(cols) >> 5)], dtype=np.int64)
            else:
                packed = base | np.unique(np.asarray(cols, dtype=np.int64) >> 5)
            if packed.size > self.WORD_LOG_MAX:
                self._word_floor[row_id] = v
            else:
                self._word_log_push(v, packed)
        self._note_touch()

    def _touch_rows(self, rows: np.ndarray, words: np.ndarray, wbounds: np.ndarray):
        """``_touch`` of a batch: one version bump and one word-log record
        for every row of it.  ``words[wbounds[i]:wbounds[i+1]]`` are row
        ``rows[i]``'s sorted unique dirty device words."""
        self._version += 1
        WRITE_SEQ.v += 1
        v = self._version
        self._mutlog.update(dict.fromkeys(rows.tolist(), v))
        sizes = np.diff(np.asarray(wbounds, dtype=np.int64))
        over = sizes > self.WORD_LOG_MAX
        if over.any():
            for r in rows[over].tolist():
                self._word_floor[r] = v
            keep = np.repeat(~over, sizes)
            packed = np.repeat(rows[~over].astype(np.int64) << 15, sizes[~over]) | words[keep]
        else:
            packed = np.repeat(rows.astype(np.int64) << 15, sizes) | words
        if packed.size:
            self._word_log_push(v, packed)
        self._note_touch()

    def _note_touch(self):
        """Tail of every _touch/_touch_rows: bump the view version and,
        when a repair subscription is live for this view, publish the
        staged write delta (core/delta.py) stamped with EXACTLY the
        version this bump produced.  Runs under the fragment lock, so
        packet content and version order can never tear.  An
        un-instrumented write path leaves ``_delta_pending`` None and
        publishes OPAQUE — the repair layer sees the hole and falls
        back to recompute instead of serving a silently-wrong repair."""
        pending, self._delta_pending = self._delta_pending, None
        if self._on_touch is None:
            return
        ver = self._on_touch()
        if ver is None or not _DELTA.wants(
            self.index, self.field, self.view, self._view_gen
        ):
            # No packet log for this view — still wake index-level
            # listeners (continuous queries watch whole indexes).
            _DELTA.touched(self.index)
            return
        if pending is None:
            _DELTA.publish_opaque(
                self.index, self.field, self.view, self._view_gen, ver
            )
        else:
            rows, widxs, before = pending
            _DELTA.publish(
                self.index, self.field, self.view, self._view_gen, ver,
                self.shard, rows, widxs, before,
            )

    def _delta_wanted(self) -> bool:
        """Pre-write gate: capture before-words only when a repair
        subscription is live.  Unsubscribed ingest pays one dict miss."""
        return self._on_touch is not None and _DELTA.wants(
            self.index, self.field, self.view, self._view_gen
        )

    def _delta_capture_packed(self, packed: np.ndarray):
        """Before-words for a packed-position batch, read pre-merge.
        ``packed`` holds ``row*SHARD_WIDTH + pos`` keys, sorted — the
        (row, word64) pairs fall out with one dedup pass and one
        rowstore gather per touched row."""
        pk = packed.astype(np.int64, copy=False)
        wk = pk >> 6
        uw = wk[np.r_[True, wk[1:] != wk[:-1]]]
        rshift = ops.SHARD_WIDTH_EXP - 6
        rows = (uw >> rshift).astype(np.int64)
        widxs = (uw & ((1 << rshift) - 1)).astype(np.int64)
        starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
        bnds = np.append(starts, rows.size)
        before = np.empty(rows.size, dtype=np.uint64)
        for k in range(starts.size):
            lo, hi = int(bnds[k]), int(bnds[k + 1])
            before[lo:hi] = self._store.words64_at(
                int(rows[lo]), widxs[lo:hi]
            )
        return rows, widxs, before

    def words64_at(self, row_id: int, widxs) -> np.ndarray:
        """Locked read of a row's uint64 words at sorted word indexes —
        the repair layer's truth read (parallel/repair.py)."""
        with self._mu:
            return self._store.words64_at(row_id, widxs)

    def _delta_capture_bit(self, row_id: int, in_row: int):
        """Stage the delta of a single-bit write that DID flip: the
        store mutation already landed, so before = after ^ bit."""
        if not self._delta_wanted():
            return
        w = np.asarray([in_row >> 6], dtype=np.int64)
        bit = np.uint64(1) << np.uint64(in_row & 63)
        self._delta_pending = (
            np.asarray([row_id], dtype=np.int64),
            w,
            self._store.words64_at(row_id, w) ^ bit,
        )

    def _word_log_push(self, v: int, packed: np.ndarray):
        """Append one batch's packed ``row << 15 | word`` keys as one
        record.  Past WORD_LOG_RECORDS fresh records the tail compacts
        into one record stamped at ``v``, which becomes a tier; a log past
        WORD_LOG_GLOBAL_MAX keys dedups into one record, and its rows with
        more than WORD_LOG_MAX distinct words turn whole-row dirty."""
        log = self._word_log
        log.append((v, packed))
        tiers = self._word_log_tiers
        if len(log) - tiers < self.WORD_LOG_RECORDS:
            return
        cat = np.concatenate([p for _, p in log[tiers:]])
        del log[tiers:]
        log.append((v, cat))
        self._word_log_tiers = len(log)
        if sum(p.size for _, p in log) <= self.WORD_LOG_GLOBAL_MAX:
            return
        cat = np.unique(np.concatenate([p for _, p in log]) if len(log) > 1 else log[0][1])
        if cat.size > self.WORD_LOG_GLOBAL_MAX:
            rk = cat >> np.int64(15)
            starts = np.flatnonzero(np.r_[True, rk[1:] != rk[:-1]])
            bnds = np.append(starts, cat.size)
            over = np.flatnonzero(np.diff(bnds) > self.WORD_LOG_MAX)
            if over.size:
                keep = np.ones(cat.size, dtype=bool)
                for k in over.tolist():
                    keep[bnds[k]: bnds[k + 1]] = False
                    self._word_floor[int(rk[starts[k]])] = v
                cat = cat[keep]
        log[:] = [(v, cat)]
        self._word_log_tiers = 1

    def sync_snapshot(self, version: int):
        """Everything written after sync point ``version``, read atomically
        under the fragment lock: ``(new_version, {row_id: update})``, or
        None when the sync point predates the last storage load (only then
        must the engine rebuild).  An update is ``("words", widxs int32[],
        vals uint32[], occ)`` — just the changed device words, when the
        word log covers the row — or ``("row", words uint32[WORDS], occ)``.
        ``occ`` is the row's exact block-occupancy bitmap
        (``bitops.occupancy64``), read under the same lock as the words,
        so the engine's occupancy summary never disagrees with the words
        it ships: a missing bit would make the block-skipping kernel drop
        set bits.  (``pilosa_tpu/core/fragment.py`` sync_snapshot.)"""
        with self._mu:
            if version >= self._version:
                return self._version, {}
            if version < self._mut_floor:
                return None
            fresh = [p for rv, p in self._word_log if rv > version]
            word_map = {}
            if fresh:
                packed = np.unique(np.concatenate(fresh) if len(fresh) > 1 else fresh[0])
                rk = packed >> np.int64(15)
                starts = np.flatnonzero(np.r_[True, rk[1:] != rk[:-1]])
                bnds = np.append(starts, packed.size).tolist()
                wlow = (packed & np.int64(bitops.WORDS - 1)).astype(np.int32)
                word_map = {
                    int(rk[bnds[k]]): wlow[bnds[k]: bnds[k + 1]]
                    for k in range(len(bnds) - 1)
                }
            out = {}
            for r, rv in self._mutlog.items():
                if rv <= version:
                    continue
                occ = self._store.occupancy64(r)
                widxs = word_map.get(r)
                if (version < self._word_floor.get(r, 0) or widxs is None
                        or widxs.size > self.WORD_LOG_MAX):
                    # A copy: the store's dense words change in place.
                    out[r] = ("row", self.row_words(r).copy(), occ)
                else:
                    out[r] = ("words", widxs, self.row_words(r)[widxs], occ)
            return self._version, out

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
        self._delta_capture_bit(row_id, in_row)
        self._touch(row_id, in_row)
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
        self._delta_capture_bit(row_id, in_row)
        self._touch(row_id, in_row)
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
        rows = np.asarray(changed_rows, dtype=np.int64)
        if self._delta_wanted():
            # Every changed plane flipped exactly the column's bit, so
            # each row's before-word = its after-word ^ bit.
            widx = np.asarray([in_row >> 6], dtype=np.int64)
            bit = np.uint64(1) << np.uint64(in_row & 63)
            self._delta_pending = (
                rows,
                np.full(len(changed_rows), in_row >> 6, dtype=np.int64),
                np.asarray(
                    [store.words64_at(r, widx)[0] ^ bit for r in changed_rows],
                    dtype=np.uint64,
                ),
            )
        self._touch_rows(
            rows,
            np.full(len(changed_rows), in_row >> 5, dtype=np.int32),
            np.arange(len(changed_rows) + 1, dtype=np.int64),
        )
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
        RowStore.bulk_merge + ONE ``_touch_rows``, whose dirty device words
        per row (``packed >> 5``) come out of the same sorted keys.
        Returns bits changed."""
        delta = (
            self._delta_capture_packed(packed)
            if self._delta_wanted()
            else None
        )
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
        wk = packed >> 5
        uw = wk[np.r_[True, wk[1:] != wk[:-1]]]
        words = (uw & (bitops.WORDS - 1)).astype(np.int32)
        wrows = uw >> 15
        wbounds = np.append(np.flatnonzero(np.r_[True, wrows[1:] != wrows[:-1]]), uw.size)
        if not touched.all():
            keep = np.flatnonzero(touched)
            rows, new_counts = rows[keep], new_counts[keep]
            wsizes = np.diff(wbounds)[keep]
            words = (np.concatenate([words[wbounds[i]: wbounds[i + 1]] for i in keep])
                     if keep.size else words[:0])
            wbounds = np.append(0, np.cumsum(wsizes))
        if rows.size:
            self._delta_pending = delta
            self._touch_rows(rows, words, wbounds)
            self.cache.bulk_update(rows, new_counts)
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

    @_locked
    def bulk_import_rowloop(self, row_ids: Iterable[int], column_ids: Iterable[int],
                            clear: bool = False) -> int:
        """The per-row import walk that ``bulk_import`` vectorizes, as the
        reference keeps it (pilosa_tpu/core/fragment.py:1208): one
        RowStore union or difference per row, each with its own ``_touch``
        (the rows' dirty words for the stacks' in-place sync; a write
        packet with no captured words, OPAQUE, as the reference's row loop
        publishes) and cache count.  The differential oracle of the ingest
        tests and the baseline of ingest measurements, not a serving
        path."""
        self._check_open()
        row_ids = np.asarray(list(row_ids), dtype=np.int64)
        column_ids = np.asarray(list(column_ids), dtype=np.int64)
        if row_ids.size == 0:
            return 0
        if self.mutex and not clear:
            changed = self._bulk_import_mutex_rowloop(row_ids, column_ids)
            self.snapshot()
            return changed
        changed = 0
        in_row = (column_ids % SHARD_WIDTH).astype(np.uint64)
        packed = (row_ids.astype(np.uint64) << np.uint64(ops.SHARD_WIDTH_EXP)) | in_row
        for r, pos in self._group_by_row(np.unique(packed)):
            before = self._store.count(r)
            after = self._store.difference(r, pos) if clear else self._store.union(r, pos)
            changed += abs(after - before)
            if clear and self._mutex_owners is not None:
                idx = pos.astype(np.int64)
                mine = self._mutex_owners[idx] == r
                self._mutex_owners[idx[mine]] = -1
            self._touch(r, pos)
            self.cache.bulk_add(r, after)
        self.cache.invalidate()
        self.snapshot()
        return changed

    def _bulk_import_mutex_rowloop(self, row_ids: np.ndarray, column_ids: np.ndarray) -> int:
        """The per-row walk of ``_bulk_import_mutex``: each stale owner's
        columns cleared row by row, then each fresh row's set."""
        in_row = (column_ids % SHARD_WIDTH).astype(np.int64)
        cols, rws = self._last_write_wins(in_row, row_ids)
        own = self._owners()
        prev = own[cols]
        changed = 0
        stale = (prev >= 0) & (prev != rws)
        if stale.any():
            for r, pos in self._group_by_pairs(prev[stale], cols[stale]):
                self._store.difference(r, pos)
                self._touch(r, pos)
                self.cache.bulk_add(r, self._store.count(r))
        fresh = prev != rws
        if fresh.any():
            for r, pos in self._group_by_pairs(rws[fresh], cols[fresh]):
                before = self._store.count(r)
                after = self._store.union(r, pos)
                changed += after - before
                self._touch(r, pos)
                self.cache.bulk_add(r, after)
        own[cols] = rws
        self.cache.invalidate()
        return changed

    def _group_by_row(self, positions: np.ndarray):
        """Storage positions -> (row_id, sorted in-row uint32) groups."""
        row_ids = (positions >> np.uint64(ops.SHARD_WIDTH_EXP)).astype(np.int64)
        in_row = positions & np.uint64(SHARD_WIDTH - 1)
        yield from self._group_by_pairs(row_ids, in_row)

    @staticmethod
    def _group_by_pairs(rows: np.ndarray, cols: np.ndarray):
        """(row, in-row col) vectors -> (row_id, sorted uint32 cols) groups."""
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
        uniq, starts = np.unique(rows, return_index=True)
        bounds = np.append(starts, rows.size)
        for i, r in enumerate(uniq):
            yield int(r), np.sort(cols[bounds[i]: bounds[i + 1]]).astype(np.uint32)

    @staticmethod
    def _last_write_wins(cols: np.ndarray, *parallel: np.ndarray):
        """Dedup columns keeping the LAST occurrence (later writes win)."""
        _, first_in_rev = np.unique(cols[::-1], return_index=True)
        keep = cols.size - 1 - first_in_rev
        return (cols[keep],) + tuple(a[keep] for a in parallel)

    @_locked
    def import_values(self, column_ids, values, bit_depth: int, clear: bool = False,
                      fresh: bool = False):
        """BSI bulk write as two multi-row merges (fragment.go importValue
        :1609-1657): every plane's set positions in one sorted union, every
        plane's cleared positions in one sorted difference, with the
        not-null plane on the set side (or, with ``clear``, the cleared
        side; the value planes are still written from the given bits, as
        the reference does).  The last value given for a column wins.
        ``fresh``: the caller promises the columns hold no value, so the
        clear merge of the zero bits is skipped; on a column with a value
        it would OR the old and new planes.  Each touched plane reaches
        ``sync_snapshot`` through ``_touch_rows``, so resident stacks sync
        in place."""
        self._check_open()
        cols = np.asarray(column_ids, dtype=np.int64)
        vals = np.asarray(values, dtype=np.int64)
        if cols.size == 0:
            return
        in_row, vals = self._last_write_wins(cols % SHARD_WIDTH, vals)
        order = np.argsort(in_row)
        in_row, vals = in_row[order], vals[order]
        pos = in_row.astype(np.uint64)
        exp = np.uint64(ops.SHARD_WIDTH_EXP)
        set_chunks, clr_chunks = [], []
        if bit_depth > 0:
            planes = np.arange(bit_depth, dtype=np.uint64)
            bitmat = ((vals[None, :] >> planes[:, None].astype(np.int64)) & 1).astype(bool)
            packed = (planes[:, None] << exp) | pos[None, :]
            set_chunks.append(packed[bitmat])
            if clear or not fresh:
                clr_chunks.append(packed[~bitmat])
        not_null = (np.uint64(bit_depth) << exp) | pos
        (clr_chunks if clear else set_chunks).append(not_null)
        # Plane-major runs of ascending positions: sorted and unique.
        for chunks, is_clear in ((clr_chunks, True), (set_chunks, False)):
            packed = np.concatenate(chunks) if chunks else np.empty(0, dtype=np.uint64)
            if packed.size:
                self._apply_packed(packed, clear=is_clear)
        self.cache.invalidate()
        self.snapshot()

    @_locked
    def import_roaring(self, data: bytes, clear: bool = False,
                       values: Optional[np.ndarray] = None, by_rows=None) -> int:
        """Union (or with ``clear``, subtract) a serialized roaring bitmap
        straight into storage (fragment.go importRoaring :1659;
        ImportRoaringRequest.Clear).  ``values``: the storage positions
        already decoded (the API decodes once and shares them), or
        ``by_rows``, the body by rows (``codec.decode_rows``: dense rows go
        in as words, through ``_apply_rows``).  The
        codec's sorted unique positions are the packed (row, pos) keys, as
        row * ShardWidth + col is row << 20 | col, so they feed the
        multi-row merge with no re-sort, and its ``_touch_rows`` marks the
        changed words dirty: the next query syncs a resident stack in
        place.  Returns bits changed."""
        self._check_open()
        if values is None and by_rows is None:
            by_rows = codec.decode_rows(data, SPARSE_MAX)
            if by_rows is None:
                values = codec.deserialize(data).values
        if by_rows is not None:
            changed = self._apply_rows(by_rows.rows, by_rows.words, clear)
            values = by_rows.positions
        else:
            changed = 0
        positions = _sorted_unique_u64(values)
        changed += self._apply_packed(positions, clear) if positions.size else 0
        self.cache.invalidate()
        self.snapshot()
        return changed

    @_locked
    def import_roaring_rowloop(self, data: bytes, clear: bool = False) -> int:
        """The roaring ingest that ``import_roaring`` vectorizes, as the
        reference keeps it (pilosa_tpu/core/fragment.py:1417): the scalar
        container decode (``codec._deserialize_py``), one store walk per
        row with its own ``_touch`` (an OPAQUE packet each, as the
        reference's), and ``changed`` from whole-store count sums.  The
        differential oracle of the ingest tests, not a serving path."""
        self._check_open()
        dec = codec._deserialize_py(data)
        before = sum(self._store.counts.values())
        positions = dec.values
        if positions.size:
            for r, pos in self._group_by_row(positions):
                if clear:
                    if r not in self._store:
                        continue
                    n = self._store.difference(r, pos)
                else:
                    n = self._store.union(r, pos)
                self._touch(r, pos)
                self.cache.bulk_add(r, n)
            self._mutex_owners = None
            self.cache.invalidate()
        self.snapshot()
        return abs(sum(self._store.counts.values()) - before)

    def _apply_rows(self, rows, words, clear: bool) -> int:
        """OR (or with ``clear``, AND NOT) dense rows into storage, each
        row's changed 32-bit words logged for the stacks' in-place sync,
        as ``_apply_packed`` logs a sparse batch's.  Returns bits
        changed.  The delta capture reads, before any merge, every 64-bit
        word a given row holds bits in, as ``_delta_capture_packed`` does
        for the same positions."""
        store = self._store
        delta = None
        if self._delta_wanted() and len(rows):
            widxs = [np.flatnonzero(w).astype(np.int64) for w in words]
            delta = (
                np.concatenate([np.full(wi.size, r, dtype=np.int64)
                                for r, wi in zip(rows, widxs)]),
                np.concatenate(widxs),
                np.concatenate([store.words64_at(r, wi)
                                for r, wi in zip(rows, widxs)]),
            )
        touched, counts, dirty, changed = [], [], [], 0
        for r, w in zip(rows, words):
            if r not in store and clear:
                continue
            old = store.words_u64(r)
            new = old & ~w if clear else old | w
            diff = np.flatnonzero(new.view(np.uint32) != old.view(np.uint32))
            if not diff.size:
                continue
            n_old = store.count(r)
            n = store.set_dense(r, new)
            changed += abs(n - n_old)
            touched.append(r)
            counts.append(n)
            dirty.append(diff.astype(np.int32))
        if touched:
            self._mutex_owners = None
            rows_a = np.asarray(touched, dtype=np.int64)
            self._delta_pending = delta
            self._touch_rows(rows_a, np.concatenate(dirty),
                             np.append(0, np.cumsum([d.size for d in dirty])))
            self.cache.bulk_update(rows_a, np.asarray(counts, dtype=np.int64))
        return changed

    @_locked
    def load_row_words(self, row_id: int, words_u64: np.ndarray):
        """Install a dense row wholesale — the bulk load path for
        benchmarks and restores (no op-log, no snapshot; the caller
        snapshots if it wants the row on disk).  The array is kept as the
        row's storage, not copied, when it is already contiguous uint64.
        Deliberately publishes OPAQUE (no delta capture): a load is not a
        serving write, and the repair layer MUST fall back to recompute
        over it."""
        self._check_open()
        n = self._store.set_dense(
            row_id, np.ascontiguousarray(words_u64, dtype=np.uint64)
        )
        self._mutex_owners = None
        self.cache.bulk_add(row_id, n)
        self._touch(row_id)

    # -- whole-row writes (Store/ClearRow support) --------------------------

    @_locked
    def clear_row(self, row_id: int) -> bool:
        """Remove every bit in a row, snapshot (fragment.go clearRow :551,
        unprotectedClearRow).  The row reaches ``sync_snapshot`` as a
        whole-row entry (zeros), so a resident stack holding it syncs in
        place."""
        self._check_open()
        if self._delta_wanted():
            # Dense delta: every nonzero word of the row, before-value =
            # the word itself (after = 0).  Empty when the row was
            # already empty — an exact no-op packet, never OPAQUE.
            old = (
                self._store.words_u64(row_id)
                if row_id in self._store
                else np.zeros(WORDS64, dtype=np.uint64)
            )
            w = np.flatnonzero(old).astype(np.int64)
            self._delta_pending = (
                np.full(w.size, row_id, dtype=np.int64), w, old[w]
            )
        if self._mutex_owners is not None:
            self._mutex_owners[self._store.positions(row_id).astype(np.int64)] = -1
        changed = self._store.drop(row_id)
        self.cache.add(row_id, 0)
        self._touch(row_id)
        self.snapshot()
        return changed

    @_locked
    def set_row(self, row: Optional[Row], row_id: int) -> bool:
        """Overwrite a row with a Row's segment for this shard, snapshot
        (fragment.go setRow :501, Store() support).  Returns whether the
        row changed."""
        self._check_open()
        seg = row.segment(self.shard) if row is not None else None
        new = (np.zeros(WORDS64, dtype=np.uint64) if seg is None
               else bitops.to_numpy(seg).view("<u8").copy())
        old = self._store.words_u64(row_id) if row_id in self._store else None
        changed = old is None or not np.array_equal(old, new)
        if self._delta_wanted():
            # Dense delta of the overwrite: exactly the words that
            # differ, with their pre-write values.
            base = old if old is not None else np.zeros(WORDS64, dtype=np.uint64)
            w = np.flatnonzero(base != new).astype(np.int64)
            self._delta_pending = (
                np.full(w.size, row_id, dtype=np.int64), w, base[w]
            )
        n = self._store.set_dense(row_id, new)
        self._mutex_owners = None
        self.cache.bulk_add(row_id, n)
        self.cache.invalidate()
        self._touch(row_id)
        self.snapshot()
        return changed

    # -- row scans (Rows/GroupBy support, fragment.go rows() :2000-2100) ---

    def rows_filtered(self, start: int = 0, column: Optional[int] = None,
                      limit: Optional[int] = None) -> List[int]:
        """Row ids from ``start`` up, holding ``column`` when given, at
        most ``limit`` of them."""
        out = []
        for r in self.row_ids():
            if r < start:
                continue
            if column is not None and not self.bit(r, column):
                continue
            out.append(r)
            if limit is not None and len(out) >= limit:
                break
        return out

    def row_iterator(self, wrap: bool, row_ids_filter: Optional[List[int]] = None):
        """Iterator over rows for GroupBy (fragment.go rowIterator :2101)."""
        ids = self.row_ids()
        if row_ids_filter is not None:
            allowed = set(row_ids_filter)
            ids = [r for r in ids if r in allowed]
        return RowIterator(self, ids, wrap)

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
        ``src_counts`` (and ``src_count_total``) precomputed.  With
        ``filter_name`` and ``filter_values``, a candidate whose row
        attribute ``filter_name`` is not one of the values is skipped."""
        if row_ids:
            pairs = [(r, self.row_count(r)) for r in row_ids]
            n = 0  # explicit ids: never truncate
        else:
            pairs = list(self.cache.top())

        filters = set(filter_values) if (filter_name and filter_values) else None

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
                mat, idx = self.device_matrix()
                present = [r for r, _ in pairs if r in idx]
                if seg is not None and present:
                    # The candidates' rows are read in place by index: no
                    # gathered copy of the matrix.
                    counts = bitops.popcount_and_rows(
                        mat, seg, rows=[idx[r] for r in present]
                    )
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
            if filters is not None:
                if self.row_attr_store is None:
                    continue
                val = self.row_attr_store.attrs(row_id).get(filter_name)
                if val is None or val not in filters:
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


class RowIterator:
    """Sorted row-ID cursor with optional wraparound (fragment.go:2101-2135)."""

    def __init__(self, frag: Fragment, row_ids: List[int], wrap: bool):
        self.frag = frag
        self.row_ids = row_ids
        self.cur = 0
        self.wrap = wrap

    def seek(self, row_id: int):
        self.cur = bisect.bisect_left(self.row_ids, row_id)

    def next(self):
        """Returns (row, row_id, wrapped); row is None when exhausted."""
        wrapped = False
        if self.cur >= len(self.row_ids):
            if not self.wrap or not self.row_ids:
                return None, 0, True
            self.cur = 0
            wrapped = True
        row_id = self.row_ids[self.cur]
        self.cur += 1
        return self.frag.row(row_id), row_id, wrapped
