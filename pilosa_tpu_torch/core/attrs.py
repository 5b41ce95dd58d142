"""Attribute store: arbitrary k/v attributes on rows and columns.

The port's copy of ``pilosa_tpu/core/attrs.py`` (upstream Pilosa: the
BoltDB-backed AttrStore, attr.go:34-43, boltdb/attrstore.go:67-280):
attributes live on the host (they never touch the card), stored in sqlite3
(stdlib, transactional, one file like Bolt) or in memory, with a cache and
100-id block checksums for anti-entropy diffing
(boltdb/attrstore.go:218-280).  The file format and the checksums are the
JAX package's byte for byte, so a data directory it wrote opens here and
the two packages' blocks compare equal.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import threading
from typing import Dict, List, Optional, Tuple

ATTR_BLOCK_SIZE = 100  # ids per checksum block (attrBlockSize)
_CACHE_MAX = 8192


class AttrStore:
    """id -> {name: value} with block checksums.  Thread-safe."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.RLock()
        self._cache: Dict[int, dict] = {}
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._db = sqlite3.connect(path, check_same_thread=False)
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS attrs (id INTEGER PRIMARY KEY, doc TEXT NOT NULL)"
            )
            self._db.commit()
        else:
            self._db = None
            self._mem: Dict[int, dict] = {}

    def close(self):
        if self._db is not None:
            self._db.close()
            self._db = None

    # -- reads -------------------------------------------------------------

    def attrs(self, id: int) -> dict:
        with self._lock:
            cached = self._cache.get(id)
            if cached is not None:
                return dict(cached)
            m = self._read(id)
            self._cache_put(id, m)
            return dict(m)

    def _read(self, id: int) -> dict:
        if self._db is None:
            return dict(self._mem.get(id, {}))
        cur = self._db.execute("SELECT doc FROM attrs WHERE id=?", (id,))
        row = cur.fetchone()
        return json.loads(row[0]) if row else {}

    # -- writes ------------------------------------------------------------

    def set_attrs(self, id: int, m: dict):
        """Merge m into existing attrs; None values delete keys
        (attr.go SetAttrs semantics)."""
        with self._lock:
            self._set_locked(id, m)
            self._commit()

    def set_bulk_attrs(self, attrs_by_id: Dict[int, dict]):
        with self._lock:
            for id, m in attrs_by_id.items():
                self._set_locked(id, m)
            self._commit()

    def _set_locked(self, id: int, m: dict):
        cur = self._read(id)
        for k, v in m.items():
            if v is None:
                cur.pop(k, None)
            else:
                cur[k] = v
        if self._db is None:
            self._mem[id] = cur
        else:
            self._db.execute(
                "INSERT INTO attrs (id, doc) VALUES (?, ?) "
                "ON CONFLICT(id) DO UPDATE SET doc=excluded.doc",
                (id, json.dumps(cur, sort_keys=True)),
            )
        self._cache_put(id, cur)

    def _commit(self):
        if self._db is not None:
            self._db.commit()

    def _cache_put(self, id: int, m: dict):
        if len(self._cache) >= _CACHE_MAX:
            self._cache.clear()
        self._cache[id] = dict(m)

    # -- anti-entropy blocks (boltdb/attrstore.go:218-280) -----------------

    def _all_ids(self) -> List[int]:
        if self._db is None:
            return sorted(i for i, m in self._mem.items() if m)
        cur = self._db.execute("SELECT id FROM attrs ORDER BY id")
        return [r[0] for r in cur.fetchall()]

    def blocks(self) -> List[Tuple[int, bytes]]:
        """(block_id, checksum) over 100-id blocks of attribute data."""
        with self._lock:
            out: List[Tuple[int, bytes]] = []
            cur_block = None
            h = None
            for id in self._all_ids():
                m = self._read(id)
                if not m:
                    continue
                blk = id // ATTR_BLOCK_SIZE
                if blk != cur_block:
                    if cur_block is not None:
                        out.append((cur_block, h.digest()))
                    cur_block = blk
                    h = hashlib.blake2b(digest_size=16)
                h.update(id.to_bytes(8, "big"))
                h.update(json.dumps(m, sort_keys=True).encode())
            if cur_block is not None:
                out.append((cur_block, h.digest()))
            return out

    def block_data(self, block_id: int) -> Dict[int, dict]:
        """All id -> attrs in one block (for the AttrDiff RPC)."""
        with self._lock:
            lo = block_id * ATTR_BLOCK_SIZE
            hi = lo + ATTR_BLOCK_SIZE
            out = {}
            for id in self._all_ids():
                if lo <= id < hi:
                    m = self._read(id)
                    if m:
                        out[id] = m
            return out
