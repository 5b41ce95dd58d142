"""Key translation: string key <-> uint64 id, bidirectional.

The port's copy of ``pilosa_tpu/core/translate.py`` (upstream Pilosa:
TranslateStore/TranslateFile, translate.go:39-53, 55-432): ids are assigned
from a per-index (columns) or per-(index, field) (rows) autoincrement
sequence starting at 1 and recorded in an append-only log file.  The log and
its sidecar are the JAX package's formats byte for byte, so a ``.keys`` file
that package wrote opens here with the same ids.

The log is a length-prefixed binary format (one flushed record per append):
    [u8 type][u32 len(index)][index][u32 len(field)][field]
    [u32 n][ (u64 id, u32 len(key), key) * n ]
(type 1 = column insert, 2 = row insert.)

Key bytes are never copied onto the heap: lookups read them straight out of
the mmap'd log (translate.go:854-1008).  Each keymap is a robin-hood
open-addressing table of (hash32, pair-offset) numpy slots plus a dense
id->offset array, about 12 bytes a slot and 8 bytes an id whatever the key
length.  The table is checkpointed to a sidecar ``<log>.idx`` with a
log-offset watermark, so reopening a store replays only the log tail
written since the last checkpoint.

Replicas streaming the primary's log (the reference's ``reader`` /
``apply_log``) belong to the cluster, which is not ported (ROADMAP.md
Queue 1 item 15).
"""

from __future__ import annotations

import io
import mmap
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

LOG_INSERT_COLUMN = 1
LOG_INSERT_ROW = 2

_IDX_MAGIC = b"PTIX2\n"
_LOAD_NUM, _LOAD_DEN = 7, 10  # resize above 70% occupancy


class TranslateError(Exception):
    pass


def _hash(kb: bytes) -> int:
    """32-bit key hash; 0 is reserved for empty slots (hashKey,
    translate.go:996-1002 reserves 0 the same way)."""
    return zlib.crc32(kb) or 1


class _LogView:
    """Append-only log with random-access reads.  File-backed logs mmap
    the on-disk bytes (remapped lazily as the file grows); in-memory
    stores keep one bytearray.  Appends flush before the index stores an
    offset, so every indexed offset is readable."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.size = 0
        self._buf = bytearray() if path is None else None
        self._file = None
        self._read_f = None
        self._mm = None
        self._mm_len = 0
        # Guards _mm/_mm_len against concurrent readers.
        self._read_lock = threading.Lock()

    def open(self) -> int:
        """Open file-backed storage; returns existing log size."""
        if self.path is None:
            return 0
        self.size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        self._file = open(self.path, "ab")
        self._read_f = open(self.path, "rb")
        return self.size

    def close(self):
        with self._read_lock:
            if self._mm is not None:
                self._mm.close()
                self._mm = None
                self._mm_len = 0
            for f in (self._file, self._read_f):
                if f is not None:
                    f.close()
            self._file = self._read_f = None

    def append(self, data: bytes) -> int:
        off = self.size
        if self._file is not None:
            self._file.write(data)
            self._file.flush()
        else:
            self._buf.extend(data)
        self.size += len(data)
        return off

    def read(self, off: int, n: int) -> bytes:
        if n <= 0:
            return b""
        if self._buf is not None:
            return bytes(self._buf[off : off + n])
        with self._read_lock:
            if off + n > self._mm_len:
                self._remap()
            if self._mm is None or off + n > self._mm_len:
                return b""  # beyond the flushed bytes (empty/torn log)
            return self._mm[off : off + n]

    def buffer(self):
        """The log's bytes as one buffer to slice (``keys_by_ids``): the
        bytearray in memory, else the map of the whole file, remapped when
        the file grew past it."""
        if self._buf is not None:
            return self._buf
        with self._read_lock:
            if self.size > self._mm_len:
                self._remap()
            return b"" if self._mm is None else self._mm

    def _remap(self):
        # The replaced map is NOT closed here: a slice copy may still be
        # in flight under this lock's previous holder on another map
        # object; dropping the reference lets GC close it safely.
        self._read_f.seek(0, os.SEEK_END)
        flen = self._read_f.tell()
        if flen:
            self._mm = mmap.mmap(self._read_f.fileno(), 0, access=mmap.ACCESS_READ)
            self._mm_len = flen


class _RHIndex:
    """Robin-hood open-addressing index over pair records in the log
    (translate.go:854-1008): slots hold (hash32, pair offset+1); key
    bytes stay in the log.  id -> offset is a dense numpy array (ids are
    assigned sequentially from 1)."""

    __slots__ = ("log", "seq", "n", "hashes", "offs", "id_off")

    def __init__(self, log: _LogView, capacity: int = 256):
        self.log = log
        self.seq = 0
        self.n = 0
        self.hashes = np.zeros(capacity, dtype=np.uint32)
        self.offs = np.zeros(capacity, dtype=np.uint64)
        self.id_off = np.zeros(256, dtype=np.uint64)  # id -> pair offset+1

    # pair record at off: [u64 id][u32 klen][key]
    def _pair_key(self, off: int) -> bytes:
        hdr = self.log.read(off, 12)
        (klen,) = struct.unpack_from("<I", hdr, 8)
        return self.log.read(off + 12, klen)

    def get(self, kb: bytes) -> int:
        """id for key, or 0."""
        h = _hash(kb)
        mask = len(self.hashes) - 1
        pos = h & mask
        dist = 0
        while True:
            eh = int(self.hashes[pos])
            if eh == 0:
                return 0
            edist = (pos - (eh & mask)) & mask
            if dist > edist:
                return 0  # robin-hood invariant: key would have displaced
            if eh == h:
                off = int(self.offs[pos]) - 1
                if self._pair_key(off) == kb:
                    (id,) = struct.unpack("<Q", self.log.read(off, 8))
                    return id
            pos = (pos + 1) & mask
            dist += 1

    def key_by_id(self, id: int) -> Optional[bytes]:
        if not (0 < id < len(self.id_off)):
            return None
        off = int(self.id_off[id])
        if off == 0:
            return None
        return self._pair_key(off - 1)

    def keys_by_ids(self, ids) -> List[str]:
        """The key of each id ("" for an id with none): ``key_by_id`` for
        many ids at once, with one buffer for all the log reads."""
        ids = np.asarray(ids, dtype=np.int64)
        offs = np.zeros(ids.size, dtype=np.int64)
        ok = (ids > 0) & (ids < len(self.id_off))
        offs[ok] = self.id_off[ids[ok]].astype(np.int64)
        buf = self.log.buffer()
        unpack = struct.unpack_from
        out = []
        for off in (offs - 1).tolist():
            if off < 0:
                out.append("")
                continue
            (klen,) = unpack("<I", buf, off + 8)
            out.append(buf[off + 12: off + 12 + klen].decode())
        return out

    def insert(self, id: int, kb: bytes, pair_off: int):
        """Record a brand-new (id, key at pair_off); caller has checked
        the key is absent."""
        if self.n + 1 > len(self.hashes) * _LOAD_NUM // _LOAD_DEN:
            self._grow()
        self._slot_insert(_hash(kb), pair_off + 1)
        self.n += 1
        if id >= len(self.id_off):
            new = np.zeros(
                max(len(self.id_off) * 2, 1 << (id.bit_length() + 1)),
                dtype=np.uint64,
            )
            new[: len(self.id_off)] = self.id_off
            self.id_off = new
        self.id_off[id] = pair_off + 1
        if id > self.seq:
            self.seq = id

    def _slot_insert(self, h: int, off1: int):
        mask = len(self.hashes) - 1
        pos = h & mask
        dist = 0
        while True:
            eh = int(self.hashes[pos])
            if eh == 0:
                self.hashes[pos] = h
                self.offs[pos] = off1
                return
            edist = (pos - (eh & mask)) & mask
            if edist < dist:  # displace the richer element
                self.hashes[pos], h = h, eh
                self.offs[pos], off1 = off1, int(self.offs[pos])
                dist = edist
            pos = (pos + 1) & mask
            dist += 1

    def _grow(self):
        old_h, old_o = self.hashes, self.offs
        cap = len(old_h) * 2
        self.hashes = np.zeros(cap, dtype=np.uint32)
        self.offs = np.zeros(cap, dtype=np.uint64)
        for i in np.nonzero(old_h)[0]:
            self._slot_insert(int(old_h[i]), int(old_o[i]))


def _encode_entry(
    typ: int, index: str, field: str, pairs: List[Tuple[int, str]]
) -> bytes:
    buf = io.BytesIO()
    ib = index.encode()
    fb = field.encode()
    buf.write(struct.pack("<BII", typ, len(ib), len(fb)))
    buf.write(ib)
    buf.write(fb)
    buf.write(struct.pack("<I", len(pairs)))
    for id, key in pairs:
        kb = key.encode() if isinstance(key, str) else key
        buf.write(struct.pack("<QI", id, len(kb)))
        buf.write(kb)
    return buf.getvalue()


def _decode_entries(data: bytes, start: int = 0):
    """Yield (typ, index, field, [(id, key, pair_offset)], end_offset);
    stops at truncation.  pair_offset is relative to ``data[0]`` —
    callers add the log offset of ``data``."""
    off = start
    n = len(data)
    while off + 9 <= n:
        typ, ilen, flen = struct.unpack_from("<BII", data, off)
        p = off + 9
        if p + ilen + flen + 4 > n:
            break
        index = data[p : p + ilen].decode()
        p += ilen
        field = data[p : p + flen].decode()
        p += flen
        (count,) = struct.unpack_from("<I", data, p)
        p += 4
        pairs = []
        ok = True
        for _ in range(count):
            if p + 12 > n:
                ok = False
                break
            id, klen = struct.unpack_from("<QI", data, p)
            if p + 12 + klen > n:
                ok = False
                break
            pairs.append((id, data[p + 12 : p + 12 + klen].decode(), p))
            p += 12 + klen
        if not ok:
            break
        yield typ, index, field, pairs, p
        off = p


class TranslateFile:
    """On-disk (or in-memory) translate store with one writer
    (translate.go:55).

    Reopen cost: the sidecar checkpoint restores every index with one
    bulk array read, then only the log tail past the checkpoint's
    watermark is replayed (``replayed_bytes`` reports how much — the
    bounded-startup contract the reference gets from its mmap design)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.RLock()
        self._log = _LogView(path)
        self._cols: Dict[str, _RHIndex] = {}
        self._rows: Dict[Tuple[str, str], _RHIndex] = {}
        self.replayed_bytes = 0

    def open(self):
        if self.path is None:
            return
        disk = self._log.open()
        watermark = self._load_sidecar()
        if watermark > disk:  # log truncated since checkpoint: rebuild
            self._cols.clear()
            self._rows.clear()
            watermark = 0
        if watermark < disk:
            tail = self._log.read(watermark, disk - watermark)
            self.replayed_bytes = len(tail)
            for typ, index, field, pairs, _ in _decode_entries(tail):
                self._apply(typ, index, field, pairs, base_off=watermark)

    def close(self):
        self.checkpoint()
        self._log.close()

    # -- sidecar checkpoint -------------------------------------------------

    def _sidecar_path(self) -> Optional[str]:
        return None if self.path is None else self.path + ".idx"

    def checkpoint(self):
        """Atomically persist every index + the covered log offset."""
        sp = self._sidecar_path()
        if sp is None:
            return
        with self._lock:
            tmp = sp + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_IDX_MAGIC)
                maps = [(0, idx, "", m) for idx, m in self._cols.items()] + [
                    (1, idx, fld, m) for (idx, fld), m in self._rows.items()
                ]
                f.write(struct.pack("<QI", self._log.size, len(maps)))
                for kind, idx, fld, m in maps:
                    ib, fb = idx.encode(), fld.encode()
                    f.write(
                        struct.pack(
                            "<BII QQ QQ",
                            kind, len(ib), len(fb),
                            m.seq, m.n,
                            len(m.hashes), len(m.id_off),
                        )
                    )
                    f.write(ib)
                    f.write(fb)
                    f.write(m.hashes.tobytes())
                    f.write(m.offs.tobytes())
                    f.write(m.id_off.tobytes())
            os.replace(tmp, sp)

    def _load_sidecar(self) -> int:
        """Restore indexes from the checkpoint; returns the log watermark
        it covers (0 = none/corrupt -> full replay)."""
        sp = self._sidecar_path()
        if sp is None or not os.path.exists(sp):
            return 0
        try:
            with open(sp, "rb") as f:
                if f.read(len(_IDX_MAGIC)) != _IDX_MAGIC:
                    return 0
                watermark, nmaps = struct.unpack("<QI", f.read(12))
                for _ in range(nmaps):
                    kind, ilen, flen, seq, n, cap, idcap = struct.unpack(
                        "<BII QQ QQ", f.read(41)
                    )
                    idx = f.read(ilen).decode()
                    fld = f.read(flen).decode()
                    m = _RHIndex(self._log, capacity=1)
                    m.seq, m.n = seq, n
                    m.hashes = np.frombuffer(
                        f.read(cap * 4), dtype=np.uint32
                    ).copy()
                    m.offs = np.frombuffer(f.read(cap * 8), dtype=np.uint64).copy()
                    m.id_off = np.frombuffer(
                        f.read(idcap * 8), dtype=np.uint64
                    ).copy()
                    if kind == 0:
                        self._cols[idx] = m
                    else:
                        self._rows[(idx, fld)] = m
            return watermark
        except (OSError, struct.error, ValueError):
            self._cols.clear()
            self._rows.clear()
            return 0

    # -- log append / apply -------------------------------------------------

    def _apply(self, typ, index, field, pairs, base_off):
        """Index pairs already present in the log at base_off+rel."""
        m = self._map_for(typ, index, field)
        for id, key, rel in pairs:
            kb = key.encode()
            if m.get(kb) == 0:
                m.insert(id, kb, base_off + rel)
            elif id > m.seq:
                m.seq = id

    def _map_for(self, typ, index, field) -> _RHIndex:
        if typ == LOG_INSERT_COLUMN:
            return self._cols.setdefault(index, _RHIndex(self._log))
        return self._rows.setdefault((index, field), _RHIndex(self._log))

    def _append_new(self, typ: int, index: str, field: str, m, new_pairs):
        """Log + index freshly assigned (id, key bytes) pairs."""
        data = _encode_entry(typ, index, field, new_pairs)
        entry_off = self._log.append(data)
        # Recover each pair's offset from the encode layout.
        rel = 9 + len(index.encode()) + len(field.encode()) + 4
        for id, key in new_pairs:
            kb = key.encode() if isinstance(key, str) else key
            m.insert(id, kb, entry_off + rel)
            rel += 12 + len(kb)

    def size(self) -> int:
        return self._log.size

    # -- TranslateStore interface (translate.go:39-53) ---------------------

    def _translate(self, typ, index, field, keys: List[str]) -> List[int]:
        with self._lock:
            m = self._map_for(typ, index, field)
            out = [m.get(k.encode()) for k in keys]
            if all(out):
                return out
            new_pairs = []
            seen: Dict[str, int] = {}
            for i, (k, id) in enumerate(zip(keys, out)):
                if id:
                    continue
                id = seen.get(k)
                if id is None:
                    m.seq += 1
                    id = m.seq
                    seen[k] = id
                    new_pairs.append((id, k))
                out[i] = id
            self._append_new(typ, index, field, m, new_pairs)
            return out

    def translate_columns_to_uint64(self, index: str, keys: List[str]) -> List[int]:
        return self._translate(LOG_INSERT_COLUMN, index, "", keys)

    def translate_column_to_string(self, index: str, id: int) -> str:
        with self._lock:
            m = self._cols.get(index)
            if m is None:
                return ""
            kb = m.key_by_id(id)
            return "" if kb is None else kb.decode()

    def translate_columns_to_strings(self, index: str, ids) -> List[str]:
        """``translate_column_to_string`` of many ids under one lock, the
        keys of a Row result's columns."""
        with self._lock:
            m = self._cols.get(index)
            return [""] * len(ids) if m is None else m.keys_by_ids(ids)

    def translate_rows_to_uint64(
        self, index: str, field: str, keys: List[str]
    ) -> List[int]:
        return self._translate(LOG_INSERT_ROW, index, field, keys)

    def translate_row_to_string(self, index: str, field: str, id: int) -> str:
        with self._lock:
            m = self._rows.get((index, field))
            if m is None:
                return ""
            kb = m.key_by_id(id)
            return "" if kb is None else kb.decode()
