"""Pilosa-roaring file-format codec (byte-compatible with the reference).

Format spec derived from upstream Pilosa's roaring/roaring.go:30-65 (header
constants), :812-883 (WriteTo), :886-974 (unmarshalPilosaRoaring) and
:3353-3420 (op-log records):

    [u32 cookie = 12348 | version<<16]
    [u32 keyN]
    keyN * [u64 key][u16 containerType][u16 n-1]      # descriptive headers
    keyN * [u32 absolute file offset]                 # offset table
    container payloads:
        array : n * u16 (sorted low-16 values)
        bitmap: 1024 * u64 (2^16 bits)
        run   : u16 runCount, runCount * (u16 start, u16 last)   # inclusive
    op-log (appended after the snapshot section, replayed on load):
        repeated [u8 opType][u64 value][u32 fnv1a32 of first 9 bytes]

All integers little-endian.  In-memory representation here is intentionally
NOT a container tree: a bitmap is a sorted, unique ``np.uint64`` vector, which
vectorizes cleanly and converts to/from the dense device layout.  Container
types exist only at the serialization boundary, chosen with the reference's
``Optimize`` thresholds (roaring.go:768,1594-1612, ArrayMaxSize=4096,
runMaxSize=2048).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 12348
VERSION = 0
COOKIE = MAGIC | (VERSION << 16)
HEADER_BASE_SIZE = 8

CONTAINER_ARRAY = 1
CONTAINER_BITMAP = 2
CONTAINER_RUN = 3

ARRAY_MAX_SIZE = 4096
RUN_MAX_SIZE = 2048

OP_TYPE_ADD = 0
OP_TYPE_REMOVE = 1
OP_SIZE = 13  # 1 type + 8 value + 4 checksum

_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)


def fnv1a32(data: bytes) -> int:
    """FNV-1a 32-bit hash (op-log record checksum)."""
    h = int(_FNV_OFFSET)
    for b in data:
        h = ((h ^ b) * int(_FNV_PRIME)) & 0xFFFFFFFF
    return h


def _runs_of(lows: np.ndarray) -> np.ndarray:
    """Collapse a sorted u16 vector into inclusive [start, last] run pairs."""
    if lows.size == 0:
        return np.empty((0, 2), dtype=np.uint16)
    breaks = np.flatnonzero(np.diff(lows.astype(np.int64)) != 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [lows.size - 1]))
    return np.stack([lows[starts], lows[ends]], axis=1)


def _num_runs(lows: np.ndarray) -> int:
    if lows.size == 0:
        return 0
    return 1 + int(np.count_nonzero(np.diff(lows.astype(np.int64)) != 1))


def container_type_for(lows: np.ndarray) -> int:
    """Pick the serialized container type with the reference's Optimize rule."""
    n = lows.size
    runs = _num_runs(lows)
    if runs <= RUN_MAX_SIZE and runs <= n // 2:
        return CONTAINER_RUN
    if n < ARRAY_MAX_SIZE:
        return CONTAINER_ARRAY
    return CONTAINER_BITMAP


def _lows_to_words(lows: np.ndarray) -> np.ndarray:
    """Sorted u16 values -> 1024 x u64 bitmap words (little-endian bit order)."""
    bits = np.zeros(1 << 16, dtype=np.uint8)
    bits[lows] = 1
    return np.packbits(bits, bitorder="little").view("<u8")


def _words_to_lows(words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint16)


def _native():
    """The C++ codec (native/roaring_codec.cpp), or None without one."""
    from .. import native

    return native.load()


def serialize(values: np.ndarray) -> bytes:
    """Serialize a sorted unique u64 vector to pilosa-roaring bytes: the
    C++ codec where it loads, else ``_serialize_py`` (the same bytes)."""
    values = np.ascontiguousarray(values, dtype=np.uint64)
    lib = _native()
    if lib is not None:
        import ctypes

        ptr = values.ctypes.data_as(ctypes.c_void_p)
        size = lib.rc_serialize(ptr, values.size, None, 0)
        if size >= 0:
            out = np.empty(size, dtype=np.uint8)
            if lib.rc_serialize(ptr, values.size, out.ctypes.data_as(ctypes.c_void_p),
                                size) == size:
                return out.tobytes()
    return _serialize_py(values)


def _serialize_py(values: np.ndarray) -> bytes:
    headers, payloads = [], []
    _containers(values, headers, payloads)
    return _assemble(headers, payloads)


def _containers(values: np.ndarray, headers: list, payloads: list) -> None:
    """Append the containers of a sorted unique u64 vector: their
    ``(key, type, n)`` headers and payload bytes."""
    values = np.asarray(values, dtype=np.uint64)
    highs = (values >> np.uint64(16)).astype(np.uint64)
    lows_all = (values & np.uint64(0xFFFF)).astype(np.uint16)
    keys, starts = np.unique(highs, return_index=True)
    bounds = np.append(starts, values.size)
    for i, key in enumerate(keys):
        lows = lows_all[bounds[i] : bounds[i + 1]]
        ctype = container_type_for(lows)
        if ctype == CONTAINER_RUN:
            runs = _runs_of(lows)
            payload = struct.pack("<H", runs.shape[0]) + runs.astype("<u2").tobytes()
        elif ctype == CONTAINER_ARRAY:
            payload = lows.astype("<u2").tobytes()
        else:
            payload = _lows_to_words(lows).astype("<u8").tobytes()
        headers.append((int(key), ctype, lows.size))
        payloads.append(payload)


def _assemble(headers: list, payloads: list) -> bytes:
    key_n = len(headers)
    out = bytearray()
    out += struct.pack("<II", COOKIE, key_n)
    out += b"".join(struct.pack("<QHH", key, ctype, n - 1) for key, ctype, n in headers)
    offset = HEADER_BASE_SIZE + key_n * (8 + 2 + 2 + 4)
    offs = np.cumsum([offset] + [len(p) for p in payloads[:-1]], dtype=np.int64) \
        if payloads else np.empty(0, dtype=np.int64)
    out += offs.astype("<u4").tobytes()
    out += b"".join(payloads)
    return bytes(out)


# Containers per 2^20-bit fragment row: a row's words are 16 containers
# of 1024 words each, and a storage key is ``row << 4 | container``.
ROW_CONTAINERS = 16
_WORDS_PER_CONTAINER = 1024


def serialize_rows(rows) -> bytes:
    """``serialize`` of a fragment's rows, byte for byte, without their
    positions: ``rows`` yields ``(row, words, positions)`` in ascending
    row order, ``words`` a dense ``uint64[16384]`` row or None, else
    ``positions`` the row's sorted in-row ``uint32`` positions.  A dense
    row's container types come from its words' popcounts and run counts
    (the number of 1 bits whose lower neighbour is 0), so a bitmap
    container is copied out as it is."""
    headers, payloads = [], []
    sparse = []

    def flush_sparse():
        if sparse:
            _containers(np.concatenate(sparse), headers, payloads)
            sparse.clear()

    for row, words, positions in rows:
        base = np.uint64(row) << np.uint64(20)
        if words is None:
            if positions is not None and positions.size:
                sparse.append(positions.astype(np.uint64) + base)
            continue
        flush_sparse()
        w = np.ascontiguousarray(words, dtype=np.uint64).reshape(
            ROW_CONTAINERS, _WORDS_PER_CONTAINER)
        counts = np.bitwise_count(w).sum(axis=1, dtype=np.int64)
        below = np.zeros_like(w)
        below[:, 1:] = w[:, :-1] >> np.uint64(63)
        starts = w & ~((w << np.uint64(1)) | below)
        runs = np.bitwise_count(starts).sum(axis=1, dtype=np.int64)
        key0 = int(row) * ROW_CONTAINERS
        for c in np.flatnonzero(counts).tolist():
            n, r = int(counts[c]), int(runs[c])
            if r <= RUN_MAX_SIZE and r <= n // 2:
                # A run container straight from the words: each run's first
                # bit (its lower neighbour 0) and last bit (its upper
                # neighbour 0), never the container's positions.
                above = np.zeros_like(w[c])
                above[:-1] = w[c, 1:] << np.uint64(63)
                ends = w[c] & ~((w[c] >> np.uint64(1)) | above)
                pairs = np.stack([_words_to_lows(starts[c]), _words_to_lows(ends)], axis=1)
                headers.append((key0 + c, CONTAINER_RUN, n))
                payloads.append(struct.pack("<H", r) + pairs.astype("<u2").tobytes())
            elif n < ARRAY_MAX_SIZE:
                _containers(_words_to_lows(w[c]).astype(np.uint64)
                            + np.uint64((key0 + c) << 16), headers, payloads)
            else:
                headers.append((key0 + c, CONTAINER_BITMAP, n))
                payloads.append(w[c].astype("<u8").tobytes())
    flush_sparse()
    return _assemble(headers, payloads)


class _Decoded:
    __slots__ = ("values", "op_n", "ops")

    def __init__(self, values: np.ndarray, op_n: int, ops: list):
        self.values = values
        self.op_n = op_n
        self.ops = ops


# Official-roaring cookies (32-bit interchange format, also accepted by the
# reference's UnmarshalBinary, roaring.go:3819-3925).
OFFICIAL_COOKIE_NO_RUN = 12346
OFFICIAL_COOKIE = 12347


def deserialize(data: bytes) -> _Decoded:
    """Decode roaring bytes -> sorted unique u64 vector.

    Accepts both Pilosa's 64-bit format (cookie 12348, with op-log replay,
    mirroring unmarshalPilosaRoaring roaring.go:886-974) and the official
    32-bit roaring interchange format (cookies 12346/12347,
    roaring.go:3885-3925).  The C++ codec decodes where it loads, else
    the vectorized numpy decoder (``_deserialize_np``); corrupt data takes
    the numpy decoder too, for its error message.  The scalar
    ``_deserialize_py`` is the torn-tail recovery path.
    """
    lib = _native()
    if lib is not None and len(data) >= HEADER_BASE_SIZE:
        import ctypes

        cap = lib.rc_decoded_bound(data, len(data))
        if cap >= 0:
            out = np.empty(cap, dtype=np.uint64)
            op_n = ctypes.c_int64(0)
            count = lib.rc_deserialize(data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                                       cap, ctypes.byref(op_n))
            if count >= 0:
                return _Decoded(out[:count], int(op_n.value), [])
    return _deserialize_np(data)


# Descriptive-header record layout: [u64 key][u16 type][u16 n-1].
_HDR_DTYPE = np.dtype([("key", "<u8"), ("type", "<u2"), ("n", "<u2")])
# Op-log record layout: [u8 type][u64 value][u32 fnv1a32].
_OP_DTYPE = np.dtype(
    {
        "names": ["t", "v", "c"],
        "formats": ["u1", "<u8", "<u4"],
        "offsets": [0, 1, 9],
        "itemsize": OP_SIZE,
    }
)


def _expand_runs(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized multi-range expansion: concatenate
    ``arange(starts[i], starts[i]+lengths[i])`` for every run without a
    python loop (np.repeat + one global arange)."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    shifted = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    return np.repeat(starts - shifted, lengths) + np.arange(total)


def _header_table(data: bytes):
    """The pilosa format's header table: ``(key_n, keys, types, ns,
    offsets, off_end)``, or None for another cookie."""
    if len(data) < HEADER_BASE_SIZE:
        raise ValueError("roaring: data too small")
    magic, version = struct.unpack_from("<HH", data, 0)
    if magic != MAGIC:
        return None
    if version != VERSION:
        raise ValueError(f"roaring: wrong version {version}")
    key_n = struct.unpack_from("<I", data, 4)[0]
    hdr_end = HEADER_BASE_SIZE + 12 * key_n
    off_end = hdr_end + 4 * key_n
    if off_end > len(data):
        raise ValueError(
            f"roaring: truncated data: header table needs {off_end} bytes,"
            f" have {len(data)}"
        )
    hdr = np.frombuffer(data, dtype=_HDR_DTYPE, count=key_n, offset=HEADER_BASE_SIZE)
    offsets = np.frombuffer(data, dtype="<u4", count=key_n, offset=hdr_end)
    keys = hdr["key"].astype(np.uint64)
    types = hdr["type"]
    ns = hdr["n"].astype(np.int64) + 1
    return key_n, keys, types, ns, offsets, off_end


def _deserialize_np(data: bytes) -> _Decoded:
    """Vectorized decode of the pilosa format: ONE structured-dtype
    frombuffer for the whole header table, per-container numpy payload
    decode (array: zero-copy frombuffer; run: repeat/cumsum range
    expansion; bitmap: unpackbits), and a batch op-log replay
    (vectorized FNV-1a checksums + last-write-wins set algebra) — no
    per-byte python on any path a bulk import takes.  Official-format
    cookies delegate to ``_deserialize_official``; corruption raises
    the same ValueErrors as the scalar oracle."""
    table = _header_table(data)
    if table is None:
        return _deserialize_official(data)
    key_n, keys, types, ns, offsets, off_end = table

    # Group maximal runs of back-to-back ARRAY containers: a sparse
    # ingest batch (fewer than 4096 bits per 65k-key range) is nothing
    # but array containers laid out contiguously, so whole stretches of
    # the payload section decode as ONE u16 frombuffer + one repeat/or —
    # python executes per GROUP (≈ one per run/bitmap container plus
    # one), not per container.
    contig = np.zeros(key_n, dtype=bool)
    if key_n > 1:
        off64 = offsets.astype(np.int64)
        contig[1:] = (
            (types[1:] == CONTAINER_ARRAY)
            & (types[:-1] == CONTAINER_ARRAY)
            & (off64[1:] == off64[:-1] + ns[:-1] * 2)
        )
    group_starts = np.flatnonzero(~contig)
    group_bounds = np.append(group_starts, key_n)

    chunks = []
    ops_offset = off_end
    for g in range(len(group_starts)):
        i0, i1 = int(group_starts[g]), int(group_bounds[g + 1])
        ctype = int(types[i0])
        offset = int(offsets[i0])
        if offset >= len(data):
            raise ValueError(f"roaring: offset out of bounds: {offset}")
        if ctype == CONTAINER_ARRAY:
            total = int(ns[i0:i1].sum())
            end = offset + total * 2
            if end > len(data):
                raise ValueError("roaring: truncated data: array container")
            lows = np.frombuffer(
                data, dtype="<u2", count=total, offset=offset
            ).astype(np.uint64)
            chunks.append(
                np.repeat(keys[i0:i1] << np.uint64(16), ns[i0:i1]) | lows
            )
            ops_offset = end
            continue
        # Non-array groups are single containers by construction.
        n = int(ns[i0])
        if ctype == CONTAINER_RUN:
            if offset + 2 > len(data):
                raise ValueError("roaring: truncated data: run header")
            run_count = struct.unpack_from("<H", data, offset)[0]
            end = offset + 2 + run_count * 4
            if end > len(data):
                raise ValueError("roaring: truncated data: run container")
            runs = np.frombuffer(
                data, dtype="<u2", count=run_count * 2, offset=offset + 2
            ).reshape(run_count, 2).astype(np.int64)
            lows = _expand_runs(
                runs[:, 0], runs[:, 1] - runs[:, 0] + 1
            ).astype(np.uint64)
        elif ctype == CONTAINER_BITMAP:
            end = offset + 1024 * 8
            if end > len(data):
                raise ValueError("roaring: truncated data: bitmap container")
            words = np.frombuffer(data, dtype="<u8", count=1024, offset=offset)
            lows = _words_to_lows(words).astype(np.uint64)
        else:
            raise ValueError(f"roaring: unknown container type {ctype}")
        ops_offset = end
        chunks.append((keys[i0] << np.uint64(16)) | lows)

    values = (
        np.concatenate(chunks) if chunks else np.empty(0, dtype=np.uint64)
    )
    return _replay_ops_np(values, data, ops_offset)


class RowsDecoded:
    """A fragment body decoded by rows (``decode_rows``): ``rows[i]``'s
    dense words are ``words[i]``; ``positions`` holds the storage
    positions of every other row, sorted and unique."""

    __slots__ = ("rows", "words", "positions")

    def __init__(self, rows, words, positions):
        self.rows = rows
        self.words = words
        self.positions = positions

    def bits(self) -> int:
        return int(sum(int(np.bitwise_count(w).sum()) for w in self.words)) + \
            int(self.positions.size)

    def columns(self) -> np.ndarray:
        """The sorted unique in-row columns that any row sets."""
        cols = np.zeros(ROW_CONTAINERS * _WORDS_PER_CONTAINER, dtype=np.uint64)
        for w in self.words:
            cols |= w
        out = _words_to_lows32(cols)
        if self.positions.size:
            out = np.union1d(out, (self.positions & np.uint64((1 << 20) - 1)).astype(np.int64))
        return out


def _words_to_lows32(words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.int64)


def decode_rows(data: bytes, dense_over: int = ARRAY_MAX_SIZE):
    """Decode a pilosa-format fragment body by rows: every row of more
    than ``dense_over`` bits (the headers' counts; a row store keeps such
    a row dense) as a ``uint64[16384]`` word vector, its bitmap
    containers copied in and its other containers set bit by bit; every
    other row as storage positions.  So a dense body never expands into
    one u64 per set bit.  Returns None where there is nothing to gain or
    the body needs ``deserialize``: no such row, a non-empty op-log,
    another cookie.  Corruption raises the ValueErrors ``deserialize``
    raises."""
    table = _header_table(data)
    if table is None:
        return None
    key_n, keys, types, ns, offsets, off_end = table
    row_of = (keys >> np.uint64(4)).astype(np.int64)
    rows, inv = np.unique(row_of, return_inverse=True)
    dense_rows = rows[np.bincount(inv, weights=ns, minlength=rows.size) > dense_over]
    if not dense_rows.size:
        return None
    bad = np.flatnonzero(offsets >= len(data))
    if bad.size:
        raise ValueError(f"roaring: offset out of bounds: {int(offsets[bad[0]])}")
    last = key_n - 1
    ctype, off = int(types[last]), int(offsets[last])
    if ctype == CONTAINER_ARRAY:
        end = off + int(ns[last]) * 2
    elif ctype == CONTAINER_BITMAP:
        end = off + _WORDS_PER_CONTAINER * 8
    elif ctype == CONTAINER_RUN:
        if off + 2 > len(data):
            raise ValueError("roaring: truncated data: run header")
        end = off + 2 + struct.unpack_from("<H", data, off)[0] * 4
    else:
        raise ValueError(f"roaring: unknown container type {ctype}")
    if end != len(data):
        return None  # an op-log to replay (or a truncated tail): deserialize
    slot = np.searchsorted(dense_rows, row_of)
    slot[slot >= dense_rows.size] = 0
    in_dense = dense_rows[slot] == row_of
    mat = np.zeros((dense_rows.size, ROW_CONTAINERS * _WORDS_PER_CONTAINER), dtype=np.uint64)
    flat = mat.reshape(-1)
    in_row = np.uint64((1 << 20) - 1)

    def scatter(pos, slots):
        at = (pos & in_row).astype(np.int64) >> 6
        np.bitwise_or.at(flat, at + slots * mat.shape[1], np.uint64(1) << (pos & np.uint64(63)))

    # Every array container in one gather: its u16 values read bytewise.
    chunks = []
    arr = np.flatnonzero(types == CONTAINER_ARRAY)
    if arr.size:
        a_off, a_n = offsets[arr].astype(np.int64), ns[arr]
        if (a_off + 2 * a_n > len(data)).any():
            raise ValueError("roaring: truncated data: array container")
        first = np.concatenate(([0], np.cumsum(a_n)[:-1]))
        at = np.repeat(a_off - 2 * first, a_n) + 2 * np.arange(int(a_n.sum()))
        buf = np.frombuffer(data, dtype=np.uint8)
        lows = buf[at].astype(np.uint64) | (buf[at + 1].astype(np.uint64) << np.uint64(8))
        pos = (np.repeat(keys[arr], a_n) << np.uint64(16)) | lows
        dense = np.repeat(in_dense[arr], a_n)
        scatter(pos[dense], np.repeat(slot[arr], a_n)[dense])
        chunks.append(pos[~dense])
    for i in np.flatnonzero(types != CONTAINER_ARRAY).tolist():
        ctype, off = int(types[i]), int(offsets[i])
        if ctype == CONTAINER_BITMAP:
            if off + _WORDS_PER_CONTAINER * 8 > len(data):
                raise ValueError("roaring: truncated data: bitmap container")
            words = np.frombuffer(data, dtype="<u8", count=_WORDS_PER_CONTAINER, offset=off)
            if in_dense[i]:
                c = int(keys[i]) & (ROW_CONTAINERS - 1)
                mat[slot[i], c * _WORDS_PER_CONTAINER:(c + 1) * _WORDS_PER_CONTAINER] |= words
            else:
                chunks.append((keys[i] << np.uint64(16)) | _words_to_lows(words).astype(np.uint64))
        elif ctype == CONTAINER_RUN:
            if off + 2 > len(data):
                raise ValueError("roaring: truncated data: run header")
            run_count = struct.unpack_from("<H", data, off)[0]
            if off + 2 + run_count * 4 > len(data):
                raise ValueError("roaring: truncated data: run container")
            runs = np.frombuffer(data, dtype="<u2", count=run_count * 2,
                                 offset=off + 2).reshape(run_count, 2).astype(np.int64)
            if in_dense[i]:
                # The runs as the container's bits: +1 at each run's first
                # bit, -1 past its last, summed (never one position a bit).
                edge = np.zeros((1 << 16) + 1, dtype=np.int32)
                np.add.at(edge, runs[:, 0], 1)
                np.add.at(edge, runs[:, 1] + 1, -1)
                bits = (np.cumsum(edge[:-1]) > 0).astype(np.uint8)
                c = int(keys[i]) & (ROW_CONTAINERS - 1)
                mat[slot[i], c * _WORDS_PER_CONTAINER:(c + 1) * _WORDS_PER_CONTAINER] |= \
                    np.packbits(bits, bitorder="little").view("<u8")
            else:
                lows = _expand_runs(runs[:, 0], runs[:, 1] - runs[:, 0] + 1).astype(np.uint64)
                chunks.append((keys[i] << np.uint64(16)) | lows)
        else:
            raise ValueError(f"roaring: unknown container type {ctype}")
    positions = np.unique(np.concatenate(chunks)) if chunks else np.empty(0, dtype=np.uint64)
    return RowsDecoded(dense_rows.tolist(), list(mat), positions)


def _replay_ops_np(values: np.ndarray, data: bytes, ops_offset: int) -> _Decoded:
    """Batch op-log replay: checksum every record in one vectorized
    FNV-1a pass, then apply adds/removes with last-write-wins set
    algebra (for each value, only its LAST op decides membership —
    exactly what sequential replay computes)."""
    total = len(data) - ops_offset
    if total <= 0:
        return _Decoded(values, 0, [])
    n_ops = total // OP_SIZE
    if total % OP_SIZE:
        raise ValueError(
            f"roaring: op data out of bounds: len={total % OP_SIZE}"
        )
    raw = np.frombuffer(
        data, dtype=np.uint8, count=n_ops * OP_SIZE, offset=ops_offset
    ).reshape(n_ops, OP_SIZE)
    h = np.full(n_ops, _FNV_OFFSET, dtype=np.uint32)
    for k in range(9):
        h = (h ^ raw[:, k]) * _FNV_PRIME
    rec = np.frombuffer(
        data, dtype=_OP_DTYPE, count=n_ops, offset=ops_offset
    )
    bad = np.flatnonzero(h != rec["c"])
    if bad.size:
        i = int(bad[0])
        raise ValueError(
            f"roaring: op checksum mismatch: exp={int(h[i]):08x} "
            f"got={int(rec['c'][i]):08x}"
        )
    typs = rec["t"]
    bad_t = np.flatnonzero(typs > OP_TYPE_REMOVE)
    if bad_t.size:
        raise ValueError(
            f"roaring: invalid op type {int(typs[int(bad_t[0])])}"
        )
    vals = rec["v"].astype(np.uint64)
    # Keep only the LAST op per value (later ops win).
    _, first_in_rev = np.unique(vals[::-1], return_index=True)
    keep = n_ops - 1 - first_in_rev
    last_v, last_t = vals[keep], typs[keep]
    removes = last_v[last_t == OP_TYPE_REMOVE]
    adds = last_v[last_t == OP_TYPE_ADD]
    if removes.size:
        values = np.setdiff1d(values, removes, assume_unique=True)
    if adds.size:
        values = np.union1d(values, adds)
    return _Decoded(values, n_ops, [])


def _deserialize_py(data: bytes, recover: bool = False):
    """Decode; with ``recover`` returns (decoded, valid_len) and stops the
    op-log replay at the first corrupt/partial op instead of raising.
    All corruption surfaces as ValueError (struct bounds errors included)."""
    try:
        return _deserialize_py_inner(data, recover)
    except struct.error as e:
        raise ValueError(f"roaring: truncated data: {e}") from e


def _deserialize_py_inner(data: bytes, recover: bool = False):
    if len(data) < HEADER_BASE_SIZE:
        raise ValueError("roaring: data too small")
    magic = struct.unpack_from("<H", data, 0)[0]
    version = struct.unpack_from("<H", data, 2)[0]
    if magic != MAGIC:
        dec = _deserialize_official(data)
        return (dec, len(data)) if recover else dec
    if version != VERSION:
        raise ValueError(f"roaring: wrong version {version}")
    key_n = struct.unpack_from("<I", data, 4)[0]

    headers = []
    pos = HEADER_BASE_SIZE
    for _ in range(key_n):
        key, ctype, n_minus_1 = struct.unpack_from("<QHH", data, pos)
        headers.append((key, ctype, n_minus_1 + 1))
        pos += 12

    chunks = []
    ops_offset = pos + 4 * key_n
    for i, (key, ctype, n) in enumerate(headers):
        offset = struct.unpack_from("<I", data, pos + 4 * i)[0]
        if offset >= len(data):
            raise ValueError(f"roaring: offset out of bounds: {offset}")
        if ctype == CONTAINER_RUN:
            run_count = struct.unpack_from("<H", data, offset)[0]
            runs = np.frombuffer(
                data, dtype="<u2", count=run_count * 2, offset=offset + 2
            ).reshape(run_count, 2)
            pieces = [
                np.arange(int(s), int(e) + 1, dtype=np.uint32)
                for s, e in runs.astype(np.int64)
            ]
            lows = (
                np.concatenate(pieces).astype(np.uint64)
                if pieces
                else np.empty(0, dtype=np.uint64)
            )
            ops_offset = offset + 2 + run_count * 4
        elif ctype == CONTAINER_ARRAY:
            lows = np.frombuffer(data, dtype="<u2", count=n, offset=offset).astype(
                np.uint64
            )
            ops_offset = offset + n * 2
        elif ctype == CONTAINER_BITMAP:
            words = np.frombuffer(data, dtype="<u8", count=1024, offset=offset)
            lows = _words_to_lows(words).astype(np.uint64)
            ops_offset = offset + 1024 * 8
        else:
            raise ValueError(f"roaring: unknown container type {ctype}")
        chunks.append((np.uint64(key) << np.uint64(16)) | lows)

    values = (
        np.concatenate(chunks) if chunks else np.empty(0, dtype=np.uint64)
    )

    # Replay the op-log (indexed, not re-sliced: op logs can be large).
    ops = []
    view = memoryview(data)
    pos = ops_offset
    while pos < len(data):
        try:
            typ, value = parse_op(view[pos : pos + OP_SIZE])
        except ValueError:
            if recover:
                break  # torn tail: keep the intact prefix
            raise
        ops.append((typ, value))
        pos += OP_SIZE
    if ops:
        values = apply_ops(values, ops)
    dec = _Decoded(values, len(ops), ops)
    if recover:
        return dec, pos
    return dec


def _deserialize_official(data: bytes) -> _Decoded:
    """Decode the official 32-bit roaring format (u16 keys; runs stored as
    (start, length); offset table only in the no-run layout)."""
    cookie = struct.unpack_from("<I", data, 0)[0]
    pos = 4
    if cookie == OFFICIAL_COOKIE_NO_RUN:
        key_n = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        is_run = [False] * key_n
        have_runs = False
    elif cookie & 0xFFFF == OFFICIAL_COOKIE:
        key_n = (cookie >> 16) + 1
        nbytes = (key_n + 7) // 8
        run_bits = data[pos : pos + nbytes]
        is_run = [bool(run_bits[i // 8] & (1 << (i % 8))) for i in range(key_n)]
        pos += nbytes
        have_runs = True
    else:
        raise ValueError(f"roaring: invalid magic number {cookie & 0xFFFF}")

    headers = []
    for i in range(key_n):
        key, n_minus_1 = struct.unpack_from("<HH", data, pos)
        n = n_minus_1 + 1
        if is_run[i]:
            ctype = CONTAINER_RUN
        elif n < ARRAY_MAX_SIZE:
            ctype = CONTAINER_ARRAY
        else:
            ctype = CONTAINER_BITMAP
        headers.append((key, ctype, n))
        pos += 4

    if not have_runs:
        offsets = [
            struct.unpack_from("<I", data, pos + 4 * i)[0] for i in range(key_n)
        ]
    else:
        # No offset table; containers are packed back-to-back.
        offsets = None

    chunks = []
    for i, (key, ctype, n) in enumerate(headers):
        offset = offsets[i] if offsets is not None else pos
        if ctype == CONTAINER_RUN:
            run_count = struct.unpack_from("<H", data, offset)[0]
            runs = np.frombuffer(
                data, dtype="<u2", count=run_count * 2, offset=offset + 2
            ).reshape(run_count, 2)
            pieces = [
                np.arange(int(s), int(s) + int(l) + 1, dtype=np.uint32)
                for s, l in runs.astype(np.int64)
            ]
            lows = (
                np.concatenate(pieces).astype(np.uint64)
                if pieces
                else np.empty(0, dtype=np.uint64)
            )
            size = 2 + run_count * 4
        elif ctype == CONTAINER_ARRAY:
            lows = np.frombuffer(data, dtype="<u2", count=n, offset=offset).astype(
                np.uint64
            )
            size = n * 2
        else:
            words = np.frombuffer(data, dtype="<u8", count=1024, offset=offset)
            lows = _words_to_lows(words).astype(np.uint64)
            size = 1024 * 8
        if offsets is None:
            pos = offset + size
        chunks.append((np.uint64(key) << np.uint64(16)) | lows)

    values = np.concatenate(chunks) if chunks else np.empty(0, dtype=np.uint64)
    return _Decoded(values, 0, [])


def deserialize_recover(data: bytes):
    """Decode with torn-write recovery: op-log replay stops at the first
    corrupt or partial op (checksum mismatch, bad type, short tail) and
    returns ``(decoded, valid_len)`` where ``valid_len`` is the byte
    length of the intact prefix — the caller truncates the file there,
    like the reference's replay behavior for a torn tail.  Errors in the
    snapshot section itself still raise (there is nothing safe to keep)."""
    return _deserialize_py(data, recover=True)


def check_bytes(data: bytes) -> list:
    """Structural validation of a serialized bitmap — the ctl-check /
    Bitmap.Check equivalent (roaring.go Check :1015, ctl/check.go :47).
    Returns a list of problem strings; empty means the file is sound.
    Validates: header magic/version, container types, offset bounds,
    per-container invariants (array sorted-unique, runs ordered and
    non-overlapping, bitmap popcount == header count), key ordering, and
    op-log checksums/types incl. a torn trailing op."""
    problems = []
    if len(data) < HEADER_BASE_SIZE:
        return [f"data too small: {len(data)} bytes"]
    magic = struct.unpack_from("<H", data, 0)[0]
    version = struct.unpack_from("<H", data, 2)[0]
    if magic != MAGIC:
        try:
            _deserialize_official(data)
            return []
        except Exception as e:
            return [f"bad magic {magic} and not official roaring: {e}"]
    if version != VERSION:
        return [f"wrong version {version}"]
    key_n = struct.unpack_from("<I", data, 4)[0]
    headers_end = HEADER_BASE_SIZE + 12 * key_n + 4 * key_n
    if headers_end > len(data):
        return [f"header table truncated: need {headers_end}, have {len(data)}"]

    prev_key = -1
    ops_offset = headers_end
    for i in range(key_n):
        hpos = HEADER_BASE_SIZE + 12 * i
        key, ctype, n_minus_1 = struct.unpack_from("<QHH", data, hpos)
        n = n_minus_1 + 1
        if key <= prev_key:
            problems.append(f"container {i}: key {key} out of order")
        prev_key = key
        offset = struct.unpack_from(
            "<I", data, HEADER_BASE_SIZE + 12 * key_n + 4 * i
        )[0]
        if offset > len(data):
            problems.append(f"container {i}: offset {offset} out of bounds")
            continue
        if ctype == CONTAINER_ARRAY:
            end = offset + n * 2
            if end > len(data):
                problems.append(f"container {i}: array data truncated")
                continue
            lows = np.frombuffer(data, dtype="<u2", count=n, offset=offset)
            if n > 1 and not np.all(lows[:-1] < lows[1:]):
                problems.append(f"container {i}: array not sorted-unique")
        elif ctype == CONTAINER_RUN:
            if offset + 2 > len(data):
                problems.append(f"container {i}: run header truncated")
                continue
            run_count = struct.unpack_from("<H", data, offset)[0]
            end = offset + 2 + run_count * 4
            if end > len(data):
                problems.append(f"container {i}: run data truncated")
                continue
            runs = np.frombuffer(
                data, dtype="<u2", count=run_count * 2, offset=offset + 2
            ).reshape(run_count, 2)
            total = 0
            last_end = -1
            for s, e in runs.astype(np.int64):
                if e < s:
                    problems.append(f"container {i}: run [{s},{e}] inverted")
                elif s <= last_end:
                    problems.append(
                        f"container {i}: run [{s},{e}] overlaps/unsorted"
                    )
                last_end = max(last_end, int(e))
                total += int(e) - int(s) + 1
            if total != n:
                problems.append(
                    f"container {i}: run cardinality {total} != header {n}"
                )
        elif ctype == CONTAINER_BITMAP:
            end = offset + 1024 * 8
            if end > len(data):
                problems.append(f"container {i}: bitmap data truncated")
                continue
            words = np.frombuffer(data, dtype="<u8", count=1024, offset=offset)
            got = (
                int(np.sum(np.bitwise_count(words)))
                if hasattr(np, "bitwise_count")
                else int(np.sum(np.unpackbits(words.view(np.uint8))))
            )
            if got != n:
                problems.append(
                    f"container {i}: bitmap popcount {got} != header {n}"
                )
        else:
            problems.append(f"container {i}: unknown type {ctype}")
            continue
        ops_offset = max(ops_offset, end)

    pos = ops_offset
    view = memoryview(data)
    while pos < len(data):
        if pos + OP_SIZE > len(data):
            problems.append(
                f"op-log: torn trailing op at byte {pos} "
                f"({len(data) - pos} of {OP_SIZE} bytes)"
            )
            break
        try:
            parse_op(view[pos : pos + OP_SIZE])
        except ValueError as e:
            problems.append(f"op-log: {e} at byte {pos}")
            break
        pos += OP_SIZE
    return problems


def parse_op(buf) -> tuple:
    if len(buf) < OP_SIZE:
        raise ValueError(f"roaring: op data out of bounds: len={len(buf)}")
    typ = buf[0]
    value = struct.unpack_from("<Q", buf, 1)[0]
    chk = struct.unpack_from("<I", buf, 9)[0]
    want = fnv1a32(bytes(buf[:9]))
    if chk != want:
        raise ValueError(f"roaring: op checksum mismatch: exp={want:08x} got={chk:08x}")
    if typ not in (OP_TYPE_ADD, OP_TYPE_REMOVE):
        raise ValueError(f"roaring: invalid op type {typ}")
    return typ, value


def encode_op(typ: int, value: int) -> bytes:
    head = struct.pack("<BQ", typ, value)
    return head + struct.pack("<I", fnv1a32(head))


def apply_ops(values: np.ndarray, ops) -> np.ndarray:
    """Replay (type, value) ops over a sorted u64 vector."""
    vals = set(values.tolist())
    for typ, value in ops:
        if typ == OP_TYPE_ADD:
            vals.add(value)
        else:
            vals.discard(value)
    return np.array(sorted(vals), dtype=np.uint64)
