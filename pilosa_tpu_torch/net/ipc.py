"""Binary IPC framing for the process-per-core serving mode.

A copy of ``pilosa_tpu/net/ipc.py`` (stdlib only): a frame of the port
and one of the reference are the same bytes, so either package's worker
can read the other's device owner.

Worker processes (net/worker.py) own HTTP accept/parse/decode/encode
and forward ALREADY-DECODED work to the single device-owner process
(net/procserver.py) over an AF_UNIX socket as compact binary frames —
no JSON on the hot path, one length-prefixed frame per message:

    u32 length | u8 type | payload (length-1 bytes)

All integers are big-endian.  Strings are u32-length-prefixed UTF-8;
byte blobs are u32-length-prefixed raw.  The hot QUERY/RESULT_FAST
pair is pure ``struct`` packing; the generic HTTP passthrough carries
its (small) header dict as JSON inside the binary frame.

Frame types:

====================  =========  =========================================
``HELLO``             w -> e     worker id + pid, sent once after the
                                 worker's TCP listener is live (so a
                                 HELLO implies the port is accepting)
``QUERY``             w -> e     one decoded POST /index/{i}/query:
                                 flags, index, PQL text, tenant, trace
                                 ids, optional shard list
``HTTP``              w -> e     generic route passthrough (method,
                                 target, headers JSON, body)
``RESPONSE``          e -> w     rendered (status, content-type, payload)
``RESULT_FAST``       e -> w     structured query results the WORKER
                                 encodes to JSON (net/wire.py fast
                                 path): ints and TopN (id, count) pairs
``GETSTATS``          e -> w     scrape-time request for the worker's
                                 metrics registry
``STATS``             w -> e     rss bytes + Prometheus exposition text
``SHUTDOWN``          e -> w     drain in-flight requests, then exit
====================  =========  =========================================

Request ids are per-worker-connection u64s minted by whichever side
initiates (workers for QUERY/HTTP, the engine for GETSTATS); the two
id spaces never meet, so no coordination is needed.
"""

from __future__ import annotations

import select
import struct
import threading
from typing import List, Optional, Tuple

HELLO = 1
QUERY = 2
HTTP = 3
RESPONSE = 4
RESULT_FAST = 5
GETSTATS = 6
STATS = 7
SHUTDOWN = 8

# QUERY flag bits.
F_PROFILE = 1
F_REMOTE = 2
F_COLUMN_ATTRS = 4
F_EXCL_ROW_ATTRS = 8
F_EXCL_COLUMNS = 16
F_HAS_SHARDS = 32

# RESULT_FAST per-result kinds.
K_INT = 0
K_PAIRS = 1

_U32 = struct.Struct("!I")
_U64 = struct.Struct("!Q")
_I64 = struct.Struct("!q")
_U16 = struct.Struct("!H")
_PAIR = struct.Struct("!qq")


def pack_str(s: Optional[str]) -> bytes:
    b = (s or "").encode("utf-8")
    return _U32.pack(len(b)) + b


def pack_bytes(b: bytes) -> bytes:
    return _U32.pack(len(b)) + b


class Cursor:
    """Sequential reader over one frame payload."""

    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u16(self) -> int:
        (v,) = _U16.unpack_from(self.buf, self.off)
        self.off += 2
        return v

    def u32(self) -> int:
        (v,) = _U32.unpack_from(self.buf, self.off)
        self.off += 4
        return v

    def u64(self) -> int:
        (v,) = _U64.unpack_from(self.buf, self.off)
        self.off += 8
        return v

    def i64(self) -> int:
        (v,) = _I64.unpack_from(self.buf, self.off)
        self.off += 8
        return v

    def str(self) -> str:
        return self.bytes().decode("utf-8")

    def bytes(self) -> bytes:
        n = self.u32()
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b


def send_frame(sock, lock: threading.Lock, ftype: int, payload: bytes = b""):
    """One frame, written atomically under ``lock`` (frames from the
    engine's pool threads and completion callbacks interleave on the
    same worker socket)."""
    frame = _U32.pack(len(payload) + 1) + bytes([ftype]) + payload
    with lock:
        sock.sendall(frame)


def recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError (peer gone)."""
    parts = []
    while n:
        chunk = sock.recv(min(n, 1 << 18))
        if not chunk:
            raise ConnectionError("ipc peer closed")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def read_frame(sock) -> Tuple[int, Cursor]:
    """(type, payload cursor) for the next frame on ``sock``."""
    (length,) = _U32.unpack(recv_exact(sock, 4))
    body = recv_exact(sock, length)
    return body[0], Cursor(body[1:])


class FrameReader:
    """Buffered frame reader: ONE ``recv`` syscall delivers as many
    frames as the kernel has queued.  Syscalls dominate the naive
    2-recvs-per-frame loop on sandboxed kernels (where each syscall is
    several microseconds), and under load the peer's sender coalesces
    frames into large writes — so the hot path here is a pure
    buffer slice, no syscall at all."""

    __slots__ = ("sock", "_buf", "_off")

    RECV_CHUNK = 1 << 18

    def __init__(self, sock):
        self.sock = sock
        self._buf = bytearray()
        self._off = 0

    def read(self) -> Tuple[int, Cursor]:
        while True:
            frame = self.next_buffered()
            if frame is not None:
                return frame
            chunk = self.sock.recv(self.RECV_CHUNK)
            if not chunk:
                raise ConnectionError("ipc peer closed")
            self._buf += chunk

    def next_buffered(self) -> Optional[Tuple[int, Cursor]]:
        """The next fully-buffered frame, or None — never a syscall.
        The event-driven sides (worker reactor callback, engine IPC IO
        thread) alternate ``fill()`` with a drain of this."""
        have = len(self._buf) - self._off
        if have >= 4:
            (length,) = _U32.unpack_from(self._buf, self._off)
            if have >= 4 + length:
                start = self._off + 4
                body = bytes(self._buf[start : start + length])
                self._off = start + length
                # Compact once consumed past half the buffer so the
                # backlog can't grow without bound.
                if self._off > (1 << 20) or self._off == len(self._buf):
                    del self._buf[: self._off]
                    self._off = 0
                return body[0], Cursor(body[1:])
        return None

    def fill(self) -> bool:
        """Nonblocking pull of whatever the kernel has queued (the
        socket must be in nonblocking mode).  False means the peer
        closed; True means the buffer holds everything available."""
        while True:
            try:
                chunk = self.sock.recv(self.RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                return True
            except OSError:
                return False
            if not chunk:
                return False
            self._buf += chunk
            if len(chunk) < self.RECV_CHUNK:
                return True

    def buffered(self) -> bool:
        """A COMPLETE frame is already in the buffer (the next read()
        needs no syscall) — the reader's drain-then-flush loops use
        this to bound their response-cork window."""
        have = len(self._buf) - self._off
        if have < 4:
            return False
        (length,) = _U32.unpack_from(self._buf, self._off)
        return have >= 4 + length


class FrameSender:
    """Flat-combining frame writer: the calling thread appends its
    frame and, if no other thread is mid-send, drains EVERYTHING queued
    in one ``sendall``.  No dedicated thread — a per-frame cross-thread
    wakeup costs a GIL switch interval (~5 ms worst case), which
    measured far worse than the syscall it saved.  When completion
    threads DO contend (a fused batch resolving K results while the
    reader answers memo hits), the loser's frame rides the winner's
    next ``sendall`` — bursts coalesce into single syscalls with zero
    handoffs.  FIFO order is preserved (appends under one lock, one
    drainer at a time)."""

    def __init__(self, sock, name: str = "ipc-send"):
        self.sock = sock
        self._plock = threading.Lock()  # guards _pending / _closed / _cork
        self._slock = threading.Lock()  # the single-drainer send lock
        self._pending: list = []
        self._cork = 0
        self._closed = False

    def send(self, ftype: int, payload: bytes = b""):
        frame = _U32.pack(len(payload) + 1) + bytes([ftype]) + payload
        with self._plock:
            if self._closed:
                raise ConnectionError("ipc sender closed")
            self._pending.append(frame)
            if self._cork > 0:
                # Corked: the burst owner's uncork() flushes everything
                # queued in ONE sendall.  On this class of host a
                # syscall costs ~15 µs — per-frame sends are the
                # dominant IPC cost, not bytes.
                return
        self._flush()

    def cork(self):
        """Suspend flushing (nestable): frames queue until uncork().
        Burst producers — the worker reactor during one event-loop
        iteration, the engine reader while frames remain buffered —
        cork so the whole burst rides a single ``sendall``."""
        with self._plock:
            self._cork += 1

    def uncork(self):
        with self._plock:
            self._cork -= 1
            flush = self._cork == 0 and bool(self._pending)
        if flush:
            self._flush()

    def _flush(self):
        while True:
            if not self._slock.acquire(blocking=False):
                # Another thread is mid-send: its drain loop (or its
                # post-release re-check) picks our frame up.
                return
            try:
                with self._plock:
                    if self._cork > 0:
                        return  # burst in progress: uncork() flushes
                    batch = self._pending
                    self._pending = []
                if batch:
                    try:
                        self._send_all(
                            batch[0] if len(batch) == 1 else b"".join(batch)
                        )
                    except OSError:
                        with self._plock:
                            self._closed = True
                            self._pending = []
                        return
            finally:
                self._slock.release()
            # A frame appended while we were sending (its owner failed
            # the acquire) must not strand: re-check after release.
            with self._plock:
                if not self._pending or self._closed:
                    return

    def _send_all(self, data: bytes):
        """sendall that survives a NONBLOCKING socket (the event-driven
        sides put the IPC socket in nonblocking mode for their reads):
        ``socket.sendall`` loses track of partial progress when it
        raises EAGAIN, so write manually and poll for writability."""
        mv = memoryview(data)
        off = 0
        while off < len(mv):
            try:
                off += self.sock.send(mv[off:])
            except (BlockingIOError, InterruptedError):
                select.select([], [self.sock], [], 1.0)

    def close(self):
        with self._plock:
            self._closed = True
            self._pending = []


# -- typed payload packing ---------------------------------------------------


def pack_hello(wid: int, pid: int) -> bytes:
    return _U32.pack(wid) + _U32.pack(pid)


def pack_query(
    req_id: int,
    flags: int,
    index: str,
    query: str,
    tenant: str,
    trace_id: Optional[str],
    span_id: Optional[str],
    shards: Optional[List[int]],
) -> bytes:
    if shards is not None:
        flags |= F_HAS_SHARDS
    out = bytearray(_U64.pack(req_id))
    out.append(flags)
    out += pack_str(index)
    out += pack_str(query)
    out += pack_str(tenant)
    out += pack_str(trace_id)
    out += pack_str(span_id)
    if shards is not None:
        out += _U32.pack(len(shards))
        out += struct.pack(f"!{len(shards)}Q", *[int(s) for s in shards])
    return bytes(out)


def unpack_query(cur: Cursor) -> dict:
    req_id = cur.u64()
    flags = cur.u8()
    doc = {
        "req_id": req_id,
        "flags": flags,
        "index": cur.str(),
        "query": cur.str(),
        "tenant": cur.str(),
        "trace_id": cur.str(),
        "span_id": cur.str(),
        "shards": None,
    }
    if flags & F_HAS_SHARDS:
        n = cur.u32()
        doc["shards"] = list(
            struct.unpack_from(f"!{n}Q", cur.buf, cur.off)
        )
        cur.off += 8 * n
    return doc


def pack_http(
    req_id: int, method: str, target: str, headers_json: bytes, body: bytes
) -> bytes:
    return (
        _U64.pack(req_id)
        + pack_str(method)
        + pack_str(target)
        + pack_bytes(headers_json)
        + pack_bytes(body)
    )


def unpack_http(cur: Cursor) -> dict:
    return {
        "req_id": cur.u64(),
        "method": cur.str(),
        "target": cur.str(),
        "headers_json": cur.bytes(),
        "body": cur.bytes(),
    }


def pack_response(req_id: int, status: int, ctype: str, payload: bytes) -> bytes:
    return (
        _U64.pack(req_id) + _U16.pack(status) + pack_str(ctype)
        + pack_bytes(payload)
    )


def unpack_response(cur: Cursor) -> Tuple[int, int, str, bytes]:
    return cur.u64(), cur.u16(), cur.str(), cur.bytes()


def pack_result_fast(req_id: int, trace_id: Optional[str], results) -> bytes:
    """``results`` as produced by ``wire.fast_result_values``: a list
    whose entries are ints or lists of (id, count) int pairs."""
    out = bytearray(_U64.pack(req_id))
    out += pack_str(trace_id)
    out += _U32.pack(len(results))
    for r in results:
        if isinstance(r, int):
            out.append(K_INT)
            out += _I64.pack(r)
        else:
            out.append(K_PAIRS)
            out += _U32.pack(len(r))
            for i, c in r:
                out += _PAIR.pack(i, c)
    return bytes(out)


def unpack_result_fast(cur: Cursor) -> Tuple[int, Optional[str], list]:
    req_id = cur.u64()
    trace_id = cur.str() or None
    n = cur.u32()
    results: list = []
    for _ in range(n):
        kind = cur.u8()
        if kind == K_INT:
            results.append(cur.i64())
        else:
            m = cur.u32()
            pairs = []
            for _ in range(m):
                (i, c) = _PAIR.unpack_from(cur.buf, cur.off)
                cur.off += 16
                pairs.append((i, c))
            results.append(pairs)
    return req_id, trace_id, results


def pack_stats(req_id: int, rss_bytes: int, exposition: bytes) -> bytes:
    return _U64.pack(req_id) + _U64.pack(rss_bytes) + pack_bytes(exposition)


def unpack_stats(cur: Cursor) -> Tuple[int, int, bytes]:
    return cur.u64(), cur.u64(), cur.bytes()


def rss_bytes() -> int:
    """Current RSS of this process (the pilosa_process_rss_bytes gauge).
    /proc is authoritative on Linux; ru_maxrss (a high-water mark, in
    KiB) is the portable fallback."""
    try:
        with open("/proc/self/statm") as f:
            import os

            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # noqa: BLE001 — telemetry must not raise
            return 0
