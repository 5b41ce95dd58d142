"""Event-loop HTTP serving tier: non-blocking reactor + admission control.

The threaded front end (net/server.py, stdlib ``ThreadingHTTPServer``)
pays one OS thread per connection: at the concurrency the batch pipeline
wants (hundreds of live connections feeding fused device batches), the
scheduler churn of ~640 handler threads was the serving bottleneck of
the JAX package's node.  This module replaces the front end with a
reactor:

* **One event loop per acceptor** (``selectors``-based), N acceptors
  behind ``SO_REUSEPORT`` as the scale-out knob (``reactors=``; default
  1: one loop per process, as the reference runs it).
* **Zero-copy-leaning parse**: requests are accumulated into one
  per-connection buffer and sliced with memoryviews — no per-line
  ``readline`` round trips, no per-request file objects, no thread
  handoff to read a socket.
* **Direct batcher feed**: the decoded query goes straight into the
  batch pipeline's accumulate stage on the reactor thread
  (``Handler.handle_async`` -> ``api.query_async`` ->
  ``CountBatcher.submit_async``), so concurrent arrivals from ALL live
  connections coalesce into the same fused device batches — the batch
  pipeline fed from N connections instead of per-connection trickles.
  Completion callbacks (batch collect workers) marshal rendered
  responses back to the loop over a wake pipe; responses are written in
  per-connection request order (HTTP pipelining semantics identical to
  the threaded server's ``_ResponseSequencer``).
* **Blocking routes** (imports, sync queries, federation scrapes, debug
  endpoints) run on an elastic bounded worker pool — the reactor never
  blocks, and the pool's bounded submit queue is the third admission
  queue (accept backlog, per-connection parse buffer, submit queue).
* **Admission control** (net/admission.py): a shed decision costs one
  parsed header block and answers 429/503 BEFORE any engine work, with
  per-tenant weighted-fair isolation.

The threaded server remains available (``PILOSA_TPU_SERVER_BACKEND=
threaded`` or config ``[server] backend``) as the differential oracle;
both servers share the same ``Handler`` route table.  docs/serving.md
is the operator guide.

A copy of ``pilosa_tpu/net/aserver.py``, with the tenant ledger's shed
accounting (``util/plans.py``) and the process-mode hooks: worker
processes watch their engine link on the loop (``register_external*``)
and cork its frames per loop pass (``loop_hooks``).
"""

from __future__ import annotations

import collections
import json
import os
import selectors
import socket
import ssl as ssl_mod
import sys
import threading
import time
from http.client import responses as STATUS_REASONS
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..util import plans as plans_mod
from ..util.stats import (
    METRIC_SERVER_CONNECTIONS,
    METRIC_SERVER_CONNECTIONS_TOTAL,
    METRIC_SERVER_REQUESTS,
    REGISTRY,
)
from .admission import AdmissionController, tenant_of

RECV_CHUNK = 262144
MAX_HEADER_BYTES = 65536
LISTEN_BACKLOG = 512
# Pending responses per connection before the reactor stops READING it:
# the same per-connection memory bound as the threaded sequencer's
# MAX_PENDING, enforced as backpressure instead of a blocked thread.
MAX_PENDING = 64

# Probe + observability routes exempt from admission control: a liveness
# probe answered 503-overload would make the orchestrator restart a node
# that is functioning correctly under load — amplifying the overload the
# admission layer exists to survive.  These also run inline on the
# reactor if the worker pool is saturated (cheap, and they must answer).
ADMISSION_EXEMPT = frozenset({"/healthz", "/readyz", "/metrics"})


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class _BlockingPool:
    """Elastic bounded thread pool for blocking route handlers.

    Threads spawn on demand up to ``max_workers`` (a thread parked in a
    device readback is cheap; an eagerly-spawned one is pure overhead
    on the tier-1 path) and exit after ``idle_ttl`` without work.  The
    submit queue is BOUNDED: a full queue is an admission signal
    (shed 503), never an unbounded backlog."""

    IDLE_TTL = 30.0

    def __init__(self, max_workers: int, queue_depth: int):
        import queue as queue_mod

        self.max_workers = max(1, max_workers)
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(1, queue_depth))
        self._lock = threading.Lock()
        self._workers = 0
        self._idle = 0
        self._stopped = False
        self._queue_mod = queue_mod

    def submit(self, fn) -> bool:
        """Enqueue ``fn``; False when the bounded queue is full (the
        caller sheds)."""
        try:
            self._q.put_nowait(fn)
        except self._queue_mod.Full:
            return False
        with self._lock:
            spawn = (
                not self._stopped
                and self._idle == 0
                and self._workers < self.max_workers
            )
            if spawn:
                self._workers += 1
        if spawn:
            threading.Thread(
                target=self._worker, daemon=True, name="http-pool"
            ).start()
        return True

    def _worker(self):
        while True:
            with self._lock:
                self._idle += 1
            try:
                fn = self._q.get(timeout=self.IDLE_TTL)
            except self._queue_mod.Empty:
                with self._lock:
                    self._idle -= 1
                    # Lost-wakeup guard: a job enqueued while this (the
                    # last idle) worker was timing out would otherwise
                    # strand in the queue with zero workers until some
                    # future submit spawns one.  submit()'s no-spawn
                    # read of _idle and this exit decision serialize on
                    # _lock, so re-checking the queue here closes the
                    # race in every interleaving.
                    if not self._q.empty():
                        continue
                    self._workers -= 1
                return
            with self._lock:
                self._idle -= 1
            if fn is None:
                with self._lock:
                    self._workers -= 1
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — a worker must survive anything
                pass

    def stop(self):
        with self._lock:
            self._stopped = True
            n = self._workers
        for _ in range(n):
            try:
                self._q.put_nowait(None)
            except self._queue_mod.Full:
                break


class _Conn:
    """One client connection owned by exactly one reactor."""

    __slots__ = (
        "sock", "addr", "rbuf", "state", "need", "head",
        "next_slot", "next_write", "ready", "out",
        "inflight", "paused", "stop_reading", "closed",
        "last_recv", "last_progress", "want_write", "handshaking",
        "tls_want_write", "registered",
    )

    HEAD = 0
    BODY = 1

    def __init__(self, sock, addr, handshaking=False):
        self.sock = sock
        self.addr = addr
        self.rbuf = bytearray()
        self.state = _Conn.HEAD
        self.need = 0           # body bytes required once headers parsed
        self.head = None        # (method, target, version, headers) during BODY
        self.next_slot = 0
        self.next_write = 0
        self.ready = {}         # slot -> rendered response bytes
        self.out = collections.deque()  # ordered rendered bytes to write
        self.inflight = 0
        self.paused = False
        self.stop_reading = False
        self.closed = False
        now = time.monotonic()
        self.last_recv = now
        self.last_progress = now
        self.want_write = False
        self.handshaking = handshaking
        self.tls_want_write = False
        self.registered = True

    def mid_request(self) -> bool:
        """A request is partially read (slow-loris exposure window)."""
        return self.state == _Conn.BODY or len(self.rbuf) > 0


class _Reactor(threading.Thread):
    """One event loop: accept + read + parse + dispatch + write for its
    listening socket's connections.  All connection state is owned by
    this thread; other threads interact only via ``call_soon``."""

    def __init__(self, srv: "AsyncHTTPServer", lsock: socket.socket, name: str):
        super().__init__(daemon=True, name=name)
        self.srv = srv
        self.lsock = lsock
        self.sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._pending: "collections.deque" = collections.deque()
        self._signaled = False
        self.conns: set = set()
        self._stopping = False
        self._last_sweep = time.monotonic()
        self._tid: Optional[int] = None
        # (sock, callback) pairs registered before start(): extra
        # readable fds the loop watches alongside its connections —
        # process-mode workers hook their engine link in here so ONE
        # thread owns client sockets AND the IPC socket (no cross-
        # thread handoff, no wake syscalls, no GIL ping-pong on the
        # query path).
        self._externals: list = []

    def add_external(self, sock, callback):
        """Watch ``sock`` for readability and run ``callback`` on the
        loop thread.  Must be called before the reactor starts."""
        self._externals.append((sock, callback))

    def register_external_soon(self, sock, callback):
        """Thread-safe dynamic variant of ``add_external``: the
        registration runs on the loop thread (selectors are not safe to
        mutate mid-select from outside).  The process-mode device-owner
        hooks (re)spawned worker links in with this."""
        def _do():
            try:
                sock.setblocking(False)
                self.sel.register(sock, selectors.EVENT_READ, ("ext", callback))
            except (KeyError, ValueError, OSError):
                pass
        self.call_soon(_do)

    def unregister_external_soon(self, sock):
        def _do():
            try:
                self.sel.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass
        self.call_soon(_do)

    # -- cross-thread marshalling ------------------------------------------

    def call_soon(self, fn):
        """Queue ``fn`` to run on the loop (thread-safe; deque append is
        GIL-atomic).  One wake byte per quiet period, not per call —
        and none at all from the loop thread itself (its next select
        uses a zero timeout while callbacks are pending)."""
        self._pending.append(fn)
        if threading.get_ident() == self._tid:
            return
        if not self._signaled:
            self._signaled = True
            try:
                self._wake_w.send(b"x")
            except OSError:
                pass  # buffer full = a wake is already pending

    def stop(self):
        self._stopping = True
        self.call_soon(lambda: None)

    # -- loop ---------------------------------------------------------------

    def run(self):
        self._tid = threading.get_ident()
        self.sel.register(self.lsock, selectors.EVENT_READ, ("accept", None))
        self.sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        for s, cb in self._externals:
            s.setblocking(False)
            self.sel.register(s, selectors.EVENT_READ, ("ext", cb))
        try:
            while not self._stopping:
                events = self.sel.select(
                    timeout=0.0 if self._pending else 0.5
                )
                self._signaled = False
                while self._pending:
                    try:
                        fn = self._pending.popleft()
                    except IndexError:
                        break
                    try:
                        fn()
                    except Exception:  # noqa: BLE001
                        pass
                # Batch hooks (process mode): the worker's engine link
                # is corked across this round's readable-event drain, so
                # a parsed pipelined burst rides ONE sendall to the
                # device-owner (net/ipc.FrameSender.cork).  Only the
                # read/parse phase is corked — the completion callbacks
                # above ran uncorked, so the engine receives the
                # previous burst's stragglers while this one parses.
                hooks = self.srv.loop_hooks
                if hooks is not None:
                    hooks[0]()
                try:
                    for key, mask in events:
                        kind, conn = key.data
                        if kind == "ext":
                            try:
                                conn()  # external-fd callback
                            except Exception:  # noqa: BLE001 — the
                                # callback owns its own error handling;
                                # never let it take down the loop.
                                pass
                            continue
                        try:
                            if kind == "accept":
                                self._accept()
                            elif kind == "wake":
                                try:
                                    while self._wake_r.recv(4096):
                                        pass
                                except (BlockingIOError, OSError):
                                    pass
                            else:
                                if conn.handshaking:
                                    self._handshake(conn)
                                    continue
                                if mask & selectors.EVENT_WRITE:
                                    self._flush(conn)
                                if mask & selectors.EVENT_READ and not conn.closed:
                                    self._readable(conn)
                        except Exception:  # noqa: BLE001 — one bad connection
                            # must never take down the loop.
                            if conn is not None:
                                self._close(conn)
                finally:
                    if hooks is not None:
                        hooks[1]()
                now = time.monotonic()
                if now - self._last_sweep >= 0.25:
                    self._last_sweep = now
                    self._sweep(now)
        finally:
            for conn in list(self.conns):
                self._close(conn)
            try:
                self.sel.close()
            except Exception:  # noqa: BLE001
                pass
            for s in (self._wake_r, self._wake_w):
                try:
                    s.close()
                except OSError:
                    pass

    # -- accept / TLS -------------------------------------------------------

    def _accept(self):
        while True:
            try:
                s, addr = self.lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            s.setblocking(False)
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            handshaking = False
            if self.srv.ssl_context is not None:
                try:
                    s = self.srv.ssl_context.wrap_socket(
                        s, server_side=True, do_handshake_on_connect=False
                    )
                except (ssl_mod.SSLError, OSError) as e:
                    sys.stderr.write(f"tls wrap error from {addr}: {e!r}\n")
                    s.close()
                    continue
                handshaking = True
            conn = _Conn(s, addr, handshaking=handshaking)
            self.conns.add(conn)
            self.srv._c_accepted.inc()
            self.sel.register(s, selectors.EVENT_READ, ("conn", conn))

    def _handshake(self, conn: _Conn):
        try:
            conn.sock.do_handshake()
        except ssl_mod.SSLWantReadError:
            self._interest(conn, read=True, write=False)
            return
        except ssl_mod.SSLWantWriteError:
            self._interest(conn, read=False, write=True)
            return
        except (ssl_mod.SSLError, OSError) as e:
            # Plain-HTTP probes / scanners: one line, not a traceback.
            sys.stderr.write(f"tls handshake error from {conn.addr}: {e!r}\n")
            self._close(conn)
            return
        conn.handshaking = False
        self._interest(conn, read=True, write=bool(conn.out))

    # -- selector interest --------------------------------------------------

    def _interest(self, conn: _Conn, read: bool, write: bool):
        """Set the selector mask.  A paused connection with nothing to
        write is UNREGISTERED entirely — leaving READ on would re-fire
        (level-triggered) and grow the buffer a hog client keeps
        blasting; with it off, unread bytes back up into the kernel
        window and the client stalls (TCP backpressure)."""
        if conn.closed:
            return
        mask = 0
        if read:
            mask |= selectors.EVENT_READ
        if write:
            mask |= selectors.EVENT_WRITE
        conn.want_write = write
        try:
            if mask == 0:
                if conn.registered:
                    self.sel.unregister(conn.sock)
                    conn.registered = False
            elif conn.registered:
                self.sel.modify(conn.sock, mask, ("conn", conn))
            else:
                self.sel.register(conn.sock, mask, ("conn", conn))
                conn.registered = True
        except (KeyError, ValueError, OSError):
            pass

    # -- read / parse -------------------------------------------------------

    def _readable(self, conn: _Conn):
        if conn.paused or conn.stop_reading:
            self._interest(conn, read=False, write=bool(conn.out))
            return
        got_any = False
        while True:
            try:
                chunk = conn.sock.recv(RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except ssl_mod.SSLWantReadError:
                break
            except ssl_mod.SSLWantWriteError:
                break
            except (ConnectionResetError, OSError):
                self._close(conn)
                return
            if not chunk:
                self._close(conn)
                return
            got_any = True
            conn.rbuf += chunk
            if len(chunk) < RECV_CHUNK and not (
                isinstance(conn.sock, ssl_mod.SSLSocket) and conn.sock.pending()
            ):
                break
        if got_any:
            conn.last_recv = time.monotonic()
            self._parse(conn)

    def _parse(self, conn: _Conn):
        """Drain complete requests out of the connection buffer.  Stops
        on an incomplete request, a paused connection (too many pending
        responses), or ``stop_reading`` (Connection: close seen)."""
        while not conn.closed and not conn.stop_reading:
            if conn.paused:
                self._interest(conn, read=False, write=bool(conn.out))
                return
            buf = conn.rbuf
            if conn.state == _Conn.HEAD:
                end = buf.find(b"\r\n\r\n")
                if end < 0:
                    if len(buf) > MAX_HEADER_BYTES:
                        self._inline_error(conn, 431, "header block too large")
                        conn.stop_reading = True
                    return
                try:
                    method, target, version, headers = self._parse_head(
                        memoryview(buf)[:end]
                    )
                except ValueError as e:
                    self._inline_error(conn, 400, str(e))
                    conn.stop_reading = True
                    return
                del conn.rbuf[: end + 4]
                te = headers.get("Transfer-Encoding", "")
                if te and "chunked" in te.lower():
                    self._inline_error(conn, 411, "chunked bodies unsupported")
                    conn.stop_reading = True
                    return
                try:
                    clen = int(headers.get("Content-Length") or 0)
                except ValueError:
                    self._inline_error(conn, 400, "bad Content-Length")
                    conn.stop_reading = True
                    return
                if clen < 0:
                    self._inline_error(conn, 400, "bad Content-Length")
                    conn.stop_reading = True
                    return
                if clen > self.srv.max_body_bytes:
                    # Rejected BEFORE buffering: the body is never read.
                    self._inline_error(
                        conn,
                        413,
                        f"body of {clen} bytes exceeds the "
                        f"{self.srv.max_body_bytes}-byte limit",
                    )
                    conn.stop_reading = True
                    return
                if "100-continue" in headers.get("Expect", "").lower() and (
                    conn.next_write == conn.next_slot and not conn.out
                ):
                    # Interim 100 only when no earlier response is
                    # pending: an out-of-band write would jump the
                    # per-connection response order (an interim reply
                    # must follow the previous request's FINAL
                    # response).  When skipped, RFC 7231 lets the
                    # client send the body after a short wait — and the
                    # final response still arrives in order.
                    self._enqueue_raw(conn, b"HTTP/1.1 100 Continue\r\n\r\n")
                conn.state = _Conn.BODY
                conn.need = clen
                conn.head = (method, target, version, headers)
                continue
            # BODY
            if len(conn.rbuf) < conn.need:
                return
            body = bytes(memoryview(conn.rbuf)[: conn.need])
            del conn.rbuf[: conn.need]
            conn.state = _Conn.HEAD
            method, target, version, headers = conn.head
            conn.head = None
            self._dispatch(conn, method, target, version, headers, body)

    @staticmethod
    def _parse_head(head: memoryview):
        """Request line + headers from one memoryview over the buffer.
        Header names are normalized to Title-Case so the shared Handler
        (which reads "Content-Type" etc.) sees the same dict shape the
        threaded server's email.Message produced."""
        text = bytes(head)
        lines = text.split(b"\r\n")
        parts = lines[0].split()
        if len(parts) != 3:
            raise ValueError("malformed request line")
        method, target, version = (
            parts[0].decode("latin-1"),
            parts[1].decode("latin-1"),
            parts[2].decode("latin-1"),
        )
        if not version.startswith("HTTP/"):
            raise ValueError("malformed HTTP version")
        headers = {}
        for ln in lines[1:]:
            if not ln:
                continue
            name, sep, value = ln.partition(b":")
            if not sep:
                raise ValueError("malformed header line")
            key = "-".join(
                p.capitalize() for p in name.decode("latin-1").strip().split("-")
            )
            val = value.decode("latin-1").strip()
            if key in ("Content-Length", "Transfer-Encoding") and key in headers:
                # Duplicate framing headers are the request-smuggling
                # primitive (RFC 7230 §3.3.3): a proxy honoring the
                # first and this server honoring the last would desync
                # body boundaries.  Reject outright.
                raise ValueError(f"duplicate {key} header")
            headers[key] = val
        return method, target, version, headers

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, conn: _Conn, method, target, version, headers, body):
        srv = self.srv
        slot = conn.next_slot
        conn.next_slot += 1
        conn.inflight += 1
        conn.last_progress = time.monotonic()
        if conn.inflight >= MAX_PENDING:
            conn.paused = True
        keep_alive = version == "HTTP/1.1"
        if headers.get("Connection", "").lower() == "close":
            keep_alive = False
        if version == "HTTP/1.0" and (
            headers.get("Connection", "").lower() == "keep-alive"
        ):
            keep_alive = True
        if not keep_alive:
            conn.stop_reading = True
        handler = srv.handler
        if handler is None:
            self._complete(conn, slot, self._render(
                503, "application/json", b'{"error": "server not ready"}',
                close=not keep_alive,
            ))
            return
        parsed = urlparse(target)
        path = parsed.path
        query = parse_qs(parsed.query)
        if method == "OPTIONS":
            self._complete(
                conn, slot, self._render_preflight(handler, headers, keep_alive)
            )
            return
        if method not in ("GET", "POST", "DELETE"):
            self._complete(conn, slot, self._render(
                501, "application/json",
                json.dumps({"error": f"unsupported method {method}"}).encode(),
                close=not keep_alive,
            ))
            return
        # Admission: shed BEFORE any engine work.  Probe/observability
        # routes bypass it — health must be readable exactly when the
        # node is loaded.
        tenant = None
        admission = srv.admission if path not in ADMISSION_EXEMPT else None
        if admission is not None:
            tenant = tenant_of(headers, path)
            decision = admission.admit(tenant)
            if decision is not None:
                status, reason = decision
                srv._c_req_shed.inc()
                # Charge the shed to the tenant's cost ledger
                # (pilosa_tenant_sheds_total{tenant}).
                plans_mod.LEDGER.note_shed(tenant)
                self._complete(conn, slot, self._render(
                    status, "application/json",
                    json.dumps(
                        {"error": f"request shed ({reason})", "shed": reason}
                    ).encode(),
                    close=not keep_alive,
                    extra=b"Retry-After: 1\r\n",
                ))
                return
        cors_origin = self._cors_origin(handler, headers)
        vary = bool(handler.allowed_origins)
        released = []

        def release_once():
            if admission is not None and not released:
                released.append(True)
                admission.release(tenant)

        def finish(status, ctype, payload):
            release_once()
            raw = self._render(
                status, ctype, payload,
                close=not keep_alive,
                cors_origin=cors_origin, vary=vary,
            )
            self.call_soon(lambda: self._complete(conn, slot, raw))

        # Fast path: deferred queries decode + submit into the batch
        # pipeline's accumulate stage right here on the reactor —
        # cross-connection coalescing.
        fast = getattr(handler, "handle_async", None)
        result = None
        if fast is not None:
            try:
                result = fast(method, path, query, body, headers)
            except Exception as e:  # noqa: BLE001
                from .server import error_response

                status, payload = error_response(e)
                result = (status, "application/json", payload)
        if result is not None:
            srv._c_req_inline.inc()
            self._finish_result(result, finish)
            return
        # Blocking path: the full route table on the worker pool.
        srv._c_req_pool.inc()

        def job():
            try:
                res = handler.handle(method, path, query, body, headers)
            except Exception as e:  # noqa: BLE001
                from .server import error_response

                status, payload = error_response(e)
                res = (status, "application/json", payload)
            self._finish_result(res, finish)

        if not srv.pool.submit(job):
            if path in ADMISSION_EXEMPT:
                # A saturated pool must not blind the orchestrator:
                # probes run on a one-shot thread instead of shedding.
                # NOT inline on the reactor — in process mode a
                # /metrics aggregation waits on worker STATS frames
                # that only this reactor thread can drain, so an
                # inline run would stall the whole query path for the
                # stats timeout and stamp every worker process down.
                threading.Thread(target=job, daemon=True).start()
                return
            release_once()
            if admission is not None:
                status, reason = admission.shed_queue_full()
                plans_mod.LEDGER.note_shed(tenant)
            else:
                status, reason = 503, "queue_full"
            srv._c_req_shed.inc()
            self.call_soon(lambda: self._complete(conn, slot, self._render(
                status, "application/json",
                json.dumps(
                    {"error": f"request shed ({reason})", "shed": reason}
                ).encode(),
                close=not keep_alive,
                extra=b"Retry-After: 1\r\n",
            )))

    @staticmethod
    def _finish_result(result, finish):
        """Normalize a Handler result (triple | DeferredResponse | str |
        bytes | JSON-able) into ``finish(status, ctype, payload)``."""
        # From net/front.py, not net/server.py: a process-mode worker runs
        # this per request and must not load the API (and torch).
        from .front import DeferredResponse

        if isinstance(result, DeferredResponse):
            result.on_ready(finish)
            return
        if isinstance(result, tuple) and len(result) == 3:
            finish(*result)
            return
        if isinstance(result, bytes):
            finish(200, "application/octet-stream", result)
            return
        if isinstance(result, str):
            finish(200, "text/plain", result.encode())
            return
        finish(200, "application/json", json.dumps(result).encode())

    # -- response rendering -------------------------------------------------

    @staticmethod
    def _cors_origin(handler, headers):
        origins = handler.allowed_origins
        origin = headers.get("Origin")
        if not origins or not origin:
            return None
        if "*" in origins or origin in origins:
            return origin
        return None

    def _render_preflight(self, handler, headers, keep_alive):
        origin = self._cors_origin(handler, headers)
        head = [b"HTTP/1.1 200 OK"]
        if handler.allowed_origins:
            head.append(b"Vary: Origin")
        if origin is not None:
            head.append(b"Access-Control-Allow-Origin: " + origin.encode())
            head.append(
                b"Access-Control-Allow-Methods: GET, POST, DELETE, OPTIONS"
            )
            head.append(b"Access-Control-Allow-Headers: Content-Type")
        head.append(b"Content-Length: 0")
        if not keep_alive:
            head.append(b"Connection: close")
        return b"\r\n".join(head) + b"\r\n\r\n"

    @staticmethod
    def _render(
        status, ctype, payload, close=False, cors_origin=None, vary=False,
        extra=b"",
    ):
        reason = STATUS_REASONS.get(status, "")
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(payload)}\r\n"
        ).encode("latin-1")
        if vary:
            head += b"Vary: Origin\r\n"
            if cors_origin is not None:
                head += (
                    b"Access-Control-Allow-Origin: " + cors_origin.encode()
                    + b"\r\n"
                )
        if close:
            head += b"Connection: close\r\n"
        return head + extra + b"\r\n" + payload

    def _inline_error(self, conn: _Conn, status: int, msg: str):
        # stop_reading BEFORE completing: _complete's flush closes the
        # connection only when it can already see the request stream is
        # over (a fatal parse error always ends it).
        conn.stop_reading = True
        slot = conn.next_slot
        conn.next_slot += 1
        conn.inflight += 1
        self._complete(conn, slot, self._render(
            status, "application/json",
            json.dumps({"error": msg}).encode(), close=True,
        ))

    # -- ordered completion + writes ---------------------------------------

    def _complete(self, conn: _Conn, slot: int, raw: bytes):
        """Reactor-thread only: park ``raw`` in its request-order slot
        and flush everything now in order."""
        if conn.closed:
            return
        conn.ready[slot] = raw
        progressed = False
        while conn.next_write in conn.ready:
            buf = conn.ready.pop(conn.next_write)
            conn.out.append(buf)
            conn.next_write += 1
            conn.inflight -= 1
            progressed = True
        if progressed:
            conn.last_progress = time.monotonic()
            if conn.paused and conn.inflight < MAX_PENDING // 2:
                conn.paused = False
                self._parse(conn)
            self._flush(conn)

    def _enqueue_raw(self, conn: _Conn, raw: bytes):
        """Out-of-band bytes (100-continue) — not a response slot."""
        conn.out.append(raw)
        self._flush(conn)

    def _flush(self, conn: _Conn):
        if conn.closed:
            return
        while conn.out:
            buf = conn.out[0]
            try:
                n = conn.sock.send(buf)
            except (BlockingIOError, InterruptedError):
                break
            except ssl_mod.SSLWantWriteError:
                break
            except ssl_mod.SSLWantReadError:
                break
            except (BrokenPipeError, ConnectionResetError, OSError):
                self._close(conn)
                return
            if n == len(buf):
                conn.out.popleft()
            else:
                conn.out[0] = buf[n:] if n else buf
            if n < len(buf):
                break
        want_write = bool(conn.out)
        if (
            not want_write
            and conn.stop_reading
            and conn.inflight == 0
            and conn.state == _Conn.HEAD
        ):
            # Everything written, nothing more to read: Connection:
            # close (or a fatal parse error) drains then closes.
            self._close(conn)
            return
        self._interest(
            conn,
            read=not conn.stop_reading and not conn.paused,
            write=want_write,
        )

    # -- lifecycle ----------------------------------------------------------

    def _sweep(self, now: float):
        srv = self.srv
        for conn in list(self.conns):
            if conn.closed:
                continue
            if conn.mid_request() and (
                now - max(conn.last_recv, conn.last_progress)
                > srv.read_timeout
            ):
                # Slow-loris: a partial request that stopped making
                # progress.  Close; no slot was opened for it.
                # last_progress matters too: a big pipelined burst the
                # server itself PAUSED (MAX_PENDING backpressure) keeps
                # unparsed bytes in rbuf with no new recvs while
                # responses flow — that is healthy, not a loris.
                self._close(conn)
            elif conn.inflight > 0 and (
                now - conn.last_progress > srv.response_timeout
            ):
                # A deferred response that never resolved (wedged
                # pipeline): drop the connection rather than hold its
                # buffers forever.  Above the batcher's 300 s wedge
                # timeout, so a hit means the pipeline failed.
                self._close(conn)
            elif (
                conn.inflight == 0
                and not conn.mid_request()
                and now - max(conn.last_recv, conn.last_progress)
                > srv.idle_timeout
            ):
                self._close(conn)

    def _close(self, conn: _Conn):
        if conn.closed:
            return
        conn.closed = True
        conn.ready.clear()
        conn.out.clear()
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self.conns.discard(conn)


class AsyncHTTPServer:
    """Drop-in for the bind/serve/shutdown surface the rest of the code
    uses on ``ThreadingHTTPServer``: ``server_address``,
    ``RequestHandlerClass.handler = ...``, ``serve_forever()``,
    ``shutdown()``, ``server_close()``."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 10101,
        ssl_context=None,
        reactors: Optional[int] = None,
        pool_workers: Optional[int] = None,
        queue_depth: Optional[int] = None,
        admission: Optional[AdmissionController] = None,
        max_body_bytes: Optional[int] = None,
        read_timeout: Optional[float] = None,
        idle_timeout: Optional[float] = None,
        response_timeout: Optional[float] = None,
        reuseport: Optional[bool] = None,
    ):
        self.ssl_context = ssl_context
        self.handler = None
        # Optional (cork, uncork) pair bracketing each reactor
        # iteration — process-mode workers batch their engine-link
        # frames with it.  None everywhere else.
        self.loop_hooks = None
        # serve() does ``srv.RequestHandlerClass.handler = Handler(...)``
        # for the threaded server; aliasing the class to the instance
        # keeps that assignment working unchanged.
        self.RequestHandlerClass = self
        if reactors is None:
            reactors = _env_int("PILOSA_TPU_SERVER_REACTORS", 1)
        self.n_reactors = max(1, int(reactors))
        if pool_workers is None:
            pool_workers = _env_int("PILOSA_TPU_SERVER_POOL_WORKERS", 256)
        if queue_depth is None:
            queue_depth = _env_int("PILOSA_TPU_SUBMIT_QUEUE", 1024)
        self.pool = _BlockingPool(pool_workers, queue_depth)
        self.admission = admission
        if max_body_bytes is None:
            max_body_bytes = _env_int(
                "PILOSA_TPU_MAX_BODY_BYTES", 256 * 1024 * 1024
            )
        self.max_body_bytes = max_body_bytes
        self.read_timeout = (
            read_timeout
            if read_timeout is not None
            else _env_float("PILOSA_TPU_READ_TIMEOUT", 120.0)
        )
        self.idle_timeout = (
            idle_timeout
            if idle_timeout is not None
            else _env_float("PILOSA_TPU_IDLE_TIMEOUT", 120.0)
        )
        # Above the batcher's 300 s wedge bound (net/server.py
        # DRAIN_TIMEOUT rationale).
        self.response_timeout = (
            response_timeout
            if response_timeout is not None
            else _env_float("PILOSA_TPU_RESPONSE_TIMEOUT", 330.0)
        )
        self._c_accepted = REGISTRY.counter(METRIC_SERVER_CONNECTIONS_TOTAL)
        self._c_req_inline = REGISTRY.counter(
            METRIC_SERVER_REQUESTS, path="inline"
        )
        self._c_req_pool = REGISTRY.counter(METRIC_SERVER_REQUESTS, path="pool")
        self._c_req_shed = REGISTRY.counter(METRIC_SERVER_REQUESTS, path="shed")
        self._socks = []
        if reuseport is None:
            reuseport = self.n_reactors > 1
        for i in range(self.n_reactors):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if reuseport:
                # The scale-out knob: the kernel load-balances accepts
                # across the per-reactor listening sockets — and, in
                # process mode, across the sibling WORKER processes'
                # listeners on the same port (net/worker.py always
                # passes reuseport=True).
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            try:
                s.bind((host, port))
            except OSError:
                for prev in self._socks:
                    prev.close()
                s.close()
                raise
            # An ephemeral bind resolves on the FIRST socket; siblings
            # must share the real port for SO_REUSEPORT to group them.
            port = s.getsockname()[1]
            s.listen(LISTEN_BACKLOG)
            s.setblocking(False)
            self._socks.append(s)
        self.server_address = self._socks[0].getsockname()[:2]
        self._reactors = [
            _Reactor(self, s, name=f"http-reactor-{i}")
            for i, s in enumerate(self._socks)
        ]
        self._started = False
        self._stop_event = threading.Event()
        self._lock = threading.Lock()

    def register_external(self, sock, callback):
        """Watch an extra readable fd on reactor 0's loop (before
        ``serve_forever``).  Process-mode workers register their engine
        link so the reactor thread owns the whole query path."""
        self._reactors[0].add_external(sock, callback)

    def register_external_soon(self, sock, callback):
        """Dynamic, thread-safe external-fd registration on reactor 0
        (works while the loop is running)."""
        self._reactors[0].register_external_soon(sock, callback)

    def unregister_external_soon(self, sock):
        self._reactors[0].unregister_external_soon(sock)

    def call_soon(self, fn):
        self._reactors[0].call_soon(fn)

    # -- ThreadingHTTPServer-compatible lifecycle ---------------------------

    def serve_forever(self, poll_interval: float = 0.5):
        with self._lock:
            if not self._started:
                self._started = True
                for r in self._reactors:
                    r.start()
        self._stop_event.wait()

    def shutdown(self):
        with self._lock:
            started = self._started
        if started:
            for r in self._reactors:
                r.stop()
            for r in self._reactors:
                r.join(timeout=10.0)
        self.pool.stop()
        self._stop_event.set()
        self.server_close()

    def server_close(self):
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass

    # -- telemetry ----------------------------------------------------------

    def connection_count(self) -> int:
        return sum(len(r.conns) for r in self._reactors)

    def refresh_gauges(self):
        REGISTRY.set_gauge(METRIC_SERVER_CONNECTIONS, self.connection_count())
        if self.admission is not None:
            self.admission.refresh_gauges()

    def snapshot(self) -> dict:
        out = {
            "backend": "async",
            "reactors": self.n_reactors,
            "connections": self.connection_count(),
            "poolWorkers": self.pool._workers,
        }
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        return out
