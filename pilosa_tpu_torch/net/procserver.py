"""Device-owner side of the process-per-core serving mode.

``ProcessHTTPServer`` is the serving backend behind ``[server]
workers = N`` (docs/serving.md "Process mode"): N shared-nothing worker
PROCESSES (net/worker.py) own accept (SO_REUSEPORT), HTTP parse, PQL
decode, and response encode, and forward already-decoded frames over
AF_UNIX to THIS process — the only one that touches the card.  This
class:

* keeps the device-owner's OWN reactor in the SO_REUSEPORT accept
  group (``workers=N`` means N+1 acceptors): it resolves the ephemeral
  port before cluster/gossip advertisement, holds the port continuously
  (every group member LISTENS — a bound-but-never-listening member
  silently eats the SYNs the kernel hashes to it), and serves its share
  of connections with no IPC hop, soaking up whatever GIL headroom the
  device leaves;
* accepts worker IPC connections and drains their frames ON that same
  reactor thread (one thread for all engine-side IO); QUERY frames are
  admitted (the ONE admission controller lives here, so the in-flight
  bound and weighted-fair tenant shares stay globally correct across
  workers), repeat all-Count queries answer from the versioned result
  memo with no executor machinery (``api.fast_counts``), and the rest
  submit straight into the batch pipeline's accumulate stage
  (``api.query_async``), so arrivals from ALL workers coalesce into the
  same fused device dispatches — each drain stamps its worker identity
  as the batcher submit origin, making cross-worker fusing measurable
  (``cross_worker_fused_batches`` in the pipeline counters);
* answers scrape-time ``aggregate_metrics``: every worker's registry is
  fetched over IPC, summed into this process's exposition
  (util/stats.merge_expositions), and per-process
  ``pilosa_process_{up,rss_bytes}{proc=}`` gauges are stamped — a
  wedged worker shows ``up 0`` before the supervisor reaps it;
* supervises the worker processes: crashes respawn (with backoff),
  ``readyz`` reflects ``not_ready_reasons()`` while any worker is
  missing, and ``shutdown`` drains workers before the engine closes.

It exposes the same bind/serve/shutdown surface the rest of the code
uses on ``ThreadingHTTPServer``/``AsyncHTTPServer``.

A copy of ``pilosa_tpu/net/procserver.py``.  Workers start with
``subprocess.Popen`` only (a fork of a process that holds a CUDA context
is undefined), as ``python -m pilosa_tpu_torch.net.worker`` with
``CUDA_VISIBLE_DEVICES=""``: no worker makes a context on the card.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..parallel import batcher as batcher_mod
from ..util import plans as plans_mod
from ..util.stats import (
    METRIC_PROCESS_RSS,
    METRIC_PROCESS_UP,
    REGISTRY,
    merge_expositions,
)
from . import ipc
from .admission import AdmissionController
from .aserver import ADMISSION_EXEMPT, _BlockingPool, _env_float, _env_int
from .wire import fast_result_values, response_to_json

# How long a scrape waits for each worker's STATS reply before marking
# it pilosa_process_up 0 and falling back to its cached exposition.
STATS_TIMEOUT = 2.0
# Supervisor respawn backoff: a worker that dies instantly (bad spec,
# port conflict) must not fork-bomb the host.
RESPAWN_BACKOFF = 1.0


class _WorkerConn:
    """One connected worker: socket + frame reader + pending stats."""

    def __init__(self, sock, wid: int, pid: int):
        self.sock = sock
        self.wid = wid
        self.pid = pid
        self.reader = ipc.FrameReader(sock)
        self.sender = ipc.FrameSender(sock, name=f"ipc-send-w{wid}")
        # Distinct per (worker, pid): a respawned worker is a new
        # origin, so the smoke assertion "fused batch spans worker
        # PIDS" is literal.
        self.origin = f"worker-{wid}:{pid}"
        self._slock = threading.Lock()
        self._stats_pending: Dict[int, tuple] = {}
        self._stats_ids = iter(range(1, 1 << 62))
        self.closed = False

    # -- engine -> worker ----------------------------------------------------

    def send_response(self, rid: int, status: int, ctype: str, payload: bytes):
        try:
            self.sender.send(
                ipc.RESPONSE, ipc.pack_response(rid, status, ctype, payload)
            )
        except (OSError, ConnectionError):
            pass  # worker died; its clients are gone too

    def send_result_fast(self, rid: int, trace_id, results):
        try:
            self.sender.send(
                ipc.RESULT_FAST, ipc.pack_result_fast(rid, trace_id, results)
            )
        except (OSError, ConnectionError):
            pass

    def send_shutdown(self):
        try:
            self.sender.send(ipc.SHUTDOWN)
        except (OSError, ConnectionError):
            pass

    def request_stats(self):
        """Fire a GETSTATS; returns (event, slot) the reader fills."""
        rid = next(self._stats_ids)
        ev = threading.Event()
        slot: dict = {}
        with self._slock:
            self._stats_pending[rid] = (ev, slot)
        try:
            self.sender.send(ipc.GETSTATS, struct.pack("!Q", rid))
        except (OSError, ConnectionError):
            ev.set()  # dead conn: resolve empty immediately
        return ev, slot

    def resolve_stats(self, rid: int, rss: int, text: bytes):
        with self._slock:
            entry = self._stats_pending.pop(rid, None)
        if entry is not None:
            ev, slot = entry
            slot["rss"] = rss
            slot["text"] = text.decode("utf-8", "replace")
            ev.set()

    def fail_pending_stats(self):
        with self._slock:
            pending = list(self._stats_pending.values())
            self._stats_pending.clear()
        for ev, _slot in pending:
            ev.set()

    def close(self):
        self.closed = True
        self.fail_pending_stats()
        self.sender.close()
        try:
            self.sock.close()
        except OSError:
            pass


class ProcessHTTPServer:
    """Drop-in for the bind/serve/shutdown surface: ``server_address``,
    ``RequestHandlerClass.handler = ...``, ``serve_forever()``,
    ``shutdown()``, ``server_close()`` — plus the process-mode extras
    (``aggregate_metrics``, ``not_ready_reasons``, ``wait_ready``)."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 10101,
        workers: int = 2,
        ssl_context=None,  # accepted for signature parity; workers
        # terminate TLS from the cert/key PATHS below (a context object
        # cannot cross the process boundary).
        tls_certificate: str = "",
        tls_key: str = "",
        reactors: Optional[int] = None,
        pool_workers: Optional[int] = None,
        queue_depth: Optional[int] = None,
        admission: Optional[AdmissionController] = None,
        max_body_bytes: Optional[int] = None,
        read_timeout: Optional[float] = None,
        idle_timeout: Optional[float] = None,
        response_timeout: Optional[float] = None,
    ):
        if ssl_context is not None and not tls_certificate:
            raise ValueError(
                "process mode terminates TLS in the workers: pass "
                "tls_certificate/tls_key paths, not an ssl_context"
            )
        self.workers = max(1, int(workers))
        self.handler = None
        self.RequestHandlerClass = self  # serve() assigns .handler
        self.admission = admission
        self._spec_opts = {
            "reactors": reactors,
            "pool_workers": pool_workers,
            "queue_depth": queue_depth,
            "max_body_bytes": max_body_bytes,
            "read_timeout": read_timeout,
            "idle_timeout": idle_timeout,
            "response_timeout": response_timeout,
            "tls_certificate": tls_certificate,
            "tls_key": tls_key,
        }
        if pool_workers is None:
            pool_workers = _env_int("PILOSA_TPU_SERVER_POOL_WORKERS", 256)
        if queue_depth is None:
            queue_depth = _env_int("PILOSA_TPU_SUBMIT_QUEUE", 1024)
        # Engine-side pool: generic HTTP passthrough frames (imports,
        # debug routes, sync queries) block here, never on a reader.
        self.pool = _BlockingPool(pool_workers, queue_depth)
        self._stats_timeout = _env_float("PILOSA_TPU_STATS_TIMEOUT", STATS_TIMEOUT)
        # The device-owner keeps ITS OWN reactor in the SO_REUSEPORT
        # accept group: it resolves the ephemeral port before cluster /
        # gossip advertisement, holds the port continuously (every
        # group member LISTENS — a bound-but-never-listening member
        # silently eats the SYNs the kernel hashes to it; clients hang
        # in retransmit backoff), and serves its share of connections
        # with no IPC hop at all.  Process mode is therefore additive:
        # ``workers=N`` means N+1 acceptors — N shared-nothing front
        # ends plus the engine's in-process reactor soaking up whatever
        # GIL headroom the device leaves (docs/serving.md "Process
        # mode").
        self._host = host
        inner_ctx = ssl_context
        if inner_ctx is None and tls_certificate:
            from .server import make_server_ssl_context

            inner_ctx = make_server_ssl_context(tls_certificate, tls_key)
        from .aserver import AsyncHTTPServer

        self.inner = AsyncHTTPServer(
            host, port,
            ssl_context=inner_ctx,
            reactors=reactors or 1,
            pool_workers=pool_workers,
            queue_depth=queue_depth,
            admission=None,  # serve() wires the ONE global controller
            max_body_bytes=max_body_bytes,
            read_timeout=read_timeout,
            idle_timeout=idle_timeout,
            response_timeout=response_timeout,
            reuseport=True,
        )
        self.server_address = self.inner.server_address
        # The AF_UNIX rendezvous the workers dial.
        self._ipc_dir = tempfile.mkdtemp(prefix="pilosa-ipc-")
        self.ipc_path = os.path.join(self._ipc_dir, "engine.sock")
        self._lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._lsock.bind(self.ipc_path)
        self._lsock.listen(self.workers * 2)
        self._lock = threading.Lock()
        self._worker_conns: Dict[int, _WorkerConn] = {}
        self._procs: Dict[int, subprocess.Popen] = {}
        self._last_stats: Dict[int, dict] = {}  # wid -> cached STATS
        self.restarts = 0
        self._started = False
        self._closing = False
        self._stop_event = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def serve_forever(self, poll_interval: float = 0.5):
        with self._lock:
            if self._started:
                self._stop_event.wait()
                return
            self._started = True
        # The engine's own reactor joins the accept group first (it
        # already holds the port), sharing the ONE handler + admission
        # controller serve() wired onto this object.
        self.inner.admission = self.admission
        self.inner.RequestHandlerClass.handler = self.handler
        threading.Thread(
            target=self.inner.serve_forever, daemon=True,
            name="engine-reactor",
        ).start()
        threading.Thread(
            target=self._accept_loop, daemon=True, name="ipc-accept"
        ).start()
        for wid in range(self.workers):
            self._spawn(wid)
        threading.Thread(
            target=self._supervise, daemon=True, name="worker-supervisor"
        ).start()
        self._stop_event.wait()

    def _spawn(self, wid: int):
        spec = dict(self._spec_opts)
        spec.update(
            wid=wid,
            host=self._host,
            port=self.server_address[1],
            ipc=self.ipc_path,
            allowed_origins=(
                self.handler.allowed_origins if self.handler is not None else []
            ),
        )
        env = dict(os.environ)
        env["PILOSA_TPU_WORKER_SPEC"] = json.dumps(spec)
        # A worker must NEVER touch the card: it lives in exactly one
        # process (this one).  Hiding every device keeps even an
        # accidental CUDA call in a worker from making a context.
        env["CUDA_VISIBLE_DEVICES"] = ""
        # The worker imports this package from where this process did.
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self._procs[wid] = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.net.worker"], env=env
        )

    def _supervise(self):
        """Respawn crashed workers until shutdown.  The restart counter
        and a backoff keep a persistently-failing worker from fork-
        bombing the host."""
        while not self._closing:
            time.sleep(0.2)
            for wid, proc in list(self._procs.items()):
                if self._closing or proc.poll() is None:
                    continue
                sys.stderr.write(
                    f"worker-{wid} (pid {proc.pid}) exited "
                    f"rc={proc.returncode}; respawning\n"
                )
                with self._lock:
                    conn = self._worker_conns.get(wid)
                if conn is not None:
                    # _drop_conn, not a bare close: the socket must
                    # leave the reactor's selector map, or the
                    # respawned worker's registration (same fd number,
                    # different socket) fails as a duplicate and the
                    # new link is never drained.
                    self._drop_conn(conn)
                self.restarts += 1
                time.sleep(RESPAWN_BACKOFF if proc.returncode else 0.0)
                if not self._closing:
                    self._spawn(wid)

    def _accept_loop(self):
        """Blocking accept + HELLO handshake, then hand the link to the
        engine reactor's event loop: worker-frame drains run on the SAME
        thread that serves the engine's own HTTP connections.  One
        thread for all engine-side IO — a separate IPC thread would
        ping-pong the engine GIL with the reactor per burst, the exact
        churn the single-threaded worker design exists to avoid."""
        while not self._closing:
            try:
                s, _addr = self._lsock.accept()
            except OSError:
                return  # listener closed (shutdown)
            # Deep IPC buffers (best effort): a corked burst must never
            # park either side's event loop mid-write.
            for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
                try:
                    s.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
                except OSError:
                    pass
            try:
                # Bounded handshake: a connector that never says HELLO
                # (wedged mid-boot, SIGSTOP) must not block every
                # future worker (re)connection behind it.
                s.settimeout(10.0)
                ftype, cur = ipc.read_frame(s)
                s.settimeout(None)
            except (ConnectionError, OSError, socket.timeout):
                s.close()
                continue
            if ftype != ipc.HELLO:
                s.close()
                continue
            wid = cur.u32()
            pid = cur.u32()
            conn = _WorkerConn(s, wid, pid)
            with self._lock:
                old = self._worker_conns.get(wid)
                self._worker_conns[wid] = conn
            if old is not None:
                old.close()
            self.inner.register_external_soon(
                s, lambda c=conn: self._on_worker_readable(c)
            )

    # Frames handled per worker per reactor pass: big enough to
    # amortize the cork's sendall, small enough that one worker's
    # backlog (the reader buffers MBs user-side under a flood) can't
    # starve the reactor's other work — the remainder re-arms via
    # call_soon so the engine's own HTTP connections and the sibling
    # worker's link run in between.
    DRAIN_ROUND = 64

    def _on_worker_readable(self, conn: "_WorkerConn"):
        """Reactor-thread callback: pull whatever the worker sent, then
        handle a bounded round of frames."""
        if not conn.reader.fill():
            self._drop_conn(conn)
            return
        self._drain_round(conn)

    def _drain_round(self, conn: "_WorkerConn"):
        """Handle up to DRAIN_ROUND buffered frames from one worker.
        Every QUERY frame feeds the batch pipeline's accumulate stage
        inline — arrivals from ALL workers (and the engine's own
        reactor connections) coalesce into the same fused device
        dispatches, tagged with their worker origin so cross-worker
        fusing is countable.  Responses produced inline (memo hits)
        ride a cork — one sendall per round (per-frame syscalls are the
        dominant IPC cost on this class of host, ~15 µs each)."""
        if conn.closed:
            return
        # Frames from THIS worker process tag their batcher submits.
        batcher_mod.set_submit_origin(conn.origin)
        try:
            conn.sender.cork()
            try:
                for _ in range(self.DRAIN_ROUND):
                    frame = conn.reader.next_buffered()
                    if frame is None:
                        break
                    ftype, cur = frame
                    if ftype == ipc.QUERY:
                        self._handle_query(conn, ipc.unpack_query(cur))
                    elif ftype == ipc.HTTP:
                        self._handle_http(conn, ipc.unpack_http(cur))
                    elif ftype == ipc.STATS:
                        rid, rss, text = ipc.unpack_stats(cur)
                        conn.resolve_stats(rid, rss, text)
            finally:
                conn.sender.uncork()
        except (ConnectionError, OSError):
            self._drop_conn(conn)
            return
        finally:
            batcher_mod.set_submit_origin(None)
        if conn.reader.buffered():
            self.inner.call_soon(lambda: self._drain_round(conn))

    def _drop_conn(self, conn: "_WorkerConn"):
        self.inner.unregister_external_soon(conn.sock)
        with self._lock:
            if self._worker_conns.get(conn.wid) is conn:
                self._worker_conns.pop(conn.wid, None)
        conn.close()

    # -- frame handling ------------------------------------------------------

    def _shed(self, conn: _WorkerConn, rid: int, status: int, reason: str):
        conn.send_response(
            rid, status, "application/json",
            json.dumps(
                {"error": f"request shed ({reason})", "shed": reason}
            ).encode(),
        )

    def _handle_query(self, conn: _WorkerConn, doc: dict):
        rid = doc["req_id"]
        handler = self.handler
        if handler is None:
            conn.send_response(
                rid, 503, "application/json", b'{"error": "server not ready"}'
            )
            return
        api = handler.api
        tenant = doc["tenant"] or "default"
        admission = self.admission
        if admission is not None:
            decision = admission.admit(tenant)
            if decision is not None:
                status, reason = decision
                plans_mod.LEDGER.note_shed(tenant)
                self._shed(conn, rid, status, reason)
                return
        released = []

        def release_once():
            if admission is not None and not released:
                released.append(True)
                admission.release(tenant)

        flags = doc["flags"]
        if not flags and doc["shards"] is None and not doc["trace_id"]:
            # Memo lane: a repeat all-Count query answers from the
            # versioned result memo with NO executor machinery — the
            # device-owner GIL spends its microseconds only on queries
            # that need the device (api.fast_counts).
            fast = api.fast_counts(doc["index"], doc["query"], tenant)
            if fast is not None:
                vals, trace_id = fast
                conn.send_result_fast(rid, trace_id, vals)
                release_once()
                return
        headers = {}
        if doc["trace_id"]:
            headers["X-Trace-Id"] = doc["trace_id"]
        if doc["span_id"]:
            headers["X-Span-Id"] = doc["span_id"]
        from ..api import QueryRequest

        req = QueryRequest(
            doc["index"],
            doc["query"],
            shards=doc["shards"],
            column_attrs=bool(flags & ipc.F_COLUMN_ATTRS),
            exclude_row_attrs=bool(flags & ipc.F_EXCL_ROW_ATTRS),
            exclude_columns=bool(flags & ipc.F_EXCL_COLUMNS),
            remote=bool(flags & ipc.F_REMOTE),
            trace_context=api.tracer.extract_headers(headers),
            profile=bool(flags & ipc.F_PROFILE),
            tenant=tenant,
        )
        try:
            fut = api.query_async(req)
        except Exception as e:  # noqa: BLE001
            release_once()
            self._send_error(conn, rid, e)
            return
        if fut is not None:
            # Pipelined: this reader thread just fed the batcher's
            # accumulate stage; the completion callback ships the
            # structured result back for the WORKER to encode.
            fut.add_done_callback(
                lambda f: self._finish_query(conn, rid, f, req, release_once)
            )
            return

        # Sync fallback (non-Count trees, remote replays): the engine
        # pool blocks on the readback, never this reader thread.
        def job():
            try:
                resp = api.query(req)
                self._send_query_response(
                    conn, rid, resp,
                    trace_id=getattr(resp, "trace_id", None),
                    plan=getattr(resp, "plan", None),
                )
            except Exception as e:  # noqa: BLE001
                self._send_error(conn, rid, e)
            finally:
                release_once()

        if not self.pool.submit(job):
            release_once()
            if admission is not None:
                status, reason = admission.shed_queue_full()
                plans_mod.LEDGER.note_shed(tenant)
            else:
                status, reason = 503, "queue_full"
            self._shed(conn, rid, status, reason)

    def _finish_query(self, conn, rid, fut, req, release_once):
        try:
            try:
                resp = fut.result(0)
            except Exception as e:  # noqa: BLE001
                self._send_error(conn, rid, e)
                return
            span = getattr(fut, "trace_span", None)
            trace_id = span.trace_id if span is not None else None
            plan = getattr(fut, "query_plan", None) if req.profile else None
            self._send_query_response(
                conn, rid, resp, trace_id=trace_id,
                plan=plan.to_dict() if plan is not None else None,
            )
        finally:
            release_once()

    def _send_query_response(self, conn, rid, resp, trace_id=None, plan=None):
        if plan is None:
            fast = fast_result_values(resp)
            if fast is not None:
                # The hot path: ship VALUES; the worker owns the JSON
                # encode (net/wire.py fast_results_bytes).
                conn.send_result_fast(rid, trace_id, fast)
                return
        out = response_to_json(resp)
        if trace_id:
            out["traceID"] = trace_id
        if plan is not None:
            out["plan"] = plan
        conn.send_response(
            rid, 200, "application/json", json.dumps(out).encode()
        )

    def _send_error(self, conn, rid, e):
        from .server import error_response

        status, payload = error_response(e)
        conn.send_response(rid, status, "application/json", payload)

    def _handle_http(self, conn: _WorkerConn, doc: dict):
        rid = doc["req_id"]
        handler = self.handler
        if handler is None:
            conn.send_response(
                rid, 503, "application/json", b'{"error": "server not ready"}'
            )
            return
        try:
            headers = json.loads(doc["headers_json"] or b"{}")
        except json.JSONDecodeError:
            headers = {}
        parsed = urlparse(doc["target"])
        path = parsed.path
        query = parse_qs(parsed.query)
        method = doc["method"]
        body = bytes(doc["body"])
        tenant = None
        admission = self.admission if path not in ADMISSION_EXEMPT else None
        if admission is not None:
            from .admission import tenant_of

            tenant = tenant_of(headers, path)
            decision = admission.admit(tenant)
            if decision is not None:
                status, reason = decision
                plans_mod.LEDGER.note_shed(tenant)
                self._shed(conn, rid, status, reason)
                return
        released = []

        def release_once():
            if admission is not None and not released:
                released.append(True)
                admission.release(tenant)

        def job():
            try:
                res = handler.handle(method, path, query, body, headers)
            except Exception as e:  # noqa: BLE001
                from .server import error_response

                status, payload = error_response(e)
                res = (status, "application/json", payload)
            self._finish_http(conn, rid, res, release_once)

        if not self.pool.submit(job):
            if path in ADMISSION_EXEMPT:
                # Probes must answer under saturation — but NOT on this
                # reader thread: a /metrics aggregation waits on STATS
                # frames that arrive here.  One short-lived thread.
                threading.Thread(target=job, daemon=True).start()
                return
            release_once()
            if admission is not None:
                status, reason = admission.shed_queue_full()
                plans_mod.LEDGER.note_shed(tenant)
            else:
                status, reason = 503, "queue_full"
            self._shed(conn, rid, status, reason)

    def _finish_http(self, conn, rid, result, release_once):
        from .server import DeferredResponse

        if isinstance(result, DeferredResponse):
            result.on_ready(
                lambda status, ctype, payload: (
                    release_once(),
                    conn.send_response(rid, status, ctype, payload),
                )
            )
            return
        try:
            if isinstance(result, tuple) and len(result) == 3:
                status, ctype, payload = result
            elif isinstance(result, bytes):
                status, ctype, payload = 200, "application/octet-stream", result
            elif isinstance(result, str):
                status, ctype, payload = 200, "text/plain", result.encode()
            else:
                status, ctype, payload = (
                    200, "application/json", json.dumps(result).encode()
                )
        finally:
            # Release BEFORE the send, matching the DeferredResponse
            # branch above and the async backend's finish(): once a
            # client holds its response, its admission slot must
            # already be free — releasing after the send let a client
            # act on the response milliseconds before the slot freed,
            # and anything keying on in-flight state (tenant fair
            # shares, the smoke's saturate-then-shed stage) raced it.
            release_once()
        conn.send_response(rid, status, ctype, payload)

    # -- scrape-time aggregation --------------------------------------------

    def aggregate_metrics(self, handler, openmetrics: bool = False) -> str:
        """The whole node's exposition: fetch every worker's registry
        over IPC, stamp per-process up/rss gauges, render the engine's
        own exposition (with those gauges), and sum the worker
        registries in (util/stats.merge_expositions)."""
        with self._lock:
            conns = dict(self._worker_conns)
        waits = [
            (wid, wc, *wc.request_stats()) for wid, wc in conns.items()
        ]
        deadline = time.monotonic() + self._stats_timeout
        others: Dict[str, str] = {}
        for wid, wc, ev, slot in waits:
            ev.wait(max(0.0, deadline - time.monotonic()))
            fresh = "text" in slot
            if fresh:
                self._last_stats[wid] = {
                    "rss": slot["rss"], "text": slot["text"],
                }
            REGISTRY.set_gauge(
                METRIC_PROCESS_UP, 1 if fresh else 0, proc=f"worker-{wid}"
            )
        # Workers that SHOULD exist but have no live connection (killed,
        # pre-respawn, wedged at boot) are down — their last-known
        # registry still sums in so node-level counters don't dip to
        # zero mid-respawn.
        for wid in range(self.workers):
            if wid not in conns:
                REGISTRY.set_gauge(
                    METRIC_PROCESS_UP, 0, proc=f"worker-{wid}"
                )
            cached = self._last_stats.get(wid)
            if cached is not None:
                others[f"worker-{wid}"] = cached["text"]
                REGISTRY.set_gauge(
                    METRIC_PROCESS_RSS, cached["rss"], proc=f"worker-{wid}"
                )
        REGISTRY.set_gauge(METRIC_PROCESS_UP, 1, proc="engine")
        REGISTRY.set_gauge(METRIC_PROCESS_RSS, ipc.rss_bytes(), proc="engine")
        primary = handler._metrics_text(openmetrics=openmetrics)
        return merge_expositions(primary, others)

    # -- readiness / introspection ------------------------------------------

    def not_ready_reasons(self) -> list:
        """Worker-health readiness contribution (api.readiness):
        non-empty while any configured worker process has no live IPC
        connection — the /readyz flip the worker-kill drill asserts."""
        if not self._started:
            return ["process workers not started"]
        with self._lock:
            n = len(self._worker_conns)
        if n < self.workers:
            return [f"workers: {n}/{self.workers} connected"]
        return []

    def wait_ready(self, timeout: float = 60.0) -> bool:
        """Block until every worker is connected and accepting."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._started and not self.not_ready_reasons():
                return True
            time.sleep(0.05)
        return False

    def worker_pids(self) -> Dict[int, int]:
        with self._lock:
            return {wid: wc.pid for wid, wc in self._worker_conns.items()}

    def connection_count(self) -> int:
        with self._lock:
            n = len(self._worker_conns)
        return n + self.inner.connection_count()

    def refresh_gauges(self):
        self.inner.refresh_gauges()

    def snapshot(self) -> dict:
        with self._lock:
            connected = sorted(self._worker_conns)
            pids = {
                str(wid): wc.pid for wid, wc in self._worker_conns.items()
            }
        out = {
            "backend": "process",
            "workers": self.workers,
            "connected": connected,
            "workerPids": pids,
            "restarts": self.restarts,
            "engineConnections": self.inner.connection_count(),
        }
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        return out

    # -- shutdown ------------------------------------------------------------

    def shutdown(self):
        """Drain workers BEFORE the engine closes: workers stop once
        their in-flight requests resolve; stragglers are terminated."""
        with self._lock:
            if self._closing:
                self._stop_event.set()
                return
            self._closing = True
            conns = list(self._worker_conns.values())
        for wc in conns:
            wc.send_shutdown()
        deadline = time.monotonic() + 15.0
        for wid, proc in list(self._procs.items()):
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5.0)
        for wc in conns:
            wc.close()
        self.pool.stop()
        try:
            self.inner.shutdown()
        except Exception:  # noqa: BLE001 — engine reactor already down
            pass
        self._stop_event.set()
        self.server_close()

    def server_close(self):
        try:
            self._lsock.close()
        except OSError:
            pass
        self.inner.server_close()
        shutil.rmtree(self._ipc_dir, ignore_errors=True)
