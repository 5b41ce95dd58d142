"""Worker process for the process-per-core serving mode.

One worker owns a full HTTP front end — SO_REUSEPORT accept, the
event-loop reactor's buffer-view parse (net/aserver.py), PQL body
decode, and response JSON encode — and forwards the *already-decoded*
work to the device-owner process over an AF_UNIX socket as compact
binary frames (net/ipc.py).  The GIL-heavy per-request byte work runs
here, in this process; the device-owner's interpreter only sees decoded
queries landing in the batch pipeline's accumulate stage, so arrivals
from ALL workers still coalesce into the same fused device dispatches
(docs/serving.md "Process mode").

The query path is SINGLE-THREADED by construction: the engine link is
registered as an external fd on the reactor's selector
(``AsyncHTTPServer.register_external``), so one thread parses client
requests, frames them (corked — one ``sendall`` per event-loop
iteration), decodes engine replies, and writes responses.  No
cross-thread handoff, no wake syscalls, no GIL ping-pong — on
hosts where a syscall costs ~15 µs and thread wakeups collapse under
oversubscription, that chain is the difference between process mode
scaling and process mode convoying.

Run as ``python -m pilosa_tpu_torch.net.worker`` with the spawn spec in
the ``PILOSA_TPU_WORKER_SPEC`` env var (net/procserver.py builds it).  A
worker NEVER touches the card: the supervisor starts it with
``CUDA_VISIBLE_DEVICES=""``, so not even an accidental CUDA call in it can
make a context on the device the owner holds.

A copy of ``pilosa_tpu/net/worker.py``; its frames are the reference's
(``net/ipc.py``).  Nothing on its import chain loads torch or the API
(``net/front.py`` holds what it shares with the node's handler), so a
worker boots and serves without either.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import socket
import sys
import threading
import time
from urllib.parse import urlencode

from ..util.stats import REGISTRY
from . import ipc
from .admission import tenant_of
from .aserver import AsyncHTTPServer
from .front import PROTOBUF_CONTENT_TYPE, DeferredResponse, decode_query_doc, fast_results_bytes

_QUERY_PATH_RE = re.compile(r"^/index/([^/]+)/query$")


class EngineLink:
    """The worker's single connection to the device-owner process.
    Outbound frames ride the reactor's cork window (one ``sendall``
    per parsed burst); inbound frames are drained by ``on_readable``
    ON the reactor thread and resolved inline."""

    def __init__(self, path: str, wid: int, response_timeout: float = 330.0):
        self.wid = wid
        self.response_timeout = response_timeout
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # Deep IPC buffers (best effort): a corked event-loop iteration
        # can flush a whole pipelined burst in one sendall, and a send
        # buffer smaller than the burst would park the reactor thread
        # mid-write behind the engine's drain rate.
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
            except OSError:
                pass
        self.sock.connect(path)
        self.reader = ipc.FrameReader(self.sock)
        self.sender = ipc.FrameSender(self.sock, name=f"ipc-send-{wid}")
        self._plock = threading.Lock()
        self._pending: dict = {}  # req_id -> DeferredResponse
        self._ids = itertools.count(1)
        self.server = None  # AsyncHTTPServer, wired by main()
        self.draining = False

    # -- requests ------------------------------------------------------------

    def register(self) -> tuple:
        d = DeferredResponse()
        rid = next(self._ids)
        with self._plock:
            self._pending[rid] = d
        return rid, d

    def discard(self, rid: int):
        with self._plock:
            self._pending.pop(rid, None)

    def send(self, ftype: int, payload: bytes = b"", rid=None):
        try:
            self.sender.send(ftype, payload)
        except (OSError, ConnectionError):
            if rid is not None:
                self.discard(rid)
            raise ConnectionError("engine process unreachable")

    def hello(self, pid: int):
        self.send(ipc.HELLO, ipc.pack_hello(self.wid, pid))

    # -- inbound (reactor thread) -------------------------------------------

    # Frames handled per reactor pass: the remainder re-arms via
    # call_soon so response writes and new parses interleave with a
    # deep backlog instead of stalling behind one long encode loop.
    DRAIN_ROUND = 64

    def on_readable(self):
        """External-fd callback: drain buffered frames.  RESULT frames
        encode + resolve right here — the DeferredResponse's completion
        lands in the same thread's pending queue and is written before
        the loop's next poll, with zero syscalls."""
        if not self.reader.fill():
            self._engine_lost()
            return
        self._drain_some()

    def _drain_some(self):
        for _ in range(self.DRAIN_ROUND):
            frame = self.reader.next_buffered()
            if frame is None:
                return
            ftype, cur = frame
            if ftype == ipc.RESPONSE:
                rid, status, ctype, payload = ipc.unpack_response(cur)
                self._resolve(rid, status, ctype, bytes(payload))
            elif ftype == ipc.RESULT_FAST:
                rid, trace_id, results = ipc.unpack_result_fast(cur)
                # Response encode happens HERE, on the worker: the
                # engine shipped values, this process builds bytes.
                self._resolve(
                    rid, 200, "application/json",
                    fast_results_bytes(results, trace_id),
                )
            elif ftype == ipc.GETSTATS:
                self._send_stats(cur.u64())
            elif ftype == ipc.SHUTDOWN:
                self._begin_drain()
        if self.reader.buffered():
            srv = self.server
            if srv is not None:
                srv._reactors[0].call_soon(self._drain_some)
            else:
                self._drain_some()

    def _engine_lost(self):
        # Engine gone (or told us to drain and closed the socket).
        # In-flight requests can never resolve.
        if not self.draining:
            sys.stderr.write(
                f"worker-{self.wid}: engine link lost, exiting\n"
            )
            os._exit(1)

    def _resolve(self, rid, status, ctype, payload):
        with self._plock:
            d = self._pending.pop(rid, None)
        if d is not None:
            d.resolve(status, ctype, payload)

    def _send_stats(self, rid: int):
        """Scrape-time registry snapshot for the device-owner's
        aggregation.  Rendering the local registry never touches the
        engine, so there is no deadlock with the engine-side scrape
        waiting on this reply."""
        srv = self.server
        if srv is not None:
            srv.refresh_gauges()
        text = REGISTRY.prometheus_text()
        try:
            self.send(
                ipc.STATS, ipc.pack_stats(rid, ipc.rss_bytes(), text.encode())
            )
        except ConnectionError:
            pass

    def _begin_drain(self):
        """SHUTDOWN from the engine: stop after in-flight requests
        resolve.  The wait runs on a side thread — the reactor must
        keep draining RESPONSE frames for those very requests."""
        if self.draining:
            return
        self.draining = True

        def drain():
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                with self._plock:
                    if not self._pending:
                        break
                time.sleep(0.05)
            srv = self.server
            if srv is not None:
                try:
                    srv.shutdown()
                except Exception:  # noqa: BLE001 — exiting anyway
                    pass
            os._exit(0)

        threading.Thread(target=drain, daemon=True, name="drain").start()


class WorkerHandler:
    """The reactor-facing handler in a worker process: same
    ``handle_async``/``handle`` surface as net/server.py's Handler, but
    every route forwards over the engine link instead of touching an
    API.  ``handle_async`` performs the full PQL request decode on the
    reactor thread — that is the per-request byte work this process
    exists to own — and frames the decoded fields."""

    def __init__(self, link: EngineLink, allowed_origins=None):
        self.link = link
        self.allowed_origins = list(allowed_origins or [])

    def handle_async(self, method, path, query, body, headers):
        if method != "POST":
            return None
        m = _QUERY_PATH_RE.match(path)
        if m is None:
            return None
        if PROTOBUF_CONTENT_TYPE in headers.get(
            "Content-Type", ""
        ) or PROTOBUF_CONTENT_TYPE in headers.get("Accept", ""):
            return None  # protobuf negotiation: generic passthrough
        doc = decode_query_doc(query, body)
        flags = 0
        if doc["profile"]:
            flags |= ipc.F_PROFILE
        if doc["remote"]:
            flags |= ipc.F_REMOTE
        if doc["columnAttrs"]:
            flags |= ipc.F_COLUMN_ATTRS
        if doc["excludeRowAttrs"]:
            flags |= ipc.F_EXCL_ROW_ATTRS
        if doc["excludeColumns"]:
            flags |= ipc.F_EXCL_COLUMNS
        rid, d = self.link.register()
        self.link.send(
            ipc.QUERY,
            ipc.pack_query(
                rid,
                flags,
                m.group(1),
                doc["query"],
                tenant_of(headers, path),
                headers.get("X-Trace-Id") or headers.get("x-trace-id"),
                headers.get("X-Span-Id") or headers.get("x-span-id"),
                doc["shards"],
            ),
            rid=rid,
        )
        return d

    def handle(self, method, path, query, body, headers):
        """Generic route passthrough, called on the worker's blocking
        pool: frame the request, park this pool thread on the reply."""
        target = path
        if query:
            target += "?" + urlencode(query, doseq=True)
        rid, d = self.link.register()
        self.link.send(
            ipc.HTTP,
            ipc.pack_http(
                rid, method, target, json.dumps(headers).encode(), body
            ),
            rid=rid,
        )
        if not d._event.wait(self.link.response_timeout):
            self.link.discard(rid)
            return (
                504,
                "application/json",
                b'{"error": "device-owner process did not answer in time"}',
            )
        return d._triple


def main():
    spec = json.loads(os.environ["PILOSA_TPU_WORKER_SPEC"])
    wid = int(spec["wid"])
    link = EngineLink(
        spec["ipc"], wid,
        response_timeout=float(spec.get("response_timeout") or 330.0),
    )
    handler = WorkerHandler(link, spec.get("allowed_origins"))
    ssl_ctx = None
    if spec.get("tls_certificate"):
        from .front import make_server_ssl_context

        ssl_ctx = make_server_ssl_context(
            spec["tls_certificate"], spec.get("tls_key", "")
        )
    srv = AsyncHTTPServer(
        spec["host"],
        int(spec["port"]),
        ssl_context=ssl_ctx,
        reactors=spec.get("reactors") or 1,
        pool_workers=spec.get("pool_workers"),
        queue_depth=spec.get("queue_depth"),
        admission=None,  # admission is GLOBAL: the device-owner arbitrates
        max_body_bytes=spec.get("max_body_bytes"),
        read_timeout=spec.get("read_timeout"),
        idle_timeout=spec.get("idle_timeout"),
        response_timeout=spec.get("response_timeout"),
        reuseport=True,  # share the port with sibling workers
    )
    srv.RequestHandlerClass.handler = handler
    # The single-threaded query path: the engine link lives on the
    # reactor's selector, and outbound frames are corked per event-loop
    # iteration so a parsed pipelined burst becomes ONE AF_UNIX sendall.
    srv.register_external(link.sock, link.on_readable)
    srv.loop_hooks = (link.sender.cork, link.sender.uncork)
    link.server = srv
    threading.Thread(
        target=srv.serve_forever, daemon=True, name="serve"
    ).start()
    # HELLO after the listeners are live: the supervisor treats it as
    # "this worker is accepting".
    link.hello(os.getpid())
    # The reactor owns the link now; the main thread just parks.
    threading.Event().wait()


if __name__ == "__main__":
    main()
