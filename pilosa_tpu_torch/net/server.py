"""HTTP server: the reference's route table on stdlib http.server.

Routes mirror http/handler.go:237-272 — the public JSON API plus the
single-node ``/internal/*`` endpoints that backup, restore and key
translation use.  gorilla/mux becomes a regex route table; JSON is the
canonical wire format, and the query and import routes negotiate
protobuf (``application/x-protobuf``) as the reference does.

The port of the single-node part of ``pilosa_tpu/net/server.py``: every
route listed in ``Handler.__init__`` answers as the reference answers,
byte for byte apart from trace ids and timings.  The routes of modules
not ported yet answer 501 with ``{"error": ...}`` naming the ROADMAP.md
item that ports them (``_UNPORTED_ROUTES``), and an API method that
raises ``NotImplementedError`` does the same; every other error keeps
the reference's mapping (``error_response``).  A kernel that fails on
the card fails its request with a 500: nothing here falls back to a
plain version.
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..api import API, ApiError, ImportRequest, ImportValueRequest, NotFoundError, QueryRequest
from ..executor import QueryResponse
from ..executor.executor import Error as ExecError, FieldNotFoundError, IndexNotFoundError
from ..executor.translate import TranslateError
from ..pql import ParseError
from ..util import plans as plans_mod
from ..util.stats import (
    METRIC_ENGINE_FUSED_MASKS_EVAL,
    METRIC_ENGINE_FUSED_MASKS_REF,
    METRIC_ENGINE_FUSED_PROGRAMS,
    METRIC_ENGINE_FUSED_QUERIES,
    METRIC_ENGINE_REBUILDS,
    METRIC_ENGINE_UPDATES,
    METRIC_SERVER_ERRORS,
    REGISTRY,
)
from . import proto
from .admission import tenant_of
from .faults import PLANE
from .front import (  # noqa: F401 — re-exported, the node's names for them
    DeferredResponse,
    _parse_shards,
    _qbool,
    _qflag,
    decode_query_doc,
    make_server_ssl_context,
)
from .wire import count_response_bytes, response_to_json

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# Negotiated by ``Accept: application/openmetrics-text``: the exposition
# that may carry exemplars (util/stats prometheus_text).
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

# Serving backend selection (docs/serving.md): "async" is the event-loop
# reactor (net/aserver.py); "threaded" is the stdlib thread-per-connection
# server kept as the differential oracle.  Config [server] backend /
# PILOSA_TPU_SERVER_BACKEND override.
DEFAULT_BACKEND = "async"

_ITEM_15 = "Queue 1 item 15 (multi-GPU and multi-host)"

# (method, route pattern, ROADMAP.md item) of every reference route this
# port leaves out: each answers 501 naming its item.
_UNPORTED_ROUTES = [
    ("POST", "/cluster/resize/abort", _ITEM_15),
    ("POST", "/cluster/resize/remove-node", _ITEM_15),
    ("POST", "/cluster/resize/set-coordinator", _ITEM_15),
    ("GET", "/cluster/metrics", _ITEM_15),
    ("POST", "/internal/cluster/message", _ITEM_15),
    ("GET", "/internal/fragment/blocks", _ITEM_15),
    ("GET", "/internal/fragment/block/data", _ITEM_15),
    ("GET", "/internal/fragment/nodes", _ITEM_15),
    ("GET", "/internal/nodes", _ITEM_15),
    ("POST", "/internal/index/{index}/attr/diff", _ITEM_15),
    ("POST", "/internal/index/{index}/field/{field}/attr/diff", _ITEM_15),
    ("DELETE", "/internal/index/{index}/field/{field}/remote-available-shards/{shardID}",
     _ITEM_15),
    ("GET", "/internal/translate/data", _ITEM_15),
    ("POST", "/internal/mesh/dispatch", _ITEM_15),
    ("POST", "/internal/mesh/ticket", _ITEM_15),
]


def _resolve_backend(backend: Optional[str]) -> str:
    if backend:
        return backend
    return os.environ.get("PILOSA_TPU_SERVER_BACKEND", DEFAULT_BACKEND)


# Process start reference for /healthz uptime.
_START_MONOTONIC = time.monotonic()


def error_response(e: BaseException) -> Tuple[int, bytes]:
    """Exception -> (status, JSON payload), shared by the synchronous
    route dispatch and deferred completion callbacks so both paths map
    errors identically.  ``NotImplementedError`` (a part of the reference
    this port leaves out, naming its ROADMAP.md item) answers 501."""
    if isinstance(e, (NotFoundError, IndexNotFoundError, FieldNotFoundError)):
        return 404, json.dumps({"error": str(e)}).encode()
    if isinstance(e, (ApiError, ExecError, ParseError, TranslateError, ValueError)):
        return 400, json.dumps({"error": str(e)}).encode()
    if isinstance(e, NotImplementedError):
        return 501, json.dumps({"error": str(e)}).encode()
    # Panic recovery (http/handler.go); print_exception(triple) works
    # from callbacks too, where there is no "current" exception.
    traceback.print_exception(type(e), e, e.__traceback__)
    return 500, json.dumps({"error": str(e)}).encode()


def _serve_fault(path: str):
    """The fault plane's serve-side verdict for one request: an injected
    error's (status, content type, payload), or None (a delay rule has
    slept already).  ``/debug/faults`` stays immune, so a drill can always
    be inspected and healed from the node it faults."""
    if not PLANE.active or path.startswith("/debug/faults"):
        return None
    verdict = PLANE.intercept("serve", route=path, transport="serve")
    if verdict is None:
        return None
    payload = json.dumps({"error": f"fault injected: {verdict.status}"}).encode()
    return verdict.status, "application/json", payload


def _unported(path: str, item: str):
    def fn(q, b, **kw):
        raise NotImplementedError(
            f"{path} is not ported to pilosa_tpu_torch yet: ROADMAP.md {item}")
    return fn


class Route:
    def __init__(self, method: str, pattern: str, fn: Callable):
        self.method = method
        self.regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )
        self.fn = fn


class Handler:
    """Dispatches requests to the API (http/handler.go Handler).

    ``allowed_origins`` enables CORS (http/handler.go:80-90
    OptHandlerAllowedOrigins wrapping gorilla's CORS middleware):
    matching Origins get ``Access-Control-Allow-Origin`` on responses
    and OPTIONS preflights are answered with the allowed methods and
    the Content-Type header, mirroring handlers.CORS defaults."""

    def __init__(self, api: API, allowed_origins=None):
        self.api = api
        self.allowed_origins = list(allowed_origins or [])
        # Wired by serve() on the async backend: the reactor, whose
        # connection and admission gauges refresh at scrape time.
        self.server = None
        # Every 5xx answer counts into pilosa_server_errors_total.
        self._err_counter = REGISTRY.counter(METRIC_SERVER_ERRORS)
        # Previous-scrape counter snapshot for /debug/vars "rates".
        self._rates_prev = None
        self.routes: List[Route] = []
        r = self._route
        # Public routes (http/handler.go:237-259).
        r("GET", "/", self._home)
        r("GET", "/version", lambda q, b, **kw: {"version": self.api.version()})
        r("GET", "/info", lambda q, b, **kw: self.api.info())
        r("GET", "/schema", lambda q, b, **kw: {"indexes": self.api.schema()})
        r("GET", "/status", self._status)
        r("GET", "/index", lambda q, b, **kw: {"indexes": self.api.schema()})
        r("GET", "/index/{index}", self._get_index)
        r("POST", "/index/{index}", self._post_index)
        r("DELETE", "/index/{index}", self._delete_index)
        r("POST", "/index/{index}/field/{field}", self._post_field)
        r("DELETE", "/index/{index}/field/{field}", self._delete_field)
        r("POST", "/index/{index}/field/{field}/import", self._post_import)
        r("POST", "/index/{index}/field/{field}/import-roaring/{shard}",
          self._post_import_roaring)
        r("POST", "/index/{index}/query", self._post_query)
        # Continuous queries (net/cq.py): subscribe a PQL query, long-poll
        # its result deltas as writes stream in.
        r("POST", "/cq", self._post_cq)
        r("GET", "/cq/{cqid}", self._get_cq)
        r("DELETE", "/cq/{cqid}", self._delete_cq)
        r("GET", "/export", self._get_export)
        r("POST", "/recalculate-caches", self._recalculate_caches)
        r("GET", "/metrics", self._metrics)
        r("GET", "/healthz", self._healthz)
        r("GET", "/readyz", self._readyz)
        r("GET", "/debug/vars", self._debug_vars)
        r("GET", "/debug/traces", self._debug_traces)
        r("GET", "/debug/events", self._debug_events)
        r("GET", "/debug/pprof", self._debug_pprof)
        r("GET", "/debug/pprof/goroutine", self._debug_pprof)
        r("GET", "/debug/pprof/profile", self._debug_pprof_profile)
        r("GET", "/debug/pprof/heap", self._debug_pprof_heap)
        r("POST", "/debug/pprof/trace", self._debug_pprof_trace)
        # Internal routes a single node serves (http/handler.go:262-272).
        r("GET", "/internal/shards/max",
          lambda q, b, **kw: {"standard": self.api.max_shards()})
        r("POST", "/internal/translate/keys", self._translate_keys)
        r("POST", "/internal/fragment/data", self._post_fragment_data)
        r("GET", "/internal/fragment/data", self._get_fragment_data)
        r("GET", "/debug/plans", self._debug_plans)
        r("GET", "/debug/sequences", self._debug_sequences)
        r("GET", "/debug/faults", self._debug_faults_get)
        r("POST", "/debug/faults", self._debug_faults_post)
        r("GET", "/debug/history", self._debug_history)
        r("GET", "/debug/heat", self._debug_heat)
        r("GET", "/debug/prefetch_advice", self._debug_prefetch_advice)
        r("GET", "/debug/flightrecorder", self._debug_flightrecorder)
        for method, pattern, item in _UNPORTED_ROUTES:
            r(method, pattern, _unported(pattern, item))

    def _route(self, method, pattern, fn):
        self.routes.append(Route(method, pattern, fn))

    # -- dispatch ----------------------------------------------------------

    def handle(
        self,
        method: str,
        path: str,
        query: dict,
        body: bytes,
        headers: Optional[dict] = None,
    ):
        """Returns (status, content_type, payload bytes) or a
        DeferredResponse.  Applies the fault plane's serve-side rules
        (peer="serve": drills against this node's own HTTP surface) and
        counts every 5xx answer into pilosa_server_errors_total, the
        numerator of the SLO error-rate objective (util/slo.py)."""
        injected = _serve_fault(path)
        if injected is not None:
            self._err_counter.inc()
            return injected
        result = self._dispatch(method, path, query, body, headers)
        if isinstance(result, DeferredResponse):
            result.on_ready(
                lambda status, ctype, payload: (
                    self._err_counter.inc() if status >= 500 else None
                )
            )
        elif (
            isinstance(result, tuple)
            and result
            and isinstance(result[0], int)
            and result[0] >= 500
        ):
            self._err_counter.inc()
        return result

    def _dispatch(
        self,
        method: str,
        path: str,
        query: dict,
        body: bytes,
        headers: Optional[dict] = None,
    ):
        """Returns (status, content_type, payload bytes)."""
        headers = headers or {}
        # Protobuf negotiation on the query/import routes, as the
        # reference does (http/handler.go Accept/Content-Type
        # application/x-protobuf).
        ctype = headers.get("Content-Type", "")
        accept = headers.get("Accept", "")
        if method == "POST" and (
            proto.CONTENT_TYPE in ctype or proto.CONTENT_TYPE in accept
        ):
            m = re.match(r"^/index/([^/]+)/query$", path)
            if m:
                return self._query_proto(m.group(1), query, body, ctype, accept)
            m = re.match(r"^/index/([^/]+)/field/([^/]+)/import$", path)
            if m and proto.CONTENT_TYPE in ctype:
                # Same exception->status mapping as the routed handlers:
                # an import validation error must answer 400, not drop
                # the connection.
                try:
                    return self._import_proto(m.group(1), m.group(2), query, body)
                except Exception as e:  # noqa: BLE001 — shared status mapping
                    status, payload = error_response(e)
                    return status, "application/json", payload
        for route in self.routes:
            if route.method != method:
                continue
            m = route.regex.match(path)
            if m is None:
                continue
            try:
                result = route.fn(query, body, _headers=headers, **m.groupdict())
            except Exception as e:  # noqa: BLE001 — shared status mapping
                status, payload = error_response(e)
                return status, "application/json", payload
            if isinstance(result, DeferredResponse):
                return result
            if isinstance(result, tuple) and len(result) == 3:
                return result  # (status, content-type, payload bytes)
            if isinstance(result, bytes):
                return 200, "application/octet-stream", result
            if isinstance(result, str):
                return 200, "text/plain", result.encode()
            return 200, "application/json", json.dumps(result).encode()
        return 404, "application/json", b'{"error": "not found"}'

    # -- protobuf handlers -------------------------------------------------

    def _query_proto(self, index, q, body, ctype, accept):
        if proto.CONTENT_TYPE in ctype:
            doc = proto.decode_query_request(body)
        else:
            try:
                doc = json.loads(body) if body else {}
            except UnicodeDecodeError:
                # A non-UTF-8 body is a client error, not a server crash
                # (json.loads raises UnicodeDecodeError, not
                # JSONDecodeError, on undecodable bytes).
                payload = proto.encode_query_response(
                    QueryResponse([]), err="request body is not valid UTF-8"
                )
                return 400, proto.CONTENT_TYPE, payload
            except json.JSONDecodeError:
                # Raw-PQL body fallback (the body decoded as UTF-8, it
                # just isn't JSON).
                doc = {
                    "query": body.decode() if isinstance(body, bytes) else body
                }
            if isinstance(doc, str):
                doc = {"query": doc}
        req = QueryRequest(
            index,
            doc.get("query", ""),
            shards=doc.get("shards") or _parse_shards(q),
            column_attrs=doc.get("columnAttrs", False),
            exclude_row_attrs=doc.get("excludeRowAttrs", False),
            exclude_columns=doc.get("excludeColumns", False),
            remote=doc.get("remote", False) or _qbool(q, "remote"),
        )
        try:
            resp = self.api.query(req)
        except Exception as e:  # errors travel in QueryResponse.Err
            status = 501 if isinstance(e, NotImplementedError) else 400
            payload = proto.encode_query_response(QueryResponse([]), err=str(e))
            return status, proto.CONTENT_TYPE, payload
        if proto.CONTENT_TYPE in accept:
            return 200, proto.CONTENT_TYPE, proto.encode_query_response(resp)
        return 200, "application/json", json.dumps(response_to_json(resp)).encode()

    def _import_proto(self, index, field, q, body):
        doc = proto.decode_import_request(body)
        if _qbool(q, "remote"):
            raise NotImplementedError(
                f"remote imports are not ported to pilosa_tpu_torch yet: ROADMAP.md {_ITEM_15}")
        if doc["columnIDs"] or doc["columnKeys"]:
            self.api.import_bits(
                ImportRequest(
                    index,
                    field,
                    shard=doc["shard"],
                    row_ids=doc["rowIDs"],
                    column_ids=doc["columnIDs"],
                    row_keys=doc["rowKeys"],
                    column_keys=doc["columnKeys"],
                    timestamps=doc["timestamps"],
                ),
                clear=_qbool(q, "clear"),
            )
        return 200, proto.CONTENT_TYPE, b""

    # -- handlers ----------------------------------------------------------

    def _home(self, q, b, **kw):
        return {"name": "pilosa-tpu", "version": self.api.version()}

    def _status(self, q, b, **kw):
        return {
            "state": self.api.state(),
            "nodes": self.api.hosts(),
            "localID": self.api.node()["id"],
        }

    def _get_index(self, q, b, *, index, **kw):
        idx = self.api.index(index)
        return {"name": index, "options": {"keys": idx.keys}}

    def _post_index(self, q, b, *, index, **kw):
        doc = json.loads(b) if b else {}
        opts = doc.get("options", {})
        self.api.create_index(
            index,
            keys=opts.get("keys", False),
            track_existence=opts.get("trackExistence", True),
        )
        return {}

    def _delete_index(self, q, b, *, index, **kw):
        self.api.delete_index(index)
        return {}

    def _post_field(self, q, b, *, index, field, **kw):
        doc = json.loads(b) if b else {}
        self.api.create_field(index, field, doc.get("options"))
        return {}

    def _delete_field(self, q, b, *, index, field, **kw):
        self.api.delete_field(index, field)
        return {}

    def _query_request(self, index, q, b, headers) -> QueryRequest:
        """Decode one POST /index/{i}/query body into a QueryRequest —
        shared by the threaded route handler and the reactor's inline
        path.  The reference reads the body as raw PQL unless it's
        protobuf (http/handler.go handlePostQuery); accept JSON
        {"query": ...} as well as a bare PQL string."""
        doc = decode_query_doc(q, b)
        # X-Pilosa-Replica-Read / X-Pilosa-Freshness-Ms are validated as
        # the reference validates them; a single node is every shard's
        # primary, so a valid value changes nothing.
        h = headers or {}
        replica_read = (
            h.get("X-Pilosa-Replica-Read") or h.get("x-pilosa-replica-read")
            or ""
        ).strip().lower()
        if replica_read not in ("", "primary", "any", "bounded"):
            raise ValueError(
                f"X-Pilosa-Replica-Read: {replica_read!r}: expected "
                "primary, any, or bounded"
            )
        raw = h.get("X-Pilosa-Freshness-Ms") or h.get("x-pilosa-freshness-ms")
        if raw:
            try:
                float(raw)
            except ValueError:
                raise ValueError(
                    f"X-Pilosa-Freshness-Ms: {raw!r}: expected a number"
                ) from None
        return QueryRequest(
            index,
            doc["query"],
            shards=doc["shards"],
            column_attrs=doc["columnAttrs"],
            exclude_row_attrs=doc["excludeRowAttrs"],
            exclude_columns=doc["excludeColumns"],
            remote=doc["remote"],
            # Join the caller's trace when the request carries one.
            trace_context=self.api.tracer.extract_headers(h),
            # ?profile=1 returns the recorded query plan inline; the
            # tenant keys the plan's cost attribution the way admission
            # fairness resolves it (the header, else the index name).
            profile=doc["profile"],
            tenant=tenant_of(h, f"/index/{index}/query"),
        )

    def _defer_query(self, req: QueryRequest):
        """Submit ``req`` into the batch pipeline; DeferredResponse when
        it pipelined, None when the caller must run the sync path."""
        fut = self.api.query_async(req)
        if fut is None:
            return None
        # Pipelined: the response resolves from the batcher's completion
        # callback; the calling thread (handler thread or reactor) goes
        # back to reading requests instead of waiting on the card.
        d = DeferredResponse()

        def _done(f):
            try:
                resp = f.result(0)
                span = getattr(f, "trace_span", None)
                trace_id = span.trace_id if span is not None else None
                plan = getattr(f, "query_plan", None) if req.profile else None
                payload = (count_response_bytes(resp, trace_id)
                           if plan is None else None)  # profiled: the full encoder
                if payload is None:
                    out = response_to_json(resp)
                    if trace_id is not None:
                        out["traceID"] = trace_id
                    if plan is not None:
                        out["plan"] = plan.to_dict()
                    payload = json.dumps(out).encode()
                d.resolve(200, "application/json", payload)
            except Exception as e:  # noqa: BLE001
                status, payload = error_response(e)
                d.resolve(status, "application/json", payload)

        fut.add_done_callback(_done)
        return d

    # The reactor's inline route: only deferred queries may run on the
    # event loop (everything else can block).
    _QUERY_PATH_RE = re.compile(r"^/index/([^/]+)/query$")

    def handle_async(self, method, path, query, body, headers):
        """Non-blocking dispatch attempt for the event-loop server
        (net/aserver.py): decode the query and feed it into the batcher
        ON THE REACTOR THREAD, so concurrent arrivals from every live
        connection coalesce into the same K5 launches.  Nothing on this
        path waits on the card (no readback, no synchronize): the parse,
        the O(1)-lane answers and the batcher's queue append.  Returns a
        DeferredResponse / response triple, or None when the request
        needs the blocking worker pool (non-query routes, protobuf
        negotiation, sync-fallback queries)."""
        if method != "POST":
            return None
        m = self._QUERY_PATH_RE.match(path)
        if m is None:
            return None
        if proto.CONTENT_TYPE in headers.get(
            "Content-Type", ""
        ) or proto.CONTENT_TYPE in headers.get("Accept", ""):
            return None
        # The inline path bypasses handle(), so it runs the same serve-side
        # fault intercept and 5xx accounting: without it an injected error
        # would never reach the SLO's error rate on this path.
        injected = _serve_fault(path)
        if injected is not None:
            self._err_counter.inc()
            return injected
        req = self._query_request(m.group(1), query, body, headers)
        result = self._defer_query(req)
        if isinstance(result, DeferredResponse):
            result.on_ready(lambda status, ctype, payload: (
                self._err_counter.inc() if status >= 500 else None))
        return result

    def _post_query(self, q, b, *, index, **kw):
        req = self._query_request(index, q, b, kw.get("_headers", {}))
        d = self._defer_query(req)
        if d is not None:
            return d
        resp = self.api.query(req)
        if resp.plan is None:
            # Fast JSON encode for int and TopN (id, count) results —
            # byte-identical to the generic walk (net/wire.py).
            payload = count_response_bytes(resp, getattr(resp, "trace_id", None))
            if payload is not None:
                return 200, "application/json", payload
        out = response_to_json(resp)
        if getattr(resp, "trace_id", None):
            out["traceID"] = resp.trace_id
        if resp.plan is not None:
            out["plan"] = resp.plan
        return out

    # -- continuous queries (net/cq.py) -------------------------------------

    def _post_cq(self, q, b, **kw):
        doc = json.loads(b) if b else {}
        index, query = doc.get("index"), doc.get("query")
        if not index or not query:
            raise ApiError("cq requires 'index' and 'query'")
        return self.api.cq.create(index, query)

    def _get_cq(self, q, b, *, cqid, **kw):
        since = int(q.get("since", ["0"])[0])
        wait_ms = int(q.get("wait_ms", ["0"])[0])
        try:
            return self.api.cq.poll(cqid, since=since, wait_ms=wait_ms)
        except KeyError:
            raise NotFoundError("no such continuous query: %s" % cqid) from None

    def _delete_cq(self, q, b, *, cqid, **kw):
        try:
            return self.api.cq.delete(cqid)
        except KeyError:
            raise NotFoundError("no such continuous query: %s" % cqid) from None

    def _post_import(self, q, b, *, index, field, **kw):
        doc = json.loads(b)
        if _qbool(q, "remote"):
            raise NotImplementedError(
                f"remote imports are not ported to pilosa_tpu_torch yet: ROADMAP.md {_ITEM_15}")
        clear = _qbool(q, "clear")  # handler.go:1002 doClear
        if "values" in doc:
            self.api.import_values(
                ImportValueRequest(
                    index,
                    field,
                    shard=doc.get("shard", 0),
                    column_ids=doc.get("columnIDs"),
                    column_keys=doc.get("columnKeys"),
                    values=doc.get("values"),
                ),
                clear=clear,
            )
        else:
            self.api.import_bits(
                ImportRequest(
                    index,
                    field,
                    shard=doc.get("shard", 0),
                    row_ids=doc.get("rowIDs"),
                    column_ids=doc.get("columnIDs"),
                    row_keys=doc.get("rowKeys"),
                    column_keys=doc.get("columnKeys"),
                    timestamps=doc.get("timestamps"),
                ),
                clear=clear,
            )
        return {}

    def _post_import_roaring(self, q, b, *, index, field, shard, **kw):
        view = q.get("view", ["standard"])[0]
        clear = _qbool(q, "clear")
        n = self.api.import_roaring(
            index, field, int(shard), b, view=view, clear=clear
        )
        return {"changed": n}

    def _get_export(self, q, b, **kw):
        index = q.get("index", [""])[0]
        field = q.get("field", [""])[0]
        shard = int(q.get("shard", ["0"])[0])
        buf = io.StringIO()
        self.api.export_csv(index, field, shard, buf)
        return buf.getvalue()

    def _metrics_text(self, openmetrics: bool = False) -> str:
        """The node's Prometheus exposition: the process registry with
        the batcher's pipeline gauges, the engine's counters and the
        serving tier's gauges refreshed at pull time."""
        eng = getattr(self.api, "engine", None)
        if eng is not None:
            snap = eng.pipeline_snapshot()
            if snap is not None:
                REGISTRY.set_gauge(
                    "pilosa_pipeline_depth_configured", snap.get("depth", 0)
                )
                for name, value in snap.get("gauges", {}).items():
                    REGISTRY.set_gauge("pilosa_pipeline_" + name, value)
                REGISTRY.set_gauge(
                    "pilosa_pipeline_batches_total", snap.get("batches", 0)
                )
            for name, value in (
                (METRIC_ENGINE_REBUILDS, eng.stack_rebuilds),
                (METRIC_ENGINE_UPDATES, eng.stack_updates),
                (METRIC_ENGINE_FUSED_PROGRAMS, eng.fused_programs),
                (METRIC_ENGINE_FUSED_QUERIES, eng.fused_program_queries),
                (METRIC_ENGINE_FUSED_MASKS_EVAL, eng.fused_masks_evaluated),
                (METRIC_ENGINE_FUSED_MASKS_REF, eng.fused_masks_referenced),
            ):
                REGISTRY.counter(name).set(value)
            eng.refresh_metrics()  # the resident block fraction
        # Serving-tier gauges (live connections, admission in-flight /
        # active tenants) refresh at scrape time too.
        if self.server is not None:
            self.server.refresh_gauges()
        # The tenant ledger's rows flush into pilosa_tenant_* at pull time
        # (the query path only touches the ledger's own lock).
        plans_mod.LEDGER.refresh_series()
        return REGISTRY.prometheus_text(openmetrics=openmetrics)

    def _node_metrics_text(self, openmetrics: bool = False) -> str:
        """The whole node's exposition: this process's registry and, in
        process mode, every worker's registry summed in at scrape time with
        the per-process liveness and RSS gauges
        (``ProcessHTTPServer.aggregate_metrics``)."""
        srv = self.server
        if srv is not None and hasattr(srv, "aggregate_metrics"):
            return srv.aggregate_metrics(self, openmetrics=openmetrics)
        return self._metrics_text(openmetrics=openmetrics)

    def _metrics(self, q, b, **kw):
        """GET /metrics: the process registry in the classic Prometheus
        text exposition.  Negotiating ``Accept: application/openmetrics-text``
        switches to the OpenMetrics exposition, whose ``_bucket`` samples
        carry trace-id exemplars (``# {trace_id=...}``): the click-through
        to /debug/plans?trace=<id>."""
        headers = kw.get("_headers", {})
        accept = next(
            (v for k, v in headers.items() if k.lower() == "accept"), ""
        )
        if "application/openmetrics-text" in accept:
            text = self._node_metrics_text(openmetrics=True)
            return 200, OPENMETRICS_CONTENT_TYPE, text.encode()
        return 200, PROMETHEUS_CONTENT_TYPE, self._node_metrics_text().encode()

    def _healthz(self, q, b, **kw):
        """GET /healthz: liveness — the process is up and the route
        table answers.  Always 200; readiness is /readyz's job."""
        return {
            "status": "ok",
            "uptimeSeconds": round(time.monotonic() - _START_MONOTONIC, 3),
        }

    def _readyz(self, q, b, **kw):
        """GET /readyz: 200 only when the holder is open and the warm
        start (when one ran this boot) is done; 503 with the reasons
        otherwise, with the warm start's progress under ``warming``."""
        ready, reasons = self.api.readiness()
        doc = {"ready": ready, "reasons": reasons, "state": self.api.state()}
        ws = self.api.warm_status()
        if ws is not None:
            doc["warming"] = ws
        # The device working set (docs/residency.md): informational, a
        # cold working set still answers from the host tier.
        rs = self.api.residency_status()
        if rs is not None:
            doc["residency"] = rs
        # SLO burn reasons (util/slo.py): informational only, a degraded
        # node still answers 200 and takes traffic (shedding is the
        # admission controller's job).
        slo = getattr(self.api, "slo", None)
        if slo is not None:
            doc["degraded"] = slo.degraded
        payload = json.dumps(doc).encode()
        return (200 if ready else 503), "application/json", payload

    def _debug_events(self, q, b, **kw):
        """GET /debug/events: the node's structured event journal,
        filterable with ?type= (exact or family prefix) and bounded with
        ?limit= (newest N)."""
        journal = getattr(self.api, "journal", None)
        if journal is None:
            return {"events": [], "capacity": 0, "dropped": 0, "node": ""}
        typ = q.get("type", [None])[0]
        try:
            limit = int(q.get("limit", ["256"])[0])
        except ValueError:
            raise ValueError("limit must be an integer")
        return journal.to_doc(type=typ, limit=limit)

    def _debug_traces(self, q, b, **kw):
        """GET /debug/traces: recent + slow span trees (JSON), each node
        carrying traceID/spanID/parentSpanID — the join surface for the
        traceID stamped into query responses and the long-query log."""
        tracer = getattr(self.api, "tracer", None)
        if tracer is None or not hasattr(tracer, "traces"):
            return {"recent": [], "slow": []}
        return tracer.traces()

    def _debug_plans(self, q, b, **kw):
        """GET /debug/plans: the bounded ring of recent plans and the
        slow-query analyzer's worst plans per op, each annotated with why
        it was slow.  ?op=Count filters by op, ?trace=<id> resolves one
        trace id to its plan, ?limit=N keeps the newest N."""
        try:
            limit = int(q.get("limit", ["64"])[0])
        except ValueError:
            raise ValueError("limit must be an integer")
        return plans_mod.STORE.to_doc(
            op=q.get("op", [None])[0],
            limit=limit,
            trace=q.get("trace", [None])[0],
        )

    def _debug_sequences(self, q, b, **kw):
        """GET /debug/sequences: the first-order plan-signature transition
        model the sequence miner learns from every recorded plan (the
        canonicalization of /debug/plans' subtrees): per signature the
        next signatures' probabilities and average gaps.  ?top=N edges per
        signature (default 5)."""
        from ..util import plan_miner

        try:
            top = int(q.get("top", ["5"])[0])
        except ValueError:
            raise ValueError("top must be an integer")
        return plan_miner.MINER.to_doc(top=top)

    def _recalculate_caches(self, q, b, **kw):
        self.api.recalculate_caches()
        return {}

    def _debug_pprof(self, q, b, **kw):
        """/debug/pprof (http/handler.go:241): a full thread stack dump,
        the Python analogue of goroutine profiles."""
        import sys

        frames = sys._current_frames()
        threads = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        for ident, frame in frames.items():
            out[threads.get(ident, str(ident))] = traceback.format_stack(frame)
        return {"threads": out, "count": len(out)}

    # One /debug/pprof/profile at a time: two sampling loops interleaving
    # their sleeps would each see about half the rate and count the other's
    # sampler in their stacks.  A waiter gives up after PPROF_WAIT_SECONDS
    # with a 429, so queued captures do not pin pool threads for minutes.
    _pprof_profile_lock = threading.Lock()
    PPROF_WAIT_SECONDS = 15.0
    # Distinct folded stacks kept per profile; past the cap samples
    # aggregate under one overflow key, so a long capture stays bounded.
    PPROF_MAX_STACKS = 5000

    def _debug_pprof_profile(self, q, b, **kw):
        """/debug/pprof/profile: a wall-clock sampling profiler over every
        thread (sys._current_frames) for ?seconds=N (at most 60) at ?hz=
        (at most 1000): folded stacks ("fnA;fnB;fnC count", the flamegraph
        format) and a table of the top leaf functions.  Identical stacks
        aggregate across threads; concurrent requests serialize."""
        import sys

        seconds = min(float(q.get("seconds", ["1"])[0]), 60.0)
        hz = min(int(q.get("hz", ["100"])[0]), 1000)
        period = 1.0 / max(hz, 1)
        me = threading.get_ident()
        folded: dict = {}
        leaf_counts: dict = {}
        n_samples = 0
        truncated = 0
        if not Handler._pprof_profile_lock.acquire(timeout=self.PPROF_WAIT_SECONDS):
            return 429, "application/json", json.dumps({
                "error": "a profile capture is already in progress",
                "retryAfterSeconds": self.PPROF_WAIT_SECONDS,
            }).encode()
        try:
            started = time.monotonic()
            deadline = started + seconds
            while time.monotonic() < deadline:
                for ident, frame in sys._current_frames().items():
                    if ident == me:
                        continue  # not the profiler's own sampling loop
                    stack = []
                    f = frame
                    while f is not None:
                        code = f.f_code
                        stack.append(f"{code.co_name} ({code.co_filename}:{code.co_firstlineno})")
                        f = f.f_back
                    stack.reverse()
                    key = ";".join(stack)
                    n = folded.get(key)
                    if n is None and len(folded) >= self.PPROF_MAX_STACKS:
                        key = "<overflow>"
                        n = folded.get(key)
                        truncated += 1
                    folded[key] = (n or 0) + 1
                    leaf = stack[-1] if key != "<overflow>" else "<overflow>"
                    leaf_counts[leaf] = leaf_counts.get(leaf, 0) + 1
                n_samples += 1
                time.sleep(period)
            ended = time.monotonic()
        finally:
            Handler._pprof_profile_lock.release()
        top = sorted(leaf_counts.items(), key=lambda kv: -kv[1])[:50]
        return {
            "seconds": seconds,
            "hz": hz,
            "samples": n_samples,
            "distinctStacks": len(folded),
            "truncatedSamples": truncated,
            "maxStacks": self.PPROF_MAX_STACKS,
            # The capture window: two profiles' windows never overlap.
            "startedMonotonic": started,
            "endedMonotonic": ended,
            "top": [{"func": f, "count": c} for f, c in top],
            "folded": [f"{k} {v}" for k, v in sorted(folded.items(), key=lambda kv: -kv[1])],
        }

    def _debug_pprof_heap(self, q, b, **kw):
        """/debug/pprof/heap: a tracemalloc allocation profile.  The first
        call starts tracing (it costs allocations about twice their time,
        so it arms on demand); later calls return the top allocation
        sites by live bytes.  ?reset=true stops tracing."""
        import tracemalloc

        if _qbool(q, "reset"):
            if tracemalloc.is_tracing():
                tracemalloc.stop()
            return {"tracing": False}
        if not tracemalloc.is_tracing():
            tracemalloc.start(25)
            return {"tracing": True, "note": "tracing armed; call again for a snapshot"}
        snap = tracemalloc.take_snapshot()
        stats = snap.statistics("lineno")[:50]
        current, peak = tracemalloc.get_traced_memory()
        return {
            "tracing": True,
            "tracedBytes": current,
            "peakBytes": peak,
            "top": [{"site": str(s.traceback), "bytes": s.size, "count": s.count}
                    for s in stats],
        }

    _pprof_trace_lock = threading.Lock()

    def _debug_pprof_trace(self, q, b, **kw):
        """A torch.profiler capture: host ops, and on the card the kernels
        themselves (the device side the sampling profiler cannot see).
        ?seconds=N (at most 10) of whatever the node runs meanwhile,
        written as a Chrome trace (``trace.json``) into ?dir= (default: a
        fresh temporary directory); the answer names the file.  A second
        capture while one runs is refused, not queued."""
        import tempfile

        from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

        seconds = min(float(q.get("seconds", ["1"])[0]), 10.0)
        dirs = q.get("dir")
        trace_dir = dirs[0] if dirs else tempfile.mkdtemp(prefix="pilosa-torchprof-")
        if not Handler._pprof_trace_lock.acquire(blocking=False):
            raise ValueError("a profiler trace is already running")
        try:
            activities = [ProfilerActivity.CPU]
            eng = getattr(self.api, "engine", None)
            if eng is not None and eng.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            try:
                # Every thread's host ops (the serving and dispatch
                # threads), where this PyTorch offers it; the card's
                # activity is process-wide either way.
                extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
            except TypeError:
                extra = {}
            prof = profile(activities=activities, **extra)
            prof.start()
            try:
                time.sleep(seconds)
            finally:
                # Stopped whatever happens: a profiler left running would
                # refuse every later capture.
                prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, "trace.json")
            prof.export_chrome_trace(path)
        finally:
            Handler._pprof_trace_lock.release()
        return {"traceDir": trace_dir, "seconds": seconds, "traceFile": path}

    def _debug_vars(self, q, b, **kw):
        stats = getattr(self.api.executor, "stats", None)
        out = (
            stats.snapshot()
            if stats is not None and hasattr(stats, "snapshot")
            else {}
        )
        eng = getattr(self.api, "engine", None)
        if eng is not None:
            # The batcher's per-stage timings, in-flight depth and batch
            # occupancy, and the engine's dispatch and sync counters.
            snap = eng.pipeline_snapshot()
            if snap is not None:
                out["pipeline"] = snap
            out["engine"] = {
                "device": str(eng.device),
                "stackRebuilds": eng.stack_rebuilds,
                "stackUpdates": eng.stack_updates,
                "denseDispatches": eng.dense_dispatches,
                "sparseDispatches": eng.sparse_dispatches,
                "batchDispatches": eng.batch_dispatches,
                "groupDispatches": eng.group_dispatches,
                "fusedPrograms": eng.fused_programs,
                "deviceBytesSkipped": eng.device_bytes_skipped,
            }
            # The stack cache: resident and evicted-live bytes against the
            # budget, evictions, the residency fraction, the promotion
            # worker and the per-index working set.
            out["engineCaches"] = eng.cache_snapshot()
        # Continuous-query state: probe the slot directly, so that a
        # scrape never starts the sweeper thread.
        cq = getattr(self.api, "_cq", None)
        if cq is not None:
            out["continuousQueries"] = cq.snapshot()
        if eng is not None:
            syncer = eng._ingest_syncer
            if syncer is not None:
                out["ingestSync"] = {
                    "chunks": syncer.chunks,
                    "coalesced": syncer.coalesced,
                    "syncs": syncer.syncs,
                    "stacksSynced": syncer.stacks_synced,
                }
        # Serving-tier state (the reactor): live connections, admission
        # in-flight and per-tenant occupancy.
        if self.server is not None:
            out["server"] = self.server.snapshot()
        # Query plans and the tenant ledger's measured cost: the JSON twin
        # of /debug/plans and pilosa_tenant_*.
        out["queryPlans"] = {
            "recorded": plans_mod.STORE.recorded,
            "enabled": plans_mod.ENABLED,
        }
        out["tenants"] = plans_mod.LEDGER.snapshot()
        # Fault plane: shown whenever rules are installed.
        if PLANE.active:
            out["faults"] = PLANE.snapshot()
        ws = self.api.warm_status()
        if ws is not None:
            out["warmStart"] = ws
        plans_mod.LEDGER.refresh_series()
        snap = REGISTRY.snapshot()
        out["metrics"] = snap
        # Per-second counter rates since the previous /debug/vars scrape
        # (the first scrape answers {}).
        rates, self._rates_prev = REGISTRY.collect_rates(
            self._rates_prev, snapshot=snap
        )
        out["rates"] = rates
        # The self-hosted history and the SLO watcher, when wired.
        hist = getattr(self.api, "history", None)
        if hist is not None:
            out["history"] = hist.snapshot()
        slo = getattr(self.api, "slo", None)
        if slo is not None:
            out["slo"] = slo.snapshot()
        return out

    def _debug_faults_get(self, q, b, **kw):
        """GET /debug/faults: the fault plane's rule table with per-rule
        matched/injected tallies."""
        return PLANE.snapshot()

    def _debug_faults_post(self, q, b, **kw):
        """POST /debug/faults: replace the rule table at runtime.  Body
        {"seed": N, "rules": [spec, ...]}; an empty rules list heals
        everything.  Reseeds on every install, so re-posting one schedule
        replays the same verdicts."""
        doc = json.loads(b) if b else {}
        try:
            PLANE.configure(doc.get("rules", []), doc.get("seed"))
        except ValueError as e:
            raise ApiError(str(e)) from None
        journal = getattr(self.api, "journal", None)
        if journal is not None:
            journal.append("faults.configure", rules=len(doc.get("rules", [])),
                           seed=PLANE.seed, via="http")
        return PLANE.snapshot()

    def _debug_history(self, q, b, **kw):
        """GET /debug/history: read the self-hosted metrics history
        (util/history.py).  ``?series=<family>`` is required;
        ``since``/``until`` are epoch seconds (default: the last 5
        minutes), ``step`` downsamples, ``label`` picks one label set.
        Values are the stored fixed-point integers (divide by ``scale``),
        what a PQL Sum over ``_system`` returns for the same window."""
        hist = getattr(self.api, "history", None)
        if hist is None:
            return 404, "application/json", json.dumps({
                "error": "metrics history is not enabled "
                         "(set [observability] history = true)"
            }).encode()
        series = q.get("series", [None])[0]
        if not series:
            raise ValueError("series parameter is required")

        def _num(name):
            raw = q.get(name, [None])[0]
            if raw is None:
                return None
            try:
                return float(raw)
            except ValueError:
                raise ValueError(f"{name} must be epoch seconds")

        return hist.query(series, since=_num("since"), until=_num("until"),
                          step=_num("step"), label=q.get("label", [None])[0])

    def _debug_heat(self, q, b, **kw):
        """GET /debug/heat: the working-set heat tables, top-K hot rows and
        2 KiB blocks by EWMA heat, each row flagged resident or not, with
        the residency gap in bytes.  ?index= ?field= filter, ?topk=N rows
        and blocks a table (default 10)."""
        from ..util import heat as heat_mod

        try:
            topk = int(q.get("topk", ["10"])[0])
        except ValueError:
            raise ValueError("topk must be an integer")
        heat_mod.HEAT.refresh_gauges()
        return heat_mod.HEAT.to_doc(index=q.get("index", [None])[0],
                                    field=q.get("field", [None])[0], topk=topk)

    def _debug_prefetch_advice(self, q, b, **kw):
        """GET /debug/prefetch_advice: the prefetch advisor's outstanding
        advice (the predicted-next signature and its row hints) and its
        running score against what the next query touched."""
        from ..parallel.advisor import ADVISOR

        return ADVISOR.to_doc()

    def _debug_flightrecorder(self, q, b, **kw):
        """GET /debug/flightrecorder: capture a flight-recorder bundle now.
        ``?persist=1`` also writes it to <data-dir>/.flightrec/ as an
        SLO-triggered capture does."""
        slo = getattr(self.api, "slo", None)
        if slo is None:
            return 404, "application/json", json.dumps({
                "error": "flight recorder is not enabled "
                         "(set [observability] history = true)"
            }).encode()
        bundle = slo.flight_bundle()
        if q.get("persist", ["0"])[0] in ("1", "true"):
            bundle["persistedTo"] = slo.persist_bundle(bundle)
        return bundle

    def _translate_keys(self, q, b, **kw):
        doc = json.loads(b)
        ids = self.api.translate_keys(
            doc.get("index", ""), doc.get("field", ""), doc.get("keys", [])
        )
        return {"ids": ids}

    def _post_fragment_data(self, q, b, **kw):
        """Whole-fragment ingest (restore; cluster.go:1251-1347)."""
        n = self.api.import_roaring(
            q["index"][0],
            q["field"][0],
            int(q["shard"][0]),
            b,
            view=q.get("view", ["standard"])[0],
        )
        return {"changed": n}

    def _get_fragment_data(self, q, b, **kw):
        """Whole-fragment export (backup; http/client.go
        RetrieveShardFromURI :708)."""
        frag = self.api.holder.fragment(
            q["index"][0],
            q["field"][0],
            q.get("view", ["standard"])[0],
            int(q["shard"][0]),
        )
        if frag is None:
            raise NotFoundError("fragment not found")
        return frag.serialized()


class _ResponseSequencer:
    """Per-connection ordered response writer.  Every response on a
    connection — synchronous or deferred — takes a slot in request
    order and is written when it (and everything before it) is ready,
    so the connection thread can keep READING pipelined requests while
    completion callbacks resolve earlier ones out of order.  Writes run
    under the lock (ordering demands serialization anyway); a broken
    socket marks the sequencer dead and drops the backlog."""

    # Pending responses allowed per connection before the reader stalls:
    # bounds per-connection memory against a client that pipelines
    # without reading.
    MAX_PENDING = 64

    __slots__ = ("_wfile", "_lock", "_cond", "_next_slot", "_next_write",
                 "_ready", "dead")

    def __init__(self, wfile):
        self._wfile = wfile
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._next_slot = 0
        self._next_write = 0
        self._ready = {}
        self.dead = False

    def open_slot(self) -> int:
        with self._cond:
            while (
                self._next_slot - self._next_write >= self.MAX_PENDING
                and not self.dead
            ):
                self._cond.wait(1.0)
            slot = self._next_slot
            self._next_slot += 1
            return slot

    def complete(self, slot: int, raw: bytes):
        with self._cond:
            self._ready[slot] = raw
            while not self.dead and self._next_write in self._ready:
                buf = self._ready.pop(self._next_write)
                try:
                    self._wfile.write(buf)
                except Exception:  # noqa: BLE001 — client went away
                    self.dead = True
                    self._ready.clear()
                    break
                self._next_write += 1
            self._cond.notify_all()

    def drain(self, timeout: float) -> bool:
        """Wait until every opened slot is written (or the connection
        died); returns True when fully drained."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._next_write < self._next_slot and not self.dead:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 1.0))
            return self._next_write >= self._next_slot

    def kill(self):
        with self._cond:
            self.dead = True
            self._ready.clear()
            self._cond.notify_all()


class _HTTPRequestHandler(BaseHTTPRequestHandler):
    handler: Handler = None
    protocol_version = "HTTP/1.1"
    # Per-connection socket timeout (reads AND writes).  Deferred
    # responses are written by the batcher's drain thread, so a client
    # that stops reading would otherwise block that thread — and its
    # batchmates' completions — inside wfile.write forever.  With the
    # timeout, the write raises, the sequencer marks the connection
    # dead, and the drain moves on.
    timeout = 120.0
    # Ceiling on waiting for in-flight deferred responses at connection
    # close; above the batcher's wedge timeout so a drain hit means the
    # pipeline, not the drain, failed.
    DRAIN_TIMEOUT = 320.0

    def log_message(self, fmt, *args):
        pass

    def _cors_origin(self):
        """The request Origin when it matches the configured allowlist
        ('*' allows any), else None."""
        origins = self.handler.allowed_origins
        origin = self.headers.get("Origin")
        if not origins or not origin:
            return None
        if "*" in origins or origin in origins:
            return origin
        return None

    def _sequencer(self) -> _ResponseSequencer:
        seq = getattr(self, "_seq", None)
        if seq is None:
            seq = self._seq = _ResponseSequencer(self.wfile)
        return seq

    def _render_response(self, status, ctype, payload, cors_origin, vary):
        """Raw HTTP/1.1 response bytes.  Built by hand (not
        send_response/send_header) because deferred responses are
        written by completion callbacks AFTER the connection thread has
        moved on to the next request."""
        reason = self.responses.get(status, ("", ""))[0]
        head = [
            f"{self.protocol_version} {status} {reason}".encode(),
            b"Content-Type: " + ctype.encode(),
            b"Content-Length: " + str(len(payload)).encode(),
        ]
        if vary:
            # Per-Origin responses must not be cached across origins.
            head.append(b"Vary: Origin")
            if cors_origin is not None:
                head.append(
                    b"Access-Control-Allow-Origin: " + cors_origin.encode()
                )
        return b"\r\n".join(head) + b"\r\n\r\n" + payload

    def _dispatch(self, method):
        parsed = urlparse(self.path)
        query = parse_qs(parsed.query)
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        seq = self._sequencer()
        slot = seq.open_slot()
        try:
            result = self.handler.handle(
                method, parsed.path, query, body, dict(self.headers)
            )
        except Exception as e:  # noqa: BLE001 — an opened slot must be
            # completed no matter what, or every later response on this
            # connection queues behind it forever.
            status, payload = error_response(e)
            result = (status, "application/json", payload)
        if isinstance(result, DeferredResponse):
            # Capture per-REQUEST state now: by resolve time this
            # handler object is parsing the connection's next request.
            cors_origin = self._cors_origin()
            vary = bool(self.handler.allowed_origins)
            result.on_ready(
                lambda status, ctype, payload: seq.complete(
                    slot,
                    self._render_response(
                        status, ctype, payload, cors_origin, vary
                    ),
                )
            )
        else:
            status, ctype, payload = result
            seq.complete(
                slot,
                self._render_response(
                    status,
                    ctype,
                    payload,
                    self._cors_origin(),
                    bool(self.handler.allowed_origins),
                ),
            )
        if self.close_connection:
            # The last response of the connection may still be in
            # flight; the socket must not close under it.
            seq.drain(self.DRAIN_TIMEOUT)

    def finish(self):
        seq = getattr(self, "_seq", None)
        if seq is not None:
            seq.drain(self.DRAIN_TIMEOUT)
            seq.kill()
        super().finish()

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def do_OPTIONS(self):
        """CORS preflight (http/handler.go:83 handlers.CORS: allowed
        methods + the Content-Type header), routed through the
        sequencer like every other response."""
        origin = self._cors_origin()
        head = [f"{self.protocol_version} 200 OK".encode()]
        if self.handler.allowed_origins:
            head.append(b"Vary: Origin")
        if origin is not None:
            head.append(b"Access-Control-Allow-Origin: " + origin.encode())
            head.append(
                b"Access-Control-Allow-Methods: GET, POST, DELETE, OPTIONS"
            )
            head.append(b"Access-Control-Allow-Headers: Content-Type")
        head.append(b"Content-Length: 0")
        seq = self._sequencer()
        seq.complete(seq.open_slot(), b"\r\n".join(head) + b"\r\n\r\n")


def bind_http(
    host: str = "localhost",
    port: int = 10101,
    ssl_context=None,
    backend: Optional[str] = None,
    workers: Optional[int] = None,
    tls_certificate: str = "",
    tls_key: str = "",
    **server_opts,
):
    """Bind the listening socket WITHOUT serving yet, so that a caller
    learns an ephemeral port from ``.server_address`` before the API
    exists, then passes the instance to serve().  ``ssl_context`` serves
    HTTPS (server/server.go:204-214).

    ``backend`` picks the serving engine: "async" (default; the
    net/aserver.py event-loop reactor) or "threaded" (the stdlib
    thread-per-connection oracle).  ``workers > 0`` selects PROCESS mode
    on the async backend: N worker processes behind SO_REUSEPORT parse and
    encode the HTTP traffic and forward decoded queries to this process,
    the only one that touches the card (net/procserver.py; ``[server]
    workers`` / ``PILOSA_TPU_SERVER_WORKERS``, default 0: the in-process
    reactor).  ``server_opts`` go to the chosen server (reactors=,
    admission=, ...)."""
    if _resolve_backend(backend) != "threaded":
        if workers is None:
            try:
                workers = int(os.environ.get("PILOSA_TPU_SERVER_WORKERS", 0))
            except ValueError:
                workers = 0
        if workers and int(workers) > 0:
            from .procserver import ProcessHTTPServer

            return ProcessHTTPServer(
                host, port, workers=int(workers), ssl_context=ssl_context,
                tls_certificate=tls_certificate, tls_key=tls_key, **server_opts,
            )
        from .aserver import AsyncHTTPServer

        return AsyncHTTPServer(
            host, port, ssl_context=ssl_context, **server_opts
        )
    cls = type("_BoundHandler", (_HTTPRequestHandler,), {"handler": None})

    def handle_error(self, request, client_address):
        # TLS handshake failures (plain-HTTP probes, scanners, version
        # mismatch) are a one-line log, not a per-connection traceback.
        import ssl
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (ssl.SSLError, ConnectionResetError)):
            sys.stderr.write(
                f"tls/conn error from {client_address}: {exc!r}\n"
            )
            return
        ThreadingHTTPServer.handle_error(self, request, client_address)

    # Bursts of concurrent clients must not get connection-reset by the
    # stdlib default listen backlog of 5.
    srv_cls = type(
        "_PilosaHTTPServer",
        (ThreadingHTTPServer,),
        {"request_queue_size": 128, "handle_error": handle_error},
    )
    srv = srv_cls((host, port), cls)
    if ssl_context is not None:
        # Handshake on first read in the per-request thread, not in the
        # single accept loop.
        srv.socket = ssl_context.wrap_socket(
            srv.socket, server_side=True, do_handshake_on_connect=False
        )
    return srv


def serve(
    api: API,
    host: str = "localhost",
    port: int = 10101,
    srv=None,
    ssl_context=None,
    allowed_origins=None,
    backend: Optional[str] = None,
    admission=None,
    **server_opts,
) -> Tuple[object, threading.Thread]:
    """Start the HTTP server on a background thread; returns (server,
    thread).  port=0 binds an ephemeral port.  ``srv`` continues a socket
    pre-bound with bind_http().  ``ssl_context`` serves HTTPS;
    ``allowed_origins`` enables CORS.  ``backend``/``admission``/
    ``server_opts`` configure the event-loop server (docs/serving.md), and
    ``workers=N`` (in ``server_opts``) runs it in process mode; the
    threaded backend ignores them."""
    if srv is None:
        srv = bind_http(
            host, port, ssl_context=ssl_context, backend=backend,
            **server_opts,
        )
    handler = Handler(api, allowed_origins=allowed_origins)
    if hasattr(srv, "admission"):  # the async reactor or process mode
        if admission is None and srv.admission is None:
            from .admission import AdmissionController

            admission = AdmissionController()
        if admission is not None:
            srv.admission = admission
        handler.server = srv
        api.admission = srv.admission
        # The measured-cost loop: the tenant ledger streams each plan's
        # device-seconds into the controller, so weighted-fair shares
        # price what a tenant's queries cost, not how many it sent.
        plans_mod.LEDGER.bind_admission(srv.admission)
    if hasattr(srv, "not_ready_reasons"):
        # Process mode: /readyz folds the worker processes' health in.
        api.process_server = srv
    srv.RequestHandlerClass.handler = handler
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread
