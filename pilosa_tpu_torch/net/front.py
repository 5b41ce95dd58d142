"""The part of the HTTP front end that needs no engine: a deferred
response, the decode of a query request's body and parameters, the fast
JSON encode of Count and TopN results, and the server's TLS context.

The node's ``Handler`` (``net/server.py``) and the process-mode worker
(``net/worker.py``) share these.  The module imports neither torch nor
the API, so a worker process, which never touches the card, boots
without loading them (``net/worker.py``); ``net/server.py`` and
``net/wire.py`` re-export every name under the reference's module.
"""

from __future__ import annotations

import json
import threading
from typing import List, Optional

# net/proto.py's CONTENT_TYPE: a request that negotiates protobuf takes the
# generic passthrough in a worker, whose imports leave out the codec.
PROTOBUF_CONTENT_TYPE = "application/x-protobuf"

class DeferredResponse:
    """A route handler's promise of a (status, content-type, payload)
    triple resolved later by a completion callback (the pipelined query
    path): the connection thread registers a writer and goes back to
    reading requests instead of blocking on the card — no handler thread
    is held per in-flight query, and one connection can have many
    requests in flight (HTTP pipelining; the per-connection
    _ResponseSequencer keeps responses in request order)."""

    __slots__ = ("_triple", "_event", "_cbs")

    def __init__(self):
        self._triple = None
        self._event = threading.Event()
        self._cbs: list = []

    def resolve(self, status: int, ctype: str, payload: bytes):
        if self._event.is_set():
            return  # first resolution wins: a duplicate must not double-write
        self._triple = (status, ctype, payload)
        self._event.set()
        while self._cbs:
            try:
                fn = self._cbs.pop()
            except IndexError:
                break
            try:
                fn(*self._triple)
            except Exception:  # noqa: BLE001 — a dead connection must not
                pass  # poison the resolver (the batcher's drain thread)

    def on_ready(self, fn):
        """Register ``fn(status, ctype, payload)`` (runs immediately if
        already resolved; append-then-claim keeps the race with resolve
        lock-free)."""
        self._cbs.append(fn)
        if self._event.is_set():
            try:
                self._cbs.remove(fn)
            except ValueError:
                return
            fn(*self._triple)


def decode_query_doc(q: dict, b: bytes) -> dict:
    """Decode one POST /index/{i}/query body + query params into plain
    fields.  Accepts JSON ``{"query": ...}``, a JSON-quoted PQL string,
    and raw PQL."""
    try:
        doc = json.loads(b) if b else {}
    except json.JSONDecodeError:
        doc = {"query": b.decode() if isinstance(b, bytes) else b}
    if isinstance(doc, str):  # JSON-quoted PQL body
        doc = {"query": doc}
    return {
        "query": doc.get("query", ""),
        "shards": doc.get("shards") or _parse_shards(q),
        "columnAttrs": _qbool(q, "columnAttrs") or doc.get("columnAttrs", False),
        "excludeRowAttrs": _qbool(q, "excludeRowAttrs")
        or doc.get("excludeRowAttrs", False),
        "excludeColumns": _qbool(q, "excludeColumns")
        or doc.get("excludeColumns", False),
        "remote": _qbool(q, "remote") or doc.get("remote", False),
        "profile": _qflag(q, "profile") or doc.get("profile", False),
    }


def _qbool(q: dict, name: str) -> bool:
    return q.get(name, ["false"])[0].lower() == "true"


def _qflag(q: dict, name: str) -> bool:
    """Permissive boolean query flag: ``?profile=1`` and ``?profile=true``
    both count."""
    return q.get(name, ["0"])[0].lower() in ("1", "true", "yes")


def _parse_shards(q: dict) -> Optional[List[int]]:
    raw = q.get("shards", [""])[0]
    if not raw:
        return None
    return [int(s) for s in raw.split(",")]


def fast_results_bytes(results, trace_id=None) -> bytes:
    """Exact ``json.dumps`` bytes for a fast-qualifying results list
    (see ``fast_result_values``): ints render as-is, pair lists as
    ``[{"id": i, "count": c}, ...]`` — byte-identical to the generic
    encoder's output, without the per-response dict builds."""
    parts = []
    for r in results:
        if type(r) is int:
            parts.append(str(r))
        else:
            parts.append(
                "["
                + ", ".join(
                    '{"id": %d, "count": %d}' % (i, c) for i, c in r
                )
                + "]"
            )
    body = '{"results": [' + ", ".join(parts) + "]"
    if trace_id:
        body += f', "traceID": "{trace_id}"'
    return (body + "}").encode()


def make_server_ssl_context(certfile: str, keyfile: str):
    """Server-side TLS context from cert/key paths (server/config.go
    TLSConfig :25-33; server.go GetTLSConfig)."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile=certfile, keyfile=keyfile or None)
    return ctx
