"""InternalClient: node-to-node + CLI HTTP client.

Mirror of the reference's InternalClient (http/client.go:69-1007 and the
root-pkg interface client.go:32-60): query forwarding, imports, schema
ensure, fragment block sync, whole-shard retrieval, cluster messages, and
translate-log streaming — stdlib ``http.client`` with POOLED KEEP-ALIVE
connections.

Pooling rationale (docs/serving.md): cluster-internal traffic — remote
shard fan-out, /cluster/metrics federation, translate-log replication,
resize shard copies — used to pay a fresh TCP (and on https a fresh TLS
handshake) per call via ``urllib.urlopen``.  Every hop now reuses an
idle persistent connection from a small per-client pool, exactly what
the reference gets for free from Go's http.Transport.

A copy of ``pilosa_tpu/net/client.py``.  Left out, each raising
``NotImplementedError`` that names its ROADMAP.md item: the cluster
control-plane message (``send_message``, private protobuf frames) and the
fragment-block sync calls (``fragment_blocks``, ``block_data``), both
Queue 1 item 15.  The deterministic fault plane (``net/faults.py``) is
consulted before each request, as in the reference.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import threading
import time
from typing import List, Optional

from ..util import tracing
from ..util.stats import METRIC_CLIENT_RETRIES, METRIC_CLUSTER_REMOTE_CALLS, REGISTRY

_ITEM_15 = "Queue 1 item 15 (multi-GPU and multi-host)"


class ClientError(Exception):
    """HTTP client failure.  ``code`` carries the response status (None
    for transport errors) and ``body`` the decoded response body, so
    callers can branch on them instead of string-matching the
    message."""

    def __init__(self, message: str, code: Optional[int] = None,
                 body: str = ""):
        super().__init__(message)
        self.code = code
        self.body = body


class InternalClient:
    # Idle persistent connections retained per client.  Concurrent
    # callers beyond this still work (a fresh connection is dialed when
    # the pool is empty); only the RETAINED idle set is bounded.
    POOL_SIZE = 8
    # Connect-phase retry budget + capped exponential backoff with
    # jitter (docs/durability.md): a recovering node that refuses
    # connections for a moment gets at most ``RETRIES`` re-dials per
    # request, spaced 50 ms, ~100 ms, ... capped at BACKOFF_CAP and
    # jittered ±50% so replica hedging and anti-entropy across many
    # callers can't synchronize into a retry storm against it.
    RETRIES = 2
    BACKOFF = 0.05
    BACKOFF_CAP = 1.0

    def __init__(
        self,
        uri: str,
        timeout: float = 30.0,
        tls_skip_verify: bool = False,
        attempt_timeout: Optional[float] = None,
        retries: Optional[int] = None,
    ):
        """Scheme-aware: an ``https://`` uri speaks TLS;
        ``tls_skip_verify`` accepts self-signed certs for
        cluster-internal traffic (server/config.go TLSConfig.SkipVerify
        :31-32, http/client.go GetHTTPClient).

        ``timeout`` bounds the WHOLE request including retries;
        ``attempt_timeout`` (default: timeout) bounds each socket
        attempt, so one black-holed dial can't consume the entire
        request deadline before the retry budget gets a chance."""
        self.uri = uri.rstrip("/")
        self.timeout = timeout
        self.attempt_timeout = (
            attempt_timeout if attempt_timeout is not None else timeout
        )
        self.retries = retries if retries is not None else self.RETRIES
        self._https = self.uri.startswith("https://")
        # urlsplit, not string surgery: IPv6 literals ("http://[::1]:10101")
        # and path-prefixed gateways ("http://gw:8080/pilosa") must keep
        # working exactly as they did through urllib.
        from urllib.parse import urlsplit

        u = urlsplit(self.uri)
        self._host = u.hostname or "localhost"
        self._port = u.port or (443 if self._https else 80)
        self._base_path = u.path.rstrip("/")
        self._ssl_ctx = None
        if self._https:
            import ssl

            if tls_skip_verify:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            else:
                ctx = ssl.create_default_context()
            self._ssl_ctx = ctx
        self._pool: List[http.client.HTTPConnection] = []
        self._pool_lock = threading.Lock()
        # Per-instance request tally + the process-wide
        # pilosa_cluster_remote_calls_total counter.  EVERY internal
        # request counts (query fan-out and control plane alike): on a
        # single node the counter staying at 0 proves a local query
        # dialed nothing; in a live cluster the per-query fan-out
        # signal is executor.remote_fanouts, not this series.
        self.requests = 0
        self._requests_counter = REGISTRY.counter(METRIC_CLUSTER_REMOTE_CALLS)
        self._retries_counter = REGISTRY.counter(METRIC_CLIENT_RETRIES)

    # -- connection pool ---------------------------------------------------

    def _connect(self) -> http.client.HTTPConnection:
        if self._https:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=self.attempt_timeout,
                context=self._ssl_ctx,
            )
        return http.client.HTTPConnection(
            self._host, self._port, timeout=self.attempt_timeout
        )

    def _acquire(self):
        """(conn, reused): an idle pooled connection when one exists,
        else a fresh dial.  ``reused`` drives the one-shot retry — a
        kept-alive socket the server closed between requests is an
        expected race, not an error."""
        with self._pool_lock:
            if self._pool:
                return self._pool.pop(), True
        return self._connect(), False

    def _release(self, conn: http.client.HTTPConnection):
        with self._pool_lock:
            if len(self._pool) < self.POOL_SIZE:
                self._pool.append(conn)
                return
        conn.close()

    def close(self):
        """Drop all idle pooled connections (tests/teardown hygiene)."""
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for c in pool:
            c.close()

    # -- low level ---------------------------------------------------------

    def _do(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        content_type: str = "application/json",
        raw: bool = False,
    ):
        self.requests += 1
        self._requests_counter.inc()
        # Deterministic fault plane (net/faults.py): an injected drop or
        # partition surfaces as a transport-style ClientError (code None),
        # an injected error as the configured status, before any bytes
        # leave this host.  The inactive plane costs one attribute read.
        from .faults import PLANE

        if PLANE.active:
            rule = PLANE.intercept(f"{self._host}:{self._port}", path)
            if rule is not None:
                if rule.action == "error":
                    raise ClientError(
                        f"{method} {path}: {rule.status}: injected fault",
                        code=rule.status, body="injected fault",
                    )
                raise ClientError(
                    f"{method} {path}: injected fault: {rule.action}"
                )
        headers = {"Content-Type": content_type} if body is not None else {}
        # Propagate the ambient trace context (trace id + this hop's
        # span id) so a remote shard fan-out joins the caller's trace —
        # the wire half of the explicit capture/attach protocol in
        # util.tracing.
        tracing.inject_headers(headers)
        deadline = time.monotonic() + self.timeout
        budget = self.retries  # connect-phase (+ idempotent-GET) retries
        stale_retry_used = False  # the free stale-keep-alive retry
        attempt = 0
        while True:
            conn, reused = self._acquire()
            if not reused:
                # Explicit connect so connect-phase failures — dial
                # refused/reset/timeout on a recovering node, before any
                # request bytes left this host — are distinguishable
                # from request/response failures.  They are always safe
                # to retry (nothing was sent), within the capped
                # exponential-backoff budget.
                try:
                    conn.connect()
                except (OSError, socket.error) as e:
                    conn.close()
                    if budget > 0 and not self._backoff(attempt, deadline):
                        budget -= 1
                        attempt += 1
                        self._retries_counter.inc()
                        continue
                    raise ClientError(f"{method} {path}: {e}") from e
            try:
                conn.request(
                    method, self._base_path + path, body=body, headers=headers
                )
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                keep = not resp.will_close
            except (
                http.client.HTTPException, socket.error, OSError,
            ) as e:
                conn.close()
                # Retry ONCE, but only on the stale-keep-alive
                # signatures — the server closed the idle socket under
                # us BEFORE producing any response bytes (send on a
                # dead socket, or an empty status line).  A timeout or
                # a failure mid-response may mean the request was
                # already processed: resending a non-idempotent POST
                # there would double-apply it, so those surface
                # immediately — except idempotent GETs, which may also
                # consume the backoff budget.
                stale = isinstance(
                    e,
                    (
                        http.client.RemoteDisconnected,
                        http.client.BadStatusLine,
                        BrokenPipeError,
                        ConnectionResetError,
                    ),
                ) and not isinstance(e, socket.timeout)
                if reused and stale and not stale_retry_used:
                    stale_retry_used = True
                    continue
                if method == "GET" and budget > 0:
                    if not self._backoff(attempt, deadline):
                        budget -= 1
                        attempt += 1
                        self._retries_counter.inc()
                        continue
                raise ClientError(f"{method} {path}: {e}") from e
            if keep:
                self._release(conn)
            else:
                conn.close()
            if status >= 400:
                detail = data.decode(errors="replace")
                raise ClientError(
                    f"{method} {path}: {status}: {detail}", code=status,
                    body=detail,
                )
            if raw:
                return data
            return json.loads(data) if data else {}

    def _backoff(self, attempt: int, deadline: float) -> bool:
        """Sleep the capped, jittered exponential delay for retry
        ``attempt``.  Returns True when the request deadline is already
        (or would be) exhausted — the caller must stop retrying."""
        delay = min(self.BACKOFF * (2 ** attempt), self.BACKOFF_CAP)
        delay *= 0.5 + random.random()  # ±50% jitter: desynchronize callers
        if time.monotonic() + delay >= deadline:
            return True
        time.sleep(delay)
        return False

    def _get(self, path: str, raw: bool = False):
        return self._do("GET", path, raw=raw)

    def _post(
        self,
        path: str,
        doc=None,
        body: Optional[bytes] = None,
        raw: bool = False,
        content_type: Optional[str] = None,
    ):
        if body is None:
            body = json.dumps(doc if doc is not None else {}).encode()
            ctype = "application/json"
        else:
            ctype = content_type or "application/octet-stream"
        return self._do("POST", path, body, ctype, raw=raw)

    # -- queries (http/client.go Query/QueryNode :217-266) -----------------

    def query(
        self,
        index: str,
        query: str,
        shards: Optional[List[int]] = None,
        remote: bool = False,
        column_attrs: bool = False,
    ) -> dict:
        doc = {"query": query}
        if shards is not None:
            doc["shards"] = shards
        if remote:
            doc["remote"] = True
        if column_attrs:
            doc["columnAttrs"] = True
        return self._post(f"/index/{index}/query", doc)

    # -- schema (http/client.go EnsureIndex/EnsureField :380-437) ----------

    def schema(self) -> list:
        return self._get("/schema")["indexes"]

    def create_index(self, index: str, keys: bool = False):
        self._post(f"/index/{index}", {"options": {"keys": keys}})

    def ensure_index(self, index: str, keys: bool = False):
        try:
            self.create_index(index, keys)
        except ClientError as e:
            if "exists" not in str(e):
                raise

    def create_field(self, index: str, field: str, options: Optional[dict] = None):
        self._post(f"/index/{index}/field/{field}", {"options": options or {}})

    def ensure_field(self, index: str, field: str, options: Optional[dict] = None):
        try:
            self.create_field(index, field, options)
        except ClientError as e:
            if "exists" not in str(e):
                raise

    # -- imports (http/client.go Import :292-487) --------------------------

    def import_bits(
        self,
        index: str,
        field: str,
        shard: int,
        row_ids: List[int],
        column_ids: List[int],
        timestamps: Optional[List[Optional[int]]] = None,
        remote: bool = False,
        clear: bool = False,
    ):
        doc = {"shard": shard, "rowIDs": row_ids, "columnIDs": column_ids}
        if timestamps:
            doc["timestamps"] = timestamps
        params = [p for p, on in (("remote=true", remote), ("clear=true", clear)) if on]
        suffix = "?" + "&".join(params) if params else ""
        self._post(f"/index/{index}/field/{field}/import{suffix}", doc)

    def import_keyed_bits(
        self, index: str, field: str, row_keys: List[str], column_keys: List[str]
    ):
        self._post(
            f"/index/{index}/field/{field}/import",
            {"rowKeys": row_keys, "columnKeys": column_keys},
        )

    def import_values(
        self,
        index: str,
        field: str,
        shard: int,
        column_ids: List[int],
        values: List[int],
        remote: bool = False,
        clear: bool = False,
    ):
        params = [p for p, on in (("remote=true", remote), ("clear=true", clear)) if on]
        suffix = "?" + "&".join(params) if params else ""
        self._post(
            f"/index/{index}/field/{field}/import{suffix}",
            {"shard": shard, "columnIDs": column_ids, "values": values},
        )

    def import_roaring(
        self,
        index: str,
        field: str,
        shard: int,
        data: bytes,
        view: str = "standard",
        clear: bool = False,
    ) -> int:
        out = self._post(
            f"/index/{index}/field/{field}/import-roaring/{shard}"
            f"?view={view}&clear={'true' if clear else 'false'}",
            body=data,
        )
        return out.get("changed", 0)

    # -- fragment sync (http/client.go :813-904) ---------------------------

    def fragment_blocks(self, index: str, field: str, view: str, shard: int) -> list:
        raise NotImplementedError(
            f"fragment block sync is not ported to pilosa_tpu_torch yet: ROADMAP.md {_ITEM_15}")

    def block_data(self, index: str, field: str, view: str, shard: int, block: int) -> dict:
        raise NotImplementedError(
            f"fragment block sync is not ported to pilosa_tpu_torch yet: ROADMAP.md {_ITEM_15}")

    def retrieve_shard(self, index: str, field: str, shard: int, view: str = "standard") -> bytes:
        """Whole-fragment roaring snapshot (RetrieveShardFromURI :708)."""
        return self._get(
            f"/internal/fragment/data?index={index}&field={field}"
            f"&view={view}&shard={shard}",
            raw=True,
        )

    def send_fragment(
        self, index: str, field: str, shard: int, data: bytes, view: str = "standard"
    ):
        self._post(
            f"/internal/fragment/data?index={index}&field={field}"
            f"&view={view}&shard={shard}",
            body=data,
        )

    # -- attrs (http/client.go ColumnAttrDiff/RowAttrDiff :905-1007) -------

    def index_attr_diff(self, index: str, blocks: list) -> dict:
        return self._post(f"/internal/index/{index}/attr/diff", {"blocks": blocks})[
            "attrs"
        ]

    def field_attr_diff(self, index: str, field: str, blocks: list) -> dict:
        return self._post(
            f"/internal/index/{index}/field/{field}/attr/diff", {"blocks": blocks}
        )["attrs"]

    # -- cluster -----------------------------------------------------------

    def send_message(self, msg: dict):
        """Cluster control-plane message as [1-byte type][protobuf]
        (broadcast.go:75-83): the private protobuf frames are not ported."""
        raise NotImplementedError(
            f"cluster messages are not ported to pilosa_tpu_torch yet: ROADMAP.md {_ITEM_15}")

    def nodes(self) -> list:
        return self._get("/internal/nodes")

    def status(self) -> dict:
        return self._get("/status")

    def metrics(self) -> str:
        """The peer's Prometheus exposition (GET /metrics) — what the
        coordinator's /cluster/metrics federation scrapes per node."""
        return self._get("/metrics", raw=True).decode()

    def health(self) -> dict:
        return self._get("/healthz")

    def readiness(self) -> dict:
        """GET /readyz body regardless of status (a 503 still carries
        the reasons JSON)."""
        try:
            return self._get("/readyz")
        except ClientError as e:
            if e.code == 503 and e.body:
                try:
                    return json.loads(e.body)
                except json.JSONDecodeError:
                    pass  # a proxy's HTML 503: surface the ClientError
            raise

    def max_shards(self) -> dict:
        return self._get("/internal/shards/max")["standard"]

    # -- translation -------------------------------------------------------

    def translate_data(self, offset: int) -> bytes:
        return self._get(f"/internal/translate/data?offset={offset}", raw=True)

    def translate_keys(self, index: str, field: str, keys: List[str]) -> List[int]:
        return self._post(
            "/internal/translate/keys",
            {"index": index, "field": field, "keys": keys},
        )["ids"]
