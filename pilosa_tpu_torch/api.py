"""API: the single-node surface a user calls, over the holder, the
executor and the card.

The port of the single-node part of ``pilosa_tpu/api.py`` (upstream
Pilosa: api.go:39-1158): queries (``query``, ``query_async``), the schema
(indexes, fields, views), the bulk imports (``import_bits`` with row and
column keys, ``import_values``, ``import_roaring``), ``export_csv`` and key
translation.  Keys are translated only here: the executor gets a
``QueryTranslator`` over the API's ``TranslateFile``.

Every import notifies the engine's ``IngestSyncer``, so resident stacks
sync in place behind the write instead of on the next query's path, and
records the ``pilosa_ingest_*`` series.  ``query`` and ``query_async``
open the ``api.Query`` span (its trace id rides the response), record the
query's plan (``util/plans.py``: ``begin``, ``attach`` around the
executor, ``record`` at the finish, the plan inline with ``profile``),
observe ``pilosa_query_seconds`` and write the long-query log line.
``fast_counts`` is the serving boundary's memo lane.  The node
facts a single node answers (``node``, ``hosts``, ``state``,
``readiness``, ``warm_status``) back ``/status`` and ``/readyz``.

The reference's other methods belong to modules not ported yet; calling one
raises ``NotImplementedError`` naming the ROADMAP.md item that ports it
(``_UNPORTED``), so nothing left out can change an answer silently.
"""

from __future__ import annotations

import csv
import datetime as dt
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import __version__
from .core.field import FieldOptions
from .core.fragment import SHARD_WIDTH
from .core.holder import Holder
from .core.index import SYSTEM_INDEX
from .core.rowstore import SPARSE_MAX
from .core.translate import TranslateFile
from .core.view import VIEW_STANDARD
from .executor import ExecOptions, Executor, QueryResponse
from .executor.translate import QueryTranslator
from .parallel.engine import TorchEngine
from .roaring import codec
from .util import events as events_mod
from .util import heat  # noqa: F401 — feeds heat, /debug/sequences and the advisor
from .util import plans
from .util import tracing
from .util.logger import NopLogger
from .util.stats import (
    INGEST_PATH_SYSTEM,
    INGEST_PATHS,
    METRIC_INGEST_BATCHES,
    METRIC_INGEST_BITS,
    METRIC_INGEST_CHANGED,
    METRIC_INGEST_SECONDS,
    METRIC_QUERY,
    REGISTRY,
)
from .util.tracing import Tracer

# Methods of the reference's API that this module leaves out, and the
# ROADMAP.md item that ports each.
_ITEM_15 = "Queue 1 item 15 (multi-GPU and multi-host)"
_UNPORTED = {
    "attach_cluster": _ITEM_15,
    "cluster_message": _ITEM_15,
    "shard_nodes": _ITEM_15,
    "set_coordinator": _ITEM_15,
    "remove_node": _ITEM_15,
    "resize_abort": _ITEM_15,
    "get_translate_data": _ITEM_15,
    "mesh_ticket": _ITEM_15,
    "mesh_collective_accept": _ITEM_15,
    "fragment_blocks": _ITEM_15,
    "fragment_block_data": _ITEM_15,
    "delete_available_shard": _ITEM_15,
    "index_attr_diff": _ITEM_15,
    "field_attr_diff": _ITEM_15,
}


class ApiError(Exception):
    pass


class NotFoundError(ApiError):
    pass


class QueryRequest:
    """handler.go:21-47, single node.  ``remote`` (a peer's replay) is
    accepted so that a caller that sets it gets an error naming the item
    that ports it, never a silently different response.
    ``trace_context`` (the caller's X-Trace-Id) roots the query's span in
    the caller's trace.  ``profile`` returns the recorded query plan with
    the response; ``tenant`` keys the plan's cost attribution (the
    X-Pilosa-Tenant header, else the index name, as admission keys it)."""

    def __init__(
        self,
        index: str,
        query: str,
        shards: Optional[List[int]] = None,
        column_attrs: bool = False,
        exclude_row_attrs: bool = False,
        exclude_columns: bool = False,
        remote: bool = False,
        trace_context=None,
        profile: bool = False,
        tenant: str = "default",
    ):
        self.index = index
        self.query = query
        self.shards = shards
        self.column_attrs = column_attrs
        self.exclude_row_attrs = exclude_row_attrs
        self.exclude_columns = exclude_columns
        self.remote = remote
        self.trace_context = trace_context
        self.profile = profile
        self.tenant = tenant or "default"


class ImportRequest:
    """internal/public.proto ImportRequest."""

    def __init__(
        self,
        index: str,
        field: str,
        shard: int = 0,
        row_ids: Optional[List[int]] = None,
        column_ids: Optional[List[int]] = None,
        row_keys: Optional[List[str]] = None,
        column_keys: Optional[List[str]] = None,
        timestamps: Optional[List[Optional[int]]] = None,
    ):
        self.index = index
        self.field = field
        self.shard = shard
        # `is None` (not truthiness): id and timestamp vectors may be
        # numpy arrays.
        self.row_ids = row_ids if row_ids is not None else []
        self.column_ids = column_ids if column_ids is not None else []
        self.row_keys = row_keys or []
        self.column_keys = column_keys or []
        self.timestamps = timestamps if timestamps is not None else []


class ImportValueRequest:
    def __init__(
        self,
        index: str,
        field: str,
        shard: int = 0,
        column_ids: Optional[List[int]] = None,
        column_keys: Optional[List[str]] = None,
        values: Optional[List[int]] = None,
    ):
        self.index = index
        self.field = field
        self.shard = shard
        self.column_ids = column_ids if column_ids is not None else []
        self.column_keys = column_keys or []
        self.values = values if values is not None else []


class API:
    """One node's API.  With no ``holder`` it builds an in-memory Holder,
    and with no ``engine`` a ``TorchEngine`` over the holder, both on the
    card unless ``device`` names another (``"cpu"`` in tests); with no
    ``translate_store`` an in-memory ``TranslateFile``.  ``stats``,
    ``tracer``, ``logger``, ``journal`` and ``long_query_time`` are the
    reference's (pilosa_tpu/api.py:140-200): the default tracer is a real
    span tracer, so every response carries a trace id.  ``node`` is the
    dict ``/status`` reports for this node (the Server passes its id and
    address).  ``with_engine=False`` builds no engine: every query runs on
    the host lane (the Server's ``[mesh] devices = -1``)."""

    def __init__(self, holder: Optional[Holder] = None,
                 translate_store: Optional[TranslateFile] = None,
                 engine: Optional[TorchEngine] = None, device=None, stats=None,
                 tracer=None, long_query_time: float = 0.0, logger=None, journal=None,
                 node: Optional[dict] = None, with_engine: bool = True):
        self.long_query_time = long_query_time
        self.logger = logger if logger is not None else NopLogger()
        self.journal = journal if journal is not None else events_mod.JOURNAL
        self.tracer = tracer if tracer is not None else Tracer()
        self._node = node
        # Wired by net.serve() on the event-loop backend.
        self.admission = None
        # The process-mode server (net/procserver.py), wired by net.serve()
        # with workers: /readyz folds the worker processes' health in.
        self.process_server = None
        # The self-hosted metrics history and the SLO watcher
        # (util/history.py, util/slo.py): the Server wires both when
        # ``[observability] history = true``.
        self.history = None
        self.slo = None
        # Continuous queries (net/cq.py), created on first POST /cq —
        # most deployments never pay the sweeper thread.
        self._cq = None
        self._cq_lock = threading.Lock()
        # Whole-query latency and ingest series, resolved once: the hot
        # paths pay the per-series locks only.
        self._h_query_sync = REGISTRY.histogram(METRIC_QUERY, path="sync")
        self._h_query_pipelined = REGISTRY.histogram(METRIC_QUERY, path="pipelined")
        self._ingest_series = {
            path: (REGISTRY.counter(METRIC_INGEST_BATCHES, path=path),
                   REGISTRY.counter(METRIC_INGEST_BITS, path=path),
                   REGISTRY.histogram(METRIC_INGEST_SECONDS, path=path))
            for path in INGEST_PATHS + (INGEST_PATH_SYSTEM,)
        }
        self._ingest_changed = REGISTRY.counter(METRIC_INGEST_CHANGED)
        self.holder = holder if holder is not None else Holder(device=device)
        if not self.holder.opened:
            self.holder.open()
        self.translate_store = (
            translate_store if translate_store is not None else TranslateFile()
        )
        self.engine = (engine if engine is not None or not with_engine
                       else TorchEngine(self.holder, device=self.holder.device))
        self.executor = Executor(self.holder, engine=self.engine,
                                 translator=QueryTranslator(self.translate_store),
                                 stats=stats)

    @property
    def cq(self):
        """Continuous-query manager, created on first use."""
        if self._cq is None:
            with self._cq_lock:
                if self._cq is None:
                    from .net.cq import CQManager

                    self._cq = CQManager(self)
        return self._cq

    def __getattr__(self, name):
        item = _UNPORTED.get(name)
        if item is None:
            raise AttributeError(name)
        raise NotImplementedError(
            f"API.{name} is not ported to pilosa_tpu_torch yet: ROADMAP.md {item}")

    def close(self):
        """Stop the continuous queries' sweeper and the engine's workers,
        and close the holder."""
        if self._cq is not None:
            self._cq.close()
        if self.engine is not None:
            self.engine.close()
        self.holder.close()

    # -- queries (api.go Query :102) ---------------------------------------

    @staticmethod
    def _exec_options(req: QueryRequest) -> ExecOptions:
        if req.remote:
            raise NotImplementedError(
                f"remote queries are not ported to pilosa_tpu_torch yet: ROADMAP.md {_ITEM_15}")
        return ExecOptions(exclude_row_attrs=req.exclude_row_attrs,
                           exclude_columns=req.exclude_columns,
                           column_attrs=req.column_attrs)

    def _long_query(self, req: QueryRequest, elapsed: float, span):
        """The long-query log line (api.go:1021, server LongQueryTime)."""
        if self.long_query_time and elapsed > self.long_query_time:
            self.logger.printf("%.3fs > %.1fs: %s %s (trace %s)", elapsed,
                               self.long_query_time, req.index, str(req.query)[:200],
                               span.trace_id if span is not None else "-")

    def query(self, req: QueryRequest) -> QueryResponse:
        opt = self._exec_options(req)
        start = time.monotonic()
        # The query's plan: the executor, engine and batcher stamp their
        # decisions on it while the span carries the timing tree.
        plan = plans.begin(req.index, req.query, tenant=req.tenant, profile=req.profile)
        with self.tracer.start_span("api.Query", parent=req.trace_context, index=req.index,
                                    remote=req.remote) as span, plans.attach(plan):
            resp = self.executor.execute(req.index, req.query, req.shards, opt)
        elapsed = time.monotonic() - start
        trace_id = span.trace_id if span is not None else None
        self._h_query_sync.observe(elapsed, exemplar=trace_id)
        if plan is not None:
            plan.finish(elapsed, trace_id=trace_id)
            plans.record(plan)
            if plan.profile:
                resp.plan = plan.to_dict()
        if span is not None:
            resp.trace_id = span.trace_id
        self._long_query(req, elapsed, span)
        return resp

    def fast_counts(self, index: str, query: str, tenant: str = "default"):
        """The serving boundary's memo lane: ``(values, trace_id)`` when
        every top-level Count of ``query`` answers from the versioned
        result memo (``Executor.memo_counts``), else None.  Process mode's
        device owner calls it before any request machinery: a repeat
        dashboard query costs a parse-cache hit and K memo lookups.  The
        tenant's query count and the pipelined latency still move; the span
        tree and the plan ring are skipped, as in the reference
        (pilosa_tpu/api.py:328-347)."""
        t0 = time.monotonic()
        vals = self.executor.memo_counts(index, query)
        if vals is None:
            return None
        plans.LEDGER.account_queries(tenant, len(vals))
        trace_id = tracing.new_id()
        self._h_query_pipelined.observe(time.monotonic() - t0)
        return vals, trace_id

    def query_async(self, req: QueryRequest):
        """Deferred query: a future (``result``/``add_done_callback`` ->
        QueryResponse, its span at ``trace_span``) when the executor can
        pipeline the request (an all-Count query through the batcher),
        else None, and the caller runs ``query``.  Nothing here waits on
        the card: the reactor thread calls it."""
        opt = self._exec_options(req)
        start = time.monotonic()
        # Begun here, finished by the completion callback on the
        # batcher's drain thread.
        span = self.tracer.begin("api.Query", parent=req.trace_context, index=req.index,
                                 pipelined=True)
        plan = plans.begin(req.index, req.query, tenant=req.tenant, profile=req.profile)
        if plan is not None:
            plan.pipelined = True
        with tracing.attach(span), plans.attach(plan):
            fut = self.executor.execute_async(req.index, req.query, req.shards, opt)
        if fut is None:
            # Declined: drop the provisional span from a live parent's
            # tree; query() roots its own for the retry.
            if span is not None and span.parent is not None:
                try:
                    span.parent.children.remove(span)
                except ValueError:
                    pass
            return None
        fut.trace_span = span
        fut.query_plan = plan

        def _finish(_f):
            elapsed = time.monotonic() - start
            if span is not None:
                span.finish()
            if plan is not None:
                plan.finish(elapsed, trace_id=span.trace_id if span is not None else None)
                plans.record(plan)
            self._h_query_pipelined.observe(
                elapsed, exemplar=span.trace_id if span is not None else None)
            self._long_query(req, elapsed, span)

        fut.add_done_callback(_finish)
        return fut

    # -- schema (api.go :129-386, 625-687) ---------------------------------

    def create_index(self, name: str, keys: bool = False, track_existence: bool = True):
        return self.holder.create_index(name, keys=keys, track_existence=track_existence)

    def index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise NotFoundError(f"index not found: {name}")
        return idx

    def delete_index(self, name: str):
        idx = self.holder.index(name)
        cid = idx.creation_id if idx is not None else ""
        # Tombstone the fields too: their creation ids must never come back.
        field_cids = [f.creation_id for f in idx.fields.values()] if idx is not None else []
        self.holder.delete_index(name)
        self.holder.tombstone(cid)
        for fcid in field_cids:
            self.holder.tombstone(fcid)

    def create_field(self, index_name: str, field_name: str, options=None):
        idx = self.index(index_name)
        if isinstance(options, dict):
            options = FieldOptions.from_dict(options)
        return idx.create_field(field_name, options)

    def field(self, index_name: str, field_name: str):
        f = self.index(index_name).field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        return f

    def delete_field(self, index_name: str, field_name: str):
        idx = self.index(index_name)
        f = idx.field(field_name)
        cid = f.creation_id if f is not None else ""
        idx.delete_field(field_name)
        self.holder.bump_shard_epoch(index_name)
        self.holder.tombstone(cid)

    def schema(self) -> List[dict]:
        return self.holder.schema()

    def views(self, index_name: str, field_name: str) -> List[str]:
        return sorted(self.field(index_name, field_name).views)

    def delete_view(self, index_name: str, field_name: str, view_name: str):
        f = self.field(index_name, field_name)
        v = f.views.pop(view_name, None)
        if v is None:
            raise NotFoundError(f"view not found: {view_name}")
        v.close()
        self.holder.bump_shard_epoch(index_name)
        if v.path and os.path.isdir(v.path):
            shutil.rmtree(v.path)

    # -- imports (api.go Import :787, ImportValue :895, ImportRoaring :290) -

    def import_bits(self, req: ImportRequest, clear: bool = False):
        """Bulk bit import: translate the keys, then one bulk write per
        fragment (api.go Import :787-894).  ``clear`` removes the given
        bits instead (the handler's ?clear=true, http/handler.go:1002)."""
        t0 = time.monotonic()
        idx = self.index(req.index)
        f = self.field(req.index, req.field)
        col_ids = req.column_ids
        row_ids = req.row_ids
        if req.column_keys:
            if not idx.keys:
                raise ApiError("importing keys into unkeyed index")
            col_ids = self.translate_store.translate_columns_to_uint64(
                req.index, req.column_keys)
        if req.row_keys:
            if not f.options.keys:
                raise ApiError("importing keys into unkeyed field")
            row_ids = self.translate_store.translate_rows_to_uint64(
                req.index, req.field, req.row_keys)
        timestamps = (np.asarray(req.timestamps).tolist()
                      if any(t for t in req.timestamps) else [])
        # Validate before any write (field.go Import validation): a late
        # error would leave the existence field holding the columns.
        if timestamps:
            if clear:
                raise ValueError("import clear is not supported with timestamps")
            if not f.time_quantum():
                raise ValueError(
                    f"field {req.field!r} has no time quantum: cannot import with timestamps")
        ts = None
        if timestamps:
            # Epoch nanoseconds, the reference's wire format (api.go:874).
            ts = [dt.datetime.fromtimestamp(t / 1e9, dt.timezone.utc).replace(tzinfo=None)
                  if t else None for t in timestamps]
        # Clears do not retract existence: other fields may hold the column.
        ef = idx.existence_field()
        if not clear and ef is not None and len(col_ids):
            ef.import_bulk(np.zeros(len(col_ids), dtype=np.int64), col_ids)
        f.import_bulk(row_ids, col_ids, ts, clear=clear)
        self._ingest_done("bits", req.index, len(col_ids), t0)

    def import_values(self, req: ImportValueRequest, clear: bool = False,
                      fresh: bool = False):
        """BSI value import (api.go ImportValue :895); ``fresh`` is the
        caller's promise that the columns hold no value yet."""
        t0 = time.monotonic()
        idx = self.index(req.index)
        f = self.field(req.index, req.field)
        col_ids = np.asarray(req.column_ids).tolist()
        if req.column_keys:
            if not idx.keys:
                raise ApiError("importing keys into unkeyed index")
            col_ids = self.translate_store.translate_columns_to_uint64(
                req.index, req.column_keys)
        ef = idx.existence_field()
        if not clear and ef is not None and len(col_ids):
            ef.import_bulk([0] * len(col_ids), col_ids)
        f.import_values(col_ids, req.values, clear=clear, fresh=fresh)
        self._ingest_done("values", req.index, len(col_ids), t0)

    def import_roaring(self, index_name: str, field_name: str, shard: int, data: bytes,
                       view: str = VIEW_STANDARD, clear: bool = False) -> int:
        """Union (or clear) a serialized roaring bitmap into one fragment,
        the fast ingest path (api.go:290-349).  The bitmap is decoded once,
        by rows where it holds dense rows (``codec.decode_rows``),
        and serves both the fragment and the existence field.
        Returns bits changed."""
        t0 = time.monotonic()
        idx = self.index(index_name)
        f = self.field(index_name, field_name)
        frag = f.view_if_not_exists(view).fragment_if_not_exists(shard)
        ef = idx.existence_field()
        by_rows = codec.decode_rows(data, SPARSE_MAX)
        if by_rows is not None:
            n = frag.import_roaring(data, clear=clear, by_rows=by_rows)
            bits = by_rows.bits()
            cols = by_rows.columns() if ef is not None and not clear else None
        else:
            positions = codec.deserialize(data).values
            n = frag.import_roaring(data, clear=clear, values=positions)
            bits = int(positions.size)
            cols = np.unique(positions % SHARD_WIDTH).astype(np.int64)
        if ef is not None and not clear and cols.size:
            cols = cols + shard * SHARD_WIDTH
            ef.import_bulk(np.zeros(len(cols), dtype=np.int64), cols)
        self._ingest_done("roaring", index_name, bits, t0, changed=n)
        return n

    def _ingest_done(self, path: str, index_name: str, bits: int, t0: float,
                     changed: int = 0):
        """Record one applied import batch (the pilosa_ingest_* series) and
        notify the engine's sync worker, so resident stacks sync behind
        the write instead of on the next query's path."""
        if index_name == SYSTEM_INDEX:
            # The history sampler's own writes go through this path: they
            # count under path="system", out of the series it records.
            path = INGEST_PATH_SYSTEM
        batches, bits_c, hist = self._ingest_series[path]
        batches.inc()
        bits_c.inc(bits)
        hist.observe(time.monotonic() - t0)
        if changed:
            self._ingest_changed.inc(changed)
        if self.engine is not None:
            self.engine.ingest_syncer().notify(index_name)

    # -- export (api.go ExportCSV :416) ------------------------------------

    def export_csv(self, index_name: str, field_name: str, shard: int, w) -> None:
        idx = self.index(index_name)
        f = self.field(index_name, field_name)
        frag = self.holder.fragment(index_name, field_name, VIEW_STANDARD, shard)
        if frag is None:
            raise NotFoundError("fragment not found")
        writer = csv.writer(w)
        base = shard * SHARD_WIDTH
        for row_id in frag.row_ids():
            row_out = (self.translate_store.translate_row_to_string(index_name, field_name,
                                                                    row_id)
                       if f.options.keys else row_id)
            for pos in frag.row_positions(row_id):
                col = base + int(pos)
                col_out = (self.translate_store.translate_column_to_string(index_name, col)
                           if idx.keys else col)
                writer.writerow([row_out, col_out])

    # -- shards and node facts (api.go :493-563, 992-1010) ----------------

    def max_shards(self) -> Dict[str, int]:
        out = {}
        for name, idx in self.holder.indexes.items():
            shards = list(idx.available_shards())
            out[name] = max(shards) if shards else 0
        return out

    def available_shards_by_index(self) -> Dict[str, List[int]]:
        return {name: [int(s) for s in idx.available_shards()]
                for name, idx in self.holder.indexes.items()}

    def node(self) -> dict:
        """This node as ``/status`` reports it (api.go Node)."""
        if self._node is not None:
            return dict(self._node)
        return {"id": "local", "uri": "http://localhost:10101", "isCoordinator": True}

    def hosts(self) -> List[dict]:
        return [self.node()]

    def state(self) -> str:
        return "NORMAL"

    def readiness(self) -> Tuple[bool, List[str]]:
        """Readiness verdict with reason strings (the GET /readyz
        contract): ready iff the holder is open, the engine's warm start,
        when one ran this boot, is done and, in process mode, every worker
        process is connected."""
        reasons: List[str] = []
        if not self.holder.opened:
            reasons.append("holder not opened")
        ws = self.warm_status()
        if ws is not None and not ws["done"]:
            reasons.append(f"warming: residency {ws['fraction']:.0%} "
                           f"({ws['built']}/{ws['total']} stacks)")
        # Process mode: a missing or crashed worker process holds
        # readiness back until the supervisor's respawn reconnects it.
        ps = self.process_server
        if ps is not None:
            reasons.extend(ps.not_ready_reasons())
        return (not reasons), reasons

    def warm_status(self) -> Optional[dict]:
        """The engine's warm-start progress ({"done", "fraction", "built",
        "total", "skipped"}), or None when no warm start ran this boot."""
        ws = getattr(self.engine, "warm_state", None)
        if ws is None:
            return None
        total = ws.get("total") or 0
        return {
            "done": bool(ws.get("done")),
            "built": int(ws.get("built", 0)),
            "total": int(ws.get("total", 0)),
            "skipped": int(ws.get("skipped", 0)),
            "fraction": 1.0 if not total else min(1.0, ws.get("built", 0) / total),
        }

    def residency_status(self) -> Optional[dict]:
        """The engine's device working set under its budget (GET /readyz
        ``residency``): the resident block fraction, the resident bytes
        against the budget, partial stacks, queries served from the host
        tier and promotions pending.  None without an engine, or with no
        bound to report (the CPU's default)."""
        eng = self.engine
        if eng is None or eng.max_resident_bytes >= 1 << 62:
            return None
        snap = eng.cache_snapshot()
        return {
            "residentBlockFraction": snap["residentBlockFraction"],
            "residentBytes": snap["residentBytes"],
            "deviceBudgetBytes": snap["deviceBudgetBytes"],
            "partialStacks": snap["partialStacks"],
            "hostFallbacks": snap["hostFallbacks"],
            "pendingPromotions": snap["residency"]["pendingPromotions"],
        }

    def version(self) -> str:
        return __version__

    def info(self) -> dict:
        return {"shardWidth": SHARD_WIDTH}

    def translate_keys(self, index: str, field: str, keys: List[str]) -> List[int]:
        if field:
            return self.translate_store.translate_rows_to_uint64(index, field, keys)
        return self.translate_store.translate_columns_to_uint64(index, keys)

    def recalculate_caches(self):
        """Re-rank every fragment's row cache (pilosa_tpu/api.py:1017), then
        tell the peers to do the same."""
        for idx in self.holder.indexes.values():
            for f in idx.fields.values():
                for v in f.views.values():
                    for frag in v.fragments.values():
                        frag.cache.recalculate()
        self._broadcast({"type": "recalculate-caches"})

    def _broadcast(self, msg: dict):
        """A node without a cluster has no peers to tell, as the
        reference's ``_broadcast`` with no cluster; the message to peers
        is ROADMAP.md Queue 1 item 15."""
