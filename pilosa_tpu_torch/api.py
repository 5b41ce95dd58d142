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

With a cluster attached (``attach_cluster``), schema changes are broadcast
to the peers, imports group their bits by shard and go to every live owner
(a DOWN owner's miss queued as a hint), ``cluster_message`` applies the
peers' control-plane messages, and the anti-entropy and resize calls
(``fragment_blocks``, ``fragment_block_data``, the attribute diffs,
``get_translate_data``) and the cluster's admin (``set_coordinator``,
``remove_node``, ``resize_abort``) are served, as in ``pilosa_tpu/api.py``.

On a multi-process mesh (``parallel/multihost.py``) the API is the peers'
side of the two-phase collective handoff (pilosa_tpu/api.py:1311-1660):
``mesh_ticket`` issues the sequencer's dense tickets,
``mesh_collective_accept`` validates a peer's dispatch and registers it
(accept), queues it for replay (commit) or drops it (abort, or expiry),
and the replay worker enters the same collective through the engine's
gate, so the initiator's all-reduce or all-gather completes.
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
from .roaring import Bitmap, codec
from .util import events as events_mod
from .util import fanout
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
    METRIC_INGEST_DEGRADED_BATCHES,
    METRIC_INGEST_SECONDS,
    METRIC_QUERY,
    REGISTRY,
)
from .util.tracing import Tracer



class ApiError(Exception):
    pass


class NotFoundError(ApiError):
    pass


class QueryRequest:
    """handler.go:21-47.  ``remote`` marks a peer's replay.
    ``replica_read`` and ``freshness_ms`` (X-Pilosa-Replica-Read,
    X-Pilosa-Freshness-Ms) override the cluster's replica-read mode and
    freshness bound for this request ("" and None defer to them).
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
        replica_read: str = "",
        freshness_ms: Optional[float] = None,
    ):
        self.index = index
        self.query = query
        self.shards = shards
        self.column_attrs = column_attrs
        self.exclude_row_attrs = exclude_row_attrs
        self.exclude_columns = exclude_columns
        self.remote = remote
        self.replica_read = replica_read
        self.freshness_ms = freshness_ms
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
    address), or the cluster's ``Node``.  ``with_engine=False`` builds no
    engine: every query runs on the host lane (the Server's ``[mesh]
    devices = -1``).  ``cluster`` attaches a ``cluster.Cluster``."""

    def __init__(self, holder: Optional[Holder] = None,
                 translate_store: Optional[TranslateFile] = None,
                 engine: Optional[TorchEngine] = None, device=None, stats=None,
                 tracer=None, long_query_time: float = 0.0, logger=None, journal=None,
                 node=None, with_engine: bool = True, cluster=None):
        self.long_query_time = long_query_time
        self.cluster = None
        # The gossip transport, for the readiness probe's convergence
        # check: set by the Server after it starts gossip.
        self.gossip = None
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
        # The multi-process mesh's peer side: the replay queue and its
        # worker (made at the first unsequenced dispatch), the accepted but
        # uncommitted dispatches by did (payload, expiry timer), and the
        # ticket counter when this node is the sequencer.
        self._mesh_replay_q = None
        self._mesh_replay_lock = threading.Lock()
        self._mesh_pending: Dict[str, tuple] = {}
        self._mesh_ticket_next = 0
        self._mesh_ticket_lock = threading.Lock()
        if cluster is not None:
            self.attach_cluster(cluster, node)

    def attach_cluster(self, cluster, node=None):
        """Wire the cluster into the executor and install the create-shard
        broadcast (view.go:226 CreateShardMessage)."""
        self.cluster = cluster
        self._node = node if node is not None else cluster.node
        self.executor.cluster = cluster
        if cluster.holder is None:
            cluster.holder = self.holder

        def on_create_shard(index, field, shard):
            # Gossiped asynchronously, as the reference's SendAsync; the
            # HTTP fan-out when no gossip transport is attached.
            cluster.send_async({"type": "create-shard", "index": index, "field": field,
                                "shard": shard})

        self.holder.set_on_create_shard(on_create_shard)

    @property
    def cq(self):
        """Continuous-query manager, created on first use."""
        if self._cq is None:
            with self._cq_lock:
                if self._cq is None:
                    from .net.cq import CQManager

                    self._cq = CQManager(self)
        return self._cq

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
        return ExecOptions(remote=req.remote, exclude_row_attrs=req.exclude_row_attrs,
                           exclude_columns=req.exclude_columns,
                           column_attrs=req.column_attrs,
                           replica_read=getattr(req, "replica_read", ""),
                           freshness_ms=getattr(req, "freshness_ms", None))

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
        # A peer's replay records no plan: the coordinator's plan charges
        # the whole query.
        plan = None if req.remote else plans.begin(req.index, req.query, tenant=req.tenant,
                                                   profile=req.profile)
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
        plan = None if req.remote else plans.begin(req.index, req.query, tenant=req.tenant,
                                                   profile=req.profile)
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
        idx = self.holder.create_index(name, keys=keys, track_existence=track_existence)
        self._broadcast({"type": "create-index", "index": name, "cid": idx.creation_id,
                         "meta": {"keys": keys}})
        return idx

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
        self._broadcast({"type": "delete-index", "index": name, "cid": cid,
                         "fieldCids": field_cids})

    def create_field(self, index_name: str, field_name: str, options=None):
        idx = self.index(index_name)
        if isinstance(options, dict):
            options = FieldOptions.from_dict(options)
        f = idx.create_field(field_name, options)
        self._broadcast({"type": "create-field", "index": index_name, "field": field_name,
                         "cid": f.creation_id, "meta": f.options.to_dict()})
        return f

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
        self._broadcast({"type": "delete-field", "index": index_name, "field": field_name,
                         "cid": cid})

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
        self._broadcast({"type": "delete-view", "index": index_name, "field": field_name,
                         "view": view_name})

    # -- imports (api.go Import :787, ImportValue :895, ImportRoaring :290) -

    def _check_writable(self):
        """Reject writes while the cluster resizes (api.go validate :93:
        apiImport/apiImportValue are methodsNormal-only — absent from
        the RESIZING method set).  A write accepted mid-resize could
        land on a fragment already copied to its new owner and vanish
        when the old copy is cleaned; clients retry after the (bounded)
        resize completes."""
        if self.cluster is not None and self.cluster.state == "RESIZING":
            raise ApiError("cluster is resizing: writes are rejected")

    def _live_owners(
        self, index: str, shard: int, clear: bool = False, hint_op=None,
        rollback=None,
    ):
        """A shard's owners with DOWN ones skipped — the DEGRADED write
        policy (docs/durability.md): survivors take the write, the ack
        is made durable on them, and each DOWN owner's miss is durably
        QUEUED as a hint record (hinted handoff) for replay on
        recovery.  ``hint_op`` builds the replayable op payload lazily
        (once per shard, only when an owner is actually DOWN).  Raises
        when every owner is DOWN (nothing can make the ack durable).
        ``clear`` marks a bit-REMOVING import — anti-entropy's
        majority-tie-to-set merge would re-SET the removed bits once
        the dead owner (still holding them) recovers, silently undoing
        the acked write — so those ack ONLY when every miss was
        absorbed by the hint queue, and fail loudly on overflow/expiry
        (the pre-hint fallback).  Callers pass clear=True for explicit
        ?clear=true imports AND for implicitly destructive ones
        (mutex/bool fields displace the previous row, BSI value imports
        rewrite bit planes).  Returns
        (live_owners, skipped_count, hinted_count)."""
        owners = self.cluster.shard_nodes(index, shard)
        live = [n for n in owners if n.state != "DOWN"]
        down = [n for n in owners if n.state == "DOWN"]
        if not live:
            raise ApiError(
                f"import unavailable: every owner of shard {shard} is "
                f"DOWN ({', '.join(n.id for n in owners)})"
            )
        hinted = 0
        # (node id, seq) enqueues awaiting rollback.  ``rollback`` is
        # CALLER-owned and spans the whole import: the gate failing on
        # shard B must also unwind shard A's hints — the grouping loop
        # runs before any apply, so the entire batch fails un-acked and
        # every absorbed miss is a phantom.
        fresh = rollback if rollback is not None else []
        hints = getattr(self.cluster, "hints", None)
        if down and hints is not None and hint_op is not None:
            op = hint_op()
            for n in down:
                seq = hints.enqueue(n.id, index, shard, op)
                if seq:
                    hinted += 1
                    fresh.append((n.id, seq))
        if clear and hinted < len(down):
            # All-or-nothing for destructive imports: the batch is about
            # to FAIL (no ack), so any miss already absorbed — THIS
            # shard's or an earlier one's — must not survive to replay
            # an import that never happened.
            for nid, seq in fresh:
                hints.discard(nid, [seq])
            del fresh[:]
            raise ApiError(
                f"clear import unavailable: owner of shard {shard} is "
                "DOWN, the hint queue could not absorb the miss, and a "
                "degraded bit-removing import would be reverted by "
                "anti-entropy on its recovery"
            )
        return live, len(down) - hinted, hinted

    def _discard_hint_rollback(self, fresh):
        """Unwind a failed import batch's queued hints — every shard's,
        whatever raised (a later shard's all-owners-DOWN error, a
        fan-out failure): the client got no ack, so no absorbed miss
        may survive to replay."""
        hints = getattr(self.cluster, "hints", None)
        if hints is None:
            return
        for nid, seq in fresh:
            hints.discard(nid, [seq])
        del fresh[:]

    def _import_destructive(self, f, clear: bool) -> bool:
        """Does this import REMOVE bits on apply?  Explicit clears do;
        so do set-imports into mutex/bool fields (last-write-wins
        displaces the column's previous row)."""
        from .core.field import FIELD_TYPE_BOOL, FIELD_TYPE_MUTEX

        return clear or f.options.type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL)

    def _note_degraded(self, index: str, skipped: int, hinted: int = 0):
        """Record how a degraded import fan-out handled its DOWN
        owners: ``hinted`` misses are queued for replay (the new
        normal), ``skipped`` ones fell back to the pre-hint anti-entropy
        seeding (hint queue absent or full).  Only a true skip counts
        the degraded-batches series — a hinted batch is not degraded,
        its replay is deterministic."""
        if hinted:
            self.journal.append(
                "ingest.hinted", index=index, hintedOwners=hinted,
            )
        if not skipped:
            return
        REGISTRY.inc(METRIC_INGEST_DEGRADED_BATCHES)
        self.journal.append(
            "ingest.degraded", index=index, skippedOwners=skipped,
        )

    def import_bits(self, req: ImportRequest, clear: bool = False, remote: bool = False):
        """Bulk bit import: translate the keys, then one bulk write per
        fragment (api.go Import :787-894).  ``clear`` removes the given
        bits instead (the handler's ?clear=true, http/handler.go:1002).  In
        a cluster the bits group by shard and go to every live owner of
        each (``remote`` marks a peer's forward, applied here as given)."""
        self._check_writable()
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
        if self.cluster is None or remote:
            self._import_local(idx, f, row_ids, col_ids, timestamps, clear)
            self._ingest_done("bits", req.index, len(col_ids), t0, remote=remote)
            return
        # Group by shard and send each group to its owners (api.go:835-860):
        # this node's groups in one local apply, the peers' through the
        # bounded fan-out.  .tolist(): the peers' slices go through
        # json.dumps, which refuses numpy integers.
        col_ids = np.asarray(col_ids).tolist()
        row_ids = np.asarray(row_ids).tolist()
        groups: Dict[int, list] = {}
        for i, c in enumerate(col_ids):
            groups.setdefault(c // SHARD_WIDTH, []).append(i)
        local_idxs: list = []
        jobs = []
        skipped_owners = hinted_owners = 0
        hint_rollback: list = []  # every shard's hints of this batch
        try:
            for shard, idxs in sorted(groups.items()):
                s_rows = [row_ids[i] for i in idxs]
                s_cols = [col_ids[i] for i in idxs]
                s_ts = [timestamps[i] for i in idxs] if timestamps else []
                live, skipped, hinted = self._live_owners(
                    req.index, shard, clear=self._import_destructive(f, clear),
                    hint_op=lambda r=s_rows, c=s_cols, t=s_ts: {
                        "kind": "import_bits", "field": req.field, "rows": r, "cols": c,
                        "ts": t or None, "clear": clear},
                    rollback=hint_rollback)
                skipped_owners += skipped
                hinted_owners += hinted
                for node in live:
                    if node.id == self.cluster.node.id:
                        local_idxs.extend(idxs)
                    else:
                        jobs.append(lambda n=node, s=shard, r=s_rows, c=s_cols, t=s_ts:
                                    self.cluster.client(n).import_bits(
                                        req.index, req.field, s, r, c, timestamps=t or None,
                                        remote=True, clear=clear))
            if local_idxs:
                jobs.append(lambda: self._import_local(
                    idx, f, [row_ids[i] for i in local_idxs], [col_ids[i] for i in local_idxs],
                    [timestamps[i] for i in local_idxs] if timestamps else [], clear))
            fanout.run_fanout(jobs)
        except Exception:
            # The batch fails unacked wherever it raised: unwind its hints.
            self._discard_hint_rollback(hint_rollback)
            raise
        self._note_degraded(req.index, skipped_owners, hinted_owners)
        self._ingest_done("bits", req.index, len(col_ids), t0)

    def _import_local(self, idx, f, row_ids, col_ids, timestamps, clear=False):
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

    def import_values(self, req: ImportValueRequest, clear: bool = False,
                      fresh: bool = False, remote: bool = False):
        """BSI value import (api.go ImportValue :895); ``fresh`` is the
        caller's promise that the columns hold no value yet.  In a cluster
        the values go to every live owner of their shard."""
        self._check_writable()
        t0 = time.monotonic()
        idx = self.index(req.index)
        f = self.field(req.index, req.field)
        col_ids = np.asarray(req.column_ids).tolist()
        if req.column_keys:
            if not idx.keys:
                raise ApiError("importing keys into unkeyed index")
            col_ids = self.translate_store.translate_columns_to_uint64(
                req.index, req.column_keys)

        def apply_local(cols, values):
            ef = idx.existence_field()
            if not clear and ef is not None and len(cols):
                ef.import_bulk([0] * len(cols), cols)
            # ``fresh`` is a local caller's promise: it never rides the fan-out.
            f.import_values(cols, values, clear=clear, fresh=fresh)

        if self.cluster is None or remote:
            apply_local(col_ids, req.values)
            self._ingest_done("values", req.index, len(col_ids), t0, remote=remote)
            return
        vals = np.asarray(req.values).tolist()
        groups: Dict[int, list] = {}
        for i, c in enumerate(col_ids):
            groups.setdefault(c // SHARD_WIDTH, []).append(i)
        local_idxs: list = []
        jobs = []
        skipped_owners = hinted_owners = 0
        hint_rollback: list = []
        try:
            for shard, idxs in sorted(groups.items()):
                cols = [col_ids[i] for i in idxs]
                values = [vals[i] for i in idxs]
                # A value import rewrites bit planes: it clears bits, so a
                # DOWN owner is acked only through the hint queue.
                live, skipped, hinted = self._live_owners(
                    req.index, shard, clear=True,
                    hint_op=lambda c=cols, v=values: {
                        "kind": "import_values", "field": req.field, "cols": c, "values": v,
                        "clear": clear},
                    rollback=hint_rollback)
                skipped_owners += skipped
                hinted_owners += hinted
                for node in live:
                    if node.id == self.cluster.node.id:
                        local_idxs.extend(idxs)
                    else:
                        jobs.append(lambda n=node, s=shard, c=cols, v=values:
                                    self.cluster.client(n).import_values(
                                        req.index, req.field, s, c, v, remote=True,
                                        clear=clear))
            if local_idxs:
                jobs.append(lambda: apply_local([col_ids[i] for i in local_idxs],
                                                [vals[i] for i in local_idxs]))
            fanout.run_fanout(jobs)
        except Exception:
            self._discard_hint_rollback(hint_rollback)
            raise
        self._note_degraded(req.index, skipped_owners, hinted_owners)
        self._ingest_done("values", req.index, len(col_ids), t0)

    def import_roaring(self, index_name: str, field_name: str, shard: int, data: bytes,
                       view: str = VIEW_STANDARD, clear: bool = False) -> int:
        """Union (or clear) a serialized roaring bitmap into one fragment,
        the fast ingest path (api.go:290-349).  The bitmap is decoded once,
        by rows where it holds dense rows (``codec.decode_rows``),
        and serves both the fragment and the existence field.
        Returns bits changed."""
        self._check_writable()
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
                     changed: int = 0, remote: bool = False):
        """Record one applied import batch (the pilosa_ingest_* series) and
        notify the engine's sync worker, so resident stacks sync behind
        the write instead of on the next query's path.  A peer's forward
        (``remote``) is counted at the node that took the import."""
        if index_name == SYSTEM_INDEX:
            # The history sampler's own writes go through this path: they
            # count under path="system", out of the series it records.
            path = INGEST_PATH_SYSTEM
        if not remote:
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

    def shard_nodes(self, index_name: str, shard: int) -> List[dict]:
        if self.cluster is not None:
            return [n.to_dict() for n in self.cluster.shard_nodes(index_name, shard)]
        return [self.node()]

    def max_shards(self) -> Dict[str, int]:
        out = {}
        for name, idx in self.holder.indexes.items():
            shards = list(idx.available_shards())
            out[name] = max(shards) if shards else 0
        return out

    def available_shards_by_index(self) -> Dict[str, List[int]]:
        return {name: [int(s) for s in idx.available_shards()]
                for name, idx in self.holder.indexes.items()}

    def fragment_blocks(
        self, index_name: str, field_name: str, view_name: str, shard: int
    ):
        frag = self.holder.fragment(index_name, field_name, view_name, shard)
        if frag is None:
            raise NotFoundError("fragment not found")
        return [
            {"id": blk, "checksum": digest.hex()}
            for blk, digest in frag.checksum_blocks()
        ]

    def fragment_block_data(
        self, index_name: str, field_name: str, view_name: str, shard: int, block: int
    ):
        frag = self.holder.fragment(index_name, field_name, view_name, shard)
        if frag is None:
            raise NotFoundError("fragment not found")
        rows, cols = frag.block_data(block)
        return {"rows": rows.tolist(), "cols": cols.tolist()}

    def delete_available_shard(self, index_name, field_name, shard: int):
        self.field(index_name, field_name).remove_available_shard(shard)

    # -- attr diff (api.go :689-786) ----------------------------------------

    def index_attr_diff(self, index_name: str, blocks: List[dict]) -> Dict[int, dict]:
        idx = self.index(index_name)
        return _attr_diff(idx.column_attr_store, blocks)

    def field_attr_diff(
        self, index_name: str, field_name: str, blocks: List[dict]
    ) -> Dict[int, dict]:
        f = self.field(index_name, field_name)
        return _attr_diff(f.row_attr_store, blocks)

    def node(self) -> dict:
        """This node as ``/status`` reports it (api.go Node)."""
        if self._node is not None:
            to_dict = getattr(self._node, "to_dict", None)
            return to_dict() if to_dict is not None else dict(self._node)
        return {"id": "local", "uri": "http://localhost:10101", "isCoordinator": True}

    def hosts(self) -> List[dict]:
        if self.cluster is not None:
            return [n.to_dict() for n in self.cluster.nodes]
        return [self.node()]

    def state(self) -> str:
        if self.cluster is not None:
            return self.cluster.state
        return "NORMAL"

    def readiness(self) -> Tuple[bool, List[str]]:
        """Readiness verdict with reason strings (the GET /readyz
        contract): ready iff the holder is open, the engine's warm start,
        when one ran this boot, is done, the cluster's state is NORMAL,
        gossip has converged (no member suspect) and, in process mode,
        every worker process is connected."""
        reasons: List[str] = []
        if not self.holder.opened:
            reasons.append("holder not opened")
        ws = self.warm_status()
        if ws is not None and not ws["done"]:
            reasons.append(f"warming: residency {ws['fraction']:.0%} "
                           f"({ws['built']}/{ws['total']} stacks)")
        if self.cluster is not None and self.cluster.state != "NORMAL":
            reasons.append(f"cluster state {self.cluster.state}")
        if self.gossip is not None:
            suspects = sorted(mid for mid, state in self.gossip.member_states().items()
                              if state == "suspect")
            if suspects:
                reasons.append("gossip not converged: suspect " + ",".join(suspects))
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

    # -- the multi-process mesh (pilosa_tpu/api.py:1307-1660) ----------------

    # Accepted but uncommitted dispatches expire after this many seconds:
    # an initiator that died between accept and commit leaves no pending
    # entry behind.  It exceeds the initiator's whole accept fan-out (35 s
    # a peer, server._broadcast_dispatch), so a slow handoff that succeeds
    # never races its own expiry.
    MESH_PENDING_TIMEOUT = 120.0
    # A replay's readback waits at most this long for its collective: a
    # collective some rank never joins is logged, not a permanent wedge of
    # the replay worker.
    MESH_REPLAY_TIMEOUT = 120.0

    # The payload keys each collective kind needs.
    _MESH_REQUIRED = {
        "count": ("query",),
        "eval": ("query",),
        "count_batch": ("queries", "shardsList"),
        "sum": ("field",),
        "minmax": ("field", "isMin"),
        "topn": ("field", "src", "n", "minThreshold", "cands"),
        "topn_scores": ("field", "rows", "src"),
        "group": ("fields", "rows"),
    }

    def mesh_ticket(self) -> int:
        """The next dense collective sequence number (this node is the
        mesh sequencer; route /internal/mesh/ticket): tickets give the
        collectives one global order, so any node may initiate
        (parallel/seqgate.py)."""
        with self._mesh_ticket_lock:
            seq = self._mesh_ticket_next
            self._mesh_ticket_next += 1
            return seq

    def mesh_collective_accept(self, payload: dict):
        """Accept a peer's collective dispatch (route /internal/mesh/dispatch):
        validate it now, so that a bad dispatch fails the initiator's
        handoff with a 400 before any rank enters a collective, then
        replay it on the worker: the same lowering over the same holder
        state gives this rank's part of the same collective.  Kinds are
        the engine's collectives: count, eval, count_batch, sum, minmax,
        topn, topn_scores and group.

        The handoff is two-phase (server._broadcast_dispatch): ``phase:
        "accept"`` validates and registers the dispatch under its ``did``
        without entering it, ``"commit"`` queues its replay, ``"abort"``
        (or expiry) drops it.  A payload with no ``did`` is a single-phase
        dispatch (in-process callers)."""
        phase = payload.get("phase", "accept")
        if phase in ("commit", "abort"):
            return self._mesh_collective_resolve(payload, phase)
        if self.engine is None:
            raise ApiError("mesh engine not available")
        from . import pql as pql_mod

        kind = payload.get("kind")
        required = self._MESH_REQUIRED.get(kind)
        if required is None:
            raise ApiError(f"unknown collective kind: {kind}")
        missing = [k for k in required if k not in payload]
        if missing:
            raise ApiError(f"collective {kind} missing: {missing}")
        idx = self.holder.index(payload.get("index", ""))
        if idx is None:
            raise NotFoundError(f"index not found: {payload.get('index')}")
        # Data-plane parity: the replay lays out this rank's block from the
        # LOCAL canonical shard axis, so a shard the initiator has and this
        # node has not heard of would give the ranks different shapes: a
        # hang instead of an error.  Reject the divergence now.
        canon = payload.get("canon")
        if canon is not None:
            mine = self.engine.canonical_shards(payload["index"])
            if [int(s) for s in canon] != [int(s) for s in mine]:
                raise ApiError(
                    f"canonical shard axis diverged: initiator={canon} "
                    f"local={mine} (retry after anti-entropy)"
                )
        # A replay that silently declines (an unknown field) would strand
        # the initiator's collective: reject at accept time.
        for fname in [payload["field"]] if "field" in payload else payload.get("fields", []):
            f = idx.field(fname)
            if f is None:
                raise NotFoundError(f"field not found: {fname}")
            if kind in ("sum", "minmax") and f.bsi_group(fname) is None:
                raise ApiError(f"field is not BSI: {fname}")
        # Parse every call text once, up front: a syntax error surfaces to
        # the initiator as a 400; the parsed calls ride the queue.
        payload = dict(payload)
        payload["_calls"] = {}
        for key in ("query", "src", "filter"):
            text = payload.get(key)
            if text is None and (key == "filter" or key not in required):
                continue
            if not text:
                raise ApiError(f"collective {kind}: empty {key}")
            q = pql_mod.parse(text)
            if len(q.calls) != 1:
                raise ApiError("collective dispatch carries exactly one call")
            payload["_calls"][key] = q.calls[0]
        if kind == "count_batch":
            if len(payload["queries"]) != len(payload["shardsList"]):
                raise ApiError("count_batch: queries/shardsList length mismatch")
            if not payload["queries"]:
                raise ApiError("count_batch: empty batch")
            batch_calls = []
            for text in payload["queries"]:
                q = pql_mod.parse(text)
                if len(q.calls) != 1:
                    raise ApiError("collective dispatch carries exactly one call")
                batch_calls.append(q.calls[0])
            payload["_batch_calls"] = batch_calls
        self._ensure_mesh_worker()
        did = payload.get("did")
        if did is None:
            self._mesh_replay_q.put(payload)  # single-phase (in-process)
            return True
        timer = threading.Timer(self.MESH_PENDING_TIMEOUT, self._mesh_pending_expire,
                                args=(did,))
        timer.daemon = True
        with self._mesh_replay_lock:
            self._mesh_pending[did] = (payload, timer)
        timer.start()
        return True

    def _ensure_mesh_worker(self):
        with self._mesh_replay_lock:
            if self._mesh_replay_q is None:
                import queue as queue_mod

                self._mesh_replay_q = queue_mod.Queue()
                threading.Thread(target=self._mesh_replay_loop, daemon=True,
                                 name="mesh-replay").start()

    def _mesh_collective_resolve(self, payload: dict, phase: str):
        """Commit or abort a pending two-phase dispatch.  A sequenced one
        (it carries a ticket) runs on a thread of its own through the
        engine's seq gate, in ticket order whatever the order commits
        arrive in; an unsequenced one keeps the FIFO replay worker."""
        did = payload.get("did")
        with self._mesh_replay_lock:
            entry = self._mesh_pending.pop(did, None)
        if entry is None:
            if phase == "abort":
                # An unknown did is a no-op, but an abort that carries a
                # ticket still skips it: the accept may have failed HERE
                # while other peers took the ticket into their streams.
                seq = payload.get("seq")
                if seq is not None and self.engine is not None:
                    self.engine.seq_gate.skip(int(seq))
                return True
            raise ApiError(f"unknown or expired dispatch: {did}")
        pending, timer = entry
        timer.cancel()
        seq = pending.get("seq")
        if phase == "commit":
            if seq is not None:
                threading.Thread(target=self._mesh_seq_replay, args=(pending,),
                                 daemon=True, name=f"mesh-seq-{seq}").start()
            else:
                self._mesh_replay_q.put(pending)
        elif seq is not None:
            self.engine.seq_gate.skip(int(seq))
        return True

    def _mesh_pending_expire(self, did: str):
        with self._mesh_replay_lock:
            entry = self._mesh_pending.pop(did, None)
        if entry is not None:
            pending, _timer = entry
            seq = pending.get("seq")
            if seq is not None and self.engine is not None:
                self.engine.seq_gate.skip(int(seq))
            self.logger.printf(
                "mesh dispatch %s expired uncommitted (initiator died mid-handoff?); "
                "dropped without dispatching", did)

    def _mesh_seq_replay(self, payload: dict):
        """Run one committed sequenced dispatch: enter the gate at its
        ticket, dispatch (the collective included), exit, read back."""
        seq = int(payload["seq"])
        gate = self.engine.seq_gate
        try:
            if not gate.enter(seq):
                self.logger.printf(
                    "mesh seq %d was force-skipped before replay (initiator may hang)", seq)
                return
            try:
                dev = self._mesh_replay_dispatch(payload)
            finally:
                gate.exit(seq)
            self._mesh_replay_readback(dev, payload)
        except Exception as e:  # noqa: BLE001
            self.logger.printf("mesh seq replay failed: %s", e)
        finally:
            # A replay's plan note belongs to no query on this thread.
            plans.take_dispatch_note()

    def _mesh_replay_loop(self):
        """Replay peers' unsequenced dispatches in arrival order (the
        initiator serializes its collectives under the engine's lock and
        hands them off in order, so arrival order is initiation order)."""
        while True:
            payload = self._mesh_replay_q.get()
            try:
                with self.engine.collective_lock:
                    dev = self._mesh_replay_dispatch(payload)
                self._mesh_replay_readback(dev, payload)
            except Exception as e:  # noqa: BLE001
                self.logger.printf("mesh replay failed: %s", e)
            finally:
                plans.take_dispatch_note()

    def _mesh_replay_readback(self, dev, payload: dict):
        """A bounded wait for a replayed dispatch's result.  The port's
        dispatch returns only after its collective (the all-reduce or
        all-gather on the host) completed, so this waits for the card's
        part of the result: on a side thread, at most
        MESH_REPLAY_TIMEOUT, logged if it sticks or fails."""
        if dev is None:
            # The initiator dispatched; a replay that declined strands it.
            # Accept-time validation makes this unreachable for a known
            # schema: say so loudly if it happens anyway.
            self.logger.printf(
                "mesh replay DID NOT DISPATCH (initiator may hang): %r",
                {k: v for k, v in payload.items() if not k.startswith("_")})
            return
        err: list = []

        def wait():
            try:
                for t in dev if isinstance(dev, (list, tuple)) else (dev,):
                    t.reshape(-1)[:1].cpu()
            except Exception as e:  # noqa: BLE001
                err.append(e)

        waiter = threading.Thread(target=wait, daemon=True)
        waiter.start()
        waiter.join(self.MESH_REPLAY_TIMEOUT)
        if waiter.is_alive():
            self.logger.printf(
                "mesh replay result STUCK >%ss: %r", self.MESH_REPLAY_TIMEOUT,
                {k: v for k, v in payload.items() if not k.startswith("_")})
        elif err:
            self.logger.printf("mesh replay readback failed: %s", err[0])

    def _mesh_replay_dispatch(self, payload: dict):
        """Enter the dispatch the initiator described, with
        ``broadcast=False``: the result (None when nothing dispatched)."""
        eng = self.engine
        kind = payload["kind"]
        index = payload["index"]
        shards = payload.get("shards")
        if shards is None:
            idx = self.holder.index(index)
            shards = [int(s) for s in idx.available_shards()] if idx else []
        calls = payload["_calls"]  # parsed at accept time
        if kind == "count":
            return eng.count_async(index, calls.get("query"), shards, broadcast=False)
        if kind == "eval":
            words, _ = eng.bitmap_stack(index, calls.get("query"), shards, broadcast=False)
            return words
        if kind == "count_batch":
            return eng.count_many_async(index, payload["_batch_calls"], payload["shardsList"],
                                        broadcast=False)
        if kind == "sum":
            res = eng.sum_async(index, payload["field"], calls.get("filter"), shards,
                                broadcast=False)
            return None if res is None else res[0]
        if kind == "minmax":
            res = eng.min_max_async(index, payload["field"], calls.get("filter"), shards,
                                    payload["isMin"], broadcast=False)
            return None if res is None else res[0]
        if kind == "topn":
            res = eng.topn_full_async(index, payload["field"], calls.get("src"), shards,
                                      payload["n"], payload["minThreshold"],
                                      row_ids=payload.get("rowIds"), broadcast=False,
                                      replay_cands=payload["cands"])
            return None if res is None else res[2]
        if kind == "topn_scores":
            res = eng.topn_scores_async(index, payload["field"], payload["rows"],
                                        calls.get("src"), shards, broadcast=False)
            return None if res is None else res[0]
        if kind == "group":
            return eng.group_counts_async(index, payload["fields"], payload["rows"],
                                          calls.get("filter"), shards, broadcast=False)
        raise ApiError(f"unknown collective kind: {kind}")

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

    def cluster_message(self, msg: dict):
        """Receive a broadcast control-plane message (server.go:485-580)."""
        typ = msg.get("type")
        # Gossip delivery is AT-LEAST-ONCE and unordered (dedup ids
        # eventually expire while peers may still retransmit), so every
        # handler here must be idempotent.  Schema messages carry the
        # object's creation_id ("cid"): creates skip tombstoned ids and
        # adopt the originator's id; deletes tombstone the id and only
        # remove a local object of that same incarnation — a redelivered
        # or reordered delete can't destroy a recreated object, and
        # clock skew is irrelevant (no wall-clock comparison).
        if typ == "create-index":
            self._apply_create_index(msg)
        elif typ == "delete-index":
            cid = msg.get("cid", "")
            self.holder.tombstone(cid)
            for fcid in msg.get("fieldCids", []):
                self.holder.tombstone(fcid)
            idx = self.holder.index(msg["index"])
            if idx is not None and (not cid or idx.creation_id == cid):
                for f in idx.fields.values():
                    self.holder.tombstone(f.creation_id)
                self.holder.delete_index(msg["index"])
        elif typ == "create-field":
            self._apply_create_field(msg["index"], msg)
        elif typ == "delete-field":
            cid = msg.get("cid", "")
            self.holder.tombstone(cid)
            idx = self.holder.index(msg["index"])
            f = idx.field(msg["field"]) if idx is not None else None
            if f is not None and (not cid or f.creation_id == cid):
                idx.delete_field(msg["field"])
                self.holder.bump_shard_epoch(msg["index"])
        elif typ == "create-shard":
            idx = self.holder.index(msg["index"])
            f = idx.field(msg["field"]) if idx else None
            if f is not None:
                f.add_remote_available_shards(Bitmap([msg["shard"]]))
        elif typ == "node-status":
            # A NodeStatus exchange is a heartbeat: record receipt plus
            # the sender's per-index data-version tokens — the evidence
            # bounded replica reads run on (docs/durability.md).
            if self.cluster is not None:
                sender = msg.get("node", {}).get("id")
                if sender:
                    self.cluster.note_heartbeat(
                        sender,
                        msg.get("versions") or None,
                        ae_passes=msg.get("aePasses"),
                        # Peer-advertised pending-hint counts (hinted
                        # handoff): quarantine release + the syncer's
                        # defer-own-pass check consume these.  A status
                        # WITHOUT the field (pre-hint peer) leaves the
                        # previous advertisement untouched.
                        pending_hints=msg.get("pendingHints"),
                    )

            # Anti-entropy schema reconciliation: adopt the sender's
            # tombstones FIRST (so a delete this node missed applies here
            # instead of this node's stale schema resurrecting it
            # elsewhere), then merge creations, skipping anything
            # tombstoned on either side.
            for cid in msg.get("tombstones", []):
                if self.holder.is_tombstoned(cid):
                    continue
                self.holder.tombstone(cid)
                for iname, idx in list(self.holder.indexes.items()):
                    if idx.creation_id == cid:
                        for f in idx.fields.values():
                            self.holder.tombstone(f.creation_id)
                        self.holder.delete_index(iname)
                        break
                    for fname, f in list(idx.fields.items()):
                        if f.creation_id == cid:
                            idx.delete_field(fname)
                            self.holder.bump_shard_epoch(iname)
                            break
            for index_name, info in msg.get("indexes", {}).items():
                idx = self._apply_create_index(
                    {
                        "index": index_name,
                        "cid": info.get("cid", ""),
                        "meta": {"keys": info.get("keys", False)},
                    }
                )
                if idx is None:
                    continue
                for field_name, finfo in info.get("fields", {}).items():
                    f = self._apply_create_field(
                        index_name,
                        {
                            "field": field_name,
                            "cid": finfo.get("cid", ""),
                            "meta": finfo.get("options", {}),
                        },
                    )
                    if f is not None:
                        f.add_remote_available_shards(
                            Bitmap(finfo.get("availableShards", []))
                        )
            # RESIZING is coordinator-granted: if the coordinator's
            # periodic status says the resize is over but this node
            # missed the set-state NORMAL broadcast (one lost POST — or
            # a coordinator that died mid-job and restarted), adopt its
            # state instead of staying wedged in RESIZING forever
            # (mergeClusterStatus parity, cluster.go:1530-1570).
            if (
                self.cluster is not None
                and self.cluster.state == "RESIZING"
                and msg.get("node", {}).get("isCoordinator")
                and msg.get("state") not in (None, "", "RESIZING")
            ):
                self.cluster.set_state(msg["state"])
        elif typ == "recalculate-caches":
            for idx in self.holder.indexes.values():
                for f in idx.fields.values():
                    for v in f.views.values():
                        for frag in v.fragments.values():
                            frag.cache.recalculate()
        elif self.cluster is not None:
            self.cluster.receive_message(msg)

    def _apply_create_index(self, msg: dict):
        """Idempotent remote create-index: skip tombstoned incarnations,
        adopt the originator's creation_id on fresh creates, and converge
        to min(local, remote) cid when both sides created the same name
        concurrently (otherwise ids diverge forever and later deletes are
        silently ignored on half the cluster).  Returns the index or None
        (tombstoned)."""
        cid = msg.get("cid", "")
        if self.holder.is_tombstoned(cid):
            return None
        existing = self.holder.index(msg["index"])
        idx = self.holder.create_index_if_not_exists(
            msg["index"], keys=msg.get("meta", {}).get("keys", False)
        )
        if cid and (existing is None or cid < idx.creation_id):
            idx.creation_id = cid
            idx.save_meta()
        return idx

    def _apply_create_field(self, index_name: str, msg: dict):
        """Idempotent remote create-field (see _apply_create_index)."""
        cid = msg.get("cid", "")
        if self.holder.is_tombstoned(cid):
            return None
        idx = self.holder.index(index_name)
        if idx is None:
            return None
        existing = idx.field(msg["field"])
        f = idx.create_field_if_not_exists(
            msg["field"], FieldOptions.from_dict(msg.get("meta", {}))
        )
        if cid and (existing is None or cid < f.creation_id):
            f.creation_id = cid
            f.save_meta()
        return f

    def set_coordinator(self, node_id: str):
        if self.cluster is None:
            raise ApiError("not clustered")
        return self.cluster.set_coordinator(node_id)

    def remove_node(self, node_id: str):
        if self.cluster is None:
            raise ApiError("not clustered")
        return self.cluster.remove_node(node_id)

    def resize_abort(self):
        if self.cluster is None:
            raise ApiError("not clustered")
        self.cluster.abort_resize()

    # -- translation (api.go :1124-1166) ------------------------------------

    def get_translate_data(self, offset: int) -> bytes:
        return self.translate_store.reader(offset)

    def _broadcast(self, msg: dict):
        if self.cluster is not None:
            self.cluster.send_sync(msg)


def _attr_diff(store, blocks: List[dict]) -> Dict[int, dict]:
    """The attributes of the local blocks whose checksums differ from the
    peer's (api.go:689-786)."""
    peer = {b["id"]: bytes.fromhex(b["checksum"]) for b in blocks}
    out: Dict[int, dict] = {}
    for blk, digest in store.blocks():
        if peer.get(blk) == digest:
            continue
        out.update(store.block_data(blk))
    return out
