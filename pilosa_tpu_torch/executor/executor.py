"""The query executor: PQL call dispatch, the fused Count, TopN, BSI and
GroupBy lanes and the host bitmap lane.

The port of ``pilosa_tpu/executor/executor.py`` (upstream Pilosa:
executor.go:84-2890):

- ``execute`` parses PQL and dispatches each call (executeCall
  :256-295).
- Count: a bare ``Count(Row(f=n))`` sums maintained row cardinalities
  with no device work (the O(1) lane); any other tree runs as one fused
  device count through the engine's batcher (``TorchEngine.batched_count``,
  as ``pilosa_tpu/executor/executor.py:1614`` does: a lone caller runs
  the count directly, a caller within a batch's hot window rides the next
  K5 launch).  Only
  ``UnsupportedLowering`` sends a Count to the host lane instead, so a
  kernel fault is never hidden behind a fallback.  A run of two or more
  CONSECUTIVE Counts in one query is one ``TorchEngine.count_many`` (one
  K5 launch); a write between two Counts ends the run, so the second sees
  it.
- ``execute_async`` (all-Count queries): every Count is answered by the
  O(1) lane or queued into the engine's batcher, and a future
  (``_QueryFuture``) comes back without waiting for the card.
- The host bitmap lane evaluates Row/Union/Intersect/Difference/Xor/Not
  and Range (a BSI condition through ``ops/bsi.py``, a time-quantum row
  over its view cover) per shard on the fragments' row mirrors and merges
  the per-shard rows.
- Sum/Min/Max (executor.go :1756-1884): with an engine, through its batch
  lane (``TorchEngine.batched_sum`` / ``batched_min_max``: one launch for a
  lone caller, a fused program with concurrent drain-mates; identical
  concurrent calls collapse into one, keyed on the write sequence) and a
  ``ValCount``; without one,
  or when the engine declines the filter (``UnsupportedLowering``), the
  per-shard host lane.  ``host_fallbacks`` counts the Count/Sum/Min/Max
  calls an engine declined to the host lane.
- TopN (executor.go :694-828): with an engine, one fused device TopN
  through the batch lane (``TorchEngine.batched_topn_full``, or the
  host-only ``topn_cache_only`` with no src); when that declines (an
  attribute or Tanimoto filter, or a candidate union past
  ``MAX_TOPN_CANDIDATES``), the two-phase composition: phase-1 scores for
  every shard in one device launch (``batched_topn_scores``), the
  per-shard heap walk of ``Fragment.top`` on the
  host, then the exact phase-2 recount of the merged ids.  Without an
  engine every shard runs ``Fragment.top(src=...)``.  Identical
  concurrent fused TopNs collapse into one launch (``SingleFlight``).
- GroupBy (executor.go :1056-1170): plain ``Rows(field=f)`` children
  run on the fused lane, every combination's count in one K8 launch
  (``TorchEngine.batched_group_counts``), assembled in row-major order;
  a child with ``previous``/``limit``/``column``, more than
  MAX_GROUP_COMBOS combinations or a filter with no lowering runs the
  per-shard host iterator (``_GroupByIterator``).  ``Rows`` merges the
  fragments' sorted row ids with its limit.
- Set/Clear write single bits (and the existence bit); Store and
  ClearRow overwrite or clear a whole row per shard.
- Attributes (executor.go :2693-2730): SetRowAttrs and SetColumnAttrs
  write the field's and the index's attribute stores (a query of
  SetRowAttrs calls alone is one bulk write per field); a ``Row`` result
  carries its row's attributes unless ``excludeRowAttrs``, and
  ``columnAttrs`` adds the attributes of every result column to the
  response (``QueryResponse.column_attr_sets``).
- Options (executor.go :317): ``columnAttrs``, ``excludeRowAttrs``,
  ``excludeColumns`` and ``shards`` for its one child call.
- Keys: with a ``translator`` (``executor/translate.py``, which the API
  plugs in), string keys in the calls become ids before execution and
  the results' ids become keys after it.

- The cluster (``cluster/``): with ``cluster`` set, ``map_reduce`` groups
  the shards by owning node (``_mapper``): this node's shards run on its
  own card through the lanes above, a peer's go to it as one remote query
  (``remote=True``, its partial merged into the same reduce), and a peer
  that fails in transport is marked DOWN and its shards retried on the
  next replica within a hedge budget.  ``_read_route`` picks a replica per
  shard (``primary``, ``any`` or ``bounded``, the request's
  ``replica_read`` and ``freshness_ms`` over the cluster's).  Single-bit
  writes apply on every live owner (``_write_replicated``); a DOWN
  owner's miss is queued as a hint (``cluster/hints.py``); attribute
  writes go to every node.  Writes are refused while the cluster resizes.
  The serving memo lane and the async Count path stay off for any query
  with a remote shard, as in the reference.

- Query plans (``util/plans.py``): each call stamps the plan the API
  attached to the thread, as the reference's executor does; the engine
  and the batcher stamp the dispatch decisions.  ``Explain(<query>)``
  plans a Count without launching anything (``TorchEngine.explain_count``)
  and returns the plan as its result.
"""

from __future__ import annotations

import datetime as dt
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import pql
from ..core import cache as cache_mod
from ..core import fragment as frag_mod
from ..core import timequantum
from ..core.field import (FIELD_TYPE_BOOL, FIELD_TYPE_INT, FIELD_TYPE_MUTEX, FIELD_TYPE_SET,
                          FIELD_TYPE_TIME)
from ..core.index import EXISTENCE_FIELD_NAME
from ..core.row import Row
from ..core.view import VIEW_STANDARD, view_bsi_name
from ..ops import bitops
from ..ops import bsi as bsi_ops
from ..parallel.errors import HostFallback
from ..parallel.singleflight import SingleFlight
from ..pql import BETWEEN, EQ, GT, GTE, LT, LTE, NEQ, Call, Condition, Query
from ..util import plans as plans_mod
from ..util.stats import METRIC_REPLICA_READS, REGISTRY, NopStatsClient

TIME_FORMAT = "%Y-%m-%dT%H:%M"  # pilosa.TimeFormat

MAX_WRITES_PER_REQUEST = 5000

DEFAULT_FIELD = "general"

# TopN's default minimum threshold (executor.go defaultMinThreshold).
DEFAULT_MIN_THRESHOLD = 1

_WRITE_CALLS = {"Set", "Clear", "SetRowAttrs", "SetColumnAttrs", "Store", "ClearRow"}

# Write calls that remove bits (directly, or by overwriting a row): never
# acked with an owner DOWN unless the hint queue absorbs the miss, since
# anti-entropy's majority-tie-to-set merge would set them again when the
# owner recovers (pilosa_tpu/executor/executor.py:326-331).
_DESTRUCTIVE_CALLS = {"Clear", "ClearRow", "Store"}



class Error(Exception):
    pass


class IndexNotFoundError(Error):
    pass


class FieldNotFoundError(Error):
    pass


class ExecOptions:
    """executor.go execOptions.  ``remote`` marks a peer's replay (its
    shards run here as given, and its results are not key-translated);
    ``replica_read`` ("" defers to the cluster's ``[cluster]
    replica-read``) and ``freshness_ms`` (None defers to ``[cluster]
    freshness-ms``) are the request's replica-read override."""

    __slots__ = ("remote", "exclude_row_attrs", "exclude_columns", "column_attrs",
                 "replica_read", "freshness_ms")

    def __init__(self, remote: bool = False, exclude_row_attrs: bool = False,
                 exclude_columns: bool = False, column_attrs: bool = False,
                 replica_read: str = "", freshness_ms: Optional[float] = None):
        self.remote = remote
        self.exclude_row_attrs = exclude_row_attrs
        self.exclude_columns = exclude_columns
        self.column_attrs = column_attrs
        self.replica_read = replica_read
        self.freshness_ms = freshness_ms

    def copy(self) -> "ExecOptions":
        return ExecOptions(self.remote, self.exclude_row_attrs, self.exclude_columns,
                           self.column_attrs, self.replica_read, self.freshness_ms)


class ValCount:
    """Sum/Min/Max result (executor.go ValCount :2652-2696)."""

    __slots__ = ("val", "count")

    def __init__(self, val: int = 0, count: int = 0):
        self.val = val
        self.count = count

    def add(self, other: "ValCount") -> "ValCount":
        return ValCount(self.val + other.val, self.count + other.count)

    def smaller(self, other: "ValCount") -> "ValCount":
        if self.count == 0 or (other.val < self.val and other.count > 0):
            return other
        return ValCount(self.val, self.count)

    def larger(self, other: "ValCount") -> "ValCount":
        if self.count == 0 or (other.val > self.val and other.count > 0):
            return other
        return ValCount(self.val, self.count)

    def __eq__(self, other):
        return (isinstance(other, ValCount) and self.val == other.val
                and self.count == other.count)

    def __repr__(self):
        return f"ValCount(val={self.val}, count={self.count})"

    def to_dict(self):
        return {"value": self.val, "count": self.count}


class FieldRow:
    """One (field, row) of a GroupBy group (executor.go:976-1001)."""

    __slots__ = ("field", "row_id", "row_key")

    def __init__(self, field: str, row_id: int = 0, row_key: str = ""):
        self.field = field
        self.row_id = row_id
        self.row_key = row_key

    def __eq__(self, other):
        return (isinstance(other, FieldRow) and self.field == other.field
                and self.row_id == other.row_id and self.row_key == other.row_key)

    def __repr__(self):
        return f"FieldRow({self.field}.{self.row_key or self.row_id})"

    def to_dict(self):
        if self.row_key:
            return {"field": self.field, "rowKey": self.row_key}
        return {"field": self.field, "rowID": self.row_id}


class GroupCount:
    """One GroupBy result: the group's rows and their intersection count."""

    __slots__ = ("group", "count")

    def __init__(self, group: List[FieldRow], count: int):
        self.group = group
        self.count = count

    def compare(self, other: "GroupCount") -> int:
        """Order by row ids, field-major (executor.go Compare :1043)."""
        for a, b in zip(self.group, other.group):
            if a.row_id < b.row_id:
                return -1
            if a.row_id > b.row_id:
                return 1
        return 0

    def __eq__(self, other):
        return (isinstance(other, GroupCount) and self.group == other.group
                and self.count == other.count)

    def __repr__(self):
        return f"GroupCount({self.group}, count={self.count})"

    def to_dict(self):
        return {"group": [g.to_dict() for g in self.group], "count": self.count}


class RowIdentifiers:
    """Rows() result of a translated query (executor.go:822-827)."""

    __slots__ = ("rows", "keys")

    def __init__(self, rows: List[int], keys: Optional[List[str]] = None):
        self.rows = rows
        self.keys = keys or []

    def __eq__(self, other):
        return (isinstance(other, RowIdentifiers) and self.rows == other.rows
                and self.keys == other.keys)

    def __repr__(self):
        return f"RowIdentifiers(rows={self.rows}, keys={self.keys})"

    def to_dict(self):
        d = {"rows": self.rows}
        if self.keys:
            d["keys"] = self.keys
        return d


class ColumnAttrSet:
    """One column's attributes in a ``columnAttrs`` response: by id, or by
    key where the index has keys."""

    __slots__ = ("id", "key", "attrs")

    def __init__(self, id: int, attrs: dict, key: str = ""):
        self.id = id
        self.attrs = attrs
        self.key = key

    def to_dict(self):
        if self.key:
            return {"key": self.key, "attrs": self.attrs}
        return {"id": self.id, "attrs": self.attrs}


class QueryResponse:
    __slots__ = ("results", "column_attr_sets", "trace_id", "plan")

    def __init__(self, results=None, column_attr_sets=None):
        self.results = results if results is not None else []
        self.column_attr_sets = column_attr_sets
        # Stamped by the API layer, surfaced as the response's "traceID".
        self.trace_id: Optional[str] = None
        # The recorded QueryPlan dict when the request asked ?profile=1,
        # surfaced as the response's "plan".
        self.plan: Optional[dict] = None


def _merge_row_ids(a: List[int], b: List[int], limit: int) -> List[int]:
    """Sorted-unique merge with limit (executor.go RowIDs.merge :833)."""
    out: List[int] = []
    i = j = 0
    while i < len(a) and j < len(b) and len(out) < limit:
        if a[i] < b[j]:
            out.append(a[i])
            i += 1
        elif a[i] > b[j]:
            out.append(b[j])
            j += 1
        else:
            out.append(a[i])
            i += 1
            j += 1
    while i < len(a) and len(out) < limit:
        out.append(a[i])
        i += 1
    while j < len(b) and len(out) < limit:
        out.append(b[j])
        j += 1
    return out


def _merge_group_counts(a: List[GroupCount], b: List[GroupCount],
                        limit: int) -> List[GroupCount]:
    """executor.go mergeGroupCounts :1013."""
    limit = min(limit, len(a) + len(b))
    out: List[GroupCount] = []
    i = j = 0
    while i < len(a) and j < len(b) and len(out) < limit:
        c = a[i].compare(b[j])
        if c < 0:
            out.append(a[i])
            i += 1
        elif c == 0:
            a[i].count += b[j].count
            out.append(a[i])
            i += 1
            j += 1
        else:
            out.append(b[j])
            j += 1
    while i < len(a) and len(out) < limit:
        out.append(a[i])
        i += 1
    while j < len(b) and len(out) < limit:
        out.append(b[j])
        j += 1
    return out


_MAXINT = (1 << 63) - 1


def _call_cacheable(c: Call) -> bool:
    """True when a parsed call can be reused across executions: read-only
    and free of string/bool args anywhere in the tree."""
    if c.name in _WRITE_CALLS:
        return False
    for v in c.args.values():
        if isinstance(v, (str, bool)):
            return False
        if isinstance(v, list) and any(isinstance(x, (str, bool)) for x in v):
            return False
        if isinstance(v, Condition) and isinstance(v.value, (str, bool)):
            return False
    return all(_call_cacheable(ch) for ch in c.children)


class _QueryFuture:
    """Future of a deferred all-Count query (``Executor.execute_async``),
    a port of ``pilosa_tpu/executor/executor.py:350 _QueryFuture``: it
    resolves to a QueryResponse once every batched item lands.  On ANY
    item error it re-executes the query synchronously on a fresh thread
    (``_fallback``): the sync path has per-call lanes the pipeline skips
    (the host lane for a tree that does not lower), so an async error
    converges to the sync answer instead of surfacing an error the sync
    path would not have raised.  Each such re-execution counts in
    ``Executor.async_fallbacks``, so that it never hides a kernel fault:
    a run that expects none checks the count.  The thread is fresh, never
    a collect worker, whose pool resolves other batches."""

    __slots__ = ("_executor", "_index", "_query", "_shards", "_opt", "_slots", "_items",
                 "_event", "_response", "_error", "_callbacks", "_cb_lock", "_draining",
                 "_pending", "_lock", "trace_span", "query_plan")

    def __init__(self, executor, index, query, shards, opt, slots, items):
        self._executor = executor
        self._index = index
        self._query = query  # parsed, its keys already translated
        self._shards = shards
        self._opt = opt
        self._slots = slots
        self._items = items  # [(result slot, batcher _Item), ...]
        self._event = threading.Event()
        self._response: Optional[QueryResponse] = None
        self._error: Optional[BaseException] = None
        self._callbacks: list = []
        self._cb_lock = threading.Lock()
        self._draining = False
        self._pending = len(items)
        self._lock = threading.Lock()
        # The API's deferred span and query plan, set by API.query_async.
        self.trace_span = None
        self.query_plan = None
        if not items:
            self._finish_ok()  # every call hit the O(1) lane
        else:
            for _k, it in items:
                it.add_done_callback(self._item_done)

    def _item_done(self, _item):
        with self._lock:
            self._pending -= 1
            if self._pending > 0:
                return
        if any(it.error is not None for _k, it in self._items):
            threading.Thread(target=self._fallback, daemon=True, name="query-fallback").start()
            return
        for k, it in self._items:
            self._slots[k] = it.result
        self._finish_ok()

    def _finish_ok(self):
        self._response = QueryResponse(list(self._slots))
        self._resolve()

    def _fallback(self):
        with self._executor._fallback_lock:
            self._executor.async_fallbacks += 1
        try:
            self._response = self._executor._execute_translated(
                self._index, self._query, self._shards, self._opt)
        except BaseException as e:  # noqa: BLE001
            self._error = e
        self._resolve()

    def _resolve(self):
        self._event.set()
        # FIFO drain under _cb_lock: registration order is completion
        # order.  ``_draining`` keeps a late registrant from running ahead
        # of an earlier callback still running on this thread; callbacks
        # run outside the lock.
        while True:
            with self._cb_lock:
                if not self._callbacks:
                    self._draining = False
                    break
                self._draining = True
                fn = self._callbacks.pop(0)
            try:
                fn(self)
            except Exception:  # noqa: BLE001
                pass

    def done(self) -> bool:
        return self._event.is_set()

    def add_done_callback(self, fn):
        """Run ``fn(self)`` on resolution: at once when resolved and fully
        drained, else behind the callbacks registered before it."""
        with self._cb_lock:
            if not self._event.is_set() or self._draining:
                self._callbacks.append(fn)
                return
        fn(self)

    def result(self, timeout: Optional[float] = None) -> QueryResponse:
        if not self._event.wait(timeout if timeout is not None else 310.0):
            raise Error("deferred query timed out (pipeline wedged?)")
        if self._error is not None:
            raise self._error
        return self._response


class Executor:
    """The query executor over a Holder and, optionally, a ``TorchEngine``
    for the fused lanes, a ``QueryTranslator`` for string keys and a
    ``Cluster`` whose peers answer the shards this node does not own."""

    _PARSE_CACHE_MAX = 512
    _GROUP_ROWS_MAX = 256

    def __init__(self, holder, engine=None, translator=None, stats=None, cluster=None):
        self.holder = holder
        self.engine = engine
        self.translator = translator
        self.cluster = cluster
        # One per peer query the mapper sent (the reference's
        # remote_fanouts): a query whose shards are all local leaves it at 0.
        self.remote_fanouts = 0
        # Per-call counts by index (the reference's stats.count hooks),
        # served at /debug/vars by an ExpvarStatsClient.
        self.stats = stats if stats is not None else NopStatsClient()
        # Parsed-query LRU for read-only queries (writes re-validate).
        self._parse_cache: "OrderedDict[str, Query]" = OrderedDict()
        self._parse_lock = threading.Lock()
        # index -> (availability token, default shard list).
        self._default: Dict[str, Tuple[tuple, List[int]]] = {}
        # Identical concurrent TopNs collapse into one launch.
        self._sflight = SingleFlight()
        # Deferred queries re-executed synchronously after an item error
        # (_QueryFuture._fallback).
        self.async_fallbacks = 0
        self._fallback_lock = threading.Lock()
        # Count/Sum/Min/Max/GroupBy calls the engine declined
        # (UnsupportedLowering) and the host lane served.
        self.host_fallbacks = 0
        # (index, field, shards) -> (view token, sorted row ids): the fused
        # GroupBy's row lists (_group_rows).
        self._group_rows_cache: Dict[tuple, tuple] = {}

    def _parse_cached(self, s: str) -> Query:
        with self._parse_lock:
            q = self._parse_cache.get(s)
            if q is not None:
                self._parse_cache.move_to_end(s)
                return q
        q = pql.parse(s)
        if all(_call_cacheable(c) for c in q.calls):
            with self._parse_lock:
                self._parse_cache[s] = q
                while len(self._parse_cache) > self._PARSE_CACHE_MAX:
                    self._parse_cache.popitem(last=False)
        return q

    # -- entry point (executor.go Execute :84) -----------------------------

    def execute(self, index: str, query, shards: Optional[List[int]] = None,
                opt: Optional[ExecOptions] = None) -> QueryResponse:
        if not index:
            raise Error("index required")
        if isinstance(query, str):
            query = self._parse_cached(query)
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        if query.write_call_n() > MAX_WRITES_PER_REQUEST:
            raise Error("too many writes in a single request")
        if self.translator is not None and not (opt is not None and opt.remote):
            self.translator.translate_calls(index, idx, query.calls)
        return self._execute_translated(index, query, shards, opt)

    def _execute_translated(self, index: str, query: Query, shards, opt) -> QueryResponse:
        """``execute`` after key translation (executor.go Execute :84-170):
        the calls, then the column attributes a ``columnAttrs`` response
        carries, then the results' ids turned into keys."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        opt = opt or ExecOptions()
        # Store and ClearRow map over shards like reads (executor.go :146).
        needs = any(c.name not in ("Set", "Clear", "SetRowAttrs", "SetColumnAttrs")
                    for c in query.calls)
        if not shards and needs:
            shards = self._default_shards(index) or [0]
        results = self._execute_calls(index, query.calls, shards, opt)
        resp = QueryResponse(results)
        if opt.column_attrs:
            resp.column_attr_sets = self._column_attr_sets(index, idx, results)
        if self.translator is not None and not opt.remote:
            self.translator.translate_results(index, idx, query.calls, results)
        return resp

    def _column_attr_sets(self, index, idx, results) -> List[ColumnAttrSet]:
        """The attributes of every column of the Row results, by column
        (executor.go Execute :139-162)."""
        ids: List[int] = []
        for r in results:
            if isinstance(r, Row):
                ids = _merge_row_ids(ids, r.columns().tolist(), _MAXINT)
        sets = []
        for cid in ids:
            attrs = idx.column_attr_store.attrs(cid)
            if attrs:
                sets.append(ColumnAttrSet(cid, attrs))
        if self.translator is not None and idx.keys:
            for col in sets:
                col.key = self.translator.translate_column_to_string(index, col.id)
                col.id = 0
        return sets

    def _execute_calls(self, index, calls, shards, opt) -> list:
        """Each call in order; a query of SetRowAttrs calls alone is one
        bulk write per field (executor.go :146-149), and a run of
        CONSECUTIVE Counts is one batched dispatch (executor.py:822-858).
        Consecutive only: a write between two Counts must be visible to the
        second."""
        if calls and all(c.name == "SetRowAttrs" for c in calls):
            return self._execute_bulk_set_row_attrs(index, calls, opt)
        results: list = []
        i, n = 0, len(calls)
        while i < n:
            if calls[i].name == "Count" and self.engine is not None:
                j = i
                while j < n and calls[j].name == "Count":
                    j += 1
                if j - i >= 2:
                    batch = self._mesh_count_many(index, calls[i:j], shards, opt)
                    if batch is None:
                        # The run declined as a whole: each call once.
                        batch = [self._execute_call(index, c, shards, opt)
                                 for c in calls[i:j]]
                    results.extend(batch)
                    i = j
                    continue
            results.append(self._execute_call(index, calls[i], shards, opt))
            i += 1
        return results

    def _mesh_bitmap_row(self, index, c: Call, shards, opt: ExecOptions):
        """A Row-valued tree on a MULTI-PROCESS mesh (executor.py:1623-1648):
        the engine's ``eval`` collective evaluates it on every rank (K10)
        and gathers the words back (``TorchEngine.bitmap_row``), so a Row
        query does not fall back to the host loop there.  A single process
        keeps the host per-shard path: the segments live on this host
        already.  Returns a Row, or None to take the host path."""
        eng = self.engine
        if eng is None or not eng.multiproc or opt.remote or not eng.lowerable(c):
            return None
        if self.cluster is not None:
            local = set(self._local_shards(index, shards))
            if any(s not in local for s in shards):
                return None
        try:
            return eng.bitmap_row(index, c, list(shards))
        except (HostFallback, ValueError):
            # Claim a half-written plan note, or it merges into the next
            # query's record on this pooled thread.
            plans_mod.take_dispatch_note()
            return None

    # -- deferred execution (executor.py:587-697) ----------------------------

    def execute_async(self, index: str, query, shards: Optional[List[int]] = None,
                      opt: Optional[ExecOptions] = None):
        """Deferred execution of an all-Count query: every Count is
        answered by the O(1) lane or queued into the engine's batcher, and
        a future (``result``/``add_done_callback``) comes back without
        waiting for the card.  None when the query is not eligible (a
        ``columnAttrs`` request among them): the caller runs ``execute``."""
        eng = self.engine
        if eng is None or eng._peerless_multiproc or (
                opt is not None and (opt.remote or opt.column_attrs)):
            return None
        try:
            if isinstance(query, str):
                query = self._parse_cached(query)
        except Exception:  # noqa: BLE001 — the sync path surfaces the error
            return None
        calls = query.calls
        if not calls or any(c.name != "Count" or len(c.children) != 1 for c in calls):
            return None
        idx = self.holder.index(index) if index else None
        if idx is None:
            return None  # the sync path raises
        try:
            if self.translator is not None:
                # In place, as the sync path does; Count results are ints,
                # which the result translation leaves as they are.
                self.translator.translate_calls(index, idx, calls)
            if not shards:
                shards = self._default_shards(index) or [0]
            if self.cluster is not None:
                local = set(self._local_shards(index, shards))
                if any(s not in local for s in shards):
                    return None  # remote shards: the sync mapper splits them
            children = [c.children[0] for c in calls]
            if not all(eng.lowerable(ch) for ch in children):
                return None
            # Two passes: every O(1)-lane answer FIRST, so that a surprise
            # in this host pass goes to the sync path with NO batcher item
            # queued (bailing after a queue append would run the query
            # twice).  The second pass only appends.
            slots: list = [self._count_from_cardinalities(index, ch, shards)
                           for ch in children]
        except Exception:  # noqa: BLE001 — any surprise: the sync path decides
            return None
        items = [(k, eng.batched_count_async(index, ch, shards))
                 for k, ch in enumerate(children) if slots[k] is None]
        self.stats.count("Count", len(calls), tags=[f"index:{index}"])
        return _QueryFuture(self, index, query, shards, opt, slots, items)

    def memo_counts(self, index: str, query: str):
        """The counts of ``query`` when EVERY top-level Count hits the
        engine's result memo over the index's full shard set, else None
        (the caller runs the deferred path).  A repeat dashboard query is
        answered with a parse-cache hit and memo lookups, nothing else.
        Correct as the batcher's memo lane is: the key carries the version
        token of every view the tree reads."""
        eng = self.engine
        if (eng is None or self.cluster is not None or self.translator is not None
                or eng._peerless_multiproc):
            return None
        try:
            q = self._parse_cached(query)
            calls = q.calls
            if not calls or any(c.name != "Count" or len(c.children) != 1 for c in calls):
                return None
            shards = self._default_shards(index) or [0]
            out = []
            for c in calls:
                key = eng._memo_key(index, c.children[0], shards)
                if key is None:
                    return None
                v = eng.result_memo.get(key)
                if v is None:
                    return None
                out.append(int(v))
        except Exception:  # noqa: BLE001 — any surprise: the full path decides
            return None
        return out

    def _default_shards(self, index: str) -> List[int]:
        """The index's available-shard list, cached against (shard epoch,
        the fields' remote-availability versions, the field count): a
        fragment created or removed moves the epoch, a remote-availability
        change moves a field's ``avail_version`` (executor.py:786-806)."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        token = (
            self.holder.shard_epoch(index),
            sum(f.avail_version for f in idx.fields.values()),
            len(idx.fields),
        )
        cached = self._default.get(index)
        if cached is not None and cached[0] == token:
            return cached[1]
        shards = [int(s) for s in idx.available_shards()]
        self._default[index] = (token, shards)
        return shards

    # -- dispatch (executor.go executeCall :245-295) -----------------------

    def _execute_call(self, index: str, c: Call, shards, opt: ExecOptions):
        t0 = time.monotonic()
        try:
            return self._dispatch_call(index, c, shards, opt)
        finally:
            # The per-op plan entry of the host-lane and aggregate ops;
            # Count's record comes from the engine/batcher with the
            # dispatch's detail.
            p = plans_mod.current_plan()
            if p is not None and c.name not in ("Count", "Explain"):
                p.note_op(op=c.name, seconds=round(time.monotonic() - t0, 6))

    def _dispatch_call(self, index: str, c: Call, shards, opt: ExecOptions):
        ids = c.args.get("ids")
        if ids is not None and not isinstance(ids, list):
            raise Error("ids must be a list")
        name = c.name
        # Writes are refused while the cluster resizes (api.go validate
        # :93): a write accepted mid-resize could land on a fragment already
        # copied to its new owner and vanish when the old copy is cleaned.
        # Reads route on the pre-resize topology until the job completes.
        if (name in _WRITE_CALLS and self.cluster is not None
                and self.cluster.state == "RESIZING"):
            raise Error("cluster is resizing: writes are rejected")
        self.stats.count(name, 1, tags=[f"index:{index}"])
        if name == "Count":
            return self._execute_count(index, c, shards, opt)
        if name == "Set":
            return self._execute_set(index, c, opt)
        if name == "Clear":
            return self._execute_clear_bit(index, c, opt)
        if name == "TopN":
            return self._execute_topn(index, c, shards, opt)
        if name == "Sum":
            return self._execute_sum(index, c, shards, opt)
        if name in ("Min", "Max"):
            return self._execute_min_max(index, c, shards, opt, name == "Min")
        if name == "ClearRow":
            return self._execute_clear_row(index, c, shards, opt)
        if name == "Store":
            return self._execute_set_row(index, c, shards, opt)
        if name == "Rows":
            return self._execute_rows(index, c, shards, opt)
        if name == "GroupBy":
            return self._execute_group_by(index, c, shards, opt)
        if name == "SetRowAttrs":
            self._execute_set_row_attrs(index, c, opt)
            return None
        if name == "SetColumnAttrs":
            self._execute_set_column_attrs(index, c, opt)
            return None
        if name == "Options":
            return self._execute_options_call(index, c, shards, opt)
        if name == "Explain":
            return self._execute_explain(index, c, shards, opt)
        return self._execute_bitmap_call(index, c, shards, opt)

    @staticmethod
    def _field_arg(c: Call) -> str:
        try:
            return c.field_arg()
        except ValueError:
            raise Error(f"{c.name}() argument required: field") from None

    def _field(self, index: str, field_name: str):
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(field_name)
        return f

    # -- map/reduce over shards (executor.go mapReduce :2183) --------------

    def map_reduce(self, index, shards, call, opt, map_fn, reduce_fn):
        """Per-shard map + reduce (executor.go mapReduce :2183-2321).

        Single-node (or remote re-entry): every shard maps locally.  With
        a cluster, shards group by owning node; remote groups execute the
        serialized call on their peer in one RPC (remoteExec :2142) and
        the partial merges into the same reduce.  A failed peer's shards
        retry on the next replica (executor.go :2216-2231)."""
        if self.cluster is None or opt.remote:
            result = None
            for shard in shards:
                result = reduce_fn(result, map_fn(shard))
            return result
        # Hedge budget shared across the whole fan-out (including
        # recursion after peer failures): a query may re-route its shards
        # past at most replica_n extra peers before erroring — so replica
        # hedging is bounded and can never retry-storm a flapping
        # cluster.  One failed peer consumes one unit regardless of how
        # many shards re-route.
        budget = {"left": max(2, self.cluster.replica_n)}
        return self._mapper(
            index, shards, call, opt, map_fn, reduce_fn, set(), budget
        )

    def _read_route(self, index, shard, owners, call, opt, hinted=None):
        """Pick this shard's execution target among its owners
        (docs/durability.md "Replica reads").  Local ownership always
        wins (zero-hop).  Writes pin to strict replica order — their
        replication fan-out handles owner death explicitly.  For reads,
        DOWN owners are deprioritized (a dead primary must not eat a
        round-trip per query before the hedge kicks in) and the
        configured mode picks among the live ones:

          primary — first live owner in replica order (reference
                    behavior + proactive DOWN skip)
          any     — deterministic per-shard rotation across live owners
                    (replicaN>1 scales reads, not just failover)
          bounded — the ``any`` rotation filtered by the freshness bound
                    (cluster.replica_fresh); no fresh replica -> first
                    live owner."""
        cluster = self.cluster
        me = cluster.node.id
        local = next((n for n in owners if n.id == me), None)
        is_write = call is not None and call.name in _WRITE_CALLS
        if local is not None and not is_write:
            return local  # reads: local ownership always wins (zero-hop)
        alive = [n for n in owners if n.state != "DOWN"]
        if not alive:
            if is_write:
                # No replica can make the ack durable: the same loud
                # failure as _write_replicated — a write must never
                # take the last-resort READ path below (it would count
                # as a read, bypass the destructive gate, and be
                # forwarded to a node the detector says is dead).
                # Unwind earlier shards' hints like every sibling
                # raise: the write fails un-acked.
                self._discard_hinted(hinted)
                raise Error(
                    f"write unavailable: every owner of shard {shard} "
                    f"is DOWN ({', '.join(n.id for n in owners)})"
                )
            # All owners DOWN: the last resort keeps replica order —
            # counted, journaled, and stamped onto the plan so the
            # /debug/plans analyzer can say WHY this read went to a
            # node the failure detector distrusts.
            REGISTRY.inc(METRIC_REPLICA_READS, route="last_resort")
            cluster.journal.append(
                "replica.last_resort", index=index, shard=shard,
                owners=[n.id for n in owners],
            )
            p = plans_mod.current_plan()
            if p is not None:
                p.note_op(
                    op=call.name if call is not None else "read",
                    last_resort=True, shard=shard,
                )
            return owners[0]
        if is_write:
            # The DOWN-owner check runs even when this node owns the
            # shard locally: a write applied here while a CO-owner is
            # DOWN still needs that co-owner's miss queued (or, for
            # destructive calls without a queue, the loud failure) —
            # the pre-hint local-win fast path silently skipped it.
            if call.name in _DESTRUCTIVE_CALLS and len(alive) < len(owners):
                # Hinted handoff (docs/durability.md): the miss queues
                # durably for replay on recovery instead of failing the
                # write — the recovered owner receives the clear BEFORE
                # anti-entropy can merge against it.  Only when the
                # queue cannot absorb it (no manager / overflow /
                # expiry) does this fall back to the pre-hint loud failure.
                down = [n for n in owners if n.state == "DOWN"]
                h = self._hint_down_writes(
                    index, shard, down, call, shards=[shard],
                    dedup=hinted, all_or_nothing=True,
                )
                if h < len(down):
                    # The whole call fails un-acked: earlier shards'
                    # hints (routing runs before ANY shard maps, so
                    # nothing has applied) are phantoms — unwind them.
                    self._discard_hinted(hinted)
                    raise Error(
                        f"{call.name} unavailable: an owner of shard "
                        f"{shard} is DOWN, the hint queue could not "
                        "absorb the miss, and a degraded bit-removing "
                        "write would be reverted by anti-entropy on "
                        "its recovery"
                    )
            return local if local is not None else alive[0]
        mode = (opt.replica_read or cluster.replica_read) if opt else (
            cluster.replica_read
        )
        if mode == "any" and len(alive) > 1:
            return alive[shard % len(alive)]
        if mode == "bounded" and len(alive) > 1:
            bound = (
                opt.freshness_ms
                if opt is not None and opt.freshness_ms is not None
                else cluster.freshness_ms
            )
            k = shard % len(alive)
            for n in alive[k:] + alive[:k]:
                if cluster.replica_fresh(n.id, index, bound):
                    return n
        return alive[0]

    def _mapper(
        self, index, shards, call, opt, map_fn, reduce_fn, down_ids, budget
    ):
        by_node = {}
        for s, placed in zip(shards, self.cluster.owners_of(index, shards)):
            owners = [n for n in placed if n.id not in down_ids]
            if not owners:
                if call is not None and call.name in _WRITE_CALLS:
                    # Same unwind as the sibling raise paths: the
                    # write fails un-acked, so hints queued by earlier
                    # routing/transport handling must not replay.
                    self._discard_hinted(budget.get("hinted"))
                raise Error(f"no available node for shard {s}")
            # The hinted-dedup set rides the shared budget dict: a
            # hedge recursion re-routes shards through _read_route
            # again, and a (node, shard) miss already queued must not
            # be double-queued as a second hint.
            target = self._read_route(
                index, s, owners, call, opt,
                hinted=budget.setdefault("hinted", {}),
            )
            # [target, shards, every-shard-routed-to-its-primary?] —
            # the primary verdict is recorded HERE, where the owners
            # list is already in hand, so the metric label below never
            # recomputes placement.
            entry = by_node.setdefault(target.id, [target, [], True])
            entry[1].append(s)
            entry[2] = entry[2] and owners[0].id == target.id

        result = None
        me = self.cluster.node.id
        # Encode once: the remote fan-out ships the SAME query text to
        # every peer, and str(call) re-serializes the whole tree — O(tree)
        # per node adds up on wide clusters.
        call_text = str(call)
        for node_id, (node, node_shards, is_primary) in sorted(
            by_node.items()
        ):
            if node_id == me:
                for shard in node_shards:
                    result = reduce_fn(result, map_fn(shard))
                continue
            REGISTRY.inc(
                METRIC_REPLICA_READS,
                route="hedge" if down_ids else (
                    "primary" if is_primary else "replica"
                ),
            )
            try:
                self.remote_fanouts += 1
                t_rpc = time.monotonic()
                doc = self.cluster.client(node).query(
                    index, call_text, shards=node_shards, remote=True
                )
                p = plans_mod.current_plan()
                if p is not None:
                    # Per-node fan-out latency attribution: the plan's
                    # "which peer was slow" record.
                    p.note_fanout(
                        node_id, time.monotonic() - t_rpc, len(node_shards)
                    )
            except Exception as e:
                # Classify before hedging.  An HTTP ERROR RESPONSE
                # proves the peer's serving plane is up: a 4xx (except
                # 429) is a deterministic request error every replica
                # would repeat — re-raise, don't hide it behind a
                # hedge; a 429/5xx shed hedges to another replica but
                # must NOT mark the node DOWN (one shed from a loaded
                # peer would otherwise exile it — degraded writes,
                # quarantine, holddown — for RECOVERY_HOLDDOWN per
                # occurrence).  404 also hedges without a verdict: a
                # schema-lagged peer may not know the index yet while
                # its replica does.  Only a TRANSPORT failure (no
                # status: refused/reset/timeout) is a failure verdict.
                code = getattr(e, "code", None)
                if (
                    code is not None
                    and 400 <= code < 500
                    and code not in (404, 429)
                ):
                    raise
                if code is None:
                    self.cluster.node_failed(node_id)
                    if call is not None and call.name in _WRITE_CALLS:
                        # A write whose forward died in transport: the
                        # peer may have missed it entirely, and the
                        # recursion below re-routes these shards to
                        # another replica — so the miss must be queued
                        # as a hint NOW (replayed idempotently on
                        # recovery) or a destructive call would leave
                        # the failed owner holding bits anti-entropy
                        # will resurrect.  Unabsorbable destructive
                        # misses fail loudly: the client never got an
                        # ack, so nothing acked can be lost.
                        failed = self.cluster.node_by_id(node_id)
                        dedup = budget.setdefault("hinted", {})
                        h = 0
                        if failed is not None:
                            for s in node_shards:
                                h += self._hint_down_writes(
                                    index, s, [failed], call,
                                    shards=[s], dedup=dedup,
                                    all_or_nothing=(
                                        call.name in _DESTRUCTIVE_CALLS
                                    ),
                                )
                        if (
                            call.name in _DESTRUCTIVE_CALLS
                            and h < len(node_shards)
                        ):
                            # Failing the whole call: unwind every hint
                            # it queued (this group's AND earlier
                            # routing's) — the client gets an error,
                            # so none of them may replay.
                            self._discard_hinted(dedup)
                            raise Error(
                                f"{call.name} unavailable: the forward "
                                f"to {node_id} failed in transport and "
                                "the hint queue could not absorb the "
                                "miss — a partial bit-removing write "
                                "would be reverted by anti-entropy on "
                                "its recovery"
                            ) from e
                budget["left"] -= 1
                if budget["left"] < 0:
                    if call is not None and call.name in _WRITE_CALLS:
                        # Same unwind as the destructive gate: the
                        # write is failing un-acked.
                        self._discard_hinted(budget.get("hinted"))
                    raise Error(
                        f"replica hedge budget exhausted at node "
                        f"{node_id}: {e}"
                    ) from e
                sub = self._mapper(
                    index,
                    node_shards,
                    call,
                    opt,
                    map_fn,
                    reduce_fn,
                    down_ids | {node_id},
                    budget,
                )
                if sub is not None:
                    result = reduce_fn(result, sub)
                continue
            from ..net.wire import result_from_json

            v = result_from_json(call.name, doc["results"][0], device=self.holder.device)
            result = reduce_fn(result, v)
        return result

    def _local_shards(self, index, shards, remote: bool = False):
        """The locally-owned subset of ``shards`` (all of them when there
        is no cluster).  ``remote=True`` — a peer re-entry — returns ALL
        requested shards: the initiator already routed them here, and
        re-filtering against this node's possibly NEWER topology (a
        resize admitting a node mid-query) would wrongly drop shards the
        old placement assigned to us (executor.go mapper: Remote=true
        executes the given shards verbatim)."""
        if self.cluster is None or remote:
            return list(shards)
        me = self.cluster.node.id
        return [s for s, owners in zip(shards, self.cluster.owners_of(index, shards))
                if any(n.id == me for n in owners)]

    # -- host bitmap lane --------------------------------------------------

    def _execute_bitmap_call(self, index, c: Call, shards, opt: ExecOptions) -> Row:
        def reduce_fn(prev, v):
            if prev is None:
                prev = Row()
            prev.merge(v)
            return prev

        row = self._mesh_bitmap_row(index, c, shards, opt)
        if row is None:
            row = self.map_reduce(index, shards, c, opt,
                                  lambda shard: self._execute_bitmap_call_shard(index, c, shard),
                                  reduce_fn)
        if row is None:
            row = Row()
        # A Row() result carries its row's attributes (executor.go:491-530).
        if c.name == "Row":
            if opt.exclude_row_attrs:
                row.attrs = {}
            else:
                field_name = self._field_arg(c)
                fld = self.holder.index(index).field(field_name)
                row_id, ok = c.uint_arg(field_name)
                if fld is not None and ok:
                    row.attrs = fld.row_attr_store.attrs(row_id)
        if opt.exclude_columns:
            row.segments = {}
        return row

    def _execute_bitmap_call_shard(self, index, c: Call, shard: int) -> Row:
        name = c.name
        if name == "Row":
            return self._execute_row_shard(index, c, shard)
        if name == "Difference":
            return self._execute_nary_shard(index, c, shard, "difference")
        if name == "Intersect":
            return self._execute_nary_shard(index, c, shard, "intersect")
        if name == "Union":
            return self._execute_nary_shard(index, c, shard, "union", empty_ok=True)
        if name == "Xor":
            return self._execute_nary_shard(index, c, shard, "xor", empty_ok=True)
        if name == "Not":
            return self._execute_not_shard(index, c, shard)
        if name == "Range":
            return self._execute_range_shard(index, c, shard)
        raise Error(f"unknown call: {name}")

    def _execute_row_shard(self, index, c: Call, shard: int) -> Row:
        field_name = self._field_arg(c)
        self._field(index, field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise Error("Row() must specify a row")
        frag = self.holder.fragment(index, field_name, VIEW_STANDARD, shard)
        if frag is None:
            return Row()
        return frag.row(row_id)

    def _execute_nary_shard(self, index, c: Call, shard: int, op: str,
                            empty_ok: bool = False) -> Row:
        if not c.children and not empty_ok:
            raise Error(f"empty {c.name} query is currently not supported")
        other = Row()
        for i, child in enumerate(c.children):
            row = self._execute_bitmap_call_shard(index, child, shard)
            other = row if i == 0 else getattr(other, op)(row)
        return other

    def _execute_not_shard(self, index, c: Call, shard: int) -> Row:
        if len(c.children) != 1:
            raise Error("Not() requires a single input row")
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        if idx.existence_field() is None:
            raise Error(f"index does not support existence tracking: {index}")
        frag = self.holder.fragment(index, EXISTENCE_FIELD_NAME, VIEW_STANDARD, shard)
        existence = frag.row(0) if frag is not None else Row()
        return existence.difference(
            self._execute_bitmap_call_shard(index, c.children[0], shard)
        )

    # -- Count -------------------------------------------------------------

    def _execute_count(self, index, c: Call, shards, opt: ExecOptions) -> int:
        if len(c.children) != 1:
            raise Error("Count() requires a single bitmap input")
        child = c.children[0]
        fast = self._count_from_cardinalities(index, child, shards, opt.remote)
        if fast is not None:
            return fast
        fused = self._mesh_count(index, child, shards, opt)

        def map_fn(shard):
            return self._execute_bitmap_call_shard(index, child, shard).count()

        if fused is not None:
            # This node's shards counted on the card; a peer's shards go to
            # the peer.  A resize between the two can route a "remote" shard
            # back here: the host lane then serves it, exactly.
            local_shards, count = fused
            remote = [s for s in shards if s not in local_shards]
            if not remote:
                return count
            p = plans_mod.current_plan()
            if p is not None:
                p.note_op(op="Count", path="fanout_split", local_shards=len(local_shards),
                          remote_shards=len(remote))
            return count + (self.map_reduce(index, remote, c, opt, map_fn,
                                            lambda a, v: (a or 0) + v) or 0)
        local = set(self._local_shards(index, shards, opt.remote))
        n_local = sum(1 for s in shards if s in local)
        if self.engine is not None and n_local:
            self.host_fallbacks += 1
        p = plans_mod.current_plan()
        if p is not None:
            # No fused dispatch: the host lane serves this node's shards.
            n_remote = len(shards) - n_local
            p.note_op(op="Count", path="fanout" if n_remote else "host",
                      local_shards=n_local, remote_shards=n_remote)
        return self.map_reduce(index, shards, c, opt, map_fn, lambda a, v: (a or 0) + v) or 0

    def _count_from_cardinalities(self, index, child: Call, shards, remote: bool = False):
        """O(1)-per-shard Count of an unfiltered Row: sum the maintained
        per-row cardinalities with zero device work (the analogue of
        summing roaring container ``n`` fields).  None for anything else,
        and in a cluster for any shard this node does not own."""
        if child.name != "Row" or child.children or len(child.args) != 1:
            return None
        (field_name, row_val), = child.args.items()
        if isinstance(row_val, bool) or not isinstance(row_val, int):
            return None
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx is not None else None
        if f is None or f.options.type == FIELD_TYPE_INT:
            return None
        if self.cluster is not None:
            local = set(self._local_shards(index, shards, remote))
            if any(s not in local for s in shards):
                return None
        view = f.view(VIEW_STANDARD)
        p = plans_mod.current_plan()
        if p is not None:
            # This lane answers: a host-side cardinality sum, no device work.
            p.note_op(op="Count", path="fast_cardinality")
        if view is None:
            return 0
        frags = view.fragments
        total = 0
        for s in shards:
            frag = frags.get(s)
            if frag is not None:
                total += frag.row_count(row_val)
        return total

    def _mesh_count_many(self, index, calls, shards, opt: ExecOptions):
        """A run of consecutive Count() calls as ONE batched dispatch
        (``TorchEngine.count_many``); O(1)-lane answers are peeled off
        first.  The counts in call order, or None to run the calls one by
        one (a tree with no device lowering, a peer's replay, or a shard
        this node does not own)."""
        if opt.remote:
            return None
        children = []
        for c in calls:
            if len(c.children) != 1 or not self.engine.lowerable(c.children[0]):
                return None
            children.append(c.children[0])
        if self.cluster is not None:
            local = set(self._local_shards(index, shards))
            if any(s not in local for s in shards):
                return None  # remote shards: the per-call path splits them
        results: list = [None] * len(children)
        rem_idx, rem_calls = [], []
        plan = plans_mod.current_plan()
        # Where the plan's ops stood before the O(1) peel: on a decline the
        # calls run one by one and stamp their own ops, so the peel's
        # stamps are unwound (nothing else appends on this thread meanwhile).
        ops_mark = len(plan.ops) if plan is not None else 0
        for k, ch in enumerate(children):
            fast = self._count_from_cardinalities(index, ch, shards)
            if fast is not None:
                results[k] = fast
            else:
                rem_idx.append(k)
                rem_calls.append(ch)
        if rem_calls:
            t0 = time.monotonic()
            try:
                try:
                    counts = self.engine.count_many(index, rem_calls,
                                                    [list(shards)] * len(rem_calls))
                finally:
                    # Claim the note on every exit: a half-written one would
                    # merge into the next query's record on this thread.
                    note = plans_mod.take_dispatch_note()
            except HostFallback:
                if plan is not None:
                    del plan.ops[ops_mark:]
                return None
            # The batch ran on THIS thread: the note once per call, and the
            # blocking launch and readback as the query's "execute" stage.
            elapsed = time.monotonic() - t0
            if plan is not None and note is not None:
                d = plans_mod.rider_note(note, len(rem_calls))
                for _ in rem_calls:
                    plan.note_op(**d)
                plan.note_stage("execute", elapsed)
                plan.note_device_seconds(elapsed)
            for k, v in zip(rem_idx, counts):
                results[k] = v
        self.stats.count("Count", len(calls), tags=[f"index:{index}"])
        return results

    def _mesh_count(self, index, child: Call, shards, opt: ExecOptions):
        """Fused Count of this node's shards through the engine's batcher:
        (local shard set, count), or None when there is no engine, no local
        shard or the tree has no device lowering.  A lone caller runs the
        count directly (``CountBatcher.submit``, then ``_direct``: no added
        latency); a caller arriving while a batch is in flight, or within
        the hot window after one, queues and is answered by the next K5
        launch."""
        if self.engine is None:
            return None
        local = self._local_shards(index, shards, opt.remote)
        if not local:
            return None
        try:
            return set(local), self.engine.batched_count(index, child, list(local))
        except HostFallback:
            return None

    def _execute_explain(self, index, c: Call, shards, opt: ExecOptions) -> dict:
        """``Explain(<query>)``: plan WITHOUT dispatching
        (pilosa_tpu/executor/executor.py:1531-1568).  Reports the path a
        real execution would take (the O(1) lane's eligibility, the memo,
        occupancy-guided sparse against dense, or the host lane), touching
        neither the card nor the memo's contents."""
        if len(c.children) != 1:
            raise Error("Explain() requires a single query input")
        child = c.children[0]
        doc: dict = {"dryRun": True, "query": str(child)}
        target = child
        if child.name == "Count" and len(child.children) == 1:
            target = child.children[0]
            inner = target
            arg = next(iter(inner.args.values()), None)
            doc["fastCardinalityEligible"] = bool(
                inner.name == "Row" and not inner.children and len(inner.args) == 1
                and isinstance(arg, int) and not isinstance(arg, bool))
        local = set(self._local_shards(index, shards, opt.remote))
        doc["localShards"] = sum(1 for s in shards if s in local)
        doc["remoteShards"] = len(shards) - doc["localShards"]
        if self.engine is None:
            doc.update(op=child.name, plannedPath="host", lowerable=False)
            return doc
        doc.update(self.engine.explain_count(index, target, shards))
        if doc.get("remoteShards"):
            doc["plannedPath"] = f"{doc.get('plannedPath', 'dense')}+fanout"
        return doc

    # -- Range (executor.go :1233-1440) ------------------------------------

    def _execute_range_shard(self, index, c: Call, shard: int) -> Row:
        if c.has_condition_arg():
            return self._execute_bsi_range_shard(index, c, shard)
        field_name = self._field_arg(c)
        f = self._field(index, field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise Error("Range() must specify a row")
        start_str = c.args.get("_start")
        end_str = c.args.get("_end")
        if not isinstance(start_str, str):
            raise Error("Range() start time required")
        if not isinstance(end_str, str):
            raise Error("Range() end time required")
        try:
            start = dt.datetime.strptime(start_str, TIME_FORMAT)
            end = dt.datetime.strptime(end_str, TIME_FORMAT)
        except ValueError:
            raise Error("cannot parse Range() time") from None
        q = f.time_quantum()
        if not q:
            return Row()
        row = Row()
        for view_name in timequantum.views_by_time_range(VIEW_STANDARD, start, end, q):
            frag = self.holder.fragment(index, field_name, view_name, shard)
            if frag is not None:
                row = row.union(frag.row(row_id))
        return row

    def _execute_bsi_range_shard(self, index, c: Call, shard: int) -> Row:
        """A BSI condition on one shard's planes (``ops/bsi.py`` over the
        fragment's device mirror), with the reference's special cases."""
        if len(c.args) == 0:
            raise Error("Range(): condition required")
        if len(c.args) > 1:
            raise Error("Range(): too many arguments")
        (field_name, cond), = c.args.items()
        if not isinstance(cond, Condition):
            raise Error(f"Range(): {field_name}: expected condition argument")
        bsig = self._field(index, field_name).bsi_group(field_name)
        if bsig is None:
            raise Error(f"field not found: {field_name}")
        frag = self.holder.fragment(index, field_name, view_bsi_name(field_name), shard)
        if frag is None:
            return Row()
        depth = bsig.bit_depth()
        planes = frag.device_planes(depth)

        def wrap(words):
            return Row({shard: words})

        if cond.op == NEQ and cond.value is None:  # `!= null` (executor.go:1355-1369)
            return wrap(bsi_ops.not_null(planes))
        if cond.op == BETWEEN:
            predicates = cond.int_slice_value()
            if len(predicates) != 2:
                raise Error("Range(): BETWEEN condition requires exactly two integer values")
            lo, hi, out_of_range = bsig.base_value_between(*predicates)
            if out_of_range:
                return Row()
            if predicates[0] <= bsig.min and predicates[1] >= bsig.max:
                return wrap(bsi_ops.not_null(planes))
            return wrap(bsi_ops.range_between(planes, bsi_ops.to_bits(lo, depth),
                                              bsi_ops.to_bits(hi, depth)))
        if not isinstance(cond.value, int) or isinstance(cond.value, bool):
            raise Error("Range(): conditions only support integer values")
        value = cond.value
        base, out_of_range = bsig.base_value(cond.op, value)
        if out_of_range and cond.op != NEQ:
            return Row()
        # Whole-range LT/GT collapse to the not-null row (executor.go:1420).
        if ((cond.op == LT and value > bsig.max) or (cond.op == LTE and value >= bsig.max)
                or (cond.op == GT and value < bsig.min) or (cond.op == GTE and value <= bsig.min)
                or (out_of_range and cond.op == NEQ)):
            return wrap(bsi_ops.not_null(planes))
        bits = bsi_ops.to_bits(base, depth)
        if cond.op == EQ:
            return wrap(bsi_ops.range_eq(planes, bits))
        if cond.op == NEQ:
            return wrap(bsi_ops.range_neq(planes, bits))
        if cond.op in (LT, LTE):
            return wrap(bsi_ops.range_lt(planes, bits, cond.op == LTE))
        if cond.op in (GT, GTE):
            return wrap(bsi_ops.range_gt(planes, bits, cond.op == GTE))
        raise Error(f"Range(): unsupported operator {cond.op}")

    # -- Sum, Min, Max (executor.go :1756-1884) ----------------------------

    def _bsi_shard_ctx(self, index, c: Call, shard: int):
        """(fragment, bsig, filter words) of one shard for the host lane's
        Sum/Min/Max, or None when the shard has nothing to read."""
        field_name = c.args.get("field")
        if not field_name:
            raise Error(f"{c.name}(): field required")
        if len(c.children) > 1:
            raise Error(f"{c.name}() only accepts a single bitmap input")
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx is not None else None
        bsig = f.bsi_group(field_name) if f is not None else None
        if bsig is None:
            return None
        frag = self.holder.fragment(index, field_name, view_bsi_name(field_name), shard)
        if frag is None:
            return None
        if c.children:
            seg = self._execute_bitmap_call_shard(index, c.children[0], shard).segment(shard)
            words = bitops.empty_row(frag.device) if seg is None else seg.to(frag.device)
        else:
            words = bitops.full_row(frag.device)
        return frag, bsig, words

    def _bsi_host_lane(self, index, c: Call, shards, opt: ExecOptions, map_fn,
                       reduce_fn) -> ValCount:
        local = set(self._local_shards(index, shards, opt.remote))
        if self.engine is not None and any(s in local for s in shards):
            self.host_fallbacks += 1

        def shard_fn(shard):
            ctx = self._bsi_shard_ctx(index, c, shard)
            return ValCount() if ctx is None else map_fn(*ctx)

        result = self.map_reduce(index, shards, c, opt, shard_fn,
                                 lambda a, v: reduce_fn(a or ValCount(), v)) or ValCount()
        return ValCount() if result.count == 0 else result

    def _execute_sum(self, index, c: Call, shards, opt: ExecOptions) -> ValCount:
        fused = self._mesh_sum(index, c, shards, opt)
        if fused is not None:
            local_shards, vc = fused
            remote = [s for s in shards if s not in local_shards]
            if remote:
                vc = vc.add(self._execute_sum(index, c, remote, opt))
            return ValCount() if vc.count == 0 else vc

        def map_fn(frag, bsig, filt):
            depth = bsig.bit_depth()
            counts, n = bsi_ops.sum_counts(frag.device_planes(depth), filt)
            counts = counts.tolist()
            n = int(n)
            return ValCount(sum(int(counts[i]) << i for i in range(depth)) + n * bsig.min, n)

        return self._bsi_host_lane(index, c, shards, opt, map_fn, ValCount.add)

    def _bsi_flight(self, kind, index, c: Call, shards, run):
        """Run ``run(field_name, filter_call)`` of a fused Sum/Min/Max as one
        flight per (call, shards, write sequence), or None for the host
        lane: no engine, a missing field argument or several inputs (the
        host lane raises), or a filter the engine declines."""
        if self.engine is None or not shards:
            return None
        field_name = c.args.get("field")
        if not field_name or len(c.children) > 1:
            return None
        # The write sequence before any derived state: a caller whose own
        # write completed never joins a flight computed before it.
        seq = frag_mod.WRITE_SEQ.v
        filter_call = c.children[0] if c.children else None
        try:
            return self._sflight.do((kind, seq, index, str(c), tuple(shards)),
                                    lambda: run(field_name, filter_call))
        except HostFallback:
            return None

    def _mesh_sum(self, index, c: Call, shards, opt: ExecOptions):
        """Fused BSI Sum of this node's shards through the engine's batch
        lane (one K6 launch for a lone caller; concurrent callers fuse with
        their drain-mates): (local shard set, ValCount), or None."""
        local = self._local_shards(index, shards, opt.remote)
        if not local:
            return None
        res = self._bsi_flight(
            "sum", index, c, local,
            lambda fld, filt: self.engine.batched_sum(index, fld, filt, list(local)))
        return None if res is None else (set(local), ValCount(*res))

    def _execute_min_max(self, index, c: Call, shards, opt: ExecOptions,
                         is_min: bool) -> ValCount:
        fused = self._mesh_min_max(index, c, shards, opt, is_min)
        if fused is not None:
            local_shards, vc = fused
            remote = [s for s in shards if s not in local_shards]
            if remote:
                rest = self._execute_min_max(index, c, remote, opt, is_min)
                vc = vc.smaller(rest) if is_min else vc.larger(rest)
            return ValCount() if vc.count == 0 else vc

        def map_fn(frag, bsig, filt):
            planes = frag.device_planes(bsig.bit_depth())
            val, n = (bsi_ops.min_valcount if is_min else bsi_ops.max_valcount)(planes, filt)
            n = int(n)
            return ValCount() if n == 0 else ValCount(int(val) + bsig.min, n)

        return self._bsi_host_lane(index, c, shards, opt, map_fn,
                                   ValCount.smaller if is_min else ValCount.larger)

    def _mesh_min_max(self, index, c: Call, shards, opt: ExecOptions, is_min: bool):
        """Fused BSI Min/Max of this node's shards through the engine's
        batch lane (one K7 launch for a lone caller): (local shard set,
        ValCount), or None."""
        local = self._local_shards(index, shards, opt.remote)
        if not local:
            return None
        res = self._bsi_flight(
            ("minmax", is_min), index, c, local,
            lambda fld, filt: self.engine.batched_min_max(index, fld, filt, list(local),
                                                          is_min))
        return None if res is None else (set(local), ValCount(*res))

    # -- TopN (executor.go :694-828) ---------------------------------------

    @staticmethod
    def _topn_args(c: Call):
        """(field, n, ids, min_threshold, attr_name, attr_values,
        tanimoto) of a TopN call, with the reference's defaults and
        checks."""
        field_name = c.args.get("_field") or DEFAULT_FIELD
        n, _ = c.uint_arg("n")
        row_ids, _ = c.uint_slice_arg("ids")
        min_threshold, _ = c.uint_arg("threshold")
        if min_threshold <= 0:
            min_threshold = DEFAULT_MIN_THRESHOLD
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            raise Error("Tanimoto Threshold is from 1 to 100 only")
        return (field_name, n, row_ids, min_threshold, c.args.get("attrName", ""),
                c.args.get("attrValues"), tanimoto)

    def _execute_topn(self, index, c: Call, shards, opt: ExecOptions):
        ids_arg, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")

        fused = self._mesh_topn_full(index, c, shards, opt)
        if fused is not None:
            return fused

        pairs = self._execute_topn_shards(index, c, shards, opt)
        # A peer's replay returns its untrimmed pairs for the coordinator's
        # merge and recount.
        if not pairs or ids_arg or opt.remote:
            return pairs

        # Phase 2: refetch exact counts for the merged candidate ids
        # (executor.go :715-733).
        other = c.clone()
        other.args["ids"] = sorted(r for r, _ in pairs)
        trimmed = self._execute_topn_shards(index, other, shards, opt)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return trimmed

    def _mesh_topn_full(self, index, c: Call, shards, opt: ExecOptions):
        """Single-dispatch TopN: both reference phases and the trim
        collapse into one K3 launch, with one small readback.  None when there
        is no engine, an attribute or Tanimoto filter needs the host walk,
        the candidate union is past MAX_TOPN_CANDIDATES, the src tree
        has no device lowering, a shard is a peer's, or the call is a peer's
        replay (it returns untrimmed pairs); the two-phase path then runs."""
        if self.engine is None or opt.remote:
            return None
        if c.args.get("attrName") or c.args.get("attrValues"):
            return None
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 0:
            return None
        if len(c.children) > 1:
            raise Error("TopN() can only have one input bitmap")
        if self.cluster is not None:
            local = set(self._local_shards(index, shards))
            if any(s not in local for s in shards):
                return None
        field_name, n, row_ids, min_threshold, _, _, _ = self._topn_args(c)
        if not c.children:
            # Cache-only TopN rides the versioned result memo: a probe miss
            # first tries the repair layer (a count table kept from write
            # deltas, re-ranked on serve), and only then recomputes.
            eng = self.engine
            key = None
            probe = getattr(eng, "memo_probe_topn", None)
            if probe is not None:
                key, hit = probe(index, field_name, shards, n, min_threshold,
                                 row_ids or None)
                if hit is not None:
                    p = plans_mod.current_plan()
                    if p is not None:
                        p.note_op(op="TopN", path="memo", memo="hit")
                    return [tuple(pr) for pr in hit]
            try:
                out = eng.topn_cache_only(
                    index, field_name, shards, n, min_threshold, row_ids or None
                )
            except HostFallback:
                # A direct engine call: claim its note before the fallback.
                plans_mod.take_dispatch_note()
                return None
            if key is not None and out is not None:
                eng.memo_store_topn(key, field_name, n, min_threshold,
                                    row_ids or None, out)
            return out
        # The write sequence before any derived state: a caller whose own
        # write completed never joins a flight computed before it.
        seq = frag_mod.WRITE_SEQ.v
        try:
            out = self._sflight.do(
                ("topn", seq, index, str(c), tuple(sorted(shards))),
                lambda: self.engine.batched_topn_full(
                    index, field_name, c.children[0], shards, n, min_threshold,
                    row_ids or None,
                ),
            )
        except HostFallback:
            return None
        # A copy: the flight's waiters share one list.
        return list(out) if isinstance(out, list) else out

    def _execute_topn_shards(self, index, c: Call, shards, opt: ExecOptions):
        def map_fn(shard):
            return self._execute_topn_shard(index, c, shard)

        def reduce_fn(prev, v):
            return cache_mod.merge_pairs([prev or [], v])

        fused = self._mesh_topn_shards(index, c, shards, opt)
        if fused is not None:
            local_shards, pairs = fused
            remote = [s for s in shards if s not in local_shards]
            if remote:
                rpairs = self.map_reduce(index, remote, c, opt, map_fn, reduce_fn) or []
                pairs = cache_mod.merge_pairs([pairs, rpairs])
        else:
            pairs = self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or []
        pairs.sort(key=cache_mod.pair_sort_key)
        return pairs

    def _mesh_topn_shards(self, index, c: Call, shards, opt: ExecOptions):
        """TopN phase 1 over this node's shards: (local shard set, merged
        pairs), or None to run the per-shard host lane.  A peer's shards
        go to the peer (``_execute_topn_shards``).

        First the slab lane (``TorchEngine.topn_device_full``, K9): each
        shard's gated candidate walk and top-k on the card, a fixed-width
        slab a shard, so the host merges at most k_out pairs a shard.  It
        serves a cluster's peers and the coordinator's own shards once one
        shard is remote.  It declines (None) with ``ids``, an attribute or
        Tanimoto filter or n = 0, and in the engine past MAX_TOPN_CANDIDATES
        candidates, when a shard's qualifiers overflow its slab, or on the
        engine's HostFallback (each counted there); then
        the per-candidate src counts of every shard in one K3 launch
        (``TorchEngine.batched_topn_scores``) and the reference's
        per-shard heap walk on the host over the precomputed scores."""
        if self.engine is None or len(c.children) != 1:
            return None
        shards = self._local_shards(index, shards, opt.remote)
        if not shards:
            return None
        (field_name, n, row_ids, min_threshold, attr_name, attr_values,
         tanimoto) = self._topn_args(c)
        if (not row_ids and not attr_name and not attr_values and tanimoto == 0 and n > 0
                and self.engine.topn_slab_enabled):
            # The write sequence before any derived state.
            seq = frag_mod.WRITE_SEQ.v
            out = self._sflight.do(
                ("topn_slab", seq, index, str(c), tuple(sorted(shards))),
                lambda: self.engine.topn_device_full(
                    index, field_name, c.children[0], shards, int(n), min_threshold))
            if out is not None:
                p = plans_mod.current_plan()
                if p is not None:
                    p.note_op(op="TopN", path="device_slab", topkDevice=int(n))
                # A copy: the flight's waiters share one list.
                return set(shards), list(out)
        frags = {}
        cand_set = set()
        for s in shards:
            frag = self.holder.fragment(index, field_name, VIEW_STANDARD, s)
            if frag is None:
                continue
            pairs = (
                [(r, frag.row_count(r)) for r in row_ids]
                if row_ids
                else list(frag.cache.top())
            )
            frags[s] = frag
            cand_set.update(r for r, _ in pairs)
        if not frags:
            return set(shards), []
        candidates = sorted(cand_set)
        p = plans_mod.current_plan()
        if p is not None:
            p.note_op(op="TopN", path="host_merge", candidates=len(candidates))
        try:
            scored = self.engine.batched_topn_scores(
                index, field_name, candidates, c.children[0], list(shards)
            )
        except HostFallback:
            return None
        if scored is None:
            return set(shards), []
        scores, src_counts, shard_pos = scored
        cand_pos = {r: i for i, r in enumerate(candidates)}
        all_pairs = []
        for s in shards:
            frag = frags.get(s)
            si = shard_pos.get(s)
            if frag is None or si is None:
                continue
            per_shard = {r: int(scores[si, cand_pos[r]]) for r in cand_set}
            all_pairs.append(
                frag.top(
                    n=int(n),
                    row_ids=row_ids or None,
                    min_threshold=min_threshold,
                    filter_name=attr_name,
                    filter_values=attr_values,
                    tanimoto_threshold=tanimoto,
                    src_counts=per_shard,
                    src_count_total=int(src_counts[si]),
                )
            )
        return set(shards), cache_mod.merge_pairs(all_pairs)

    def _execute_topn_shard(self, index, c: Call, shard: int):
        (field_name, n, row_ids, min_threshold, attr_name, attr_values,
         tanimoto) = self._topn_args(c)
        src = None
        if len(c.children) == 1:
            src = self._execute_bitmap_call_shard(index, c.children[0], shard)
        elif len(c.children) > 1:
            raise Error("TopN() can only have one input bitmap")
        frag = self.holder.fragment(index, field_name, VIEW_STANDARD, shard)
        if frag is None:
            return []
        return frag.top(
            n=int(n),
            src=src,
            row_ids=row_ids or None,
            min_threshold=min_threshold,
            filter_name=attr_name,
            filter_values=attr_values,
            tanimoto_threshold=tanimoto,
        )

    # -- Rows / GroupBy (executor.go :897-1170) ----------------------------

    def _execute_rows(self, index, c: Call, shards, opt: ExecOptions) -> List[int]:
        col, ok = c.uint_arg("column")
        if ok:
            shards = [col // frag_mod.SHARD_WIDTH]
        limit_arg, has_limit = c.uint_arg("limit")
        limit = limit_arg if has_limit else _MAXINT
        return self.map_reduce(
            index, shards, c, opt, lambda shard: self._execute_rows_shard(index, c, shard),
            lambda prev, v: _merge_row_ids(prev or [], v, limit)) or []

    def _execute_rows_shard(self, index, c: Call, shard: int) -> List[int]:
        field_name = c.args.get("field")
        if not isinstance(field_name, str):
            raise Error("Rows() argument required: field")
        self._field(index, field_name)
        frag = self.holder.fragment(index, field_name, VIEW_STANDARD, shard)
        if frag is None:
            return []
        previous, has_prev = c.uint_arg("previous")
        column = None
        col, ok = c.uint_arg("column")
        if ok:
            if col // frag_mod.SHARD_WIDTH != shard:
                return []
            column = col
        limit_arg, has_limit = c.uint_arg("limit")
        return frag.rows_filtered(start=previous + 1 if has_prev else 0, column=column,
                                  limit=limit_arg if has_limit else None)

    def _execute_group_by(self, index, c: Call, shards, opt: ExecOptions) -> List[GroupCount]:
        """GroupBy (executor.go :1056): the fused lane over plain
        ``Rows(field=f)`` children, else the per-shard host iterator; then
        ``offset`` and ``limit``."""
        if not c.children:
            raise Error("need at least one child call")
        limit_arg, has_limit = c.uint_arg("limit")
        limit = limit_arg if has_limit else _MAXINT
        filter_call = c.call_arg("filter")
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        child_rows: List[Optional[List[int]]] = [None] * len(c.children)
        for i, child in enumerate(c.children):
            if child.name != "Rows":
                raise Error(f"'{child.name}' is not a valid child query for GroupBy, "
                            "must be 'Rows'")
            # An unknown field is an error up front (executor.go GroupBy
            # "Unknown Field"), not a silent empty result.
            fname = child.args.get("field")
            if not isinstance(fname, str) or idx.field(fname) is None:
                raise FieldNotFoundError(str(fname))
            _, has_lim = child.uint_arg("limit")
            _, has_col = child.uint_arg("column")
            if has_lim or has_col:
                child_rows[i] = self._execute_rows(index, child, shards, opt)
                if not child_rows[i]:
                    return []

        def map_fn(shard):
            return self._execute_group_by_shard(index, c, filter_call, shard, child_rows)

        def reduce_fn(prev, v):
            return _merge_group_counts(prev or [], v, limit)

        fused = self._mesh_group_by(index, c, filter_call, shards, opt)
        if fused is not None:
            local_shards, results = fused
            remote = [s for s in shards if s not in local_shards]
            if remote:
                rres = self.map_reduce(index, remote, c, opt, map_fn, reduce_fn) or []
                results = _merge_group_counts(results, rres, limit)
        else:
            results = self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or []
        offset, has_offset = c.uint_arg("offset")
        if has_offset and offset < len(results):
            results = results[offset:]
        if has_limit and limit < len(results):
            results = results[:limit]
        return results

    def _mesh_group_by(self, index, c: Call, filter_call, shards, opt: ExecOptions):
        """Fused GroupBy of this node's shards: every group combination's
        count in one K8 launch (``TorchEngine.batched_group_counts``),
        assembled in row-major order with the reference's progressive
        ``limit`` cut; (local shard set, results).  Applies to plain
        ``Rows(field=f)`` children only.  The shaped count tensor rides the
        result memo; the assembled list never does, so a memo hit cannot
        drift from a recompute.  None sends the call to the host lane: no
        engine, no local shard, another child, more than MAX_GROUP_COMBOS
        combinations, or a filter with no device lowering."""
        eng = self.engine
        if eng is None:
            return None
        for child in c.children:
            if child.name != "Rows" or set(child.args) - {"field"}:
                return None
        shards = self._local_shards(index, shards, opt.remote)
        if not shards:
            return None
        # The write sequence before the row lists: a leader with stale row
        # sets must key as pre-write.
        seq = frag_mod.WRITE_SEQ.v
        fields = [child.args["field"] for child in c.children]
        qsig = str(c) if filter_call is None else f"{c}|flt:{filter_call}"
        key, hit = eng.memo_probe_groupby(index, qsig, fields, filter_call, shards)
        row_lists = [self._group_rows(index, f, shards) for f in fields]
        if any(not rows for rows in row_lists):
            return set(shards), []
        shape = tuple(len(rows) for rows in row_lists)
        if hit is not None and tuple(hit.shape) == shape:
            p = plans_mod.current_plan()
            if p is not None:
                p.note_op(op="GroupBy", path="memo", memo="hit")
            counts = hit
        else:
            try:
                # The row lists derive from fragment state that WRITE_SEQ
                # versions already, so they stay out of the key.
                counts = self._sflight.do(
                    ("groupby", seq, index, str(c), tuple(sorted(shards))),
                    lambda: eng.batched_group_counts(index, fields, row_lists, filter_call,
                                                     shards))
            except HostFallback:
                plans_mod.take_dispatch_note()
                self.host_fallbacks += 1
                return None
            if counts is None:
                return None
            eng.memo_store_groupby(key, fields, row_lists, filter_call, counts)
        limit_arg, has_limit = c.uint_arg("limit")
        limit = limit_arg if has_limit else _MAXINT
        counts = np.asarray(counts).reshape(shape)
        results: List[GroupCount] = []
        # np.ndindex walks the tensor in row-major order, the nested
        # iterator's order (executor.go:2726), so the limit cut matches.
        for combo in np.ndindex(shape):
            n = int(counts[combo])
            if n > 0:
                results.append(GroupCount(
                    [FieldRow(fields[d], row_lists[d][combo[d]]) for d in range(len(fields))],
                    n))
            if len(results) >= limit:
                break
        return set(shards), results

    def _group_rows(self, index, field, shards) -> List[int]:
        """The sorted union of the field's row ids over ``shards``: the
        fused lane's axis for the field.  Cached against the view's token
        (shard epoch, generation, version), which every write to the view
        moves: the union walks every shard's fragment, milliseconds at a
        thousand shards."""
        view = self.holder.view(index, field, VIEW_STANDARD)
        if view is None:
            return []
        token = (self.holder.shard_epoch(index), view.gen, view.version)
        key = (index, field, tuple(shards))
        hit = self._group_rows_cache.get(key)
        if hit is not None and hit[0] == token:
            return hit[1]
        rows = set()
        for s in shards:
            frag = view.fragments.get(s)
            if frag is not None:
                rows.update(frag.row_ids())
        rows = sorted(rows)
        if len(self._group_rows_cache) >= self._GROUP_ROWS_MAX:
            self._group_rows_cache.clear()
        self._group_rows_cache[key] = (token, rows)
        return rows

    def _execute_group_by_shard(self, index, c: Call, filter_call, shard,
                                child_rows) -> List[GroupCount]:
        filter_row = None
        if filter_call is not None:
            filter_row = self._execute_bitmap_call_shard(index, filter_call, shard)
        iterator = _GroupByIterator.create(self, child_rows, c.children, filter_row, index,
                                           shard)
        if iterator is None:
            return []
        limit_arg, has_limit = c.uint_arg("limit")
        limit = limit_arg if has_limit else _MAXINT
        results: List[GroupCount] = []
        while len(results) < limit:
            gc, done = iterator.next()
            if done:
                break
            if gc.count > 0:
                results.append(gc)
        return results

    # -- writes ------------------------------------------------------------

    def _execute_set(self, index, c: Call, opt: ExecOptions) -> bool:
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise Error("Set() column argument 'col' required")
        field_name = self._field_arg(c)
        f = self._field(index, field_name)
        ef = self.holder.index(index).existence_field()
        if ef is not None:
            ef.set_bit(0, col_id)
        if f.options.type == FIELD_TYPE_INT:
            value, ok = c.int_arg(field_name)
            if not ok:
                raise Error("Set() row argument required")
            # A BSI Set rewrites value planes: it clears bits.
            return self._write_replicated(index, c, col_id, opt,
                                          lambda: f.set_value(col_id, value),
                                          destructive=True)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise Error("Set() row argument required")
        timestamp = None
        ts = c.args.get("_timestamp")
        if isinstance(ts, str):
            try:
                timestamp = dt.datetime.strptime(ts, TIME_FORMAT)
            except ValueError:
                raise Error(f"invalid date: {ts}") from None
        if f.options.type == FIELD_TYPE_BOOL and row_id not in (0, 1):
            raise Error("bool field rows must be 0 or 1")
        # Mutex and bool sets clear the column's previous row.
        return self._write_replicated(
            index, c, col_id, opt, lambda: f.set_bit(row_id, col_id, timestamp),
            destructive=f.options.type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL))

    def _execute_clear_bit(self, index, c: Call, opt: ExecOptions) -> bool:
        field_name = self._field_arg(c)
        f = self._field(index, field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise Error("Clear() row argument required")
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise Error("Clear() col argument required")
        return self._write_replicated(index, c, col_id, opt,
                                      lambda: f.clear_bit(row_id, col_id), destructive=True)

    def _hint_down_writes(
        self, index, shard, down, call, shards=None, dedup=None,
        all_or_nothing=False,
    ):
        """Durably queue the missed write for each DOWN owner (hinted
        handoff, docs/durability.md): the hint record carries the
        serialized call, replayed with remote=True against the
        recovered owner by the HintManager's worker.  Returns how many
        of ``down`` were absorbed — the caller applies the skip-or-fail
        fallback policy to the rest.  ``dedup`` ({(node, shard): seq}
        scoped to one logical write) keeps a hedge-recursion re-route
        from double-queuing the same miss.  ``all_or_nothing`` (the
        destructive-gate contract) ROLLS BACK this call's fresh
        enqueues and returns 0 when any of ``down`` could not be
        absorbed: the caller is about to fail the write without an
        ack, and a surviving partial hint would replay an op that
        never happened onto one replica."""
        hints = getattr(self.cluster, "hints", None)
        if hints is None:
            return 0
        op = {"kind": "query", "query": str(call)}
        if shards is not None:
            op["shards"] = [int(s) for s in shards]
        n = 0
        fresh = []  # (node_id, dedup key, seq) queued by THIS call
        for node in down:
            key = (node.id, shard)
            if dedup is not None and key in dedup:
                n += 1  # already queued by an earlier route of this write
                continue
            seq = hints.enqueue(node.id, index, shard, op)
            if seq:
                n += 1
                fresh.append((node.id, key, seq))
                if dedup is not None:
                    dedup[key] = seq
        if all_or_nothing and n < len(down):
            for node_id, key, seq in fresh:
                hints.discard(node_id, [seq])
                if dedup is not None:
                    dedup.pop(key, None)
            return 0
        if n:
            self._note_hinted(index, call.name, shard, n)
        return n

    def _discard_hinted(self, dedup):
        """Unwind EVERY hint a failing logical write queued — across
        all its shards and targets (the per-call all_or_nothing rolls
        back only the current shard's batch; the write erroring at a
        LATER shard must not leave earlier shards' hints to replay an
        op the client never got an ack for)."""
        hints = getattr(self.cluster, "hints", None)
        if hints is None or not dedup:
            return
        for (node_id, _shard), seq in list(dedup.items()):
            hints.discard(node_id, [seq])
        dedup.clear()

    def _note_hinted(self, index, op_name, shard, n):
        """One hinted write: journal + plan stamp (the analyzer's
        "owner DOWN: queued as hint" annotation feeds off the op
        note; the pilosa_hints_* series are counted by the manager)."""
        self.cluster.journal.append(
            "write.hinted", index=index, op=op_name, shard=int(shard),
            owners=int(n),
        )
        p = plans_mod.current_plan()
        if p is not None:
            p.note_op(op=op_name, hinted=int(n), shard=int(shard))

    def _write_replicated(
        self, index, c: Call, col_id: int, opt, local_fn,
        destructive: bool = False,
    ):
        """Apply a single-bit write on every replica of the column's shard:
        locally when this node is an owner, forwarded otherwise
        (executor.go executeSetBitField :1865-1898).  Single-node: just
        local.

        DEGRADED policy (docs/durability.md): an owner the failure
        detector has marked DOWN has the miss durably QUEUED as a hint
        record for replay on recovery (hinted handoff) — the surviving
        owners take the write now and the recovered owner receives it
        before anti-entropy can merge against it.  When the hint queue
        cannot absorb the miss (no manager / overflow / expiry) the
        policy falls back verbatim to the pre-hint policy: purely-ADDITIVE sets skip
        the dead owner (anti-entropy seeds it on recovery — majority
        ties resolve to set, so the survivor's bit wins) while
        DESTRUCTIVE writes fail loudly — a Clear, or any write that
        implicitly clears bits (mutex/bool sets displacing the previous
        row, BSI sets rewriting value planes), acked on the lone
        survivor would be partially REVERTED by that same tie rule when
        the dead owner recovers still holding the old bits.  Every
        owner DOWN fails loudly: there is no replica to make the ack
        durable on.  An owner that is not yet marked DOWN but fails the
        forward also fails the write loudly — the client never got an
        ack, so nothing acked can be lost."""
        if self.cluster is None:
            return local_fn()
        shard = col_id // frag_mod.SHARD_WIDTH
        owners = self.cluster.shard_nodes(index, shard)
        if opt.remote:
            # Directed delivery (replication forward or hint replay):
            # the sender already ran the degraded-write policy — apply
            # locally when this node is an owner, no re-gating (a
            # replay must land even while some OTHER owner is DOWN).
            if any(n.id == self.cluster.node.id for n in owners):
                return bool(local_fn())
            return False
        live = [n for n in owners if n.state != "DOWN"]
        down = [n for n in owners if n.state == "DOWN"]
        if not live:
            raise Error(
                f"write unavailable: every owner of shard {shard} is DOWN "
                f"({', '.join(n.id for n in owners)})"
            )
        hinted = 0
        if down:
            hinted = self._hint_down_writes(
                index, shard, down, c, all_or_nothing=destructive,
            )
        if destructive and hinted < len(down):
            raise Error(
                f"{c.name} unavailable: owner of shard {shard} is DOWN, "
                "the hint queue could not absorb the miss, and a "
                "degraded bit-removing write would be reverted by "
                "anti-entropy's majority-tie-to-set merge on recovery"
            )
        ret = False
        for node in live:
            if node.id == self.cluster.node.id:
                if local_fn():
                    ret = True
                continue
            doc = self.cluster.client(node).query(index, str(c), remote=True)
            if doc["results"][0]:
                ret = True
        return ret

    def _forward_to_all(self, index, c: Call, opt):
        """Forward an attr write to every other node (executor.go
        :1964-1993)."""
        if self.cluster is None or opt.remote:
            return
        for node in self.cluster.nodes:
            if node.id == self.cluster.node.id:
                continue
            self.cluster.client(node).query(index, str(c), remote=True)

    # -- whole-row writes (executor.go :1964-2040) --------------------------

    def _execute_clear_row(self, index, c: Call, shards, opt: ExecOptions) -> bool:
        field_name = self._field_arg(c)
        f = self._field(index, field_name)
        if f.options.type not in (FIELD_TYPE_SET, FIELD_TYPE_TIME, FIELD_TYPE_MUTEX,
                                  FIELD_TYPE_BOOL):
            raise Error(f"ClearRow() is not supported on {f.options.type} field types")
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise Error("ClearRow() row argument required")
        def map_fn(shard):
            changed = False
            for view in list(f.views.values()):
                frag = view.fragment(shard)
                if frag is not None:
                    changed |= frag.clear_row(row_id)
            return changed

        return bool(self.map_reduce(index, shards, c, opt, map_fn, lambda a, v: bool(a) or v))

    def _execute_set_row(self, index, c: Call, shards, opt: ExecOptions) -> bool:
        field_name = self._field_arg(c)
        f = self._field(index, field_name)
        if f.options.type != FIELD_TYPE_SET:
            raise Error(f"Store() is not supported on {f.options.type} field types")
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise Error("Store() row argument required")
        if len(c.children) != 1:
            raise Error("Store() requires a source row")
        def map_fn(shard):
            src = self._execute_bitmap_call_shard(index, c.children[0], shard)
            frag = f.view_if_not_exists(VIEW_STANDARD).fragment_if_not_exists(shard)
            return frag.set_row(src, row_id)

        return bool(self.map_reduce(index, shards, c, opt, map_fn, lambda a, v: bool(a) or v))

    # -- attributes (executor.go :2693-2730) -------------------------------

    def _row_attrs_args(self, index, c: Call):
        """(field, row id, attributes) of a SetRowAttrs call."""
        f = self._field(index, c.args.get("_field"))
        row_id, ok = c.uint_arg("_row")
        if not ok:
            raise Error("SetRowAttrs() row field required")
        attrs = {k: v for k, v in c.args.items() if k not in ("_field", "_row")}
        return f, row_id, attrs

    def _execute_set_row_attrs(self, index, c: Call, opt: ExecOptions):
        f, row_id, attrs = self._row_attrs_args(index, c)
        f.row_attr_store.set_attrs(row_id, attrs)
        self._forward_to_all(index, c, opt)

    def _execute_bulk_set_row_attrs(self, index, calls: List[Call], opt: ExecOptions) -> list:
        """A query of SetRowAttrs calls alone: one bulk write per field."""
        by_field: Dict[str, tuple] = {}
        for c in calls:
            f, row_id, attrs = self._row_attrs_args(index, c)
            by_field.setdefault(f.name, (f, {}))[1].setdefault(row_id, {}).update(attrs)
        for f, m in by_field.values():
            f.row_attr_store.set_bulk_attrs(m)
        for c in calls:
            self._forward_to_all(index, c, opt)
        return [None] * len(calls)

    def _execute_set_column_attrs(self, index, c: Call, opt: ExecOptions):
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        col, ok = c.uint_arg("_col")
        if not ok:
            raise Error("SetColumnAttrs() column required")
        attrs = {k: v for k, v in c.args.items() if k not in ("_col", "field")}
        idx.column_attr_store.set_attrs(col, attrs)
        self._forward_to_all(index, c, opt)

    # -- Options (executor.go :317) ----------------------------------------

    def _execute_options_call(self, index, c: Call, shards, opt: ExecOptions):
        opt_copy = opt.copy()
        if "columnAttrs" in c.args:
            opt.column_attrs, _ = c.bool_arg("columnAttrs")  # the whole response's
        if "excludeRowAttrs" in c.args:
            opt_copy.exclude_row_attrs, _ = c.bool_arg("excludeRowAttrs")
        if "excludeColumns" in c.args:
            opt_copy.exclude_columns, _ = c.bool_arg("excludeColumns")
        if "shards" in c.args:
            s = c.args["shards"]
            if not isinstance(s, list) or any(
                    isinstance(x, bool) or not isinstance(x, int) for x in s):
                raise Error("Query(): shards must be a list of unsigned integers")
            shards = [int(x) for x in s]
        if len(c.children) != 1:
            raise Error("Options() requires exactly one child call")
        return self._execute_call(index, c.children[0], shards, opt_copy)


class _GroupByIterator:
    """Multi-field row-combination walker (executor.go:2726-2890): the
    GroupBy host lane over one shard."""

    def __init__(self):
        self.row_iters = []
        self.rows: List[Tuple[Optional[Row], int]] = []
        self.fields: List[FieldRow] = []
        self.filter: Optional[Row] = None
        self.done = False

    @classmethod
    def create(cls, executor, child_rows, children: List[Call], filter_row, index,
               shard) -> Optional["_GroupByIterator"]:
        gbi = cls()
        gbi.filter = filter_row
        gbi.rows = [(None, 0)] * len(children)
        ignore_prev = False
        for i, call in enumerate(children):
            field_name = call.args["field"]
            gbi.fields.append(FieldRow(field_name))
            frag = executor.holder.fragment(index, field_name, VIEW_STANDARD, shard)
            if frag is None:
                return None
            it = frag.row_iterator(wrap=(i != 0), row_ids_filter=child_rows[i] or None)
            gbi.row_iters.append(it)
            prev, has_prev = call.uint_arg("previous")
            if has_prev and not ignore_prev:
                if i == len(children) - 1:
                    prev += 1
                it.seek(prev)
            next_row, row_id, wrapped = it.next()
            if next_row is None:
                gbi.done = True
                return gbi
            gbi.rows[i] = (next_row, row_id)
            if has_prev and row_id != prev:
                ignore_prev = True
            if wrapped:
                for j in range(i - 1, -1, -1):
                    next_row, row_id, w2 = gbi.row_iters[j].next()
                    if next_row is None:
                        gbi.done = True
                        return gbi
                    gbi.rows[j] = (next_row, row_id)
                    if not w2:
                        break
        if gbi.filter is not None and gbi.rows:
            r, i0 = gbi.rows[0]
            gbi.rows[0] = (r.intersect(gbi.filter), i0)
        for i in range(1, len(gbi.rows) - 1):
            r, rid = gbi.rows[i]
            gbi.rows[i] = (r.intersect(gbi.rows[i - 1][0]), rid)
        return gbi

    def _next_at_idx(self, i: int):
        nr, row_id, wrapped = self.row_iters[i].next()
        if nr is None:
            self.done = True
            return
        if wrapped and i != 0:
            self._next_at_idx(i - 1)
            if self.done:
                return
        if i == 0 and self.filter is not None:
            self.rows[i] = (nr.intersect(self.filter), row_id)
        elif i == 0 or i == len(self.rows) - 1:
            self.rows[i] = (nr, row_id)
        else:
            self.rows[i] = (nr.intersect(self.rows[i - 1][0]), row_id)

    def next(self) -> Tuple[Optional[GroupCount], bool]:
        if self.done:
            return None, True
        if len(self.rows) == 1:
            count = self.rows[-1][0].count()
        else:
            count = self.rows[-1][0].intersection_count(self.rows[-2][0])
        group = [FieldRow(f.field, rid) for f, (_, rid) in zip(self.fields, self.rows)]
        ret = GroupCount(group, count)
        self._next_at_idx(len(self.rows) - 1)
        return ret, False
