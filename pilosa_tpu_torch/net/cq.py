"""Continuous queries: subscribe a PQL query, stream result deltas.

``POST /cq {"index": i, "query": q}`` registers a subscription: the
query runs once (seeding the result memo and, for repairable shapes,
the repair layer's materialized entry) and every subsequent write to
the index wakes a single sweeper thread that re-executes the dirty
subscriptions.  Because the first execution registered the result for
repair-on-write (parallel/repair.py), the steady-state re-execution
cost is O(changed bits), not O(data) — that is what makes a standing
query affordable under streaming ingest.

Delivery is long-poll (``GET /cq/{id}?since=N&wait_ms=M``), matching
the serving tier's plain-HTTP surface: each changed result appends an
entry to a bounded per-subscription log (oldest entries drop).

Bitmap results ship DELTA DIFFS on the wire: when the previous and
current results are both bitmap-shaped (``{"columns": [...]}``), the
log entry is ``{"seq": n, "diff": [{"added": [...], "removed": [...]},
...]}`` — one added/removed pair per result position — so a standing
query over a big row costs O(changed ids) per delivery, not O(row).
The FULL result is sent on the first delivery (seq 1, from create),
whenever either side is not bitmap-shaped, and as a ``"resync": true``
entry when a reader's ``since`` has fallen off the trimmed log (a
missed diff cannot be reconstructed, so the poll answers with the
current full result instead of a gapped diff stream).

The write-side hook is DeltaHub.add_listener (core/delta.py): it fires
inside the writing fragment's lock, so the callback only sets a flag —
the sweeper debounces a burst of writes into one re-execution.

A copy of ``pilosa_tpu/net/cq.py``.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import OrderedDict, deque

from ..core.delta import HUB
from ..util.stats import METRIC_CQ_ACTIVE, METRIC_CQ_DELTAS, REGISTRY
from .wire import response_to_json

__all__ = ["CQManager"]


class _Sub:
    __slots__ = (
        "qid", "index", "query", "seq", "last", "last_result",
        "last_cols", "log",
    )

    def __init__(self, qid: str, index: str, query: str):
        self.qid = qid
        self.index = index
        self.query = query
        self.seq = 0
        self.last = None  # canonical JSON of the last served result
        self.last_result = None  # full current result (resync answers)
        self.last_cols = None  # per-result column sets when bitmap-shaped
        self.log: deque = deque(maxlen=CQManager.LOG_MAX)


def _bitmap_cols(result):
    """Per-result column-id sets when EVERY result is bitmap-shaped
    (``{"columns": [ids]}``); None otherwise — counts, TopN, keyed rows
    and mixed batches keep shipping full results."""
    if not isinstance(result, list) or not result:
        return None
    out = []
    for r in result:
        if not isinstance(r, dict) or "columns" not in r:
            return None
        out.append(frozenset(r["columns"]))
    return out


class CQManager:
    """All continuous-query state for one API instance."""

    MAX_SUBS = 64
    LOG_MAX = 64
    DEBOUNCE = 0.05  # coalesce a write burst into one re-execution
    WAIT_MAX_MS = 30_000

    def __init__(self, api):
        self.api = api
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._subs: "OrderedDict[str, _Sub]" = OrderedDict()
        self._dirty: set = set()  # index names written since last sweep
        self._wake = threading.Event()
        self._worker = None
        self._closed = False
        self._ids = itertools.count(1)
        self._listening = False
        self._c_deltas = REGISTRY.counter(METRIC_CQ_DELTAS)

    # -- subscription lifecycle --------------------------------------------

    def create(self, index: str, query: str) -> dict:
        result = self._execute(index, query)
        canon = _canon(result)
        with self._lock:
            if self._closed:
                raise ValueError("continuous queries are shut down")
            if len(self._subs) >= self.MAX_SUBS:
                raise ValueError(
                    "too many continuous queries (max %d)" % self.MAX_SUBS
                )
            sub = _Sub("cq-%d" % next(self._ids), index, query)
            sub.seq = 1
            sub.last = canon
            sub.last_result = result
            sub.last_cols = _bitmap_cols(result)
            sub.log.append({"seq": 1, "result": result})
            self._subs[sub.qid] = sub
            self._ensure_running()
            n = len(self._subs)
        REGISTRY.set_gauge(METRIC_CQ_ACTIVE, n)
        return {"id": sub.qid, "seq": 1, "result": result}

    def delete(self, qid: str) -> dict:
        with self._lock:
            sub = self._subs.pop(qid, None)
            if sub is None:
                raise KeyError(qid)
            n = len(self._subs)
            if n == 0 and self._listening:
                HUB.remove_listener(self._on_write)
                self._listening = False
        REGISTRY.set_gauge(METRIC_CQ_ACTIVE, n)
        return {"deleted": qid}

    def poll(self, qid: str, since: int = 0, wait_ms: int = 0) -> dict:
        """Entries newer than ``since``; blocks up to ``wait_ms`` for
        the first one (long-poll)."""
        deadline = time.monotonic() + min(wait_ms, self.WAIT_MAX_MS) / 1000.0
        with self._cond:
            while True:
                sub = self._subs.get(qid)
                if sub is None:
                    raise KeyError(qid)
                deltas = [e for e in sub.log if e["seq"] > since]
                if deltas:
                    if since > 0 and deltas[0]["seq"] > since + 1 and any(
                        "result" not in e for e in deltas
                    ):
                        # The reader's position fell off the trimmed
                        # log and at least one surviving entry is a
                        # diff: a gapped diff stream would corrupt the
                        # reader's view, so answer with the current
                        # FULL result instead.
                        return {
                            "id": qid,
                            "seq": sub.seq,
                            "deltas": [{
                                "seq": sub.seq,
                                "result": sub.last_result,
                                "resync": True,
                            }],
                        }
                    return {"id": qid, "seq": sub.seq, "deltas": deltas}
                left = deadline - time.monotonic()
                if left <= 0 or self._closed:
                    return {"id": qid, "seq": sub.seq, "deltas": []}
                self._cond.wait(left)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "active": len(self._subs),
                "deltas": int(self._c_deltas.get()),
                "subscriptions": [
                    {"id": s.qid, "index": s.index, "query": s.query,
                     "seq": s.seq}
                    for s in self._subs.values()
                ],
            }

    def close(self):
        with self._cond:
            self._closed = True
            if self._listening:
                HUB.remove_listener(self._on_write)
                self._listening = False
            self._cond.notify_all()
        self._wake.set()
        w = self._worker
        if w is not None:
            w.join(timeout=2.0)

    # -- write side ---------------------------------------------------------

    def _on_write(self, index: str):
        # Fires inside the writing fragment's lock: flag and go.
        self._dirty.add(index)
        self._wake.set()

    def _ensure_running(self):
        # Called under self._lock.
        if not self._listening:
            HUB.add_listener(self._on_write)
            self._listening = True
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name="cq-sweeper", daemon=True
            )
            self._worker.start()

    # -- sweeper ------------------------------------------------------------

    def _run(self):
        while not self._closed:
            if not self._wake.wait(timeout=1.0):
                continue
            time.sleep(self.DEBOUNCE)
            self._wake.clear()
            dirty, self._dirty = self._dirty, set()
            if not dirty:
                continue
            self._sweep(dirty)

    def _sweep(self, dirty):
        with self._lock:
            todo = [
                (s.qid, s.index, s.query)
                for s in self._subs.values()
                if s.index in dirty
            ]
        for qid, index, query in todo:
            if self._closed:
                return
            try:
                result = self._execute(index, query)
            except Exception:  # a dropped index/field ends the stream
                continue
            canon = _canon(result)
            cols = _bitmap_cols(result)
            with self._cond:
                sub = self._subs.get(qid)
                if sub is None or sub.last == canon:
                    continue
                sub.seq += 1
                sub.last = canon
                if (
                    cols is not None
                    and sub.last_cols is not None
                    and len(cols) == len(sub.last_cols)
                ):
                    entry = {
                        "seq": sub.seq,
                        "diff": [
                            {
                                "added": sorted(c - p),
                                "removed": sorted(p - c),
                            }
                            for p, c in zip(sub.last_cols, cols)
                        ],
                    }
                else:
                    entry = {"seq": sub.seq, "result": result}
                sub.last_result = result
                sub.last_cols = cols
                sub.log.append(entry)
                self._c_deltas.inc()
                self._cond.notify_all()

    def _execute(self, index: str, query: str):
        from ..api import QueryRequest  # late: api imports net.serve

        resp = self.api.query(QueryRequest(index, query))
        return response_to_json(resp)["results"]


def _canon(result) -> str:
    """Canonical comparison text: change detection must not depend on
    container identity (lists vs tuples out of the memo)."""
    return json.dumps(result, sort_keys=True, default=str)
