"""Structured event journal: a bounded ring of typed, timestamped,
trace-id-linked records.

A copy of ``pilosa_tpu/util/events.py``.

The control-plane analogue of the query path's span rings: the things
that page an operator — gossip membership flaps, resize phase
transitions, anti-entropy passes, engine HBM evictions — each append one
typed record here instead of (or in addition to) a free-text log line,
so ``GET /debug/events`` can answer "what happened around 14:03" with
filterable structure.  This is the Dapper-style annotation half of the
observability layer (PAPERS.md): events created while a query span is
ambient automatically carry its trace id, so an eviction triggered by a
query joins that query's trace.

Design constraints:

- **Bounded**: a ``deque(maxlen=capacity)`` ring; the journal can never
  grow a long-lived node's memory.  ``dropped`` counts what the ring
  aged out, so a consumer can tell "quiet" from "overwritten".
- **Cheap**: ``append()`` is one lock, one deque append, and (when a
  logger is attached) one formatted line — safe inside gossip probe
  loops and the engine's dispatch path.
- **Per-node**: each Server owns its own journal (Monarch-style local
  collection).  Library-level components default to the process-global
  ``JOURNAL`` so standalone/engine-only use still records.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import tracing

DEFAULT_CAPACITY = 1024


class Event:
    __slots__ = ("seq", "ts", "type", "node", "trace_id", "message", "fields")

    def __init__(self, seq: int, type: str, node: str = "",
                 trace_id: str = "", message: str = "",
                 fields: Optional[Dict] = None):
        self.seq = seq
        self.ts = time.time()
        self.type = type
        self.node = node
        self.trace_id = trace_id
        self.message = message
        self.fields = fields or {}

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts": round(self.ts, 6),
            "type": self.type,
            "node": self.node,
            "traceID": self.trace_id,
            "message": self.message,
            "fields": self.fields,
        }

    def __repr__(self):
        return f"Event({self.seq}, {self.type!r}, {self.fields!r})"


class EventJournal:
    """Thread-safe bounded ring of Events.

    ``node`` labels every record with the owning node's id (mutable:
    the server learns its persisted id after construction).  ``logger``
    mirrors each event to the structured log, one line per event, so
    the journal and the log never disagree about what happened."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, node: str = "",
                 logger=None):
        self.capacity = max(1, int(capacity))
        self.node = node
        self.logger = logger
        self._ring: "deque[Event]" = deque(maxlen=self.capacity)
        self._seq = 0
        self._lock = threading.Lock()

    def append(self, type: str, message: str = "",
               trace_id: Optional[str] = None, **fields) -> Event:
        """Record one event.  When ``trace_id`` is not given, the
        calling thread's ambient span (util.tracing current_span) is
        consulted — this is how a query-triggered eviction links to the
        query's trace without the engine knowing about tracing."""
        if trace_id is None:
            span = tracing.current_span()
            trace_id = span.trace_id if span is not None else ""
        with self._lock:
            self._seq += 1
            ev = Event(self._seq, type, self.node, trace_id, message,
                       fields or None)
            self._ring.append(ev)
        if self.logger is not None:
            try:
                kv = " ".join(f"{k}={v}" for k, v in ev.fields.items())
                self.logger.printf(
                    "event[%s] %s%s%s%s",
                    ev.node or "-",
                    ev.type,
                    f" {message}" if message else "",
                    f" {kv}" if kv else "",
                    f" (trace {trace_id})" if trace_id else "",
                )
            except Exception:  # noqa: BLE001 — journaling never raises
                pass
        return ev

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        """Events aged out of the ring (total appended minus retained)."""
        with self._lock:
            return self._seq - len(self._ring)

    def events(self, type: Optional[str] = None,
               limit: Optional[int] = None) -> List[Event]:
        """Chronological snapshot (oldest first).  ``type`` filters by
        exact type or family prefix (``type=gossip`` matches ``gossip``
        and every ``gossip.*``); ``limit`` keeps the NEWEST n after
        filtering."""
        with self._lock:
            out = list(self._ring)
        if type:
            out = [
                e for e in out
                if e.type == type or e.type.startswith(type + ".")
            ]
        if limit is not None and limit >= 0:
            # limit=0 means ZERO events, not "everything" (out[-0:] is
            # the whole list — the classic slice trap).
            out = out[-limit:] if limit > 0 else []
        return out

    def to_doc(self, type: Optional[str] = None,
               limit: Optional[int] = None) -> dict:
        """The /debug/events document."""
        evs = self.events(type=type, limit=limit)
        with self._lock:
            dropped = self._seq - len(self._ring)
        return {
            "events": [e.to_dict() for e in evs],
            "node": self.node,
            "capacity": self.capacity,
            "dropped": dropped,
        }

    def clear(self):
        with self._lock:
            self._ring.clear()


# Process-global default journal: what library-level components append
# to when no per-node journal was injected (Server wires its own journal
# through the engine and the API).
JOURNAL = EventJournal()
