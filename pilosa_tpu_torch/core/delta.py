"""Write-delta bus: the repair layer's view of the ingest stream.

The version-token result memo (parallel/engine.py _ResultMemo) makes
invalidation free — a write bumps its view's version and the next key
simply misses.  Repair-on-write needs the converse: the *content* of
each write, keyed by the exact version the bump produced, so a stale
materialized result can be advanced to the current tokens in O(changed
bits) instead of recomputed from the full index.

Fragments publish here from inside their own lock (core/fragment.py
_touch/_touch_rows): one packet per version bump, carrying the touched
(row, word64) keys and each word's BEFORE value.  The after-state is
never shipped — a repairing reader re-reads the truth words under the
fragment lock and validates that no further bump landed meanwhile, so
"after" is simply the truth at the validated tokens.

Correctness is structural, not best-effort: view versions are a dense
per-view counter (view._bump_version), every bump while a subscription
is live produces exactly one packet (a data packet on instrumented
write paths, an OPAQUE packet otherwise), and a repair is only legal
when the packet log covers EVERY integer version between the entry's
base token and the current token.  Any un-instrumented write path —
mutex bulk imports, dense row loads, storage reloads — publishes
opaque, punches a hole in the chain, and the entry falls back to a
full recompute.  A write that races subscription itself (bump before
the log existed) leaves a missing version with the same effect.

This module is import-leaf (numpy + threading only): core/fragment.py
publishes into it and parallel/repair.py consumes from it without an
import cycle through the parallel package.

A copy of ``pilosa_tpu/core/delta.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple


class Packet:
    """One version bump of one view: ``rows[i]`` / ``widxs[i]`` /
    ``before[i]`` are the touched (row, 64-bit-word) keys of shard
    ``shard`` with the word's pre-write value.  ``rows is None`` marks
    an OPAQUE bump (un-instrumented write path): the version is
    accounted for but its content is unknown, so entries whose
    footprint could overlap must fall back."""

    __slots__ = ("version", "shard", "rows", "widxs", "before")

    def __init__(self, version, shard, rows, widxs, before):
        self.version = version
        self.shard = shard
        self.rows = rows
        self.widxs = widxs
        self.before = before

    @property
    def opaque(self) -> bool:
        return self.rows is None

    def nwords(self) -> int:
        return 0 if self.rows is None else len(self.rows)


class _ViewLog:
    __slots__ = ("floor", "packets", "words", "refs")

    def __init__(self, floor: int):
        # Versions <= floor are not covered: entries based at or below
        # it cannot repair (pre-subscription writes, trimmed packets).
        self.floor = floor
        self.packets: List[Packet] = []
        self.words = 0
        self.refs = 0


class DeltaHub:
    """Process-global (index, field, view, view-gen) -> bounded packet
    log.  The view's process-unique generation token (core/view.py
    View.gen) is part of the key: a same-named view recreated after a
    drop starts a fresh version counter, and its bumps must never
    satisfy coverage checks against the old view's packets.

    ``wants()`` is the ingest-path gate: a lock-free dict probe, so an
    unsubscribed deployment pays one dict miss per write batch and
    captures nothing.  Publish runs under the writing fragment's lock
    (so packet content and version can never tear) plus this hub's own
    lock for the log append; readers take only the hub lock."""

    # Per-view-log retention: packets past either bound trim oldest-first
    # and raise the floor, aging out entries that fell too far behind.
    PACKETS_MAX = 4096
    WORDS_MAX = 1 << 19  # 4 MiB of before-words per view log

    def __init__(self):
        self._lock = threading.Lock()
        self._logs: Dict[Tuple[str, str, str, int], _ViewLog] = {}
        self._listeners: List[Callable[[str], None]] = []

    # -- subscription (repair layer) ---------------------------------------

    def subscribe(self, vkey: Tuple[str, str, str, int], base_version: int):
        """Start (or share) the packet log for a view.  A NEW log's
        floor is the subscriber's base version: bumps the subscriber
        never saw packets for are structurally unrepairable."""
        with self._lock:
            log = self._logs.get(vkey)
            if log is None:
                log = self._logs[vkey] = _ViewLog(base_version)
            log.refs += 1

    def unsubscribe(self, vkey: Tuple[str, str, str, int]):
        with self._lock:
            log = self._logs.get(vkey)
            if log is None:
                return
            log.refs -= 1
            if log.refs <= 0:
                del self._logs[vkey]

    def add_listener(self, fn: Callable[[str], None]):
        """Register a write notification callback (continuous queries).
        Fires with the written index name, from inside the writing
        fragment's lock — it MUST be non-blocking (set an event)."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn):
        with self._lock:
            self._listeners = [f for f in self._listeners if f is not fn]

    def touched(self, index: str):
        """Listener-only write notification for a view with no packet
        log: continuous queries subscribe to whole indexes, so they
        must hear about writes the repair layer never asked to see.
        Free when nobody listens (one truthiness test per write batch)."""
        if self._listeners:
            self._fire(index)

    # -- ingest side (fragment) --------------------------------------------

    def wants(self, index: str, field: str, view: str, gen: int) -> bool:
        """Lock-free: is anyone accumulating deltas for this view?"""
        return (index, field, view, gen) in self._logs

    def publish(self, index, field, view, gen, version, shard, rows, widxs,
                before):
        self._append(
            (index, field, view, gen),
            Packet(version, shard, rows, widxs, before),
        )
        self._fire(index)

    def publish_opaque(self, index, field, view, gen, version):
        self._append(
            (index, field, view, gen), Packet(version, None, None, None, None)
        )
        self._fire(index)

    def _append(self, vkey, pkt: Packet):
        with self._lock:
            log = self._logs.get(vkey)
            if log is None:
                return
            log.packets.append(pkt)
            log.words += pkt.nwords()
            while log.packets and (
                len(log.packets) > self.PACKETS_MAX
                or log.words > self.WORDS_MAX
            ):
                old = log.packets.pop(0)
                log.words -= old.nwords()
                log.floor = max(log.floor, old.version)

    def _fire(self, index: str):
        for fn in list(self._listeners):
            try:
                fn(index)
            except Exception:  # noqa: BLE001 — listeners are advisory
                pass

    # -- read side (repair layer) ------------------------------------------

    def packets_for(
        self, vkey, base: int, current: int
    ) -> Optional[List[Packet]]:
        """The packets covering EVERY version in (base, current], in
        version order — or None when the chain has a hole (a bump that
        predates subscription, raced it, or was trimmed).  Opaque
        packets are included; callers whose footprint touches this view
        must reject them, callers for whom the view is value-neutral
        (time-quantum siblings of a standard-view query) may not."""
        if current <= base:
            return []
        with self._lock:
            log = self._logs.get(vkey)
            if log is None or base < log.floor:
                return None
            sel = [p for p in log.packets if base < p.version <= current]
        sel.sort(key=lambda p: p.version)
        if len(sel) != current - base:
            return None
        for i, p in enumerate(sel):
            if p.version != base + 1 + i:
                return None
        return sel

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "viewLogs": len(self._logs),
                "packets": sum(len(g.packets) for g in self._logs.values()),
                "bufferedWords": sum(g.words for g in self._logs.values()),
            }


HUB = DeltaHub()
