"""Hinted handoff: durable bounded replay queues for writes to DOWN
owners (docs/durability.md "Hinted handoff"; DeCandia et al., *Dynamo*,
SOSP'07 §4.6, adapted to this codebase's op-log/anti-entropy machinery).

The pre-hint write policy under a DOWN owner was binary: additive sets
skip-and-count (anti-entropy heals later) while anything bit-REMOVING —
clears, mutex/bool displacement, BSI plane rewrites — failed loudly,
because anti-entropy's majority-tie-to-set merge would revert the write
when the dead owner recovers still holding the old bits.  Hinted handoff
closes that gap: the coordinator durably enqueues the miss as a
per-(node, index, shard) HINT RECORD and a replay worker drains the
queue to the recovered owner BEFORE its post-recovery quarantine is
released, so the clear reaches the recovered replica before any
majority-tie merge can resurrect the bit.

Record shape mirrors the fragment word log's version-stamped records:
each hint is ``(seq, payload)`` with a per-target monotonic ``seq``
stamp, appended to ONE log file per target node
(``<data-dir>/.hints/<node>.log``, JSON lines).  Durability honors
``[storage] ack`` exactly like the op-log: at ``logged`` (default) the
record is flushed to the OS before enqueue() returns — a ``logged`` ack
on the write that queued it survives coordinator SIGKILL by
construction; ``fsynced`` adds the fsync; rewrites (partial replay,
expiry) use the pre-hint atomic temp+fsync+rename pattern.

The queue is BOUNDED (``[cluster] hint-max-bytes`` / ``hint-max-age``)
and the bound makes degradation explicit: on overflow or expiry the
affected write falls back VERBATIM to the pre-hint policy — additive sets
skip-and-count, destructive writes fail loudly — with the drop counted
as ``pilosa_hints_dropped_total{reason}`` and journaled.

Replay ordering invariants (the whole point):

- The replay worker only targets nodes not currently marked DOWN, and
  drains strictly in seq order per target.
- ``Cluster.note_heartbeat`` refuses to release a recovered node's
  bounded-read quarantine while ANY pending hints for it are known —
  locally queued or advertised by a peer's NodeStatus (``pendingHints``).
- ``HolderSyncer`` excludes replicas we still hold hints for from
  anti-entropy merges, and DEFERS its own pass while any peer advertises
  pending hints for THIS node — so the majority-tie merge can never run
  against a replica that is still missing a queued clear.

A copy of ``pilosa_tpu/cluster/hints.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..util import events as events_mod
from ..util.stats import (
    METRIC_HINTS_DROPPED,
    METRIC_HINTS_PENDING,
    METRIC_HINTS_PENDING_BYTES,
    METRIC_HINTS_QUEUED,
    METRIC_HINTS_REPLAYED,
    REGISTRY,
)

DEFAULT_MAX_BYTES = 16 * 1024 * 1024
DEFAULT_MAX_AGE = 3600.0
REPLAY_POLL = 0.5


class _HintQueue:
    """One target node's queue: in-memory record list + the append-only
    log file backing it.  All mutation happens under the manager lock."""

    __slots__ = ("target", "path", "records", "nbytes", "seq", "fh")

    def __init__(self, target: str, path: str):
        self.target = target
        self.path = path
        self.records: List[dict] = []
        self.nbytes = 0
        self.seq = 0
        self.fh = None


class HintManager:
    """Durable bounded hint queues + the replay worker.

    Attached to the Cluster (``cluster.hints``) by the Server; the
    executor's ``_write_replicated``, the API's import fan-outs, and the
    mapper's destructive-write gate enqueue through it, and the syncer /
    quarantine logic reads its pending counts."""

    def __init__(
        self,
        path: Optional[str],
        node_id: str = "",
        max_bytes: int = DEFAULT_MAX_BYTES,
        max_age: float = DEFAULT_MAX_AGE,
        ack: str = "logged",
        journal=None,
        logger=None,
    ):
        # path None = memory-only (tests, harness clusters that opt in
        # without a data dir): same semantics minus durability.
        self.dir = os.path.join(path, ".hints") if path else None
        self.node_id = node_id
        self.max_bytes = int(max_bytes)
        self.max_age = float(max_age)
        self.ack = ack
        self.journal = journal if journal is not None else events_mod.JOURNAL
        self.logger = logger
        self.cluster = None  # attached by the server/harness
        self._lock = threading.RLock()
        # Per-target seq high-water marks, SURVIVING queue drains: a
        # drained queue's _HintQueue (and its seq state) is deleted,
        # but a still-in-flight write may hold (target, seq) rollback
        # handles — if a recreated queue restarted at seq 1, a stale
        # handle could discard a DIFFERENT, later write's hint.  Seqs
        # stay monotonic per target for the process lifetime.
        self._next_seq: Dict[str, int] = {}
        # Serializes whole replay/expiry passes (the worker thread and
        # the syncer's replay-before-AE drain both call
        # replay_pending): two concurrent passes over one queue would
        # each truncate by its own snapshot count and silently discard
        # records enqueued or expired mid-replay.  Deliberately NOT
        # self._lock — this one is held across the replay HTTP calls,
        # and enqueue (the write ack path) must never wait on those.
        self._replay_lock = threading.Lock()
        self._queues: Dict[str, _HintQueue] = {}
        self._closing = threading.Event()
        self._worker: Optional[threading.Thread] = None
        # Lifetime tallies mirrored into /debug/vars alongside the
        # pilosa_hints_* series.
        self.queued_total = 0
        self.replayed_total = 0
        self.dropped_total = 0
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            self._load()

    # -- persistence -------------------------------------------------------

    def _qpath(self, target: str) -> Optional[str]:
        if self.dir is None:
            return None
        return os.path.join(self.dir, f"{target}.log")

    def _load(self):
        """Recover queues from disk (coordinator restart): torn tails —
        a SIGKILL mid-append — keep the intact record prefix and
        truncate there, like the fragment op-log replay."""
        for name in sorted(os.listdir(self.dir)):
            if not name.endswith(".log"):
                continue
            target = name[: -len(".log")]
            p = os.path.join(self.dir, name)
            q = _HintQueue(target, p)
            try:
                with open(p, "rb") as f:
                    raw = f.read()
                # Only NEWLINE-TERMINATED records count as intact (the
                # split's last segment is b"" for a clean file, or a
                # tail torn mid-record — including torn exactly between
                # the JSON and its '\n', which would otherwise parse
                # but glue the NEXT append onto its line).
                for line in raw.split(b"\n")[:-1]:
                    try:
                        rec = json.loads(line)
                        rec["seq"]; rec["index"]; rec["op"]  # noqa: B018
                    except (ValueError, KeyError, TypeError):
                        break  # torn/corrupt tail: keep the prefix
                    q.records.append(rec)
                    q.nbytes += len(line) + 1
                    q.seq = max(q.seq, int(rec["seq"]))
                if q.nbytes < len(raw):
                    # A SIGKILL mid-append left a torn tail: truncate at
                    # the last intact record, like the op-log replay.
                    with open(p, "r+b") as f:
                        f.truncate(q.nbytes)
                self._next_seq[target] = q.seq
            except OSError as e:
                if self.logger:
                    self.logger.printf("hint queue %s unreadable: %s", p, e)
                continue
            if q.records:
                self._queues[target] = q
        self._refresh_gauges()

    def _open_fh(self, q: _HintQueue):
        if q.path is not None and q.fh is None:
            q.fh = open(q.path, "ab")
        return q.fh

    def _append(self, q: _HintQueue, line: bytes):
        fh = self._open_fh(q)
        if fh is None:
            return
        fh.write(line)
        # Same ack ladder as the fragment op-log (_append_op): the
        # configured durability promise is met BEFORE the caller acks
        # the write that queued this hint.
        if self.ack != "received":
            fh.flush()
            if self.ack == "fsynced":
                os.fsync(fh.fileno())

    def _rewrite(self, q: _HintQueue):
        """Persist the in-memory record list as the whole file (partial
        replay / expiry / rollback): atomic temp+fsync+rename per the
        pre-hint pattern, or unlink when drained.  Maintains ``q.nbytes``
        as it serializes — the single accounting point for every
        record-removal path."""
        q.nbytes = sum(
            len(json.dumps(r).encode()) + 1 for r in q.records
        )
        if q.path is None:
            return
        if q.fh is not None:
            q.fh.close()
            q.fh = None
        if not q.records:
            try:
                os.unlink(q.path)
            except OSError:
                pass
            return
        tmp = q.path + ".tmp"
        with open(tmp, "wb") as f:
            for rec in q.records:
                f.write(json.dumps(rec).encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, q.path)

    def _refresh_gauges(self):
        REGISTRY.set_gauge(
            METRIC_HINTS_PENDING,
            sum(len(q.records) for q in self._queues.values()),
        )
        REGISTRY.set_gauge(
            METRIC_HINTS_PENDING_BYTES,
            sum(q.nbytes for q in self._queues.values()),
        )

    # -- enqueue -----------------------------------------------------------

    def enqueue(self, target: str, index: str, shard: int, op: dict) -> int:
        """Durably queue one missed write for ``target``.  Returns the
        record's ``seq`` stamp (truthy; a ``discard`` handle for
        all-or-nothing callers), or 0 — WITHOUT queuing — when the
        bound would be exceeded: the caller falls back to the pre-hint
        policy (skip-and-count for additive, fail-loud for
        destructive) and the drop is counted/journaled so the
        degradation is explicit, never silent."""
        with self._lock:
            if self._closing.is_set():
                return 0
            q = self._queues.get(target)
            if q is None:
                q = _HintQueue(target, self._qpath(target))
                # Resume the target's monotonic seq past any DRAINED
                # queue's high water (see _next_seq).
                q.seq = self._next_seq.get(target, 0)
                self._queues[target] = q
            q.seq += 1
            self._next_seq[target] = q.seq
            rec = {
                "seq": q.seq,
                "t": time.time(),
                "index": index,
                "shard": int(shard),
                "op": op,
            }
            line = json.dumps(rec).encode() + b"\n"
            total = sum(x.nbytes for x in self._queues.values())
            if total + len(line) > self.max_bytes:
                q.seq -= 1
                self.dropped_total += 1
                REGISTRY.inc(METRIC_HINTS_DROPPED, reason="overflow")
                self.journal.append(
                    "hints.dropped", target=target, index=index,
                    shard=int(shard), reason="overflow",
                    pendingBytes=total, maxBytes=self.max_bytes,
                )
                return 0
            try:
                self._append(q, line)
            except OSError as e:
                # A hint we cannot make durable is a hint we do not
                # have: the caller must fall back, not ack on a promise
                # the disk refused.  Counted under its OWN reason — an
                # operator alerting on overflow must not chase
                # hint-max-bytes when the disk is the problem.
                q.seq -= 1
                self.dropped_total += 1
                REGISTRY.inc(METRIC_HINTS_DROPPED, reason="io_error")
                self.journal.append(
                    "hints.dropped", target=target, index=index,
                    shard=int(shard), reason="io_error", error=str(e),
                )
                return 0
            q.records.append(rec)
            q.nbytes += len(line)
            self.queued_total += 1
            REGISTRY.inc(METRIC_HINTS_QUEUED)
            self.journal.append(
                "hints.queued", target=target, index=index,
                shard=int(shard), kind=op.get("kind", "?"), seq=q.seq,
            )
            self._refresh_gauges()
            return q.seq

    def discard(self, target: str, seqs) -> None:
        """Remove just-enqueued records by seq — the all-or-nothing
        rollback for DESTRUCTIVE writes: when a gate fails the write
        AFTER some of its down-owner misses were absorbed, the client
        gets an error (no ack), so those hints must not survive to
        replay an op that never happened onto one replica."""
        seqs = set(int(s) for s in seqs)
        if not seqs:
            return
        with self._lock:
            q = self._queues.get(target)
            if q is None:
                return
            keep = [r for r in q.records if int(r["seq"]) not in seqs]
            removed = len(q.records) - len(keep)
            if not removed:
                return
            q.records = keep
            self._rewrite(q)
            # The queued counter already ticked for these (counters are
            # monotonic); the unwind lands under its own drop reason so
            # queued == replayed + dropped + pending still reconciles.
            self.dropped_total += removed
            REGISTRY.inc(METRIC_HINTS_DROPPED, removed, reason="rolled_back")
            self.journal.append(
                "hints.dropped", target=target, records=removed,
                reason="rolled_back",
            )
            if not q.records:
                del self._queues[target]
            self._refresh_gauges()

    # -- introspection -----------------------------------------------------

    def pending(self, target: str) -> int:
        with self._lock:
            q = self._queues.get(target)
            return len(q.records) if q is not None else 0

    def pending_map(self) -> Dict[str, int]:
        """{target node id: pending record count}, nonzero entries only
        — what node_status() advertises to peers."""
        with self._lock:
            return {
                t: len(q.records)
                for t, q in self._queues.items()
                if q.records
            }

    def stats(self) -> dict:
        with self._lock:
            return {
                "pending": {
                    t: len(q.records)
                    for t, q in self._queues.items()
                    if q.records
                },
                "pendingBytes": sum(
                    q.nbytes for q in self._queues.values()
                ),
                "maxBytes": self.max_bytes,
                "maxAgeSeconds": self.max_age,
                "queued": self.queued_total,
                "replayed": self.replayed_total,
                "dropped": self.dropped_total,
            }

    # -- expiry / drops ----------------------------------------------------

    def expire(self, now: Optional[float] = None) -> int:
        """Drop records older than ``max_age`` (counted + journaled):
        a hint held longer than the bound is no longer trustworthy
        repair material — the pre-hint fallback (anti-entropy seeding /
        the loud failure already surfaced) owns the outcome."""
        with self._replay_lock:
            return self._expire_locked(now)

    def _expire_locked(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        dropped = 0
        with self._lock:
            for q in list(self._queues.values()):
                keep = [
                    r for r in q.records
                    if now - float(r.get("t", now)) <= self.max_age
                ]
                n = len(q.records) - len(keep)
                if not n:
                    continue
                q.records = keep
                self._rewrite(q)
                dropped += n
                self.dropped_total += n
                REGISTRY.inc(METRIC_HINTS_DROPPED, n, reason="expired")
                self.journal.append(
                    "hints.dropped", target=q.target, reason="expired",
                    records=n,
                )
                if not q.records:
                    del self._queues[q.target]
            if dropped:
                self._refresh_gauges()
        return dropped

    def drop_node(self, target: str):
        """The target left the cluster for good (admin removal): its
        queue will never replay — drop it, counted."""
        with self._lock:
            q = self._queues.pop(target, None)
            if q is None:
                return
            n = len(q.records)
            q.records = []
            self._rewrite(q)
            if n:
                self.dropped_total += n
                REGISTRY.inc(METRIC_HINTS_DROPPED, n, reason="node_removed")
                self.journal.append(
                    "hints.dropped", target=target, reason="node_removed",
                    records=n,
                )
            self._refresh_gauges()

    # -- replay ------------------------------------------------------------

    def _apply(self, client, rec: dict):
        """Deliver one hint record to its recovered target.  Every op
        replays with remote=True — the target applies locally, no
        re-fan-out, exactly like the original replication forward it
        stands in for."""
        op = rec["op"]
        kind = op.get("kind")
        index, shard = rec["index"], int(rec["shard"])
        if kind == "query":
            client.query(
                index, op["query"], shards=op.get("shards"), remote=True
            )
        elif kind == "import_bits":
            client.import_bits(
                index, op["field"], shard, op["rows"], op["cols"],
                timestamps=op.get("ts") or None, remote=True,
                clear=bool(op.get("clear")),
            )
        elif kind == "import_values":
            client.import_values(
                index, op["field"], shard, op["cols"], op["values"],
                remote=True, clear=bool(op.get("clear")),
            )
        else:
            # (api.import_roaring applies locally with no owner fan-out
            # — peer-to-peer anti-entropy pushes — so there is no
            # roaring hint kind; an unknown kind is a poison record.)
            raise ValueError(f"unknown hint op kind: {kind!r}")

    def replay(self, target: str, node=None) -> bool:
        """Drain ``target``'s queue in seq order.  Returns True when the
        queue fully drained (file unlinked).  A transport/5xx/429
        failure stops the pass (retried by the worker); a deterministic
        4xx or malformed record is DROPPED (reason=rejected) so one
        poison hint can never wedge the queue behind it forever."""
        with self._replay_lock:
            return self._replay_locked(target, node)

    def _replay_locked(self, target: str, node=None) -> bool:
        from ..net.client import ClientError

        with self._lock:
            q = self._queues.get(target)
            recs = list(q.records) if q is not None else []
        if not recs:
            return True
        if node is None and self.cluster is not None:
            node = self.cluster.node_by_id(target)
        if node is None:
            return False
        client = (
            self.cluster.client(node) if self.cluster is not None else node
        )
        consumed = set()  # seqs delivered or rejected THIS pass
        replayed = 0
        rejected = 0
        for rec in recs:
            try:
                self._apply(client, rec)
                replayed += 1
            except ClientError as e:
                if e.code is not None and 400 <= e.code < 500 and e.code != 429:
                    rejected += 1  # deterministic: re-sending can't help
                else:
                    break  # transient: keep the record, retry later
            except (ValueError, KeyError, TypeError):
                # Malformed record (unknown kind, missing payload
                # field): poison — drop it, or it would escape the
                # pass, lose this pass's progress, and wedge the queue
                # behind it on every retry.
                rejected += 1
            consumed.add(int(rec["seq"]))
        if not consumed:
            return False
        with self._lock:
            q = self._queues.get(target)
            if q is not None:
                # Remove by SEQ, not by prefix count: a concurrent
                # discard() (a destructive gate's rollback runs on the
                # write path, outside _replay_lock) may have removed a
                # snapshot record mid-pass, and a count-based slice
                # would then drop an unrelated, un-replayed record.
                q.records = [
                    r for r in q.records if int(r["seq"]) not in consumed
                ]
                self._rewrite(q)
                drained = not q.records
                if drained:
                    del self._queues[q.target]
            else:
                drained = True
            if replayed:
                self.replayed_total += replayed
                REGISTRY.inc(METRIC_HINTS_REPLAYED, replayed)
            if rejected:
                self.dropped_total += rejected
                REGISTRY.inc(METRIC_HINTS_DROPPED, rejected, reason="rejected")
            self._refresh_gauges()
        self.journal.append(
            "hints.replayed", target=target, records=replayed,
            rejected=rejected, drained=drained,
        )
        if drained and self.cluster is not None:
            # Advertise the drain promptly (pendingHints now empty for
            # this target) so peers holding the recovered node in
            # bounded-read quarantine can release it within one
            # heartbeat instead of one anti-entropy interval.
            try:
                self.cluster.send_async(self.cluster.node_status())
            except Exception:  # noqa: BLE001 — best-effort acceleration
                pass
        return drained

    def replay_pending(self) -> int:
        """One synchronous pass over every target with pending hints
        (the worker's body; also called directly by the syncer's
        replay-before-AE drain and by tests).  Skips targets still
        marked DOWN — replay needs the serving plane up.  Returns the
        number of targets fully drained."""
        with self._replay_lock:
            self._expire_locked()
            with self._lock:
                targets = [t for t, q in self._queues.items() if q.records]
            drained = 0
            for t in targets:
                node = (
                    self.cluster.node_by_id(t)
                    if self.cluster is not None
                    else None
                )
                if node is None or getattr(node, "state", "") == "DOWN":
                    continue
                try:
                    if self._replay_locked(t, node):
                        drained += 1
                except Exception as e:  # noqa: BLE001 — worker must survive
                    if self.logger:
                        self.logger.printf(
                            "hint replay to %s failed: %s", t, e
                        )
            return drained

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True, name="hint-replay"
            )
            self._worker.start()
        return self

    def _worker_loop(self):
        while not self._closing.wait(REPLAY_POLL):
            try:
                self.replay_pending()
            except Exception as e:  # noqa: BLE001
                if self.logger:
                    self.logger.printf("hint replay pass failed: %s", e)

    def close(self):
        self._closing.set()
        with self._lock:
            for q in self._queues.values():
                if q.fh is not None:
                    try:
                        q.fh.flush()
                        q.fh.close()
                    except (OSError, ValueError):
                        pass
                    q.fh = None
