"""Dense global ordering gate for mesh collectives (the port of
``pilosa_tpu/parallel/seqgate.py``; pure Python, a copy of its own).

Every rank of a multi-process mesh must ENTER collectives in the same
order, or two ranks block in each other's collective: gloo runs a process
group's operations in the order each process calls them.  A sequencer
node issues dense tickets, every collective carries its ticket, and this
gate makes each process execute seq 0, 1, 2, ... in ticket order whatever
the arrival order, so local initiations and peer replays interleave
through one gate and any node may initiate (the reference's any-node
mapReduce, executor.go:2183).

Aborted or expired tickets are ``skip``ped so the stream advances past
them; a ticket stalled longer than ``STALL_TIMEOUT`` (its commit lost with
a crashed initiator) is force-skipped with a log line rather than wedging
every later collective.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class SeqGate:
    # Must exceed the slowest LEGITIMATE path from ticket issue to
    # commit arrival: the initiator's two-phase fan-out budgets 35 s per
    # phase per peer (server._broadcast_dispatch), so a healthy but slow
    # handoff can hold the head ticket ~70 s.  Skipping a healthy ticket
    # is the one thing this timeout must never do — it splits the mesh
    # into processes that ran the collective and processes that jumped
    # it.
    STALL_TIMEOUT = 150.0

    def __init__(self, on_stall: Optional[Callable[[int], None]] = None):
        self._cond = threading.Condition()
        self.next_seq = 0
        self._skips: set = set()
        self._on_stall = on_stall
        # The seq currently EXECUTING (between a successful enter and
        # its exit): stall detection must never skip a running head —
        # a long dispatch (first compile of a new program shape easily
        # exceeds any timeout) is progress, not a lost ticket.
        self._running: Optional[int] = None
        # Monotonic timestamp of the last next_seq advance, for stall
        # detection (only meaningful while someone is waiting).
        self._advanced_at = time.monotonic()

    def enter(self, seq: int) -> bool:
        """Block until it is ``seq``'s turn.  Returns False if the seq
        was already passed (force-skipped while we waited or before we
        arrived) — the caller must NOT execute its collective then."""
        with self._cond:
            while self.next_seq < seq:
                waited = self._cond.wait(timeout=1.0)
                if waited:
                    continue
                if self._running == self.next_seq:
                    # Head is executing, not lost: its exit will advance.
                    self._advanced_at = time.monotonic()
                    continue
                stalled_for = time.monotonic() - self._advanced_at
                if stalled_for >= self.STALL_TIMEOUT:
                    # The ticket at the head never arrived (initiator
                    # died between ticket and broadcast, or its commit
                    # was lost).  Skip it so the stream survives.
                    stuck = self.next_seq
                    self._advance(stuck + 1)
                    if self._on_stall is not None:
                        self._on_stall(stuck)
            if self.next_seq == seq:
                self._running = seq
                return True
            return False

    def exit(self, seq: int):
        """Mark ``seq`` executed; wakes the next ticket holder."""
        with self._cond:
            if self._running == seq:
                self._running = None
            if self.next_seq == seq:
                self._advance(seq + 1)

    def skip(self, seq: int):
        """Mark ``seq`` as never-executing (aborted/expired ticket)."""
        with self._cond:
            if seq < self.next_seq:
                return
            if seq == self.next_seq:
                self._advance(seq + 1)
            else:
                self._skips.add(seq)

    def _advance(self, to: int):
        # Caller holds the lock.
        self.next_seq = to
        while self.next_seq in self._skips:
            self._skips.discard(self.next_seq)
            self.next_seq += 1
        self._advanced_at = time.monotonic()
        self._cond.notify_all()
