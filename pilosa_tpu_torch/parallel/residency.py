"""Tiered residency: the card's memory as a working-set cache over the host
tier (docs/residency.md).

The port of ``pilosa_tpu/parallel/residency.py``.  The host tier (the
fragments' row stores) is the at-rest format; the card holds only the
working set.  This module is the cache's control plane:

* ``ResidencyManager``: a bounded queue of promotion requests and one
  worker thread.  A miss in ``TorchEngine.field_stack`` whose full stack
  would not fit the device budget does not block and does not admit the
  stack past the budget: it requests a promotion here, raises ``ResidencyMiss``,
  and the executor serves the query from the host tier.  The worker then
  promotes the touched rows into a packed block pool
  (``TorchEngine._promote``), so the next query over that working set runs
  on the card.
* Coalescing: repeated misses on one stack merge their row sets into one
  pending request (a dashboard's widgets converge on one promotion); a
  ``None`` (whole-stack) request absorbs any row set; a declined promotion
  arms a cooldown, so a stack that can never fit does not spin the worker.
* Accounting: bytes a promotion has allocated on the card but not yet
  committed count against every admission check (``inflight_bytes``), so
  concurrent admissions cannot stack on top of an upload in flight.

The engine side (partial stacks, the block pool, cost-priced eviction, the
version-token commit gate) lives in ``engine.py``; this module owns only
the queue, the thread and the telemetry.  The budget bounds the engine's
stacks only: the host tier's per-fragment device mirrors
(``Fragment.device_matrix``), which the host lane reads, lie outside it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Set, Tuple

from ..util import tracing
from ..util.stats import (
    METRIC_ENGINE_HOST_FALLBACKS,
    METRIC_ENGINE_PARTIAL_PROMOTIONS,
    METRIC_ENGINE_PROMOTED_BYTES,
    METRIC_ENGINE_PROMOTIONS,
    METRIC_ENGINE_PROMOTIONS_DECLINED,
    REGISTRY,
)

Key = Tuple[str, str, str]  # (index, field, view)

# Seconds a key stays unrequestable after a DECLINED promotion: the stack
# cannot fit even partially, so re-requesting it per query would only burn
# the worker; the host tier keeps serving meanwhile.
DECLINE_COOLDOWN = 5.0

# Distinct keys queued at once: a scan over thousands of cold fields must
# not grow an unbounded backlog; past it, misses stay on the host tier
# until the queue drains.
MAX_PENDING = 64


class ResidencyManager:
    """The promotion queue and its worker, one per TorchEngine."""

    def __init__(self, engine):
        self._engine = engine
        self._cv = threading.Condition()
        # key -> [rows, cause, trace_id]: rows is the requested row set, or
        # None for the whole stack (aggregates: BSI planes, TopN candidates,
        # GroupBy fields), which absorbs any row set merged into it.  The
        # first cause wins a merge and the first non-empty trace id is kept.
        self._pending: Dict[Key, list] = {}
        # key -> (deadline, the declined request was for the whole stack): a
        # declined FULL promotion does not absorb later row-hinted requests
        # (the working set may fit where the whole stack never will); a
        # declined PARTIAL one means the budget is too small for any of it.
        self._cooldown: Dict[Key, tuple] = {}
        self._inflight_bytes = 0
        self._busy = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # Telemetry, mirrored to the pilosa_engine_* series.
        self.requests = 0  # requests queued or merged into a pending one
        self.promotions = 0
        self.partial_promotions = 0
        self.declined = 0
        self.dropped = 0  # requests past MAX_PENDING (the host tier serves)
        self.advisor_deferred = 0  # speculative requests refused under backlog
        self.promoted_bytes = 0
        self.promote_seconds = 0.0
        self._c_full: Dict[str, object] = {}
        self._c_partial = REGISTRY.counter(METRIC_ENGINE_PARTIAL_PROMOTIONS)
        self._c_declined = REGISTRY.counter(METRIC_ENGINE_PROMOTIONS_DECLINED)
        self._c_bytes = REGISTRY.counter(METRIC_ENGINE_PROMOTED_BYTES)
        self._c_fallbacks = REGISTRY.counter(METRIC_ENGINE_HOST_FALLBACKS)

    # -- request side (the engine's miss paths) ------------------------------

    def request(self, key: Key, rows: Optional[Set[int]] = None, cause: str = "reactive",
                trace_id: Optional[str] = None) -> bool:
        """Queue (or merge into) a promotion of ``key``: ``rows`` is the
        row-id working set the query touched, None the whole stack.
        ``cause`` labels its origin ("reactive" | "warm_start" | "advisor")
        and ``trace_id`` joins it to the query's trace (by default the
        ambient span's).  False when a cooldown or the queue bound absorbed
        it (the host tier serves either way).  Never waits on the card."""
        if trace_id is None:
            span = tracing.current_span()
            trace_id = span.trace_id if span is not None else ""
        with self._cv:
            if self._closed:
                return False
            now = time.monotonic()
            cd = self._cooldown.get(key)
            if cd is not None:
                deadline, full_decline = cd
                if deadline > now and not (full_decline and rows is not None):
                    return False
                del self._cooldown[key]
            cur = self._pending.get(key)
            if cur is not None:
                if rows is None:
                    cur[0] = None
                elif cur[0] is not None:
                    cur[0].update(rows)
                if not cur[2] and trace_id:
                    cur[2] = trace_id
                if cause != "advisor" and cur[1] == "advisor":
                    # A demand miss caught up with speculation: the merged
                    # promotion is demand now (worker order and journal).
                    cur[1] = cause
            else:
                if cause == "advisor" and len(self._pending) >= MAX_PENDING // 2:
                    # Speculative requests get the queue's front half only:
                    # under backlog promote-ahead yields before it can crowd
                    # out a demand promotion.
                    self.advisor_deferred += 1
                    return False
                if len(self._pending) >= MAX_PENDING:
                    self.dropped += 1
                    return False
                self._pending[key] = [None if rows is None else set(rows), cause, trace_id]
            self.requests += 1
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="residency-promote",
                                                daemon=True)
                self._thread.start()
            self._cv.notify()
            return True

    def _full_counter(self, cause: str):
        c = self._c_full.get(cause)
        if c is None:
            c = self._c_full[cause] = REGISTRY.counter(METRIC_ENGINE_PROMOTIONS, cause=cause)
        return c

    def note_host_fallback(self):
        """One query served from the host tier while its stack promotes."""
        self._c_fallbacks.inc()

    # -- admission accounting ------------------------------------------------

    def inflight_bytes(self) -> int:
        """Device bytes promotions have allocated but not yet committed."""
        with self._cv:
            return self._inflight_bytes

    def add_inflight(self, n: int):
        with self._cv:
            self._inflight_bytes += int(n)

    def sub_inflight(self, n: int):
        with self._cv:
            self._inflight_bytes = max(0, self._inflight_bytes - int(n))

    # -- worker --------------------------------------------------------------

    def _run(self):
        device = getattr(self._engine, "device", None)
        if getattr(device, "type", None) == "cuda" and device.index is not None:
            # The current device is per thread: promote on the engine's card.
            import torch

            torch.cuda.set_device(device.index)
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                # Demand first: a speculative (advisor) promotion runs only
                # when no reactive or warm-start request waits, so
                # promote-ahead competes for budget, never for the worker.
                key = next((k for k, v in self._pending.items() if v[1] != "advisor"), None)
                if key is None:
                    key = next(iter(self._pending))
                rows, cause, trace_id = self._pending.pop(key)
                self._busy = True
            try:
                t0 = time.perf_counter()
                try:
                    outcome, shipped = self._engine._promote(key, rows, cause=cause,
                                                             trace_id=trace_id)
                except Exception as e:  # noqa: BLE001 — the worker survives
                    self._engine._log(f"residency promote {key}: {e!r}")
                    outcome, shipped = "declined", 0
                self.promote_seconds += time.perf_counter() - t0
                if shipped:
                    self.promoted_bytes += shipped
                    self._c_bytes.inc(shipped)
                if outcome == "full":
                    self.promotions += 1
                    self._full_counter(cause).inc()
                elif outcome == "partial":
                    self.partial_promotions += 1
                    self._c_partial.inc()
                elif outcome == "declined":
                    self.declined += 1
                    self._c_declined.inc()
                    with self._cv:
                        self._cooldown[key] = (time.monotonic() + DECLINE_COOLDOWN, rows is None)
                # "skipped": resident already, or the index went away.
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    # -- lifecycle and introspection -----------------------------------------

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until the queue is drained and the worker idle; False on
        timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "requests": self.requests,
                "pendingPromotions": len(self._pending),
                "inflightBytes": self._inflight_bytes,
                "busy": self._busy,
                "promotions": self.promotions,
                "partialPromotions": self.partial_promotions,
                "declined": self.declined,
                "dropped": self.dropped,
                "advisorDeferred": self.advisor_deferred,
                "promotedBytes": self.promoted_bytes,
                "promoteSeconds": round(self.promote_seconds, 6),
                "cooldowns": len(self._cooldown),
            }

    def close(self):
        """Stop the worker: pending requests are dropped, a promotion in
        progress finishes (its commit sees the closed engine)."""
        with self._cv:
            self._closed = True
            self._pending.clear()
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=30)
