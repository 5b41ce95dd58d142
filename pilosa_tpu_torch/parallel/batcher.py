"""Cross-request Count micro-batcher: a bounded multi-batch pipeline.

The count lane of ``pilosa_tpu/parallel/batcher.py``.  The reference
(Pilosa) amortizes small queries with goroutines over shared mmap'd
fragments; on the card the amortization has to happen before the launch:
every Count pays a fixed host floor (lowering, a launch, a blocking
readback), so 100 concurrent Counts run one launch each would pay 100
floors.  This batcher drains concurrent arrivals into ONE
``TorchEngine.count_many_async`` call — one K5 launch
(``kernels.count_batch_tree``) and one readback for K answers.

Stages, each with its own worker loop, and a bounded number of batches in
flight:

  accumulate  ``submit``/``submit_async`` queue arrivals; the drain worker
              gives concurrent arrivals a short window to pile into one
              drain (``count-batch-drain``)
  dispatch    the drain is grouped by index (K5 takes its programs as
              data, so one launch holds any mix of trees); the dispatch
              worker (``count-batch-dispatch``) lowers and launches each
              group without waiting for the card (under the
              engine lock, so a write's scatter never lands between a
              batch's plan and its launch), then queues the answer's copy
              into a pinned host buffer of its own on the launching stream
              and records an event after it
  collect     a pool of ``count-batch-collect-N`` workers wait on that
              event, decode the answers, store them in the result memo and
              resolve the submitters' futures (completion callbacks run
              here)

The in-flight depth is bounded by a semaphore (``max_inflight``, default
DEFAULT_INFLIGHT, env PILOSA_PIPELINE_DEPTH): the dispatch worker blocks
on the (depth+1)'th batch, so under overload the queue accumulates and the
batch size follows the load.  Each in-flight batch owns one of
``max_inflight`` pinned readback buffers, returned to the pool only after
its event completed.  Per-stage timings, the in-flight depth and batch
occupancy are kept in a ``util.stats.PipelineStats`` (``pipeline``).

Policy: a lone query runs on its own thread with no added latency (the
direct path, exactly the unbatched Count); concurrent queries batch.

The aggregate lane (``submit_op``): Sum/Min/Max/TopN/GroupBy items queue
beside the Counts.  ``_plan_drain`` pools every aggregate of a drain, and
every Count that shares a Row subtree with one, over all indexes, into one
``fused`` group (``TorchEngine.fused_drain_async``: one F1 per index and
the edges' kernels, each shared mask evaluated once); a fused group of one
is a ``solo`` group on the op's own program; the other Counts keep the
count lane.  A fused or solo group's outputs come back in one copy.

Every item captures its submitter's query plan (``util/plans.py``), and
each stage stamps it as the reference's stages do
(``pilosa_tpu/parallel/batcher.py:298-346, 414-425, 589-920``): the memo
outcome at submit, the queue wait, the engine's dispatch note fanned out
to every rider (bytes divided by each rider's footprint share), and the
device seconds from the host clock around the dispatch and the readback.
An item also carries the submit origin of the thread that queued it
(``set_submit_origin``; process mode's frame drains set it per worker),
so ``cross_worker_fused_batches`` counts batches whose riders came
through different worker processes.
A Count whose tree holds a BSI range leaf joins a drain like any other:
K5 evaluates its range leaves in the same launch.
"""

from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import re
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..util import plans as plans_mod
from ..util.stats import PipelineStats
from . import fusion
from . import kernels
from .engine import UnsupportedLowering, _Lowering

# Submission-origin tag (process mode): the device owner's frame drain
# stamps its worker's identity here before it submits that worker's
# queries, so every item carries it and the dispatch loop can count
# batches whose riders arrived through DIFFERENT worker processes.  None
# (the in-process reactor, a direct API call) contributes nothing.
_ORIGIN = threading.local()


def set_submit_origin(origin: Optional[str]):
    """Tag every later submit from THIS thread with ``origin``."""
    _ORIGIN.value = origin


def submit_origin() -> Optional[str]:
    return getattr(_ORIGIN, "value", None)


class _Item:
    """One submitted item, a Count tree (``kind`` "count") or an aggregate
    op (``spec``: {"kind", "field", "filter", ...}), resolved by the
    collect stage (or inline on the direct path).  ``add_done_callback``
    lets a caller resolve a pending response without parking a thread in
    ``event.wait``."""

    __slots__ = ("index", "call", "shards", "kind", "spec", "plan_extra", "event", "result",
                 "error", "t_submit", "plan", "memo_note", "memo_key", "origin", "_callbacks")

    def __init__(self, index, call, shards, kind="count", spec=None):
        self.index = index
        self.call = call
        self.shards = shards
        self.kind = kind
        self.spec = spec
        # Per-item plan-note extras from the fused planner (op name,
        # mask_shared_with, a sparse peel's fields).
        self.plan_extra = None
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        # The submitter's query plan: the stage workers stamp decisions
        # and timings onto it across the thread hops.
        self.plan = plans_mod.current_plan()
        # ("miss", reason) from submit time, merged into the plan's op.
        self.memo_note = None
        # Result-memo key computed at SUBMIT time (engine.memo_probe): the
        # collect stage stores the answer under the version tokens the
        # query began with, never newer ones.
        self.memo_key = None
        # The serving process that submitted it (None outside process mode).
        self.origin = submit_origin()
        self._callbacks: List[Callable] = []

    def done(self) -> bool:
        return self.event.is_set()

    def add_done_callback(self, fn: Callable[["_Item"], None]):
        """Run ``fn(self)`` when the item resolves (at once if it has).
        Callbacks run on the resolving thread (a collect worker): keep them
        short.  Append-then-claim over the GIL-atomic list keeps
        registration lock-free against a concurrent resolve: whichever
        side removes the callback from the list runs it."""
        self._callbacks.append(fn)
        if self.event.is_set():
            try:
                self._callbacks.remove(fn)
            except ValueError:
                return  # the resolver claimed (and ran) it
            fn(self)

    def _resolve(self):
        self.event.set()
        while self._callbacks:
            try:
                fn = self._callbacks.pop()
            except IndexError:
                break
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a bad callback must not
                pass  # poison its batchmates' completions


class CountBatcher:
    # Bail out of a wait after this long: the workers catch every
    # exception, so a hit means the engine itself wedged.
    WAIT_TIMEOUT = 300.0
    # After a real (>= 2 query) batch, keep routing arrivals through the
    # queue for this long: under sustained concurrency the direct path
    # would otherwise take the lead after every batch and put a 1-answer
    # readback between every K-answer one.  Size-1 drains do not refresh
    # it, so a lone caller's latency is untouched.
    HOT_WINDOW = 0.25
    # Accumulation window: once the queue is non-empty, concurrent
    # arrivals get this long to pile into the SAME drain, and the window
    # breaks early when arrivals go quiet (the depth stable across one
    # poll), so a lone straggler pays about one poll.  Seconds; the
    # reference's values, not yet tuned on the card.
    ACCUM_WINDOW = 0.15
    ACCUM_POLL = 0.005
    # Batches in flight at once (the pipeline depth), PILOSA_PIPELINE_DEPTH
    # or the constructor's ``max_inflight``.
    DEFAULT_INFLIGHT = 4

    def __init__(self, engine, max_batch: int = 512, max_inflight: Optional[int] = None):
        self.engine = engine
        self.max_batch = max_batch
        if max_inflight is None:
            max_inflight = int(os.environ.get("PILOSA_PIPELINE_DEPTH", self.DEFAULT_INFLIGHT))
        self.max_inflight = max(1, int(max_inflight))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Item] = []
        self._busy = False
        self._inflight = threading.Semaphore(self.max_inflight)
        self._last_fused = 0.0  # monotonic time of the last >= 2 batch
        self._workers_started = False
        self._threads: List[threading.Thread] = []
        # Grouped batches ready to dispatch, and dispatched batches
        # awaiting readback.
        self._dispatch_q: "queue_mod.Queue" = queue_mod.Queue()
        self._collect_q: "queue_mod.Queue" = queue_mod.Queue()
        # Pinned host buffers for the readbacks of batches in flight on the
        # card, one per in-flight slot, made at the first such batch.
        self._pinned: "queue_mod.Queue" = queue_mod.Queue()
        self._pinned_made = False
        # Batches dispatched but not yet collected (read lock-free by the
        # drain loop's accumulate heuristic; written under _lock).
        self._live = 0
        self.batches = 0
        self.batched_queries = 0
        self._stopped = False
        self.pipeline = PipelineStats()
        self.pipeline.gauge("depth_configured", self.max_inflight)

    # -- accumulate stage ---------------------------------------------------

    def submit(self, index: str, call, shards) -> int:
        """Count one tree; returns the count.  A result-memo hit answers
        here with no queue and no launch.  Otherwise a lone caller runs
        directly; callers arriving while a dispatch is in flight, or within
        the hot window after a batch, queue and are answered by the next
        batch."""
        probed = getattr(self.engine, "memo_probe", None) is not None
        key, hit = self._memo_probe(index, call, shards)
        memo_note = self._plan_memo_note(probed, key, hit)
        if hit is not None:
            return int(hit)
        item = self._submit(index, call, shards, allow_direct=True, memo_key=key,
                            memo_note=memo_note)
        if item is None:
            return self._direct(index, call, shards, key, probed, memo_note)
        if not item.event.wait(self.WAIT_TIMEOUT):
            raise RuntimeError("batched count timed out (engine wedged?)")
        if item.error is not None:
            raise item.error
        return item.result

    def submit_async(self, index: str, call, shards) -> _Item:
        """Queue one Count into the pipeline and return its future
        (``_Item``).  Never takes the direct path: the caller hands off
        completion, so blocking here would defeat it.  A memo hit returns
        a future that has resolved already."""
        key, hit = self._memo_probe(index, call, shards)
        memo_note = self._plan_memo_note(
            getattr(self.engine, "memo_probe", None) is not None, key, hit)
        if hit is not None:
            item = _Item(index, call, list(shards))
            item.result = int(hit)
            item._resolve()
            return item
        return self._submit(index, call, shards, allow_direct=False, memo_key=key,
                            memo_note=memo_note)

    def submit_op(self, index: str, kind: str, spec: dict, shards):
        """One aggregate op (sum/min/max/topn/topnf/group) through the batch
        lane: a lone caller runs the op's own program directly (no added
        latency); callers arriving while the pipe is busy queue into the
        drain, where the planner fuses them with their drain-mates.
        Returns the op's result; raises the item's own error."""
        key, hit = self.engine.memo_probe_op(index, kind, spec, shards)
        if hit is not None:
            plan = plans_mod.current_plan()
            if plan is not None:
                plan.note_op(op=fusion.OP_NAMES.get(kind, kind), path="memo", memo="hit")
            return hit
        item = self._submit(index, None, shards, allow_direct=True, memo_key=key,
                            kind=kind, spec=spec)
        if item is None:
            return self._direct_op(index, kind, spec, shards, key)
        if not item.event.wait(self.WAIT_TIMEOUT):
            raise RuntimeError("batched op timed out (engine wedged?)")
        if item.error is not None:
            raise item.error
        return item.result

    def _direct_op(self, index, kind, spec, shards, memo_key=None):
        t0 = time.monotonic()
        try:
            out = self.engine.solo_op(index, kind, spec, shards)
            if memo_key is not None:
                self.engine.memo_store_op(memo_key, kind, spec, out)
            return out
        finally:
            note = plans_mod.take_dispatch_note()
            plan = plans_mod.current_plan()
            if plan is not None:
                d = dict(note) if note else {}
                d.setdefault("op", fusion.OP_NAMES.get(kind, kind))
                d.setdefault("path", "direct")
                plan.note_op(**d)
                elapsed = time.monotonic() - t0
                plan.note_stage("execute", elapsed)
                plan.note_device_seconds(elapsed)
            with self._lock:
                self._busy = False
                if self._queue:
                    self._cond.notify_all()

    def _plan_memo_note(self, probed: bool, key, hit):
        """Record the memo outcome on the SUBMIT thread, where the plan is
        ambient: a hit is a whole op record (no dispatch follows); a miss
        becomes a ("miss", reason) note merged into the op the dispatch
        fan-out records."""
        plan = plans_mod.current_plan()
        if plan is None or not probed:
            return None
        if hit is not None:
            plan.note_op(op="Count", path="memo", memo="hit")
            return None
        reason = "ineligible"
        if key is not None:
            memo = getattr(self.engine, "result_memo", None)
            if memo is not None and hasattr(memo, "miss_reason"):
                reason = memo.miss_reason(key)
        return ("miss", reason)

    def _memo_probe(self, index, call, shards):
        """engine.memo_probe, duck-typed: the batcher also runs against
        stub engines (tests) with no result memo."""
        probe = getattr(self.engine, "memo_probe", None)
        if probe is None:
            return None, None
        return probe(index, call, shards)

    def _submit(self, index, call, shards, allow_direct: bool, memo_key=None,
                memo_note=None, kind="count", spec=None):
        with self._lock:
            hot = time.monotonic() - self._last_fused < self.HOT_WINDOW
            if allow_direct and not self._busy and not self._queue and not hot:
                self._busy = True
                return None  # the caller runs the direct path
            item = _Item(index, call, list(shards), kind=kind, spec=spec)
            item.memo_key = memo_key
            item.memo_note = memo_note
            self._queue.append(item)
            self._ensure_workers()
            # Wake the drain worker on the empty -> non-empty transition
            # only (it polls while it accumulates).
            if len(self._queue) == 1:
                self._cond.notify_all()
        return item

    def _direct(self, index, call, shards, memo_key=None, probed=False,
                memo_note=None) -> int:
        t0 = time.monotonic()
        try:
            if probed:
                # submit() probed (and missed): hand the key through so the
                # engine stores the result without a second key walk.
                return self.engine.count(index, call, shards, memo_key=memo_key)
            return self.engine.count(index, call, shards)
        finally:
            # The engine published its dispatch decisions to this thread's
            # note; the whole blocking launch and readback is this query's
            # one "execute" stage and its device attribution.
            note = plans_mod.take_dispatch_note()
            plan = plans_mod.current_plan()
            if plan is not None:
                d = dict(note) if note else {"op": "Count", "path": "direct"}
                if memo_note is not None:
                    d["memo"], d["memo_reason"] = memo_note
                plan.note_op(**d)
                elapsed = time.monotonic() - t0
                plan.note_stage("execute", elapsed)
                plan.note_device_seconds(elapsed)
            with self._lock:
                self._busy = False
                if self._queue:
                    self._cond.notify_all()

    def _ensure_workers(self):
        if self._workers_started:
            return
        self._workers_started = True
        self._threads = [
            threading.Thread(target=self._drain_loop, daemon=True, name="count-batch-drain"),
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="count-batch-dispatch"),
        ] + [threading.Thread(target=self._collect_loop, daemon=True,
                              name=f"count-batch-collect-{i}") for i in range(self.max_inflight)]
        for t in self._threads:
            t.start()

    def stop(self, timeout: float = 10.0):
        """Shut the stage workers down and wait for them to exit.  Queued
        items resolve before the workers exit; a submit after stop() would
        wait forever, so stop only a batcher the engine no longer hands
        out."""
        self._stopped = True
        with self._lock:
            self._cond.notify_all()
        if self._workers_started:
            self._dispatch_q.put(None)
            for _ in range(self.max_inflight):
                self._collect_q.put(None)
            deadline = time.monotonic() + timeout
            for t in self._threads:
                if t is not threading.current_thread():
                    t.join(max(0.0, deadline - time.monotonic()))

    # -- drain stage (accumulate -> grouped batches) ------------------------

    def _drain_loop(self):
        while not self._stopped:
            with self._lock:
                while not self._queue:
                    if self._stopped:
                        return
                    self._cond.wait(timeout=60.0)
                depth0 = len(self._queue)
            # A lone queued query in an IDLE pipe (no batch in flight,
            # outside the hot window) dispatches at once.  With a batch in
            # flight, waiting costs it nothing (it could not go ahead of
            # that batch) and lets its peers pile in; without this, load
            # that arrives one at a time between wakeups would never
            # start the first batch.
            if depth0 > 1 or self._live > 0 or (
                time.monotonic() - self._last_fused < self.HOT_WINDOW
            ):
                deadline = time.monotonic() + self.ACCUM_WINDOW
                prev = -1
                while time.monotonic() < deadline:
                    with self._lock:
                        depth = len(self._queue)
                    if depth >= self.max_batch or depth == prev:
                        break  # a full drain, or arrivals went quiet
                    prev = depth
                    time.sleep(self.ACCUM_POLL)
            with self._lock:
                batch = self._queue[: self.max_batch]
                del self._queue[: len(batch)]
            for group in self._plan_drain(batch):
                self._dispatch_q.put(group + (False,))

    def _plan_drain(self, batch):
        """Group one drain: every aggregate item, and every Count that shares
        a Row subtree with an aggregate of its index (the dashboard shape:
        one segment filter fanned into N widgets), pooled over all indexes
        into ONE ``fused`` group; a fused group of one is ``solo`` (the op's
        own program); the remaining Counts one ``count`` group per index.
        The reference splits those Counts by ``_signature``, because XLA
        compiles one program per structure; K5 takes any mix of trees in
        one launch."""
        groups = []
        fused_all: list = []
        by_index: dict = {}
        for it in batch:
            by_index.setdefault(it.index, []).append(it)
        for index, items in by_index.items():
            aggs = [it for it in items if it.kind != "count"]
            counts = [it for it in items if it.kind == "count"]
            if aggs:
                agg_texts = set()
                for it in aggs:
                    agg_texts |= fusion.item_texts(it.spec)
                fused_all.extend(aggs)
                rest = []
                for it in counts:
                    (fused_all if agg_texts & fusion.subtree_texts(it.call) else rest).append(it)
                counts = rest
            if counts:
                groups.append(("count", index, counts))
        if len(fused_all) == 1:
            groups.append(("solo", fused_all[0].index, fused_all))
        elif fused_all:
            groups.append(("fused", None, fused_all))  # the items carry their indexes
        return groups

    # -- dispatch stage -----------------------------------------------------

    def _dispatch_loop(self):
        device = getattr(self.engine, "device", None)
        if isinstance(device, torch.device) and device.type == "cuda" and device.index is not None:
            # The current device is per thread: launch on the engine's
            # card (an engine on plain "cuda" runs on device 0, every new
            # thread's current device), on its default stream.
            torch.cuda.set_device(device.index)
        while True:
            got = self._dispatch_q.get()
            if got is None:
                return  # stop() sentinel
            gkind, index, items, retried = got
            # Blocks while ``max_inflight`` batches are in the pipe: the
            # backpressure that lets the accumulate stage size batches.
            self._inflight.acquire()
            with self._lock:
                self._live += 1
            self.pipeline.add_delta("inflight", 1)
            if not retried:
                now = time.monotonic()
                # One wait per distinct plan: a query whose Counts ride as
                # several items waits once, its longest.
                plan_wait: dict = {}
                for it in items:
                    self.pipeline.record("queue_wait", now - it.t_submit)
                    if it.plan is not None:
                        wait = now - it.t_submit
                        prev = plan_wait.get(id(it.plan))
                        if prev is None or wait > prev[1]:
                            plan_wait[id(it.plan)] = (it.plan, wait)
                for plan, wait in plan_wait.values():
                    plan.note_stage("queue_wait", wait)
            decoders = None
            weights = None
            try:
                t0 = time.monotonic()
                if gkind == "count":
                    dev = self.engine.count_many_async(
                        index, [it.call for it in items], [it.shards for it in items])
                    readback = self._start_readback(dev, len(items))
                else:
                    if gkind == "fused":
                        fd = self.engine.fused_drain_async([
                            (it.index, it.spec if it.spec is not None
                             else {"kind": "count", "call": it.call}, it.shards)
                            for it in items])
                        live, decoders, weights = [], [], []
                        for it, err, dec, w, note in zip(items, fd.errors, fd.decoders,
                                                         fd.weights, fd.item_notes):
                            if err is not None:
                                it.error = err
                                it._resolve()
                            else:
                                it.plan_extra = note
                                live.append(it)
                                decoders.append(dec)
                                weights.append(w)
                        items = live
                        dev, layout = fd.dev, fd.layout
                    else:  # solo: one aggregate on its own program
                        it0 = items[0]
                        tensors, dec = self.engine.solo_op_async(it0.index, it0.kind, it0.spec,
                                                                 it0.shards)
                        decoders = [dec]
                        dev, layout = (None, None) if tensors is None else fusion.pack(
                            tensors, self.engine.device)
                    readback = (None if dev is None else self._start_readback_bytes(dev),
                                layout)
                t1 = time.monotonic()
                note = plans_mod.take_dispatch_note()
                if note is None and gkind == "solo":
                    # The per-op programs publish no note of their own:
                    # name the lane, so the plan still says which ran.
                    note = {"op": fusion.OP_NAMES.get(items[0].kind, items[0].kind),
                            "path": "solo"}
                self._stamp_plans(items, note, t1 - t0, weights)
                self.pipeline.record("lower_dispatch", t1 - t0)
            except BaseException as batch_err:  # noqa: BLE001 — the loop must
                # survive anything: a dead dispatch worker would wedge every
                # later submit at WAIT_TIMEOUT.
                # A failed dispatch may have half-written its plan note:
                # clear it, so the next batch on this thread starts clean.
                plans_mod.take_dispatch_note()
                with self._lock:
                    self._live -= 1
                self.pipeline.add_delta("inflight", -1)
                self._inflight.release()
                self._handle_batch_failure(index, items, retried, batch_err, gkind)
                continue
            self.batches += 1
            self.batched_queries += len(items)
            self.pipeline.incr("batches")
            self.pipeline.incr("batched_queries", len(items))
            self.pipeline.gauge_max("max_batch_occupancy", len(items))
            if len(items) >= 2:
                self.pipeline.incr("fused_batches")
                self.pipeline.incr("fused_queries", len(items))
                self._last_fused = time.monotonic()
                # Process mode: a batch whose riders came through DIFFERENT
                # worker processes is the cross-process coalescing evidence.
                origins = {it.origin for it in items if it.origin}
                if len(origins) >= 2:
                    self.pipeline.incr("cross_worker_fused_batches")
            if gkind == "fused":
                # Heterogeneous drains launched as fused programs.
                self.pipeline.incr("fused_program_batches")
                self.pipeline.incr("fused_program_queries", len(items))
            self._collect_q.put((readback, items, time.monotonic(), decoders, weights))

    def _start_readback_bytes(self, dev):
        """A fused or solo group's packed outputs (``fusion.pack``): on the
        card, a non-blocking copy into a pinned buffer of their own on the
        launching stream and an event after it; a CPU buffer as it is."""
        if not dev.is_cuda:
            return dev, None
        host = torch.empty(dev.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev.device))
        return host, ev

    def _start_readback(self, dev, n: int):
        """Queue the copy of a batch's answers to the host without waiting:
        for a tensor on the card, a non-blocking copy into a pinned buffer
        of this batch's own on the launching stream, and an event after it
        that the collect worker waits on.  Anything else (a CPU tensor, a
        test's stub) is read by the collect worker as it is."""
        if not (isinstance(dev, torch.Tensor) and dev.is_cuda):
            return (None, dev, None)
        if not self._pinned_made:
            self._pinned_made = True
            for _ in range(self.max_inflight):
                self._pinned.put(torch.empty(self.max_batch, dtype=torch.int64, pin_memory=True))
        # One buffer per in-flight slot, and this batch holds a slot: one
        # is free (a collect worker returns its buffer before the slot).
        buf = self._pinned.get()
        host = buf[:n]
        host.copy_(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev.device))
        return (buf, host, ev)

    def _handle_batch_failure(self, index, items: List[_Item], retried, batch_err,
                              gkind="count"):
        """One bad item (an unknown field, a missing row argument) must not
        fail its batchmates, and a serial retry per item would stall the
        pipeline.  Split FAST instead: probe each item's LOWERING (host
        work, no launch) to find the culprits, then re-enqueue the rest as
        ONE group, marked ``retried`` so that a failure of the launch itself
        cannot loop.  The failed group's in-flight slot is released before
        this runs: re-enqueueing while holding it would deadlock a depth-1
        pipeline."""
        if retried:
            for it in items:
                if it.error is None:
                    it.error = batch_err
                it._resolve()
            return
        good = []
        # Probe mode: an item whose stack missed was counted once already,
        # when the batch raised; its ResidencyMiss goes back to its caller,
        # who serves it from the host lane.
        probe = getattr(self.engine, "probe_residency", contextlib.nullcontext)
        for it in items:
            try:
                with probe():
                    if it.kind == "count":
                        self._probe_lowering(it)
                    else:
                        self.engine.probe_fused_item(it.index, it.spec, it.shards)
                plans_mod.take_dispatch_note()  # probe leftovers: discard
                good.append(it)
            except Exception as e:  # noqa: BLE001
                # The probe may have noted WHY the item failed (the
                # residency layer's host_fallback): fan it onto the item's
                # plan, though the answer comes from the host lane.
                note = plans_mod.take_dispatch_note()
                if it.plan is not None and note is not None:
                    it.plan.note_op(**plans_mod.rider_note(note, 1))
                it.error = e
                it._resolve()
        if good and len(good) < len(items):
            if gkind == "fused" and len(good) == 1:
                # A fused group that shrank to one takes that item's own lane.
                gkind = "count" if good[0].kind == "count" else "solo"
                index = good[0].index
            self._dispatch_q.put((gkind, index, good, True))
        else:
            # Nothing attributable (a failure of the launch itself): fail
            # the whole group with the batch's error.
            for it in good or items:
                if it.error is None:
                    it.error = batch_err
                it._resolve()

    @staticmethod
    def _stamp_plans(items: List[_Item], note, lower_seconds: float, weights=None):
        """Fan the engine's dispatch note out to every rider's plan.  Byte
        tallies divide by each rider's footprint share where the fused
        planner measured one (``weights``), evenly otherwise; the
        planner's per-item extras overlay the shared note."""
        if note is None:
            return
        n = len(items)
        total_w = sum(weights) if weights else 0.0
        staged = set()
        for i, it in enumerate(items):
            if it.plan is None:
                continue
            frac = (weights[i] / total_w) if total_w else None
            d = plans_mod.rider_note(note, n, frac=frac)
            if it.plan_extra is not None:
                d.update(it.plan_extra)
                if frac is not None:
                    d["fused_cost_frac"] = round(frac, 4)
            if it.memo_note is not None:
                d["memo"], d["memo_reason"] = it.memo_note
            it.plan.note_op(**d)
            # One lower_dispatch stamp per distinct plan.
            if id(it.plan) not in staged:
                staged.add(id(it.plan))
                it.plan.note_stage("lower_dispatch", lower_seconds)

    def _probe_lowering(self, it: _Item):
        """Lower one item's tree as its batch would, and raise what its
        lowering raises."""
        eng = self.engine
        lw = _Lowering(eng, eng.canonical_shards(it.index))
        if hasattr(eng, "_collect_row_hints"):
            lw.row_hints = eng._collect_row_hints(it.index, it.call)
        prog = eng._lower(it.index, it.call, lw)
        if not kernels.fits(prog):
            raise UnsupportedLowering("count tree exceeds the kernels' limits")

    # -- collect stage ------------------------------------------------------

    def _collect_loop(self):
        while True:
            got = self._collect_q.get()
            if got is None:
                return  # stop() sentinel
            readback, items, t_dispatched, decoders, weights = got
            buf = None
            try:
                if decoders is None:  # the count lane: int64[K]
                    buf, host, ev = readback
                    if ev is not None:
                        ev.synchronize()
                        out = host.tolist()
                        self._pinned.put(buf)
                        buf = None
                    else:
                        out = np.asarray(host).tolist()
                else:  # fused or solo: packed outputs, or None (no launch)
                    (got_bytes, layout) = readback
                    parts = None
                    if got_bytes is not None:
                        host, ev = got_bytes
                        if ev is not None:
                            ev.synchronize()
                        parts = fusion.unpack(host.numpy(), layout)
                t_ready = time.monotonic()
                self.pipeline.record("device_readback", t_ready - t_dispatched)
                for i, it in enumerate(items):
                    it.result = int(out[i]) if decoders is None else decoders[i](parts)
                    # Store under the tokens read at submit time
                    # (engine.memo_probe's ordering note).
                    if it.memo_key is not None:
                        if it.kind == "count":
                            self.engine.memo_store(it.memo_key, it.result, call=it.call)
                        else:
                            self.engine.memo_store_op(it.memo_key, it.kind, it.spec, it.result)
                t_done = time.monotonic()
                self.pipeline.record("decode", t_done - t_ready)
                # Device-cost attribution from the host clock: the batch
                # held its slot for the readback window; each rider pays
                # its footprint share, or an even one.
                window = t_ready - t_dispatched
                total_w = sum(weights) if weights else 0.0
                staged = set()
                for i, it in enumerate(items):
                    if it.plan is None:
                        continue
                    if id(it.plan) not in staged:
                        staged.add(id(it.plan))
                        it.plan.note_stage("device_readback", window)
                        it.plan.note_stage("decode", t_done - t_ready)
                    it.plan.note_device_seconds(
                        window * weights[i] / total_w if total_w
                        else window / max(1, len(items)))
            except BaseException as e:  # noqa: BLE001
                for it in items:
                    it.error = e
            finally:
                if buf is not None:
                    self._pinned.put(buf)
                with self._lock:
                    self._live -= 1
                self.pipeline.add_delta("inflight", -1)
                self._inflight.release()
                for it in items:
                    it._resolve()

    # -- signatures / telemetry ---------------------------------------------

    @staticmethod
    def _signature(index, call) -> tuple:
        """The reference's batch-group key: the index and the call tree
        with integer LITERALS masked, so that Counts of one structure
        (field names, operators, nesting) share a group whatever rows they
        ask for.  The count lane here groups by index alone (K5 takes any
        mix of trees, and F1 its slot table as data), so nothing keys on
        it; it stays as the reference's vocabulary.

        Only digits in ARGUMENT position (after '=', '(', ',', '[', '<',
        '>' or whitespace) are masked: digit runs inside identifiers are
        structure, so ``Row(f1=3)`` and ``Row(f2=3)`` stay apart.
        Timestamp literals (segments touching '-', ':' or 'T') are not
        masked: a time Range covers different views per span."""

        def mask(m):
            s, e = m.start(), m.end()
            ctx = m.string[max(0, s - 1): e + 1]
            if "-" in ctx or ":" in ctx or "T" in ctx:
                return m.group()
            return "#"

        return (index, re.sub(r"(?<=[=(,\[<>\s])\d+", mask, str(call)))

    def pipeline_snapshot(self) -> dict:
        """Stage timings, depth gauges and occupancy."""
        snap = self.pipeline.snapshot()
        snap["depth"] = self.max_inflight
        snap["batches"] = self.batches
        snap["batchedQueries"] = self.batched_queries
        snap["avgOccupancy"] = (
            round(self.batched_queries / self.batches, 2) if self.batches else 0.0)
        return snap
