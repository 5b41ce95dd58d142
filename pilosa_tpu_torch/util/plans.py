"""Query plan introspection + per-tenant device-cost attribution.

A copy of ``pilosa_tpu/util/plans.py`` (stdlib only), so that a plan of
the port and one of the reference hold the same fields and the same
analyzer notes.  The plan's device seconds come from the host clock
around each dispatch, as in the reference: nothing here synchronizes the
card.

Every executed query records a structured ``QueryPlan`` capturing the
decisions the engine ACTUALLY took — sparse vs dense path, occupancy
blocks surviving vs total, bytes touched vs skipped, batch-CSE dedup,
result-memo status (and WHY a miss missed), tier padding, fan-out with
per-node latencies — plus per-pipeline-stage
timing attribution and the query's device-seconds share of each fused
dispatch.  The aggregate histograms at /metrics say THAT p99 spiked;
the plan says WHY this query was slow (docs/observability.md "Query
plans & cost attribution").

Three surfaces feed off the same records:

* ``?profile=1`` on POST /index/{i}/query returns the plan inline in
  the response (and the PQL ``Explain(...)`` call plans WITHOUT
  dispatching);
* ``GET /debug/plans`` serves a bounded recent ring plus a slow-query
  analyzer that auto-retains the worst plans per op-type and annotates
  why they were slow ("dense fallback: occupancy 92%", "memo miss:
  version token advanced", "remote fan-out: 2/8 shards non-local");
* a per-tenant resource ledger (device-seconds, bytes touched, queries,
  sheds) exported as ``pilosa_tenant_*`` and fed back to the admission
  controller, so weighted-fair shares are judged against MEASURED cost
  rather than request count.

Recording is always-on and built to vanish in the noise (<2% on the
count_intersect p50, measured by the replay estimator of
``chip_smoke.py``'s procmode phase):
plans are append-only lists of small dicts, the engine->batcher seam is
one thread-local dict per DISPATCH (not per query), and the analyzer
runs only at record time.  ``PILOSA_PLANS=0`` disables the whole layer.

Thread model: mirrors util/tracing.py.  The plan rides a module-level
thread-local slot (``current_plan``/``attach``) captured explicitly at
batcher-submit time and re-attached nowhere — worker threads stamp the
captured reference directly (QueryPlan is append-only, so cross-thread
stamps need no lock).  Engine dispatch code publishes its decisions to
a thread-local *dispatch note* (``note_dispatch``); whoever drove the
dispatch on that thread (the batcher's dispatch worker, the direct
path, the consecutive-Count batch) takes the note and fans it out to
the plans of every query that rode the dispatch.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .stats import (
    METRIC_CACHE_ENTRIES,
    METRIC_CACHE_RECALC,
    METRIC_TENANT_BYTES_SKIPPED,
    METRIC_TENANT_BYTES_TOUCHED,
    METRIC_TENANT_DEVICE_SECONDS,
    METRIC_TENANT_QUERIES,
    METRIC_TENANT_SHEDS,
    REGISTRY,
)

# Kill switch for the whole layer (the profile-overhead estimator
# measures the delta; operators can flip it on a pathological workload).
ENABLED = os.environ.get("PILOSA_PLANS", "1") != "0"

_TLS = threading.local()


def current_plan() -> Optional["QueryPlan"]:
    """The plan the calling thread is currently recording into, if any."""
    return getattr(_TLS, "plan", None)


class attach:
    """Make ``plan`` the calling thread's current plan for the block
    (the capture half of a thread hop is just ``current_plan()`` on the
    submitting thread).  ``attach(None)`` is a no-op block.  A slotted
    class, not a @contextmanager: this sits on the per-query hot path
    and the generator protocol costs ~2x the plain __enter__/__exit__
    pair."""

    __slots__ = ("_plan", "_prev")

    def __init__(self, plan: Optional["QueryPlan"]):
        self._plan = plan

    def __enter__(self):
        self._prev = getattr(_TLS, "plan", None)
        if self._plan is not None:
            _TLS.plan = self._plan
        return self._plan

    def __exit__(self, *exc):
        _TLS.plan = self._prev
        return False


# -- the engine -> dispatcher note seam -------------------------------------


def note_dispatch(**kw):
    """Publish dispatch-level decisions (sparse/dense path, occupancy,
    CSE, tier, bytes) to the calling thread's pending note.  The engine
    calls this inside its dispatch closures; the thread that DROVE the
    dispatch (batcher worker or direct-path caller) takes the note when
    the call returns and stamps it onto every rider's plan.  One dict
    update per device dispatch — not per query."""
    if not ENABLED:
        return
    d = getattr(_TLS, "note", None)
    if d is None:
        d = _TLS.note = {}
    d.update(kw)


def take_dispatch_note() -> Optional[dict]:
    """Claim (and clear) the calling thread's pending dispatch note."""
    d = getattr(_TLS, "note", None)
    if d is not None:
        _TLS.note = None
    return d


def rider_note(note: dict, riders: int, frac: Optional[float] = None) -> dict:
    """A dispatch note copied for ONE of ``riders`` co-dispatched
    queries: batch-level byte tallies are divided — by the rider's
    measured footprint fraction ``frac`` when the fused planner supplied
    one (a 1-mask Count rider must not be charged for an 8-plane Sum
    neighbor's sweep), evenly otherwise — while decision fields (path,
    CSE, tier, occupancy) are copied whole.  The single point of change
    for per-rider-divided note fields (the batcher's fused batch and
    the executor's consecutive-Count batch both fan notes out through
    here)."""
    d = dict(note)
    for k in ("bytes_touched", "bytes_skipped"):
        if k in d:
            if frac is not None:
                d[k] = int(int(d[k]) * frac)
            else:
                d[k] = int(d[k]) // max(1, riders)
    return d


class QueryPlan:
    """One query's structured execution record.  Append-only by design:
    stage stamps arrive from the batcher's dispatch/collect workers
    while op stamps arrive from the submit thread, so every mutation is
    a single list.append (GIL-atomic) and readers aggregate at
    ``to_dict`` time."""

    __slots__ = (
        "index",
        "query",
        "tenant",
        "profile",
        "trace_id",
        "start_wall",
        "duration",
        "ops",
        "_stage_events",
        "fanouts",
        "annotations",
        "pipelined",
    )

    def __init__(self, index: str, query: str, tenant: str = "default",
                 profile: bool = False):
        self.index = index
        self.query = str(query)[:512]
        self.tenant = tenant or "default"
        self.profile = profile
        self.trace_id: Optional[str] = None
        self.start_wall = time.time()
        self.duration: Optional[float] = None
        # Per-op decision records: {"op": "Count", "path": "sparse", ...}
        self.ops: List[dict] = []
        # (stage, seconds) events; "device" entries carry this query's
        # attributed share of a fused dispatch's device time.
        self._stage_events: List[tuple] = []
        # (node_id, seconds, n_shards) per remote peer RPC.
        self.fanouts: List[tuple] = []
        self.annotations: List[str] = []
        self.pipelined = False

    # -- stamping (hot path: appends only) ---------------------------------

    def note_op(self, **kw):
        self.ops.append(kw)

    def note_stage(self, stage: str, seconds: float):
        self._stage_events.append((stage, seconds))

    def note_device_seconds(self, seconds: float):
        self._stage_events.append(("device", seconds))

    def note_fanout(self, node_id: str, seconds: float, n_shards: int):
        self.fanouts.append((node_id, seconds, n_shards))

    def finish(self, duration: float, trace_id: Optional[str] = None):
        self.duration = duration
        if trace_id is not None:
            self.trace_id = trace_id

    # -- aggregation --------------------------------------------------------

    @property
    def device_seconds(self) -> float:
        return sum(s for st, s in self._stage_events if st == "device")

    def tallies(self):
        """(device_seconds, bytes_touched, bytes_skipped) in one pass: the
        ledger's per-query read, on the completion thread."""
        dev = 0.0
        for st, sec in self._stage_events:
            if st == "device":
                dev += sec
        touched = skipped = 0
        for o in self.ops:
            if "bytes_touched" in o:
                touched += int(o["bytes_touched"])
            if "bytes_skipped" in o:
                skipped += int(o["bytes_skipped"])
        return dev, touched, skipped

    @property
    def bytes_touched(self) -> int:
        return sum(int(o.get("bytes_touched", 0)) for o in self.ops)

    @property
    def bytes_skipped(self) -> int:
        return sum(int(o.get("bytes_skipped", 0)) for o in self.ops)

    def stages(self) -> Dict[str, float]:
        """Per-stage wall attribution.  Aggregation is MAX, not sum: a
        query whose Counts ride several dispatch groups gets one stamp
        per group, and those windows overlap in wall time — summing
        them reports stagesMs > durationMs and falsely trips the
        analyzer's queue-wait check.  The longest single window is the
        query's wall exposure to that stage.  (Device-cost shares are
        the separate "device" events, which DO sum — they are resource
        attribution, not wall time.)"""
        out: Dict[str, float] = {}
        for stage, s in self._stage_events:
            if stage != "device":
                prev = out.get(stage)
                if prev is None or s > prev:
                    out[stage] = s
        return out

    def primary_op(self) -> str:
        for o in self.ops:
            name = o.get("op")
            if name:
                return name
        return "Query"

    def to_dict(self) -> dict:
        """The plan tree: query -> ops -> per-op decisions, with stage
        timing attribution and fan-out latencies alongside."""
        return {
            "index": self.index,
            "query": self.query,
            "tenant": self.tenant,
            "traceID": self.trace_id,
            "startTime": self.start_wall,
            "durationMs": (
                None if self.duration is None else round(self.duration * 1e3, 3)
            ),
            "pipelined": self.pipelined,
            "deviceSeconds": round(self.device_seconds, 6),
            "bytesTouched": self.bytes_touched,
            "bytesSkipped": self.bytes_skipped,
            "stagesMs": {
                k: round(v * 1e3, 3) for k, v in self.stages().items()
            },
            "ops": list(self.ops),
            "fanouts": [
                {"node": n, "ms": round(s * 1e3, 3), "shards": k}
                for n, s, k in self.fanouts
            ],
            "annotations": list(self.annotations),
        }


# -- slow-query analyzer -----------------------------------------------------


def _pct(x: float) -> str:
    return f"{100.0 * x:.0f}%"


def analyze(plan: QueryPlan, slow: bool = False) -> List[str]:
    """Why-was-this-slow annotations, derived purely from the recorded
    decisions.  Cheap by construction — string work happens only for
    the conditions that actually hold; the registry is consulted only
    for slow TopN plans (the rank-cache maintenance linkage)."""
    notes: List[str] = []
    for op in plan.ops:
        path = op.get("path")
        if path == "dense" and "occ_fraction" in op:
            notes.append(
                f"dense fallback: occupancy {_pct(op['occ_fraction'])} "
                f"(> sparse threshold {_pct(op.get('threshold', 0.25))})"
            )
        elif path == "sparse":
            notes.append(
                "sparse path: "
                f"{op.get('blocks_surviving', '?')}/{op.get('blocks_total', '?')}"
                f" blocks, {op.get('bytes_skipped', 0)} bytes skipped"
            )
        elif path == "host_fallback":
            # Tiered residency (docs/residency.md): the stack (or the
            # rows this query touched) was not device-resident; the
            # query served from the compressed host tier while the
            # async promotion ran.
            notes.append(
                f"host fallback: stack {op.get('stack', '?')} "
                f"{_pct(float(op.get('resident_fraction', 0.0)))} resident "
                "(async promotion enqueued)"
            )
        reason = op.get("memo_reason")
        if op.get("memo") == "miss" and reason == "version_token_advanced":
            notes.append("memo miss: version token advanced (write since last run)")
        elif op.get("memo") == "miss" and reason == "evicted":
            notes.append("memo miss: entry evicted (memo pressure)")
        if op.get("cse_deduped"):
            notes.append(
                f"batch CSE: {op['cse_deduped']} duplicate(s) collapsed "
                f"into {op.get('cse_unique', '?')} slot(s)"
            )
        if path == "fused_program":
            shared = int(op.get("mask_shared_with", 0) or 0)
            if shared:
                notes.append(
                    f"fused program: mask shared with {shared} other "
                    f"quer{'y' if shared == 1 else 'ies'}"
                )
            me = int(op.get("masks_evaluated", 0) or 0)
            mr = int(op.get("masks_referenced", 0) or 0)
            if mr > me > 0:
                notes.append(
                    f"fusion: {mr} mask references evaluated as {me} "
                    f"distinct masks ({mr - me} evaluation(s) saved)"
                )
            if op.get("crossIndex"):
                notes.append(
                    "cross-index drain: one fused program spans "
                    f"{int(op.get('fused_indexes', 0) or 0) or 'multiple'} "
                    "indexes"
                )
            if op.get("fusedGroupBy"):
                notes.append(
                    f"GroupBy fused: {int(op['fusedGroupBy'])} combo "
                    "count(s) as one program edge"
                )
        if op.get("topkDevice"):
            notes.append(
                f"TopN trim on-device (K={int(op['topkDevice'])})"
            )
        elif op.get("op") == "TopN" and path == "host_merge":
            notes.append(
                f"TopN host merge: {int(op.get('candidates', 0) or 0)} "
                "candidates re-ranked on host"
            )
    # Degraded-routing annotations (docs/durability.md), aggregated to
    # ONE note each — a 100-shard query on an all-DOWN owner set stamps
    # one op per shard, and 100 identical notes would drown the plan.
    lr_shards = sum(1 for op in plan.ops if op.get("last_resort"))
    if lr_shards:
        notes.append(
            f"all owners DOWN: last-resort primary read "
            f"({lr_shards} shard{'s' if lr_shards != 1 else ''})"
        )
    hinted = sum(int(op.get("hinted", 0) or 0) for op in plan.ops)
    if hinted:
        notes.append(
            f"owner DOWN: write durably queued as hint for replay "
            f"({hinted} miss{'es' if hinted != 1 else ''})"
        )
    if plan.fanouts:
        n_remote = sum(k for _, _, k in plan.fanouts)
        n_local = 0
        for op in plan.ops:
            n_local = max(n_local, int(op.get("local_shards", 0)))
        total = n_remote + n_local
        worst = max(plan.fanouts, key=lambda f: f[1])
        notes.append(
            f"remote fan-out: {n_remote}/{total or n_remote} shards "
            f"non-local; slowest peer {worst[0]} {worst[1] * 1e3:.1f}ms"
        )
    dur = plan.duration or 0.0
    stages = plan.stages()
    qw = stages.get("queue_wait", 0.0)
    if dur > 0 and qw > 0.5 * dur:
        notes.append(
            f"queue wait dominated: {qw * 1e3:.1f}ms of {dur * 1e3:.1f}ms "
            "(pipeline saturated — check pilosa_admission_inflight)"
        )
    if slow and plan.primary_op() == "TopN":
        # Link the TopN tail to rank-cache maintenance:
        # a slow TopN with a busy recalculating cache is repair cost,
        # not query cost.
        h = REGISTRY.get_histogram(METRIC_CACHE_RECALC, path="merge")
        hf = REGISTRY.get_histogram(METRIC_CACHE_RECALC, path="full")
        recalcs = (h.count if h else 0) + (hf.count if hf else 0)
        entries = REGISTRY.get_gauge(
            METRIC_CACHE_ENTRIES, cache_type="ranked"
        ) or 0.0
        notes.append(
            f"TopN: ranked cache {int(entries)} entries, "
            f"{int(recalcs)} recalculations observed "
            "(see pilosa_cache_recalculate_seconds)"
        )
    return notes


class PlanStore:
    """Bounded plan retention: a recent ring plus the worst-K plans per
    op-type (the slow-query analyzer's working set), served at
    GET /debug/plans."""

    DEFAULT_KEEP = 128
    KEEP_SLOW_PER_OP = 8
    SLOW_THRESHOLD = 0.100  # seconds; matches the tracer's slow ring

    def __init__(self, keep: int = DEFAULT_KEEP,
                 keep_slow_per_op: int = KEEP_SLOW_PER_OP):
        self._recent: "deque[QueryPlan]" = deque(maxlen=max(1, keep))
        self.keep_slow_per_op = keep_slow_per_op
        self._slow: Dict[str, List[QueryPlan]] = {}
        self._lock = threading.Lock()
        self.recorded = 0

    def _annotate(self, plan: QueryPlan):
        """Fill annotations on demand (idempotent — analyze() is a pure
        function of the recorded decisions, so a concurrent double-fill
        writes the same strings)."""
        if not plan.annotations:
            slow = (plan.duration or 0.0) >= self.SLOW_THRESHOLD
            plan.annotations = analyze(plan, slow=slow)
        return plan

    def record(self, plan: QueryPlan):
        slow = (plan.duration or 0.0) >= self.SLOW_THRESHOLD
        # Analyzer cost rides the hot path only when someone will read
        # the result immediately (a profiled response embeds the plan;
        # a slow plan enters the worst-per-op set).  Ring-only plans
        # annotate lazily at /debug/plans serve time.
        if slow or plan.profile:
            plan.annotations = analyze(plan, slow=slow)
        with self._lock:
            self.recorded += 1
            self._recent.append(plan)
            if slow:
                op = plan.primary_op()
                worst = self._slow.setdefault(op, [])
                worst.append(plan)
                worst.sort(key=lambda p: -(p.duration or 0.0))
                del worst[self.keep_slow_per_op:]

    def find(self, trace_id: str) -> Optional[QueryPlan]:
        with self._lock:
            for p in reversed(self._recent):
                if p.trace_id == trace_id:
                    return p
            for worst in self._slow.values():
                for p in worst:
                    if p.trace_id == trace_id:
                        return p
        return None

    def to_doc(self, op: Optional[str] = None, limit: int = 64,
               trace: Optional[str] = None) -> dict:
        if trace:
            p = self.find(trace)
            return {
                "plans": [self._annotate(p).to_dict()] if p is not None else []
            }
        with self._lock:
            # Filter BEFORE the limit slice: ?op= must surface matching
            # plans anywhere in the ring, not only within the newest
            # ``limit`` entries.
            recent = [
                p for p in self._recent
                if op is None or p.primary_op() == op
            ][-limit:] if limit > 0 else []
            slow = {
                k: [self._annotate(p).to_dict() for p in v]
                for k, v in self._slow.items()
                if op is None or k == op
            }
            recorded = self.recorded
        return {
            "recent": [self._annotate(p).to_dict() for p in recent],
            "slow": slow,
            "recorded": recorded,
            "capacity": self._recent.maxlen,
            "slowThresholdMs": self.SLOW_THRESHOLD * 1e3,
        }

    def reset(self):
        with self._lock:
            self._recent.clear()
            self._slow.clear()
            self.recorded = 0


# -- per-tenant resource ledger ----------------------------------------------


class TenantLedger:
    """Measured per-tenant cost, accumulated from the same plan records
    the introspection surfaces serve: queries, device-seconds, bytes
    touched/skipped, sheds.  Exported as the ``pilosa_tenant_*`` series
    and fed back to the admission controller (``bind_admission``) so
    weighted-fair shares price a tenant's MEASURED device cost, not its
    request count.  Tenant cardinality is bounded: past ``max_tenants``
    distinct keys, new tenants accrue under ``_other``."""

    MAX_TENANTS = 256
    OVERFLOW = "_other"

    def __init__(self, max_tenants: int = MAX_TENANTS):
        self.max_tenants = max_tenants
        self._lock = threading.Lock()
        # tenant -> [queries, device_seconds, bytes_touched, bytes_skipped,
        #            sheds]
        self._tenants: Dict[str, list] = {}
        # tenant -> cached registry counter handles (resolved once).
        self._series: Dict[str, tuple] = {}
        # tenant -> per-column tallies already flushed into the registry
        # counters (refresh_series): account() is ONE ledger-lock row
        # update, the five pilosa_tenant_* series sync at scrape time —
        # pull-time collection, same as the engine/cache gauges.
        self._flushed: Dict[str, list] = {}
        # tenant -> EWMA device-seconds per query: the ledger's copy of the
        # measured-cost signal.  Eviction prices stacks by it
        # (TorchEngine.cost_of_index), warm start orders its builds by it,
        # and the server persists and reseeds it across restarts.
        self._ewma: Dict[str, float] = {}
        self._admission = None

    def bind_admission(self, admission):
        """Wire the measured-cost feedback loop: every accounted query
        updates the controller's per-tenant cost EWMA."""
        self._admission = admission

    def _slot(self, tenant: str):
        row = self._tenants.get(tenant)
        if row is None:
            if len(self._tenants) >= self.max_tenants:
                tenant = self.OVERFLOW
                row = self._tenants.get(tenant)
            if row is None:
                row = self._tenants[tenant] = [0, 0.0, 0, 0, 0]
                self._series[tenant] = (
                    REGISTRY.counter(
                        METRIC_TENANT_QUERIES,
                        help="Queries executed, by tenant",
                        tenant=tenant,
                    ),
                    REGISTRY.counter(
                        METRIC_TENANT_DEVICE_SECONDS,
                        help="Attributed device-seconds consumed, by tenant",
                        tenant=tenant,
                    ),
                    REGISTRY.counter(
                        METRIC_TENANT_BYTES_TOUCHED,
                        help="Device bytes touched by queries, by tenant",
                        tenant=tenant,
                    ),
                    REGISTRY.counter(
                        METRIC_TENANT_BYTES_SKIPPED,
                        help="Device bytes skipped by sparse plans, by tenant",
                        tenant=tenant,
                    ),
                    REGISTRY.counter(
                        METRIC_TENANT_SHEDS,
                        help="Requests shed before engine work, by tenant",
                        tenant=tenant,
                    ),
                )
        return tenant, row, self._series[tenant]

    # EWMA smoothing of the ledger's cost signal (the admission
    # controller's COST_EWMA).
    COST_EWMA = 0.2

    def account(self, plan: QueryPlan):
        dev, touched, skipped = plan.tallies()
        with self._lock:
            tenant, row, _series = self._slot(plan.tenant)
            row[0] += 1
            row[1] += dev
            row[2] += touched
            row[3] += skipped
            prev = self._ewma.get(tenant)
            self._ewma[tenant] = (
                dev if prev is None
                else (1 - self.COST_EWMA) * prev + self.COST_EWMA * dev
            )
        adm = self._admission
        if adm is not None and hasattr(adm, "note_cost"):
            adm.note_cost(tenant, dev)

    def cost_ewma(self, tenant: str) -> float:
        """The tenant's measured device-cost EWMA (0.0 when unseen): the
        eviction and warm-start pricing signal."""
        with self._lock:
            return self._ewma.get(tenant, 0.0)

    def ewma_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._ewma)

    def seed_costs(self, costs: Dict[str, float]):
        """Reseed the cost EWMAs from a persisted snapshot (server boot:
        warm start orders its builds by the last run's hot tenants).  A
        tenant that already has a live signal keeps it."""
        with self._lock:
            for tenant, v in costs.items():
                try:
                    v = float(v)
                except (TypeError, ValueError):
                    continue
                if tenant not in self._ewma and v > 0:
                    self._ewma[str(tenant)] = v

    def note_shed(self, tenant: str):
        with self._lock:
            tenant, row, _series = self._slot(tenant or "default")
            row[4] += 1

    def account_queries(self, tenant: str, queries: int = 1):
        """Query-count-only accounting for the serving memo lane: the
        tenant served ``queries`` Counts at ~zero device cost — no plan
        object exists to route through ``account``."""
        with self._lock:
            _tenant, row, _series = self._slot(tenant or "default")
            row[0] += queries

    def refresh_series(self):
        """Flush accumulated per-tenant tallies into the registry
        counters (called at /metrics and /debug/vars pull time, like
        the engine residency gauges).  Counters only ever move by the
        non-negative delta since the last flush, so the exported series
        stay monotonic."""
        with self._lock:
            for tenant, row in self._tenants.items():
                series = self._series[tenant]
                flushed = self._flushed.setdefault(tenant, [0, 0.0, 0, 0, 0])
                for i in range(5):
                    delta = row[i] - flushed[i]
                    if delta > 0:
                        series[i].inc(delta)
                        flushed[i] = row[i]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                t: {
                    "queries": r[0],
                    "deviceSeconds": round(r[1], 6),
                    "bytesTouched": r[2],
                    "bytesSkipped": r[3],
                    "sheds": r[4],
                }
                for t, r in self._tenants.items()
            }

    def reset(self):
        with self._lock:
            self._tenants.clear()
            self._flushed.clear()
            self._ewma.clear()
            # Registry counters stay at their last-flushed values
            # (monotonic contract); only the ledger's own view resets.


# Process-wide singletons, mirroring util.stats.REGISTRY: the engine,
# batcher, executor, and both HTTP backends all stamp into one store.
STORE = PlanStore()
LEDGER = TenantLedger()

# Finish-side observers: callables invoked with every recorded plan
# AFTER the ring + ledger update.  This is the one seam the working-set
# telemetry layer (util/heat.py: heat tables, the sequence miner, the
# prefetch advisor) hangs off — observers see the SAME plan records the
# ledger accounts, so derived byte tallies can never drift from the
# pilosa_tenant_* / bytes-skipped counters.  Observers must be cheap
# and must never raise (each call is fenced regardless).
_OBSERVERS: List = []


def add_observer(fn):
    """Register a finish-side plan observer (idempotent per fn)."""
    if fn not in _OBSERVERS:
        _OBSERVERS.append(fn)


def remove_observer(fn):
    try:
        _OBSERVERS.remove(fn)
    except ValueError:
        pass


def begin(index: str, query: str, tenant: str = "default",
          profile: bool = False) -> Optional[QueryPlan]:
    """A fresh plan, or None when the layer is disabled."""
    if not ENABLED:
        return None
    return QueryPlan(index, query, tenant=tenant, profile=profile)


def record(plan: Optional[QueryPlan]):
    """Finish-side entry point: ring + analyzer + tenant ledger +
    telemetry observers."""
    if plan is None:
        return
    STORE.record(plan)
    LEDGER.account(plan)
    for fn in _OBSERVERS:
        try:
            fn(plan)
        except Exception:  # noqa: BLE001 — telemetry never fails a query
            pass
