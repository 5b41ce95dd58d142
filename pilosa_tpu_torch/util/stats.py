"""Telemetry: a fixed-bucket latency histogram, the per-stage stats of the
count batcher, the process metrics registry that ``GET /metrics`` and
``/debug/vars`` serve, and the stats clients of the server.

Copies from ``pilosa_tpu/util/stats.py``: ``Histogram``,
``PipelineStats``, ``Counter``, ``MetricsRegistry`` with its classic
Prometheus exposition, ``REGISTRY``, the ``METRIC_*`` names the serving
modules record, ``diff_rates`` and the ``NopStatsClient`` /
``ExpvarStatsClient`` / ``MultiStatsClient`` backends, the per-tenant
cost series (``pilosa_tenant_*``, fed by ``util/plans.py``), the
process-mode gauges, ``merge_expositions`` and
``snapshot_from_exposition``, the working-set heat, advisor, history, SLO
and fault-plane series, and the OpenMetrics exposition whose ``_bucket``
samples carry trace-id exemplars.  The engine's fusion counters are plain attributes, named below with the
series that ``/metrics`` publishes them under.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

# -- whole-dashboard fusion (pilosa_tpu/util/stats.py:379-400) ---------------
#   pilosa_engine_fused_program_programs_total   drains launched as fused
#                                                programs (TorchEngine.fused_programs)
#   pilosa_engine_fused_program_queries_total    items that rode them
#                                                (fused_program_queries)
#   pilosa_engine_fused_program_masks_evaluated_total  distinct Row subtrees
#                                                evaluated (fused_masks_evaluated)
#   pilosa_engine_fused_program_masks_referenced_total subtree references the
#                                                drains asked for; the gap to
#                                                masks_evaluated is the
#                                                evaluations fusion saved
#                                                (fused_masks_referenced)
METRIC_ENGINE_FUSED_PROGRAMS = "pilosa_engine_fused_program_programs_total"
METRIC_ENGINE_FUSED_QUERIES = "pilosa_engine_fused_program_queries_total"
METRIC_ENGINE_FUSED_MASKS_EVAL = "pilosa_engine_fused_program_masks_evaluated_total"
METRIC_ENGINE_FUSED_MASKS_REF = "pilosa_engine_fused_program_masks_referenced_total"
# -- engine caches (pilosa_tpu/util/stats.py:373-377, 675-679) ---------------
#   pilosa_engine_cache_hits_total{cache=...}   engine cache hits
#   pilosa_engine_cache_misses_total{cache=...} engine cache misses
#   pilosa_device_bytes_skipped_total           device bytes the sparse path
#                                               (K2) skipped
METRIC_ENGINE_CACHE_HITS = "pilosa_engine_cache_hits_total"
METRIC_ENGINE_CACHE_MISSES = "pilosa_engine_cache_misses_total"
METRIC_DEVICE_BYTES_SKIPPED = "pilosa_device_bytes_skipped_total"
# Engine cache names labelling the hit/miss series, the reference's: the
# memo_* names are the per-op-kind result-memo tallies.  The port has no
# device scalar or zero-stack cache (a row goes to a kernel by value, a zero
# leaf is zeros with no load), so "scalar" and "zeros" stay at 0.
ENGINE_CACHES = (
    "stack", "mask", "zeros", "scalar", "canonical", "result_memo",
    "batch_cse", "fused_plan",
    "memo_sum", "memo_min", "memo_max", "memo_topn", "memo_groupby",
)
# -- tiered residency (pilosa_tpu/util/stats.py:425-451) ----------------------
#   pilosa_engine_promotions_total{cause=}  promotions completing a FULL stack
#   pilosa_engine_partial_promotions_total  promotions admitting a partial
#                                           (working-set) block-pool stack
#   pilosa_engine_promotions_declined_total promotions that could not fit even
#                                           partially (the key cools down)
#   pilosa_engine_promoted_bytes_total      device bytes the promotion worker
#                                           shipped
#   pilosa_engine_host_fallbacks_total      queries served from the host tier
#                                           because their stack was not
#                                           resident (each requested a
#                                           promotion instead of blocking)
#   pilosa_engine_resident_block_fraction   gauge: occupancy blocks resident
#                                           on the card / blocks of the full
#                                           row universe, over known stacks
#   pilosa_engine_evictions_total           stacks the budget evicted
METRIC_ENGINE_PROMOTIONS = "pilosa_engine_promotions_total"
METRIC_ENGINE_PARTIAL_PROMOTIONS = "pilosa_engine_partial_promotions_total"
METRIC_ENGINE_PROMOTIONS_DECLINED = "pilosa_engine_promotions_declined_total"
METRIC_ENGINE_PROMOTED_BYTES = "pilosa_engine_promoted_bytes_total"
METRIC_ENGINE_HOST_FALLBACKS = "pilosa_engine_host_fallbacks_total"
METRIC_ENGINE_RESIDENT_BLOCK_FRACTION = "pilosa_engine_resident_block_fraction"
METRIC_ENGINE_EVICTIONS = "pilosa_engine_evictions_total"
# The {cause=} of pilosa_engine_promotions_total: "reactive" (a query missed
# and the worker chased it), "warm_start" (restart admission) or "advisor"
# (promote-ahead, parallel/advisor.py).
# -- working-set heat and the prefetch advisor (pilosa_tpu/util/stats.py:452-469)
#   pilosa_engine_heat_tracked_rows         gauge: rows with live heat state
#   pilosa_engine_residency_gap_bytes       gauge: bytes of HOT rows not
#                                           resident on the card (0 when the
#                                           working set is resident)
#   pilosa_advisor_predictions_total        rows the prefetch advisor
#                                           predicted the next query touches
#   pilosa_advisor_hits_total               predicted rows the next query
#                                           touched
#   pilosa_advisor_misses_total             predicted rows it did not touch
METRIC_ENGINE_HEAT_TRACKED_ROWS = "pilosa_engine_heat_tracked_rows"
METRIC_ENGINE_RESIDENCY_GAP = "pilosa_engine_residency_gap_bytes"
METRIC_ADVISOR_PREDICTIONS = "pilosa_advisor_predictions_total"
METRIC_ADVISOR_HITS = "pilosa_advisor_hits_total"
METRIC_ADVISOR_MISSES = "pilosa_advisor_misses_total"
# -- fault plane (net/faults.py) ----------------------------------------------
#   pilosa_faults_injected_total{action=}   fault-plane injections
#                                           (drop | delay | error | partition)
METRIC_FAULTS_INJECTED = "pilosa_faults_injected_total"
# -- self-hosted metrics history and the SLO watcher (util/history.py,
# util/slo.py)
#   pilosa_history_samples_total            series values written to _system
#   pilosa_history_ticks_total              sampler passes completed
#   pilosa_history_views_dropped_total      hour views retired by retention
#   pilosa_history_dropped_total{reason=}   values not stored
#                                           (stride | clamp | error)
#   pilosa_history_tick_seconds             histogram: one sampler pass
#   pilosa_slo_burn_total{slo=}             SLO burn events journaled
METRIC_HISTORY_SAMPLES = "pilosa_history_samples_total"
METRIC_HISTORY_TICKS = "pilosa_history_ticks_total"
METRIC_HISTORY_VIEWS_DROPPED = "pilosa_history_views_dropped_total"
METRIC_HISTORY_DROPPED = "pilosa_history_dropped_total"
METRIC_HISTORY_TICK_SECONDS = "pilosa_history_tick_seconds"
METRIC_SLO_BURN = "pilosa_slo_burn_total"
HISTORY_DROP_REASONS = ("stride", "clamp", "error")

# Fixed log-spaced latency buckets (seconds), 100 us .. 60 s.  Fixed
# buckets (not reservoirs) keep observe() O(log B) with bounded memory.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Fixed-bucket latency histogram with linear-interpolation quantile
    estimation.  Thread-safe; observe() is a bisect + one locked
    increment.

    Exemplars (OpenMetrics): ``observe(v, exemplar=trace_id)`` keeps the
    most recent (trace id, value, wall time) per bucket, one slot a bucket
    allocated at the first exemplar: what links a latency bucket to its
    plan at /debug/plans."""

    __slots__ = ("buckets", "_counts", "sum", "count", "_lock", "_exemplars")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()
        self._exemplars = None  # lazy: [(trace_id, value, wall_ts) | None]

    def observe(self, value: float, exemplar: Optional[str] = None):
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self.sum += value
            self.count += 1
            if exemplar:
                ex = self._exemplars
                if ex is None:
                    ex = self._exemplars = [None] * (len(self.buckets) + 1)
                ex[i] = (exemplar, value, time.time())

    def exemplars(self) -> Optional[list]:
        """A consistent copy of the per-bucket exemplar slots (None when no
        exemplar was ever attached)."""
        with self._lock:
            return None if self._exemplars is None else list(self._exemplars)

    def export(self) -> Tuple[List[int], float, int]:
        """One consistent (counts, sum, count) triple taken under the lock."""
        with self._lock:
            return list(self._counts), self.sum, self.count

    def _quantile_of(self, counts: List[int], total: int, q: float) -> float:
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c > 0:
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
        return self.buckets[-1]

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1) by linear interpolation inside the
        containing bucket; 0.0 on an empty histogram, and observations in
        the +Inf bucket clamp to the top finite bound."""
        counts, _, total = self.export()
        return self._quantile_of(counts, total, q)

    def snapshot(self) -> dict:
        counts, total_sum, count = self.export()  # one consistent view
        return {
            "count": count,
            "sumSeconds": round(total_sum, 6),
            "meanSeconds": round(total_sum / count, 6) if count else 0.0,
            "p50": round(self._quantile_of(counts, count, 0.50), 6),
            "p95": round(self._quantile_of(counts, count, 0.95), 6),
            "p99": round(self._quantile_of(counts, count, 0.99), 6),
        }


class PipelineStats:
    """Per-stage telemetry for the pipelined count path
    (``parallel/batcher.py``): stage timings (queue wait, lower+dispatch,
    device+readback, decode), the live/high-water in-flight batch depth,
    and batch-occupancy counters.  Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        # stage -> [count, total_seconds, max_seconds]
        self._stages: Dict[str, list] = {}
        self._gauges: Dict[str, float] = {}
        self._counters: Dict[str, int] = {}
        # stage -> Histogram (quantiles in snapshot()).
        self._hists: Dict[str, Histogram] = {}

    def record(self, stage: str, seconds: float, n: int = 1):
        with self._lock:
            s = self._stages.setdefault(stage, [0, 0.0, 0.0])
            s[0] += n
            s[1] += seconds
            s[2] = max(s[2], seconds)
            h = self._hists.get(stage)
            if h is None:
                h = self._hists[stage] = Histogram()
        h.observe(seconds)

    def gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value: float):
        """Keep the high-water mark (e.g. the largest batch seen)."""
        with self._lock:
            if value > self._gauges.get(name, float("-inf")):
                self._gauges[name] = value

    def incr(self, name: str, value: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def add_delta(self, name: str, delta: int):
        """Adjust a gauge by ``delta`` and track its high-water twin
        (``<name>_max``) in the same critical section — the pattern for
        in-flight depth counters."""
        with self._lock:
            v = self._gauges.get(name, 0) + delta
            self._gauges[name] = v
            if v > self._gauges.get(name + "_max", 0):
                self._gauges[name + "_max"] = v
            return v

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            stages = {
                k: {
                    "count": c,
                    "totalSeconds": round(t, 6),
                    "meanSeconds": round(t / c, 6) if c else 0.0,
                    "maxSeconds": round(m, 6),
                }
                for k, (c, t, m) in self._stages.items()
            }
            hists = dict(self._hists)
            gauges = dict(self._gauges)
            counters = dict(self._counters)
        for k, h in hists.items():
            if k in stages:
                snap = h.snapshot()
                stages[k]["p50Seconds"] = snap["p50"]
                stages[k]["p95Seconds"] = snap["p95"]
                stages[k]["p99Seconds"] = snap["p99"]
        return {
            "stages": stages,
            "gauges": gauges,
            "counters": counters,
        }


class Counter:
    """One monotonic counter series with a cached handle: ``inc()`` is a
    single locked add on the series' own lock, so hot paths resolve the
    series once and never touch the registry lock again."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0):
        with self._lock:
            self.value += value

    def set(self, value: float):
        """Publish a total kept elsewhere (an engine attribute) at scrape
        time."""
        with self._lock:
            self.value = float(value)

    def get(self) -> float:
        with self._lock:
            return self.value


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_float(v: float) -> str:
    """Prometheus number formatting: shortest round-trippable text."""
    return f"{v:.10g}"


class MetricsRegistry:
    """Name + labels -> histogram/counter/gauge, exported as Prometheus
    text (the /metrics surface) and as a JSON snapshot (merged into
    /debug/vars).  Label sets are sorted tuples so label order never
    splits a series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[str, Dict[tuple, Histogram]] = {}
        self._counters: Dict[str, Dict[tuple, Counter]] = {}
        self._gauges: Dict[str, Dict[tuple, float]] = {}
        self._help: Dict[str, str] = {}

    @staticmethod
    def _labelkey(labels: dict) -> tuple:
        return tuple(sorted(labels.items()))

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        """Get-or-create the histogram series (registering it makes the
        series visible at /metrics before the first observation)."""
        key = self._labelkey(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            series = self._hists.setdefault(name, {})
            h = series.get(key)
            if h is None:
                h = series[key] = Histogram()
            return h

    def observe(self, name: str, seconds: float, **labels):
        self.histogram(name, **labels).observe(seconds)

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        """Get-or-create the counter series handle.  Resolve once per hot
        path and call ``inc()`` on the handle."""
        key = self._labelkey(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            series = self._counters.setdefault(name, {})
            c = series.get(key)
            if c is None:
                c = series[key] = Counter()
            return c

    def inc(self, name: str, value: float = 1.0, **labels):
        self.counter(name, **labels).inc(value)

    def set_gauge(self, name: str, value: float, **labels):
        key = self._labelkey(labels)
        with self._lock:
            self._gauges.setdefault(name, {})[key] = value

    def get_histogram(self, name: str, **labels) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name, {}).get(self._labelkey(labels))

    def get_gauge(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name, {}).get(self._labelkey(labels))

    @staticmethod
    def _fmt_labels(key: tuple, extra: str = "") -> str:
        def esc(v) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"')

        parts = [f'{_prom_name(k)}="{esc(v)}"' for k, v in key]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def prometheus_text(self, openmetrics: bool = False) -> str:
        """The whole registry in the Prometheus text exposition.

        ``openmetrics=True`` gives the OpenMetrics exposition: ``_bucket``
        samples carry their most recent exemplar (``# {trace_id="..."}
        value timestamp``), counter families drop ``_total`` in HELP/TYPE,
        and the text ends with ``# EOF``.  The classic text (the default)
        stays exemplar-free: its consumers reject the suffix."""
        with self._lock:
            hists = {n: dict(s) for n, s in self._hists.items()}
            counters = {n: dict(s) for n, s in self._counters.items()}
            gauges = {n: dict(s) for n, s in self._gauges.items()}
            helps = dict(self._help)
        lines: List[str] = []
        for name in sorted(hists):
            pname = _prom_name(name)
            lines.append(f"# HELP {pname} {helps.get(name, name)}")
            lines.append(f"# TYPE {pname} histogram")
            for key in sorted(hists[name]):
                h = hists[name][key]
                counts, h_sum, h_count = h.export()
                exemplars = h.exemplars() if openmetrics else None

                def ex_suffix(i: int) -> str:
                    if exemplars is None or exemplars[i] is None:
                        return ""
                    tid, val, ts = exemplars[i]
                    esc = str(tid).replace("\\", "\\\\").replace('"', '\\"')
                    return f' # {{trace_id="{esc}"}} {_prom_float(val)} {_prom_float(ts)}'

                running = 0
                for i, bound in enumerate(h.buckets):
                    running += counts[i]
                    le = self._fmt_labels(key, f'le="{_prom_float(bound)}"')
                    lines.append(f"{pname}_bucket{le} {running}{ex_suffix(i)}")
                le = self._fmt_labels(key, 'le="+Inf"')
                lines.append(f"{pname}_bucket{le} {running + counts[-1]}"
                             f"{ex_suffix(len(h.buckets))}")
                lbl = self._fmt_labels(key)
                lines.append(f"{pname}_sum{lbl} {_prom_float(h_sum)}")
                lines.append(f"{pname}_count{lbl} {h_count}")
        for name in sorted(counters):
            pname = _prom_name(name)
            # OpenMetrics names a counter family without its _total suffix;
            # the sample lines are the same in both formats.
            fam = pname
            if openmetrics and fam.endswith("_total"):
                fam = fam[: -len("_total")]
            lines.append(f"# HELP {fam} {helps.get(name, name)}")
            lines.append(f"# TYPE {fam} counter")
            for key in sorted(counters[name]):
                lbl = self._fmt_labels(key)
                lines.append(f"{pname}{lbl} {_prom_float(counters[name][key].get())}")
        for name in sorted(gauges):
            pname = _prom_name(name)
            lines.append(f"# HELP {pname} {helps.get(name, name)}")
            lines.append(f"# TYPE {pname} gauge")
            for key in sorted(gauges[name]):
                lbl = self._fmt_labels(key)
                lines.append(f"{pname}{lbl} {_prom_float(gauges[name][key])}")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON view (histograms as count/sum/quantiles) for /debug/vars."""
        with self._lock:
            hists = {n: dict(s) for n, s in self._hists.items()}
            counters = {n: dict(s) for n, s in self._counters.items()}
            gauges = {n: dict(s) for n, s in self._gauges.items()}

        def label_str(key: tuple) -> str:
            return ",".join(f"{k}={v}" for k, v in key) or "_"

        return {
            "histograms": {n: {label_str(k): h.snapshot() for k, h in s.items()}
                           for n, s in hists.items()},
            "counters": {n: {label_str(k): c.get() for k, c in s.items()}
                         for n, s in counters.items()},
            "gauges": {n: {label_str(k): v for k, v in s.items()}
                       for n, s in gauges.items()},
        }

    def collect_rates(self, prev, now: Optional[float] = None,
                      snapshot: Optional[dict] = None):
        """Counter snapshot -> per-second rates since ``prev`` (the state
        the previous call returned; None on the first call, which yields
        no rates).  Returns ``(rates, state)``."""
        if now is None:
            now = time.time()
        snap = snapshot if snapshot is not None else self.snapshot()
        counters = snap.get("counters", {})
        state = {"ts": now, "counters": counters}
        if not prev or not prev.get("counters"):
            return {}, state
        return diff_rates(prev["counters"], counters, now - float(prev.get("ts", now))), state


def diff_rates(prev_counters: dict, cur_counters: dict,
               dt: float) -> Dict[str, Dict[str, float]]:
    """Per-second rates from two counter snapshots taken ``dt`` apart; a
    counter that went down contributes its current value (a reset)."""
    if dt <= 0:
        return {}
    out: Dict[str, Dict[str, float]] = {}
    for family, cur in cur_counters.items():
        prev = prev_counters.get(family)
        if prev is None:
            continue
        fam_out = {}
        for label_str, cur_v in cur.items():
            if label_str not in prev:
                continue
            d = cur_v - prev[label_str]
            fam_out[label_str] = (cur_v if d < 0 else d) / dt
        if fam_out:
            out[family] = fam_out
    return out


# The process-wide metrics registry, exported at GET /metrics and merged
# into /debug/vars.
REGISTRY = MetricsRegistry()

#   pilosa_query_seconds{path=sync|pipelined}  whole-query latency (api.py)
METRIC_QUERY = "pilosa_query_seconds"
#   pilosa_pipeline_stage_seconds / _depth*, pipeline_* gauges: the
#   batcher's PipelineStats, published at scrape time
METRIC_PIPELINE_STAGE = "pilosa_pipeline_stage_seconds"
#   pilosa_ingest_batches_total{path=}     import batches applied (api.py)
#   pilosa_ingest_bits_total{path=}        bits they carried
#   pilosa_ingest_changed_total            bits import-roaring changed
#   pilosa_ingest_seconds{path=}           host time per batch
METRIC_INGEST_BATCHES = "pilosa_ingest_batches_total"
METRIC_INGEST_BITS = "pilosa_ingest_bits_total"
METRIC_INGEST_CHANGED = "pilosa_ingest_changed_total"
METRIC_INGEST_SECONDS = "pilosa_ingest_seconds"
INGEST_PATHS = ("bits", "values", "roaring")
# The history sampler's own writes to _system: kept out of INGEST_PATHS so
# that the series it records do not count its writes.
INGEST_PATH_SYSTEM = "system"
#   pilosa_engine_stack_rebuilds_total / _updates_total: TorchEngine's
#   stack_rebuilds and stack_updates, published at scrape time
METRIC_ENGINE_REBUILDS = "pilosa_engine_stack_rebuilds_total"
METRIC_ENGINE_UPDATES = "pilosa_engine_stack_updates_total"
#   pilosa_client_retries_total            InternalClient retries
#   pilosa_cluster_remote_calls_total      InternalClient requests
METRIC_CLIENT_RETRIES = "pilosa_client_retries_total"
METRIC_CLUSTER_REMOTE_CALLS = "pilosa_cluster_remote_calls_total"
# -- serving tier ------------------------------------------------------------
#   pilosa_admission_inflight               gauge: requests admitted, not done
#   pilosa_admission_active_tenants         gauge: tenants with in-flight work
#   pilosa_admission_admitted_total         counter: requests admitted
#   pilosa_admission_shed_total{reason=}    counter: fast-rejected requests
#   pilosa_server_connections               gauge: live HTTP connections
#   pilosa_server_connections_total         counter: connections accepted
#   pilosa_server_requests_total{path=}     counter: requests by dispatch path
#                                           (inline = reactor fast path,
#                                           pool = blocking worker, shed)
#   pilosa_server_errors_total              counter: 5xx responses served
METRIC_ADMISSION_INFLIGHT = "pilosa_admission_inflight"
METRIC_ADMISSION_TENANTS = "pilosa_admission_active_tenants"
METRIC_ADMISSION_ADMITTED = "pilosa_admission_admitted_total"
METRIC_ADMISSION_SHED = "pilosa_admission_shed_total"
METRIC_SERVER_CONNECTIONS = "pilosa_server_connections"
METRIC_SERVER_CONNECTIONS_TOTAL = "pilosa_server_connections_total"
METRIC_SERVER_REQUESTS = "pilosa_server_requests_total"
METRIC_SERVER_ERRORS = "pilosa_server_errors_total"
# -- per-tenant cost attribution (util/plans.py) ------------------------------
#   pilosa_tenant_queries_total{tenant=}        queries executed
#   pilosa_tenant_device_seconds_total{tenant=} attributed device-seconds
#                                               (each query's share of every
#                                               batch it rode)
#   pilosa_tenant_bytes_touched_total{tenant=}  device bytes its plans read
#   pilosa_tenant_bytes_skipped_total{tenant=}  bytes its sparse plans skipped
#   pilosa_tenant_sheds_total{tenant=}          admission sheds charged to it
# Series are made per tenant when first seen (bounded by TenantLedger's
# cardinality cap).
METRIC_TENANT_QUERIES = "pilosa_tenant_queries_total"
METRIC_TENANT_DEVICE_SECONDS = "pilosa_tenant_device_seconds_total"
METRIC_TENANT_BYTES_TOUCHED = "pilosa_tenant_bytes_touched_total"
METRIC_TENANT_BYTES_SKIPPED = "pilosa_tenant_bytes_skipped_total"
METRIC_TENANT_SHEDS = "pilosa_tenant_sheds_total"
#   pilosa_cache_recalculate_seconds{path=} / pilosa_cache_entries{cache_type=}:
#   the TopN rank-cache series the slow-TopN analyzer note reads
METRIC_CACHE_RECALC = "pilosa_cache_recalculate_seconds"
METRIC_CACHE_ENTRIES = "pilosa_cache_entries"
# -- process mode (net/procserver.py) -----------------------------------------
#   pilosa_process_up{proc=}                1 while the process answers the
#                                           scrape-time stats probe (engine:
#                                           always 1; a wedged worker shows 0
#                                           before the supervisor reaps it)
#   pilosa_process_rss_bytes{proc=}         resident set size per process
METRIC_PROCESS_UP = "pilosa_process_up"
METRIC_PROCESS_RSS = "pilosa_process_rss_bytes"
# -- repair-on-write materialized results (pilosa_tpu/util/stats.py:680-703) --
#   pilosa_result_repairs_total{kind=}        memo entries advanced to the
#                                             current version tokens in
#                                             O(changed bits) instead of
#                                             recomputed
#   pilosa_result_repair_fallbacks_total{kind=} repair attempts that fell
#                                             back to a full recompute
#                                             (opaque write, coverage hole,
#                                             structural change, lost race)
#   pilosa_result_repair_seconds              host time per repair attempt
#   pilosa_result_repair_touched_words_total  64-bit words a repair actually
#                                             read — the O(touched) evidence
#                                             vs the index's total words
#   pilosa_cq_active                          live continuous-query
#                                             subscriptions (POST /cq)
#   pilosa_cq_deltas_total                    result deltas streamed to
#                                             continuous-query subscribers
METRIC_RESULT_REPAIRS = "pilosa_result_repairs_total"
METRIC_RESULT_REPAIR_FALLBACKS = "pilosa_result_repair_fallbacks_total"
METRIC_RESULT_REPAIR_SECONDS = "pilosa_result_repair_seconds"
METRIC_RESULT_REPAIR_TOUCHED_WORDS = "pilosa_result_repair_touched_words_total"
METRIC_CQ_ACTIVE = "pilosa_cq_active"
METRIC_CQ_DELTAS = "pilosa_cq_deltas_total"
REPAIR_KINDS = ("count", "sum", "topn", "groupby", "minmax")
SHED_REASONS = ("overload", "tenant_fair", "queue_full")
SERVER_REQUEST_PATHS = ("inline", "pool", "shed")

# Pre-register the always-on surface so /metrics exposes every required
# series from process start.
for _path in ("sync", "pipelined"):
    REGISTRY.histogram(METRIC_QUERY, help="Whole-query latency (seconds)", path=_path)
for _path in SERVER_REQUEST_PATHS:
    REGISTRY.counter(METRIC_SERVER_REQUESTS, help="HTTP requests by dispatch path",
                     path=_path)
REGISTRY.counter(METRIC_SERVER_ERRORS, help="HTTP 5xx responses served")
REGISTRY.counter(METRIC_SERVER_CONNECTIONS_TOTAL, help="HTTP connections accepted")
for _path in INGEST_PATHS:
    REGISTRY.counter(METRIC_INGEST_BATCHES, help="Import batches applied", path=_path)
    REGISTRY.counter(METRIC_INGEST_BITS, help="Bits carried by import batches", path=_path)
    REGISTRY.histogram(METRIC_INGEST_SECONDS, help="Host time per import batch (seconds)",
                       path=_path)
REGISTRY.counter(METRIC_INGEST_CHANGED, help="Bits changed by roaring imports")
REGISTRY.counter(METRIC_INGEST_BATCHES, help="Import batches applied", path=INGEST_PATH_SYSTEM)
REGISTRY.counter(METRIC_INGEST_BITS, help="Bits carried by import batches",
                 path=INGEST_PATH_SYSTEM)
REGISTRY.histogram(METRIC_INGEST_SECONDS, help="Host time per import batch (seconds)",
                   path=INGEST_PATH_SYSTEM)
REGISTRY.set_gauge(METRIC_ENGINE_HEAT_TRACKED_ROWS, 0)
REGISTRY.set_gauge(METRIC_ENGINE_RESIDENCY_GAP, 0)
REGISTRY.counter(METRIC_ADVISOR_PREDICTIONS,
                 help="Rows the prefetch advisor predicted the next query would touch")
REGISTRY.counter(METRIC_ADVISOR_HITS,
                 help="Advisor-predicted rows the next query actually touched")
REGISTRY.counter(METRIC_ADVISOR_MISSES, help="Advisor-predicted rows the next query did not touch")
for _action in ("drop", "delay", "error", "partition"):
    REGISTRY.counter(METRIC_FAULTS_INJECTED, help="Deterministic fault-plane injections",
                     action=_action)
REGISTRY.counter(METRIC_HISTORY_SAMPLES, help="Series values the history sampler stored in _system")
REGISTRY.counter(METRIC_HISTORY_TICKS, help="History sampler passes completed")
REGISTRY.counter(METRIC_HISTORY_VIEWS_DROPPED,
                 help="_system time-quantum views retired by retention")
for _reason in HISTORY_DROP_REASONS:
    REGISTRY.counter(METRIC_HISTORY_DROPPED, help="Series values the sampler could not store",
                     reason=_reason)
REGISTRY.histogram(METRIC_HISTORY_TICK_SECONDS, help="Cost of one history sampler pass (seconds)")
for _kind in REPAIR_KINDS:
    REGISTRY.counter(METRIC_RESULT_REPAIRS,
                     help="Materialized results repaired in-place from write deltas",
                     kind=_kind)
    REGISTRY.counter(METRIC_RESULT_REPAIR_FALLBACKS,
                     help="Repair attempts that fell back to full recompute", kind=_kind)
REGISTRY.histogram(METRIC_RESULT_REPAIR_SECONDS,
                   help="Host time per materialized-result repair attempt (seconds)")
REGISTRY.counter(METRIC_RESULT_REPAIR_TOUCHED_WORDS,
                 help="64-bit words read by result repairs (O(touched), not O(index))")
REGISTRY.set_gauge(METRIC_CQ_ACTIVE, 0)
REGISTRY.counter(METRIC_CQ_DELTAS, help="Result deltas streamed to continuous queries")
del _action, _reason, _kind


class StatsClient:
    """Interface (stats/stats.go:31-66); also usable as a base class."""

    def with_tags(self, *tags: str) -> "StatsClient":
        return self

    def tags(self) -> List[str]:
        return []

    def count(self, name: str, value: int = 1, rate: float = 1.0, tags=None):
        pass

    def count_with_custom_tags(self, name, value, rate, tags):
        self.count(name, value, rate, tags)

    def gauge(self, name: str, value: float, rate: float = 1.0):
        pass

    def histogram(self, name: str, value: float, rate: float = 1.0):
        pass

    def set(self, name: str, value: str, rate: float = 1.0):
        pass

    def timing(self, name: str, value_seconds: float, rate: float = 1.0):
        pass

    def open(self):
        pass

    def close(self):
        pass


class NopStatsClient(StatsClient):
    pass


class ExpvarStatsClient(StatsClient):
    """In-memory, inspectable backend (the reference's expvar client,
    stats/stats.go:117-214): exposed by the HTTP layer at /debug/vars."""

    def __init__(self, _tags: Optional[List[str]] = None, _root=None):
        self._tags = _tags or []
        if _root is None:
            _root = {"lock": threading.Lock(), "counters": {}, "gauges": {},
                     "timings": {}, "sets": {}, "children": {}}
        self._root = _root

    def _scope(self, name: str) -> str:
        if not self._tags:
            return name
        return ",".join(sorted(self._tags)) + ":" + name

    def with_tags(self, *tags: str) -> "ExpvarStatsClient":
        return ExpvarStatsClient(sorted(set(self._tags) | set(tags)), self._root)

    def tags(self) -> List[str]:
        return list(self._tags)

    def count(self, name, value: int = 1, rate: float = 1.0, tags=None):
        key = self._scope(name)
        if tags:
            key += "," + ",".join(tags)
        with self._root["lock"]:
            self._root["counters"][key] = self._root["counters"].get(key, 0) + value

    def gauge(self, name, value: float, rate: float = 1.0):
        with self._root["lock"]:
            self._root["gauges"][self._scope(name)] = value

    def histogram(self, name, value: float, rate: float = 1.0):
        with self._root["lock"]:
            h = self._root["timings"].get(self._scope(name))
            if h is None:
                h = self._root["timings"][self._scope(name)] = Histogram()
        h.observe(value)

    def set(self, name, value: str, rate: float = 1.0):
        with self._root["lock"]:
            self._root["sets"][self._scope(name)] = value

    def timing(self, name, value_seconds: float, rate: float = 1.0):
        self.histogram(name, value_seconds, rate)

    def snapshot(self) -> Dict[str, dict]:
        with self._root["lock"]:
            timings = dict(self._root["timings"])
            return {
                "counters": dict(self._root["counters"]),
                "gauges": dict(self._root["gauges"]),
                "sets": dict(self._root["sets"]),
                "timingCounts": {k: h.count for k, h in timings.items()},
                "timings": {k: h.snapshot() for k, h in timings.items()},
            }


class MultiStatsClient(StatsClient):
    """Fan out to several backends (stats/stats.go:217-283)."""

    def __init__(self, clients: List[StatsClient]):
        self.clients = clients

    def with_tags(self, *tags: str) -> "MultiStatsClient":
        return MultiStatsClient([c.with_tags(*tags) for c in self.clients])

    def count(self, name, value: int = 1, rate: float = 1.0, tags=None):
        for c in self.clients:
            c.count(name, value, rate, tags)

    def gauge(self, name, value: float, rate: float = 1.0):
        for c in self.clients:
            c.gauge(name, value, rate)

    def histogram(self, name, value: float, rate: float = 1.0):
        for c in self.clients:
            c.histogram(name, value, rate)

    def set(self, name, value: str, rate: float = 1.0):
        for c in self.clients:
            c.set(name, value, rate)

    def timing(self, name, value_seconds: float, rate: float = 1.0):
        for c in self.clients:
            c.timing(name, value_seconds, rate)


def _iter_samples(text: str):
    """Yield ``(key, value, exemplar_suffix)`` per sample line of a
    Prometheus exposition.  ``key`` is the exact ``name{labels}`` string
    as rendered (every process renders through this module's registry,
    so identical series give identical keys)."""
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        suffix = ""
        if " # {" in line:
            head, _, tail = line.rpartition(" # {")
            line, suffix = head, " # {" + tail
        key, sep, value = line.rpartition(" ")
        if not sep:
            continue
        try:
            v = float(value)
        except ValueError:
            continue
        yield key, v, suffix


def _exposition_meta(text: str) -> Dict[str, List[str]]:
    """Metric family -> its # HELP/# TYPE lines, from one exposition."""
    out: Dict[str, List[str]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("#"):
            continue
        parts = line.split(None, 3)
        if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
            out.setdefault(parts[2], []).append(line)
    return out


def merge_expositions(primary: str, others: Dict[str, str]) -> str:
    """Sum per-process registry expositions into ONE whole-node exposition
    (the process-mode /metrics surface; pilosa_tpu/util/stats.py:1008).

    ``primary`` is the device owner's exposition; ``others`` maps a
    process label to that process's exposition (the worker registries).
    Samples sharing an exact ``name{labels}`` key are SUMMED (counters,
    gauges and histogram ``_bucket``/``_sum``/``_count`` lines are all
    additive across processes, which share DEFAULT_BUCKETS).  Worker-only
    series are appended with their own HELP/TYPE, emitted once and never
    for a family the primary declared already (a second HELP/TYPE line
    for one name fails the whole exposition in Prometheus' parser)."""
    add: Dict[str, float] = {}
    extra_order: List[str] = []
    extra_meta: Dict[str, List[str]] = {}
    for text in others.values():
        for key, v, _suffix in _iter_samples(text):
            if key in add:
                add[key] += v
            else:
                add[key] = v
                extra_order.append(key)
        for fam, meta in _exposition_meta(text).items():
            extra_meta.setdefault(fam, meta)
    out: List[str] = []
    for line in primary.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            out.append(line)
            continue
        suffix = ""
        sample = stripped
        if " # {" in sample:
            head, _, tail = sample.rpartition(" # {")
            sample, suffix = head, " # {" + tail
        key, sep, value = sample.rpartition(" ")
        delta = add.pop(key, None) if sep else None
        if delta is None:
            out.append(line)
            continue
        try:
            total = float(value) + delta
        except ValueError:
            out.append(line)
            continue
        out.append(f"{key} {_prom_float(total)}{suffix}")
    tail_lines: List[str] = []
    emitted_meta: set = set(_exposition_meta(primary))
    for key in extra_order:
        if key not in add:
            continue  # summed into a primary line above
        fam = _prom_name(key.split("{", 1)[0])
        base = fam
        for strip in ("_bucket", "_sum", "_count"):
            if base.endswith(strip):
                base = base[: -len(strip)]
        for meta_name in (base, fam):
            if meta_name in extra_meta and meta_name not in emitted_meta:
                emitted_meta.add(meta_name)
                tail_lines.extend(extra_meta[meta_name])
                break
        tail_lines.append(f"{key} {_prom_float(add[key])}")
    if tail_lines:
        if out and out[-1].strip() == "# EOF":
            out[-1:-1] = tail_lines
        else:
            out.extend(tail_lines)
    return "\n".join(out) + "\n"


def snapshot_from_exposition(text: str) -> dict:
    """Parse a classic Prometheus exposition back into the
    ``MetricsRegistry.snapshot()`` shape (pilosa_tpu/util/stats.py:1119).

    In process mode the history sampler runs in the device owner but must
    see the whole node, so it samples the merged exposition
    (``aggregate_metrics``) instead of the local registry.  Counters and
    gauges map directly (by their # TYPE lines); histograms are rebuilt
    from their cumulative ``_bucket`` lines against DEFAULT_BUCKETS, so
    p50/p95 come out of ``Histogram.snapshot``'s quantile math."""
    types: Dict[str, str] = {}
    for fam, meta in _exposition_meta(text).items():
        for line in meta:
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[fam] = parts[3]
    counters: Dict[str, Dict[str, float]] = {}
    gauges: Dict[str, Dict[str, float]] = {}
    # histogram family -> label_str -> {"buckets": {le: v}, "sum", "count"}
    hraw: Dict[str, Dict[str, dict]] = {}

    def split_key(key: str):
        if "{" in key:
            name, _, rest = key.partition("{")
            pairs = []
            for k, v in re.findall(r'([A-Za-z0-9_]+)="((?:[^"\\]|\\.)*)"', rest.rstrip("}")):
                v = v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\")
                pairs.append((k, v))
            return name, pairs
        return key, []

    def label_str(pairs) -> str:
        return ",".join(f"{k}={v}" for k, v in pairs) or "_"

    for key, v, _suffix in _iter_samples(text):
        name, pairs = split_key(key)
        base = name
        kind = None
        for strip in ("_bucket", "_sum", "_count"):
            if name.endswith(strip) and types.get(name[: -len(strip)]) == "histogram":
                base = name[: -len(strip)]
                kind = strip
                break
        if kind is not None:
            le = None
            core = [(k, lv) for k, lv in pairs if k != "le"]
            for k, lv in pairs:
                if k == "le":
                    le = lv
            ent = hraw.setdefault(base, {}).setdefault(
                label_str(core), {"buckets": {}, "sum": 0.0, "count": 0.0})
            if kind == "_bucket" and le is not None:
                ent["buckets"][le] = v
            elif kind == "_sum":
                ent["sum"] = v
            elif kind == "_count":
                ent["count"] = v
            continue
        t = types.get(name)
        if t == "counter":
            counters.setdefault(name, {})[label_str(pairs)] = v
        elif t == "gauge":
            gauges.setdefault(name, {})[label_str(pairs)] = v

    histograms: Dict[str, Dict[str, dict]] = {}
    for fam, series in hraw.items():
        out = histograms.setdefault(fam, {})
        for ls, ent in series.items():
            h = Histogram()
            cumulative = [ent["buckets"].get(_prom_float(b), 0.0) for b in DEFAULT_BUCKETS]
            cumulative.append(ent["buckets"].get("+Inf", ent["count"]))
            prev = 0.0
            for i, c in enumerate(cumulative):
                h._counts[i] = max(0, int(round(c - prev)))
                prev = max(prev, c)
            h.count = int(ent["count"])
            h.sum = float(ent["sum"])
            out[ls] = h.snapshot()
    return {"histograms": histograms, "counters": counters, "gauges": gauges}
