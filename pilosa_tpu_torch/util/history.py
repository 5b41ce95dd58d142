"""Self-hosted metrics history: the index observes itself.

The HistorySampler walks the metrics registry every ``[observability]
sample-interval`` seconds and writes every series into the internal
``_system`` index through the NORMAL bulk-import paths — so metric
history is stored, sharded, compressed, op-logged, and queryable by the
same engine it measures (docs/observability.md).  Layout:

- One BSI int field per metric family.  Counters land as per-second
  rates under ``<family>_rate`` (monotonic-reset safe via
  ``stats.diff_rates``); histograms land as ``<family>_rate`` (count
  rate), ``<family>_p50_us`` and ``<family>_p95_us`` (quantiles in
  microseconds); gauges land under their own name.  Values are stored as
  ``round(v * SCALE)`` — the read surfaces report ``scale`` so clients
  recover floats.
- One shared time field ``samples`` (quantum ``H``, no standard view)
  holds a presence bit per stored value, so every sample lands in an
  hour view ``standard_YYYYMMDDHH`` — PQL ``Range(samples=<sid>, S, E)``
  over those views is the query surface, and retention is "drop the
  expired hour views", which bounds both storage and file count.
- Columns encode (time bucket, series): ``col = slot * STRIDE + sid``
  where ``slot = (bucket // interval) % ring_slots`` and ``sid`` is the
  series id from the key-translation store (key ``node|family|labels``).
  The ring is sized ``retention + 2h`` of slots, so by the time a slot
  is reused its previous hour view has long been retired — a stale BSI
  value at a reused column is unreachable from every read path, because
  both PQL (Range row ∧ Sum) and ``query()`` demand the presence bit in
  a live hour view.

Self-observation guard: the sampler's own imports are rerouted to
``pilosa_ingest_*{path="system"}`` by the API layer (they never touch
the headline ingest series), and the sampler skips sampling those
``path=system`` series — no feedback loop.

A copy of ``pilosa_tpu/util/history.py`` over the port's holder and API.
The read surface in PQL, ``Sum(Range(samples=<sid>, S, E),
field=<family>)``, runs on the card like any BSI Sum: K6 with the hour
views' time cover as its filter.  ``_retire`` drops hour views through
``API.delete_view``, which moves the index's shard epoch: a resident stack
of a dropped view is never read again (the budget's LRU evicts it).  The
reference coalesces the telemetry fields' snapshots
(``snapshot_debounce``); the port's fragments keep their own snapshot
policy, which has no such knob.
"""

from __future__ import annotations

import datetime as dt
import math
import re
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core import timequantum
from ..core.fragment import SHARD_WIDTH
from ..core.index import SYSTEM_INDEX
from ..core.view import VIEW_STANDARD, view_bsi_name
from .stats import (
    METRIC_HISTORY_DROPPED,
    METRIC_HISTORY_SAMPLES,
    METRIC_HISTORY_TICK_SECONDS,
    METRIC_HISTORY_TICKS,
    METRIC_HISTORY_VIEWS_DROPPED,
    REGISTRY,
    diff_rates,
)

# The shared presence/time field.  No leading underscore: PQL field
# names must start with a letter (pql/parser.py _FIELD_RE), and
# ``Range(samples=<sid>, ...)`` is the documented query surface.
SAMPLES_FIELD = "samples"
# Fixed-point factor for stored values (reads report it back).
SCALE = 1000
# Series slots per time bucket: sid must stay below this for the column
# encoding to be collision-free.  1024 series per node is far above the
# registry's real cardinality; overflow series are dropped and counted.
STRIDE = 1024
# BSI range ceiling — 52 bits holds every scaled value we emit (bytes
# gauges at ×1000 included) while staying exact in a float64 JSON path.
MAX_VALUE = (1 << 52) - 1

_HOUR_VIEW_RE = re.compile(r"standard_(\d{10})$")

# Ingest families whose path="system" series are the sampler's own
# writes: sampling them would re-measure the measurement.
_SELF_PREFIX = "pilosa_ingest_"
_SELF_LABEL = "path=system"


def _suppressed(family: str, label_str: str) -> bool:
    return family.startswith(_SELF_PREFIX) and _SELF_LABEL in label_str.split(
        ","
    )


def _flatten_counters(snap: dict) -> Dict[str, Dict[str, float]]:
    """Counters + histogram counts as one rate-diffable counter map
    (histogram counts are monotonic — their diff is the event rate)."""
    flat = {f: dict(s) for f, s in snap.get("counters", {}).items()}
    for fam, series in snap.get("histograms", {}).items():
        flat["\x00hist:" + fam] = {
            ls: float(h.get("count", 0)) for ls, h in series.items()
        }
    return flat


def _hour_start(tb: float) -> dt.datetime:
    t = dt.datetime.fromtimestamp(tb, dt.timezone.utc).replace(tzinfo=None)
    return t


class HistorySampler:
    """Background sampler + read surface over the ``_system`` index.

    Construct with the serving API; ``tick()`` is driven either by the
    Server's monitor thread (real deployments) or directly by tests with
    an explicit ``now`` (no thread, deterministic buckets).
    ``snapshot_fn`` overrides where samples come from — process mode
    passes a merged-exposition reader so worker registries are included.
    """

    def __init__(
        self,
        api,
        node: str = "",
        interval: float = 10.0,
        retention: float = 3600.0,
        snapshot_fn: Optional[Callable[[], dict]] = None,
        now_fn: Callable[[], float] = time.time,
    ):
        self.api = api
        self.node = node
        self.interval = max(0.25, float(interval))
        self.retention = max(self.interval, float(retention))
        # Slot-ring period = retention + 2h: a reused slot's previous
        # hour view is guaranteed already retired (see module docstring).
        self.ring_slots = max(
            8, int(math.ceil((self.retention + 7200.0) / self.interval))
        )
        self._snapshot_fn = snapshot_fn or REGISTRY.snapshot
        self._now = now_fn
        self._lock = threading.Lock()
        self._prev: Optional[dict] = None
        # series key -> sid (-1 = dropped: sid past STRIDE)
        self._sids: Dict[str, int] = {}
        # family field -> {label_str: sid} — the read-side registry
        self._series: Dict[str, Dict[str, int]] = {}
        # family -> (field, bsi_view, bit_depth) write-target cache
        self._fields_ok: Dict[str, tuple] = {}
        self._schema_ok = False
        # Ring slots this process has written.  The first visit to a
        # slot is a FRESH write (its columns provably carry no value:
        # the ring period exceeds the hour-view span and boot wipes any
        # inherited _system state), so value imports can take the
        # set-only BSI fast path; a wrapped slot falls back to the full
        # clear+set import.
        self._seen_slots: set = set()
        self.last_tick_ts = 0.0
        # Callables run (fenced) at the top of every tick BEFORE the
        # registry snapshot — pull-time gauges that would otherwise only
        # refresh at /metrics scrapes (the working-set heat gauges:
        # tracked rows + residency gap) get a current value in every
        # sampled point, so gap-over-time is PQL-queryable at the
        # sampler's full resolution.
        self.pre_tick_hooks: list = []
        self._c_ticks = REGISTRY.counter(METRIC_HISTORY_TICKS)
        self._c_samples = REGISTRY.counter(METRIC_HISTORY_SAMPLES)
        self._c_views_dropped = REGISTRY.counter(METRIC_HISTORY_VIEWS_DROPPED)
        self._c_drop = {
            r: REGISTRY.counter(METRIC_HISTORY_DROPPED, reason=r)
            for r in ("stride", "clamp", "error")
        }
        self._h_tick = REGISTRY.histogram(METRIC_HISTORY_TICK_SECONDS)

    # -- schema ------------------------------------------------------------

    def ensure_schema(self):
        holder = self.api.holder
        if holder.index(SYSTEM_INDEX) is not None:
            # Inherited _system state from a previous process: wipe it.
            # History is process-lifetime telemetry (flight-recorder
            # bundles are the durable artifact); starting clean bounds
            # stale BSI data on disk and is what makes the sampler's
            # first-lap fresh-slot claim sound.
            try:
                self.api.delete_index(SYSTEM_INDEX)
            except Exception:
                pass
        if holder.index(SYSTEM_INDEX) is None:
            try:
                self.api.create_index(SYSTEM_INDEX, track_existence=False)
            except Exception:
                pass  # concurrent creator (broadcast replay) won the race
        idx = holder.index(SYSTEM_INDEX)
        if idx is not None and idx.field(SAMPLES_FIELD) is None:
            self.api.create_field(
                SYSTEM_INDEX,
                SAMPLES_FIELD,
                {
                    "type": "time",
                    "timeQuantum": "H",
                    "noStandardView": True,
                    "cacheType": "none",
                },
            )
        self._schema_ok = True

    def _ensure_field(self, family: str):
        """Create-if-missing and return ``(field, bsi_view, bit_depth)``
        for one family — the sampler's direct write target."""
        cached = self._fields_ok.get(family)
        if cached is not None:
            return cached
        idx = self.api.holder.index(SYSTEM_INDEX)
        if idx is None:
            return None
        if idx.field(family) is None:
            self.api.create_field(
                SYSTEM_INDEX,
                family,
                {
                    "type": "int",
                    "min": 0,
                    "max": MAX_VALUE,
                    # No TopN surface over telemetry bit planes: a rank
                    # cache would only add invalidate/recalculate work
                    # to every tick.
                    "cacheType": "none",
                },
            )
        fld = idx.field(family)
        if fld is None:
            return None
        view = fld.view_if_not_exists(view_bsi_name(family))
        cached = (fld, view, fld.bsi_group(family).bit_depth())
        self._fields_ok[family] = cached
        return cached

    def _sid(self, family: str, label_str: str) -> Optional[int]:
        key = f"{self.node}|{family}|{label_str}"
        sid = self._sids.get(key)
        if sid is None:
            sid = self.api.translate_store.translate_rows_to_uint64(
                SYSTEM_INDEX, SAMPLES_FIELD, [key]
            )[0]
            if sid >= STRIDE:
                sid = -1
                self._c_drop["stride"].inc()
            self._sids[key] = sid
            if sid >= 0:
                self._series.setdefault(family, {})[label_str] = sid
        return None if sid < 0 else sid

    # -- sampling ----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        """One sampler pass: registry snapshot -> rates/quantiles/gauges
        -> one bulk value import per family + one presence import ->
        retention.  Returns the number of values stored."""
        with self._lock:
            return self._tick_locked(now)

    def _tick_locked(self, now: Optional[float]) -> int:
        t0 = time.monotonic()
        if now is None:
            now = self._now()
        if not self._schema_ok:
            self.ensure_schema()
        for hook in self.pre_tick_hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — a hook never fails a tick
                pass
        snap = self._snapshot_fn()
        flat = _flatten_counters(snap)
        prev = self._prev
        self._prev = {"ts": now, "counters": flat}
        rates: Dict[str, Dict[str, float]] = {}
        if prev is not None:
            rates = diff_rates(prev["counters"], flat, now - prev["ts"])

        points: List[tuple] = []  # (family_field, label_str, raw_value)
        for fam, series in rates.items():
            if fam.startswith("\x00hist:"):
                src = fam[len("\x00hist:"):]
            else:
                src = fam
            for ls, v in series.items():
                if _suppressed(src, ls):
                    continue
                points.append((src + "_rate", ls, v * SCALE))
        for fam, series in snap.get("gauges", {}).items():
            for ls, v in series.items():
                points.append((fam, ls, v * SCALE))
        for fam, series in snap.get("histograms", {}).items():
            for ls, h in series.items():
                if _suppressed(fam, ls):
                    continue
                points.append((fam + "_p50_us", ls, h.get("p50", 0.0) * 1e6))
                points.append((fam + "_p95_us", ls, h.get("p95", 0.0) * 1e6))

        bucket = int(now // self.interval)
        tb = bucket * self.interval
        slot = bucket % self.ring_slots
        by_field: Dict[str, tuple] = {}
        bit_rows: List[int] = []
        bit_cols: List[int] = []
        for fam, ls, raw in points:
            v = int(round(raw))
            if v < 0 or v > MAX_VALUE:
                self._c_drop["clamp"].inc()
                v = min(max(v, 0), MAX_VALUE)
            sid = self._sid(fam, ls)
            if sid is None:
                continue
            col = slot * STRIDE + sid
            cols, vals = by_field.setdefault(fam, ([], []))
            cols.append(col)
            vals.append(v)
            bit_rows.append(sid)
            bit_cols.append(col)

        from ..api import ImportRequest

        fresh = slot not in self._seen_slots
        self._seen_slots.add(slot)
        # Every column this tick shares one shard: cols span
        # [slot*STRIDE, slot*STRIDE + STRIDE) and SHARD_WIDTH is a
        # multiple of STRIDE.  Writes go straight to that fragment —
        # at ~84 families per tick the API/field layers' per-call
        # bookkeeping would otherwise dominate the sampler's duty
        # cycle; one explicit _ingest_done below keeps the
        # path="system" attribution and the device-sync nudge.
        shard = (slot * STRIDE) // SHARD_WIDTH
        t0_imp = time.monotonic()
        stored = 0
        for fam, (cols, vals) in by_field.items():
            try:
                target = self._ensure_field(fam)
                if target is None:
                    raise RuntimeError("_system index unavailable")
                _fld, view, depth = target
                view.fragment_if_not_exists(shard).import_values(
                    cols, vals, depth, fresh=fresh
                )
                stored += len(cols)
            except Exception:
                self._c_drop["error"].inc(len(cols))
        if stored:
            try:
                self.api._ingest_done(
                    "values", SYSTEM_INDEX, stored, t0_imp
                )
            except Exception:
                pass
        if bit_cols:
            ts_ns = int(tb * 1e9)
            try:
                self.api.import_bits(
                    ImportRequest(
                        SYSTEM_INDEX,
                        SAMPLES_FIELD,
                        row_ids=bit_rows,
                        column_ids=bit_cols,
                        timestamps=[ts_ns] * len(bit_cols),
                    )
                )
            except Exception:
                self._c_drop["error"].inc(len(bit_cols))
                stored = 0
        self._retire(now)
        self.last_tick_ts = now
        self._c_ticks.inc()
        self._c_samples.inc(stored)
        self._h_tick.observe(time.monotonic() - t0)
        return stored

    def _retire(self, now: float):
        """Drop hour views whose whole hour has aged past retention —
        the retention unit IS the time-quantum view, so expiry is a
        bounded file/metadata delete, never a scan."""
        idx = self.api.holder.index(SYSTEM_INDEX)
        f = idx.field(SAMPLES_FIELD) if idx is not None else None
        if f is None:
            return
        cutoff = now - self.retention
        for name in list(f.views):
            m = _HOUR_VIEW_RE.match(name)
            if m is None:
                continue
            try:
                start = dt.datetime.strptime(m.group(1), "%Y%m%d%H").replace(
                    tzinfo=dt.timezone.utc
                )
            except ValueError:
                continue
            if start.timestamp() + 3600.0 <= cutoff:
                try:
                    self.api.delete_view(SYSTEM_INDEX, SAMPLES_FIELD, name)
                    self._c_views_dropped.inc()
                except Exception:
                    pass

    # -- reads -------------------------------------------------------------

    def query(
        self,
        series: str,
        since: Optional[float] = None,
        until: Optional[float] = None,
        step: Optional[float] = None,
        label: Optional[str] = None,
    ) -> dict:
        """Downsampled series read for /debug/history.

        Reads the SAME planes PQL does: a point exists iff its presence
        bit is set in the covering LIVE hour view (so retention and ring
        reuse are invisible) and the family's BSI holds a value at the
        column.  Values are scaled ints; ``scale`` recovers floats.
        """
        now = self._now()
        until = now if until is None else float(until)
        since = until - 300.0 if since is None else float(since)
        step = self.interval if not step else max(
            self.interval,
            round(float(step) / self.interval) * self.interval,
        )
        fam_series = dict(self._series.get(series, {}))
        if label is not None:
            fam_series = {
                ls: sid for ls, sid in fam_series.items() if ls == label
            }
        out: Dict[str, list] = {ls: [] for ls in fam_series}
        idx = self.api.holder.index(SYSTEM_INDEX)
        f = idx.field(series) if idx is not None else None
        samples_f = idx.field(SAMPLES_FIELD) if idx is not None else None
        if f is not None and samples_f is not None and fam_series:
            start = math.ceil(since / self.interval) * self.interval
            n_buckets = int(max(0.0, until - start) // step) + 1
            view_cache: Dict[str, object] = {}
            for i in range(n_buckets):
                tb = start + i * step
                if tb > until:
                    break
                vname = timequantum.views_by_time(
                    VIEW_STANDARD, _hour_start(tb), "H"
                )[0]
                view = view_cache.get(vname)
                if vname not in view_cache:
                    view = samples_f.view(vname)
                    view_cache[vname] = view
                if view is None:
                    continue
                slot = int(round(tb / self.interval)) % self.ring_slots
                for ls, sid in fam_series.items():
                    col = slot * STRIDE + sid
                    frag = view.fragment(col // SHARD_WIDTH)
                    if frag is None or not frag.bit(sid, col):
                        continue
                    v, ok = f.value(col)
                    if ok:
                        out[ls].append([tb, v])
        return {
            "series": series,
            "node": self.node,
            "scale": SCALE,
            "interval": self.interval,
            "step": step,
            "since": since,
            "until": until,
            "points": out,
        }

    def series_names(self) -> List[str]:
        return sorted(self._series)

    def window(
        self, seconds: float, until: Optional[float] = None
    ) -> Dict[str, dict]:
        """Every known family over the trailing window — the flight
        recorder's history section.  ``until`` anchors the window (an
        SLO-triggered capture anchors at the breach evaluation time, so
        the bundle holds exactly the breaching window)."""
        now = self._now() if until is None else float(until)
        out = {}
        for fam in self.series_names():
            q = self.query(fam, since=now - seconds, until=now)
            pts = {ls: p for ls, p in q["points"].items() if p}
            if pts:
                out[fam] = {"scale": q["scale"], "points": pts}
        return out

    def snapshot(self) -> dict:
        idx = self.api.holder.index(SYSTEM_INDEX)
        f = idx.field(SAMPLES_FIELD) if idx is not None else None
        return {
            "enabled": True,
            "node": self.node,
            "interval": self.interval,
            "retention": self.retention,
            "ringSlots": self.ring_slots,
            "families": len(self._series),
            "series": sum(len(s) for s in self._series.values()),
            "hourViews": sorted(f.views) if f is not None else [],
            "lastTickTs": self.last_tick_ts,
        }
