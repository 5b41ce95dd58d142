"""Working-set heat recorder (docs/observability.md).

The telemetry substrate for predictive residency: every recorded query
plan — fused, sparse-peeled, host-fallback, and repair-served alike —
carries per-dispatch ``touches`` notes naming the (index, field, view)
stacks it read, the row ids, and the occupied 2KiB blocks.  This module
folds those notes into bounded per-(index, field, view) EWMA heat
tables at row AND block granularity, exported as:

* ``GET /debug/heat?index=&field=&topk=`` — top-K hot rows/blocks per
  table with a resident-vs-host split (which hot rows the device
  actually holds);
* gauge ``pilosa_engine_heat_tracked_rows`` — rows with live heat
  state;
* gauge ``pilosa_engine_residency_gap_bytes`` — bytes of HOT rows NOT
  device-resident: the single number that says "promotion is behind
  traffic" (0 when the working set is resident).  The ``_system``
  history sampler snapshots it every tick, so gap-over-time is
  PQL-queryable like any other series.

Drift-free by construction: heat consumes the SAME per-dispatch plan
notes that feed ``pilosa_device_bytes_skipped_total`` and the tenant
ledger (``plans.record`` fans one plan object out to all three), so the
heat tables' byte totals always reconcile with the counter deltas —
``totals()["bytesAccounted"]`` equals the ledger's per-tenant sum for
the same traffic (tests/test_heat.py pins it).

The recorder also feeds the access-sequence miner
(``plan_miner.MINER``) and the prefetch advisor
(``parallel/advisor.py``), giving them one consistent view of what each
query touched.

A dispatch note's ``touches`` entry is a tuple::

    (index, field, view, rows, n_blocks, block_mask)

``rows`` is a sorted tuple of row ids (None = the whole stack, e.g. a
BSI aggregate over every plane), ``n_blocks`` the summed occupied-block
count across those rows, ``block_mask`` the OR of their 64-bit
occupancy masks (bit b = occupancy block b touched).  Byte accounting
stays op-level: each op's ``bytes_touched`` is distributed across its
touches weighted by row count, and ops without touches accumulate into
the ``untracked`` bucket — so the sum over tables plus untracked equals
the op-note total exactly.

Kill switch: ``PILOSA_HEAT=0`` (or ``HEAT.enabled = False`` at
runtime) drops the recorder to a no-op; the plans layer's own
``PILOSA_PLANS=0`` disables it transitively (no plans are recorded).

A copy of ``pilosa_tpu/util/heat.py`` (stdlib only): the same EWMA float
operations in the same order, so that the port's tables equal the
reference's for the same plans.  The touches come from
``TorchEngine._touch_of`` over the stacks' host occupancy summaries
(``_FieldStack.occ``, numpy): recording heat never reads the card.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from . import plan_miner
from . import plans as plans_mod
from .stats import (
    METRIC_ENGINE_HEAT_TRACKED_ROWS,
    METRIC_ENGINE_RESIDENCY_GAP,
    REGISTRY,
)

# Blocks per (row, shard): occupancy masks are uint64 bitmaps
# (bitops.OCC_BLOCKS; imported lazily to keep util/ free of the
# accelerator modules).
N_BLOCKS = 64

# Bounds: tables (LRU) and rows per table (coldest pruned).  At the
# defaults the whole recorder tops out around 128 * 2048 row entries —
# a few MB of host state for an arbitrarily large index.
MAX_TABLES = 128
MAX_ROWS = 2048
# Per-observation EWMA decay applied lazily per row (heat at tick t =
# heat * DECAY**(t - last_tick)); a row is HOT while its effective heat
# is at least HOT_HEAT — untouched for ~60 plans it cools below the
# threshold and leaves the residency-gap accounting.
DECAY = 0.95
HOT_HEAT = 0.25

# Distinct occupancy masks tracked per table (block heat is keyed by
# mask; coldest quartile pruned past the bound).
MAX_MASKS = 64

# Replay cache for memoized dispatches: a memo hit runs NO dispatch (so
# stamps no touches), but the query still *logically* touched the same
# working set — replay the touches its first real dispatch recorded,
# with zero bytes (no device bytes moved; the ledger agrees).
MAX_MEMO = 512


class _Table:
    """Heat state for one (index, field, view) stack."""

    __slots__ = ("rows", "block_heat", "touches", "bytes", "full_touches")

    def __init__(self):
        # row id -> [heat, last_tick, touches, bytes]
        self.rows: Dict[int, list] = {}
        # Block heat is keyed by occupancy MASK, not by block: repeated
        # traffic reuses the same mask, so a touch is one O(1) dict
        # update instead of a 64-bit walk (the walk moved to the rare
        # read path — see block_heats()).  mask -> [heat, last_tick].
        self.block_heat: Dict[int, list] = {}
        self.touches = 0
        self.bytes = 0
        self.full_touches = 0  # rows=None observations (whole stack)

    def heat_of(self, entry: list, tick: int) -> float:
        return entry[0] * (DECAY ** max(0, tick - entry[1]))

    def touch(self, tick: int, rows: Optional[tuple], n_blocks: int,
              block_mask: int, nbytes: int):
        self.touches += 1
        self.bytes += nbytes
        if block_mask:
            e = self.block_heat.get(block_mask)
            if e is None:
                if len(self.block_heat) >= MAX_MASKS:
                    ranked = sorted(
                        self.block_heat.items(),
                        key=lambda kv: self.heat_of(kv[1], tick),
                    )
                    for m, _e in ranked[: MAX_MASKS // 4]:
                        del self.block_heat[m]
                e = self.block_heat[block_mask] = [0.0, tick]
            dt = tick - e[1]
            e[0] = (e[0] * (DECAY ** dt) if dt > 0 else e[0]) + 1.0
            e[1] = tick
        if rows is None:
            self.full_touches += 1
            return
        per_row = nbytes // len(rows) if rows else 0
        rem = nbytes - per_row * len(rows)
        for i, r in enumerate(rows):
            e = self.rows.get(r)
            if e is None:
                e = self.rows[r] = [0.0, tick, 0, 0]
            dt = tick - e[1]
            e[0] = (e[0] * (DECAY ** dt) if dt > 0 else e[0]) + 1.0
            e[1] = tick
            e[2] += 1
            e[3] += per_row + (rem if i == 0 else 0)
        if len(self.rows) > MAX_ROWS:
            # Prune the coldest quartile in one pass — amortized O(1)
            # per touch, and a pruned row simply re-warms if touched.
            ranked = sorted(
                self.rows.items(), key=lambda kv: self.heat_of(kv[1], tick)
            )
            for r, _e in ranked[: MAX_ROWS // 4]:
                del self.rows[r]

    def hot_rows(self, tick: int) -> List[int]:
        return [
            r for r, e in self.rows.items()
            if self.heat_of(e, tick) >= HOT_HEAT
        ]

    def block_heats(self, tick: int) -> List[float]:
        """Fold the mask-keyed heat into per-block floats (read path
        only — /debug/heat)."""
        out = [0.0] * N_BLOCKS
        for mask, e in self.block_heat.items():
            h = self.heat_of(e, tick)
            m = mask
            while m:
                b = (m & -m).bit_length() - 1
                out[b] += h
                m &= m - 1
        return out


class HeatRecorder:
    """Process-wide working-set heat state, fed by ``plans.record``."""

    def __init__(self):
        self.enabled = os.environ.get("PILOSA_HEAT", "1") != "0"
        self._lock = threading.Lock()
        self._tables: "OrderedDict[Tuple[str, str, str], _Table]" = (
            OrderedDict()
        )
        self._tick = 0
        self._engine_ref = None  # weakref to the bound TorchEngine
        # (index, query) -> touches list, for memo-hit replay.
        self._memo_touches: "OrderedDict[tuple, list]" = OrderedDict()
        # Byte reconciliation (the differential-test contract): every
        # op-note byte lands in exactly one of tables / untracked.
        self.bytes_accounted = 0
        self.untracked_bytes = 0
        self.plans_observed = 0
        # Downstream consumers fed (plan, signature, touches) after the
        # tables update — the prefetch advisor registers here lazily
        # (import inside the record path to avoid a util<->parallel
        # import cycle at module load).
        self._consumers: Optional[list] = None

    # -- engine binding ------------------------------------------------------

    def bind_engine(self, engine):
        """Bind the TorchEngine whose residency answers the
        resident-vs-host split (weakly: heat must not pin a closed
        engine alive).  Last binding wins — one serving engine per
        process."""
        self._engine_ref = weakref.ref(engine)

    def _engine(self):
        ref = self._engine_ref
        return ref() if ref is not None else None

    # -- record side (plans.record observer) ---------------------------------

    def observe_plan(self, plan):
        if not self.enabled:
            return
        index = getattr(plan, "index", None)
        query = getattr(plan, "query", None)
        if not index or index.startswith("_") or not query:
            # The _system self-metrics index (SLO watcher PQL, history
            # flushes) must not pollute the traffic model.
            return
        ops = list(getattr(plan, "ops", ()) or ())
        touched: list = []
        untracked = 0
        memo_hit = False
        for op in ops:
            nbytes = int(op.get("bytes_touched") or 0)
            touches = op.get("touches")
            if touches:
                touched.append((touches, nbytes))
            else:
                untracked += nbytes
                if op.get("memo") == "hit":
                    memo_hit = True
        with self._lock:
            self._tick += 1
            tick = self._tick
            self.plans_observed += 1
            mkey = (index, query)
            if not touched and memo_hit:
                # Memoized: replay the working set the first real
                # dispatch recorded, byte-free (the stored (touches,
                # bytes) pairs are re-labeled with zero bytes here —
                # flattening is deferred to this rare path).
                stored = self._memo_touches.get(mkey)
                if stored is not None:
                    self._memo_touches.move_to_end(mkey)
                    touched = [(ts, 0) for ts, _b in stored]
            elif touched:
                self._memo_touches[mkey] = touched
                self._memo_touches.move_to_end(mkey)
                while len(self._memo_touches) > MAX_MEMO:
                    self._memo_touches.popitem(last=False)
            self.bytes_accounted += untracked
            self.untracked_bytes += untracked
            all_touches: list = []
            for touches, nbytes in touched:
                self.bytes_accounted += nbytes
                if len(touches) == 1:  # the common single-stack op
                    self._touch_locked(tick, touches[0], nbytes)
                    all_touches.append(touches[0])
                    continue
                weights = [
                    (len(t[3]) if t[3] else 1) for t in touches
                ]
                total_w = sum(weights) or 1
                spent = 0
                for i, t in enumerate(touches):
                    share = (
                        nbytes - spent if i == len(touches) - 1
                        else nbytes * weights[i] // total_w
                    )
                    spent += share
                    self._touch_locked(tick, t, share)
                    all_touches.append(t)
        # Sequence + advisor feeds run OUTSIDE the table lock (the
        # miner and advisor have their own locks; signature() parses).
        try:
            sig = plan_miner.signature(index, query)
            plan_miner.MINER.observe(sig, float(plan.start_wall))
        except Exception:  # noqa: BLE001 — telemetry never fails a query
            sig = None
        if sig is not None:
            for fn in self._consumer_list():
                try:
                    fn(plan, sig, all_touches)
                except Exception:  # noqa: BLE001
                    pass

    def _consumer_list(self) -> list:
        if self._consumers is None:
            consumers = []
            try:
                from ..parallel import advisor as advisor_mod

                consumers.append(advisor_mod.ADVISOR.observe)
            except Exception:  # noqa: BLE001 — advisor optional
                pass
            self._consumers = consumers
        return self._consumers

    def add_consumer(self, fn):
        lst = self._consumer_list()
        if fn not in lst:
            lst.append(fn)

    def _touch_locked(self, tick, t, nbytes):
        index, field, view, rows, n_blocks, block_mask = t
        key = (index, field, view)
        tab = self._tables.get(key)
        if tab is None:
            tab = self._tables[key] = _Table()
            while len(self._tables) > MAX_TABLES:
                self._tables.popitem(last=False)
        else:
            self._tables.move_to_end(key)
        tab.touch(tick, rows, int(n_blocks), int(block_mask), int(nbytes))

    # -- read side -----------------------------------------------------------

    def refresh_gauges(self) -> dict:
        """Recompute + set the two heat gauges; returns {trackedRows,
        gapBytes} (the history sampler's pre-tick hook calls this so
        every sampled point is current)."""
        eng = self._engine()
        tracked = 0
        gap = 0
        with self._lock:
            tick = self._tick
            items = [
                (key, tab.hot_rows(tick), len(tab.rows))
                for key, tab in self._tables.items()
            ]
        for key, hot, n_rows in items:
            tracked += n_rows
            if not hot or eng is None:
                continue
            try:
                resident, row_bytes = eng.residency_row_split(key, hot)
            except Exception:  # noqa: BLE001 — gauge is best-effort
                continue
            gap += (len(hot) - len(resident)) * row_bytes
        REGISTRY.set_gauge(METRIC_ENGINE_HEAT_TRACKED_ROWS, tracked)
        REGISTRY.set_gauge(METRIC_ENGINE_RESIDENCY_GAP, gap)
        return {"trackedRows": tracked, "gapBytes": gap}

    def to_doc(self, index: str = "", field: str = "",
               topk: int = 10) -> dict:
        """The /debug/heat document: per-table top-K hot rows (with the
        resident-vs-host split) and top-K hot blocks."""
        eng = self._engine()
        topk = max(1, int(topk))
        with self._lock:
            tick = self._tick
            keys = [
                k for k in self._tables
                if (not index or k[0] == index)
                and (not field or k[1] == field)
            ]
            snap = []
            for k in keys:
                tab = self._tables[k]
                rows = [
                    (r, tab.heat_of(e, tick), e[2], e[3])
                    for r, e in tab.rows.items()
                ]
                snap.append((k, rows, tab.block_heats(tick), tab.touches,
                             tab.bytes, tab.full_touches))
        tables = []
        for k, rows, blocks, touches, nbytes, full in snap:
            rows.sort(key=lambda t: (-t[1], t[0]))
            hot = [r for r, h, _t, _b in rows if h >= HOT_HEAT]
            resident: set = set()
            row_bytes = 0
            if eng is not None and hot:
                try:
                    resident, row_bytes = eng.residency_row_split(k, hot)
                except Exception:  # noqa: BLE001
                    pass
            blk = sorted(
                ((b, h) for b, h in enumerate(blocks) if h > 0),
                key=lambda t: (-t[1], t[0]),
            )
            tables.append({
                "index": k[0], "field": k[1], "view": k[2],
                "rows": len(rows),
                "hotRows": len(hot),
                "residentHotRows": len(resident),
                "gapBytes": (len(hot) - len(resident)) * row_bytes,
                "touches": touches,
                "fullStackTouches": full,
                "bytes": nbytes,
                "topRows": [
                    {"row": r, "heat": round(h, 4), "touches": t,
                     "bytes": b,
                     "resident": (r in resident) if hot else None}
                    for r, h, t, b in rows[:topk]
                ],
                "topBlocks": [
                    {"block": b, "heat": round(h, 4)}
                    for b, h in blk[:topk]
                ],
            })
        tables.sort(key=lambda t: -t["bytes"])
        with self._lock:
            doc = {
                "plansObserved": self.plans_observed,
                "bytesAccounted": self.bytes_accounted,
                "untrackedBytes": self.untracked_bytes,
                "blockBytes": 2048,
            }
        doc["tables"] = tables
        return doc

    def totals(self) -> dict:
        """Byte reconciliation for the differential test: table bytes +
        untracked == bytesAccounted == sum of op-note bytes_touched."""
        with self._lock:
            return {
                "bytesAccounted": self.bytes_accounted,
                "untrackedBytes": self.untracked_bytes,
                "tableBytes": sum(
                    t.bytes for t in self._tables.values()
                ),
                "tables": len(self._tables),
                "plansObserved": self.plans_observed,
            }

    def reset(self):
        with self._lock:
            self._tables.clear()
            self._memo_touches.clear()
            self._tick = 0
            self.bytes_accounted = 0
            self.untracked_bytes = 0
            self.plans_observed = 0
        REGISTRY.set_gauge(METRIC_ENGINE_HEAT_TRACKED_ROWS, 0)
        REGISTRY.set_gauge(METRIC_ENGINE_RESIDENCY_GAP, 0)


HEAT = HeatRecorder()
plans_mod.add_observer(HEAT.observe_plan)
