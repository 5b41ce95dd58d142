"""Prefetch advisor: predicted-next working sets, scored continuously.

The advisor drives promote-ahead: every advice set it issues is also pushed into
``ResidencyManager.request(cause="advisor")`` (minus the rows already
resident), behind the exact admission scoring, decline cooldowns, and
version-token commit gate demand promotions use — so speculative
promotions compete with demand traffic but can never corrupt it, and
they inherit a prediction quality that was already observable and
bench-guarded (``prefetch_advisor_hit_rate``) before the first byte
moved.  The residency worker additionally serves demand (non-advisor)
requests first, so promote-ahead never starves a miss.

Protocol (docs/observability.md "advisor scoring"): after each query
the advisor (1) grades the advice set issued after the PREVIOUS query
against the rows this query actually touched — every advised row is a
hit or a miss, counted on ``pilosa_advisor_{hits,misses}_total``; (2)
learns this query's signature -> working-set map; (3) issues a fresh
advice set from the miner's top predicted-next signature (probability
gate MIN_P), counting advised rows on
``pilosa_advisor_predictions_total`` and holding the set for the next
arrival.  ``GET /debug/prefetch_advice`` serves the outstanding set and
the running score.

Fed by the heat recorder (util/heat.py registers this module's
``ADVISOR.observe`` as a consumer), so the advisor sees exactly the
touches the heat tables and the tenant ledger account.

A copy of ``pilosa_tpu/parallel/advisor.py`` (stdlib only).  A promotion
it drives lands in the engine's block pool like a demand one, so the
predicted query's next arrival runs on K1P over pool rows instead of the
host lane.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from ..util import plan_miner
from ..util.stats import (
    METRIC_ADVISOR_HITS,
    METRIC_ADVISOR_MISSES,
    METRIC_ADVISOR_PREDICTIONS,
    REGISTRY,
)

# Minimum transition probability to issue advice at all — below this
# the miner is guessing and silence beats noise (a wrong prefetch would
# cost device bytes in the wired follow-on).
MIN_P = 0.2
# Bounds on the learned signature -> working-set maps.
MAX_SIGS = 256
MAX_ROWS_PER_SIG = 512


class PrefetchAdvisor:
    def __init__(self):
        self._lock = threading.Lock()
        # signature -> {(index, field, view): frozenset(rows)}
        self._working_sets: "OrderedDict[str, Dict[tuple, frozenset]]" = (
            OrderedDict()
        )
        # Outstanding advice: (predicted_sig, p, {key: rowset}) issued
        # after the last query, graded on the next arrival.
        self._outstanding: Optional[Tuple[str, float, dict]] = None
        self.predictions = 0
        self.hits = 0
        self.misses = 0
        self.advice_sets = 0
        # (predicted_sig, p, hits, misses) of the most recent grade.
        self.last_grade: Optional[tuple] = None
        self._c_pred = REGISTRY.counter(METRIC_ADVISOR_PREDICTIONS)
        self._c_hits = REGISTRY.counter(METRIC_ADVISOR_HITS)
        self._c_miss = REGISTRY.counter(METRIC_ADVISOR_MISSES)
        # -- promote-ahead --------------------------------------------------
        # Weak engine binding (TorchEngine.__init__ calls bind_engine):
        # advice must not pin a closed engine alive.
        self._engine_ref = None
        # Kill switch: False makes the advisor report-only (the bench A/B arm flips this).
        self.drive_promotions = True
        self.driven_rows = 0
        self.driven_requests = 0

    def bind_engine(self, engine):
        self._engine_ref = weakref.ref(engine)

    def _engine(self):
        ref = self._engine_ref
        return ref() if ref is not None else None

    # -- feed (heat-recorder consumer) ---------------------------------------

    def observe(self, plan, sig: str, touches: list):
        """One completed query: grade, learn, advise."""
        touched = set()
        ws: Dict[tuple, set] = {}
        for t in touches:
            index, field, view, rows = t[0], t[1], t[2], t[3]
            if not rows:
                continue  # full-stack touches advise nothing row-level
            key = (index, field, view)
            s = ws.setdefault(key, set())
            for r in rows:  # rows are sorted ints (engine._touch_of)
                touched.add((index, field, view, r))
                s.add(r)
        if not touched:
            # No row-granular working set (pure write, memo-less host
            # op): hold the outstanding advice for the next real one.
            return
        with self._lock:
            self._grade_locked(touched)
            self._learn_locked(sig, ws)
            self._advise_locked(sig)
            out = self._outstanding
        # Drive promote-ahead OUTSIDE the advisor lock: the residency
        # split takes engine locks and the eviction pricer reads this
        # advisor's predictions UNDER those locks (predicted_keys), so
        # holding both here would invert the lock order.
        if out is not None:
            self._drive(out[2])

    def _drive(self, hints: dict):
        """Push an advice set into residency as ``cause="advisor"``
        promote-ahead requests, minus the rows already resident.  Best
        effort on the query path: any failure is swallowed — advice
        must never fail the query it rode in on."""
        if not self.drive_promotions:
            return
        engine = self._engine()
        if engine is None:
            return
        try:
            for key, rows in hints.items():
                resident, _ = engine.residency_row_split(key, rows)
                want = set(rows) - resident
                if not want:
                    continue
                engine.residency.request(key, want, cause="advisor")
                self.driven_requests += 1
                self.driven_rows += len(want)
        except Exception:  # noqa: BLE001 — advice is strictly best-effort
            pass

    def predicted_keys(self) -> frozenset:
        """Keys named by the outstanding advice set — the eviction
        pricer's predicted-next-touch signal (engine._evict_for).
        Cold start (no outstanding advice) is the empty set, which
        reduces eviction ordering to the legacy cost/LRU blend."""
        with self._lock:
            out = self._outstanding
            return frozenset(out[2]) if out is not None else frozenset()

    def _grade_locked(self, touched: set):
        out = self._outstanding
        self._outstanding = None
        if out is None:
            return
        pred_sig, p, hints = out
        hits = 0
        misses = 0
        for (index, field, view), rows in hints.items():
            for r in rows:
                if (index, field, view, r) in touched:
                    hits += 1
                else:
                    misses += 1
        self.hits += hits
        self.misses += misses
        if hits:
            self._c_hits.inc(hits)
        if misses:
            self._c_miss.inc(misses)
        # Raw tuple on the hot path; to_doc() formats it.
        self.last_grade = (pred_sig, p, hits, misses)

    def _learn_locked(self, sig: str, ws: Dict[tuple, set]):
        if not ws:
            return
        cur = self._working_sets.get(sig)
        if cur is None:
            cur = self._working_sets[sig] = {}
            while len(self._working_sets) > MAX_SIGS:
                self._working_sets.popitem(last=False)
        else:
            self._working_sets.move_to_end(sig)
        for key, rows in ws.items():
            old = cur.get(key)
            if old is not None and rows <= old:
                continue  # steady state: nothing new to merge
            merged = set(old or ()) | rows
            if len(merged) > MAX_ROWS_PER_SIG:
                merged = set(sorted(merged)[:MAX_ROWS_PER_SIG])
            cur[key] = frozenset(merged)

    def _advise_locked(self, sig: str):
        pred = plan_miner.MINER.predict_next(sig)
        if pred is None:
            return  # cold start: unseen signature, no advice
        nxt, p = pred
        if p < MIN_P:
            return
        hints = self._working_sets.get(nxt)
        if not hints:
            return  # predicted signature's working set not learned yet
        n_rows = sum(len(r) for r in hints.values())
        if not n_rows:
            return
        self._outstanding = (nxt, p, dict(hints))
        self.advice_sets += 1
        self.predictions += n_rows
        self._c_pred.inc(n_rows)

    # -- read side -----------------------------------------------------------

    def hit_rate(self) -> float:
        with self._lock:
            graded = self.hits + self.misses
            return self.hits / graded if graded else 0.0

    def to_doc(self) -> dict:
        with self._lock:
            out = self._outstanding
            doc = {
                "adviceSets": self.advice_sets,
                "predictions": self.predictions,
                "hits": self.hits,
                "misses": self.misses,
                "hitRate": round(
                    self.hits / (self.hits + self.misses), 4
                ) if (self.hits + self.misses) else None,
                "lastGrade": {
                    "predictedSignature": self.last_grade[0],
                    "p": round(self.last_grade[1], 4),
                    "hits": self.last_grade[2],
                    "misses": self.last_grade[3],
                } if self.last_grade is not None else None,
                "learnedSignatures": len(self._working_sets),
                "minP": MIN_P,
                "drivesPromotions": bool(
                    self.drive_promotions and self._engine() is not None
                ),
                "drivenRequests": self.driven_requests,
                "drivenRows": self.driven_rows,
            }
            if out is None:
                doc["outstanding"] = None
            else:
                nxt, p, hints = out
                doc["outstanding"] = {
                    "predictedSignature": nxt,
                    "p": round(p, 4),
                    "hints": [
                        {"index": k[0], "field": k[1], "view": k[2],
                         "rows": sorted(rows)}
                        for k, rows in hints.items()
                    ],
                }
        return doc

    def reset(self):
        with self._lock:
            self._working_sets.clear()
            self._outstanding = None
            self.predictions = 0
            self.hits = 0
            self.misses = 0
            self.advice_sets = 0
            self.last_grade = None
            self.driven_rows = 0
            self.driven_requests = 0


ADVISOR = PrefetchAdvisor()
