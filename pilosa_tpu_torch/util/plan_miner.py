"""Access-sequence miner over recorded query plans: the first-order
plan-signature transition model served at ``GET /debug/sequences``.

A plan's signature is its index plus the sorted mask-subtree texts of its
calls, the canonicalization the fused planner hash-conses masks by
(``parallel/fusion.subtree_texts``).  Dashboards repeat, so "after
signature A, signature B follows within the window with probability p"
is learnable from the plans alone.

A copy of the online half of ``pilosa_tpu/util/plan_miner.py`` (stdlib
only; the parser and ``fusion.subtree_texts`` are the port's own).  The
heat recorder (``util/heat.py``) feeds ``MINER`` every recorded plan, and
the prefetch advisor reads ``predict_next``.  The reference's offline
reports (``mine``, ``mine_sequences`` and their renderers, used only by
its ``scripts/plan_miner.py``) come with the port of that script
(ROADMAP.md Queue 1)."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

# Top-level call names whose first child is a mask (Row) tree; a bare
# bitmap call is its own mask.
_MASK_PARENTS = ("Count", "Sum", "Min", "Max", "TopN", "Rows", "GroupBy")
_BITMAP_CALLS = ("Row", "Union", "Intersect", "Difference", "Xor", "Not",
                 "Range")


def _mask_trees(call) -> list:
    """The mask (Row-tree) roots a top-level call evaluates."""
    if call.name in _BITMAP_CALLS:
        return [call]
    if call.name in _MASK_PARENTS and call.children:
        return [ch for ch in call.children if ch.name in _BITMAP_CALLS]
    return []


def plan_masks(query_text: str) -> List[str]:
    """Every mask-subtree text a recorded query evaluates (one entry
    per OCCURRENCE — repeats across the query's own calls count).
    Unparseable / truncated plan texts yield []."""
    from ..parallel.fusion import subtree_texts
    from ..pql import parser as pql_parser

    try:
        q = pql_parser.parse(query_text)
    except Exception:  # noqa: BLE001 — recorded text may be truncated
        return []
    out: List[str] = []
    for call in q.calls:
        for tree in _mask_trees(call):
            # Every subtree is a potential shared mask: the fused
            # planner hash-conses at all levels, so mine at all levels.
            out.extend(sorted(subtree_texts(tree)))
    return out


# Two queries more than WINDOW_S apart are unrelated for sequence
# purposes (a dashboard burst fires its widgets back-to-back; the e2e
# HTTP RTT floor of a loopback node is ~100ms, so 5s comfortably spans a
# burst without chaining independent sessions).
WINDOW_S = 5.0
# Bounds: distinct signatures tracked, and successor fan-out per
# signature.  Least-recently-observed signatures / lowest-count edges
# are evicted first.
MAX_SIGS = 256
MAX_NEXT = 16

_SIG_CACHE: "OrderedDict[Tuple[str, str], str]" = OrderedDict()
_SIG_CACHE_MAX = 512
_SIG_LOCK = threading.Lock()


def signature(index: str, query_text: str) -> str:
    """Canonical signature of a recorded query: its index plus the
    sorted mask-subtree texts (the same ``fusion.subtree_texts``
    canonicalization the fused planner hash-conses by), so predictions
    name real mask slots.  Unparseable texts fall back to the raw query
    string — still a stable key for repeats.

    The cache hit is LOCK-FREE (a single dict get is atomic under the
    GIL) and eviction is insertion-order FIFO rather than LRU — this
    runs on every recorded plan, and a repeated-dashboard workload hits
    the same few entries forever, so recency tracking buys nothing."""
    key = (index, query_text)
    hit = _SIG_CACHE.get(key)
    if hit is not None:
        return hit
    masks = plan_masks(query_text)
    sig = f"{index}|" + (";".join(masks) if masks else query_text)
    with _SIG_LOCK:
        _SIG_CACHE[key] = sig
        while len(_SIG_CACHE) > _SIG_CACHE_MAX:
            _SIG_CACHE.popitem(last=False)
    return sig


class TransitionModel:
    """Bounded first-order transition table over plan signatures.

    ``observe(sig, wall)`` feeds one completed query; an edge
    ``prev → sig`` is counted only when the gap is within ``window_s``.
    ``predictions(sig)`` never raises on unseen signatures: cold start
    returns []."""

    def __init__(self, window_s: float = WINDOW_S,
                 max_sigs: int = MAX_SIGS, max_next: int = MAX_NEXT):
        self.window_s = float(window_s)
        self.max_sigs = int(max_sigs)
        self.max_next = int(max_next)
        self._lock = threading.Lock()
        # sig -> {next_sig: [count, dt_sum_seconds]}
        self._next: "OrderedDict[str, Dict[str, list]]" = OrderedDict()
        self._last_sig: Optional[str] = None
        self._last_wall = 0.0
        self.observed = 0
        self.edges_observed = 0

    def observe(self, sig: str, wall: float):
        with self._lock:
            self.observed += 1
            prev, prev_wall = self._last_sig, self._last_wall
            self._last_sig, self._last_wall = sig, float(wall)
            if prev is None:
                return
            dt = float(wall) - prev_wall
            if dt < 0 or dt > self.window_s:
                return
            self.edges_observed += 1
            succ = self._next.get(prev)
            if succ is None:
                succ = self._next[prev] = {}
                while len(self._next) > self.max_sigs:
                    self._next.popitem(last=False)
            else:
                self._next.move_to_end(prev)
            edge = succ.get(sig)
            if edge is None:
                if len(succ) >= self.max_next:
                    worst = min(succ, key=lambda k: succ[k][0])
                    del succ[worst]
                succ[sig] = [1, dt]
            else:
                edge[0] += 1
                edge[1] += dt

    def predict_next(self, sig: str) -> Optional[Tuple[str, float]]:
        """Fast single-best path for the per-query advisor hot loop:
        ``(next_sig, probability)`` or None — one pass, no list build,
        no sort (ties break on insertion order, oldest edge wins)."""
        with self._lock:
            succ = self._next.get(sig)
            if not succ:
                return None
            total = 0
            best = None
            best_n = 0
            for nxt, e in succ.items():
                n = e[0]
                total += n
                if n > best_n:
                    best_n = n
                    best = nxt
            return best, best_n / total

    def predictions(self, sig: str,
                    top: int = 3) -> List[Tuple[str, float, float, int]]:
        """``[(next_sig, probability, avg_gap_ms, count), ...]`` ranked
        by probability; [] for unseen signatures (cold start)."""
        with self._lock:
            succ = self._next.get(sig)
            if not succ:
                return []
            total = sum(e[0] for e in succ.values())
            out = [
                (nxt, e[0] / total, 1000.0 * e[1] / e[0], e[0])
                for nxt, e in succ.items()
            ]
        out.sort(key=lambda t: (-t[1], -t[3], t[0]))
        return out[: max(0, int(top))]

    def to_doc(self, top: int = 5) -> dict:
        with self._lock:
            sigs = list(self._next.keys())
        transitions = []
        for s in sigs:
            preds = self.predictions(s, top=top)
            if not preds:
                continue
            transitions.append({
                "signature": s,
                "next": [
                    {"signature": nxt, "p": round(p, 4),
                     "avgGapMs": round(gap_ms, 1), "count": n}
                    for nxt, p, gap_ms, n in preds
                ],
            })
        with self._lock:
            doc = {
                "windowSeconds": self.window_s,
                "observed": self.observed,
                "edgesObserved": self.edges_observed,
                "signatures": len(self._next),
            }
        doc["transitions"] = transitions
        return doc

    def reset(self):
        with self._lock:
            self._next.clear()
            self._last_sig = None
            self._last_wall = 0.0
            self.observed = 0
            self.edges_observed = 0


# Process-wide model fed by the heat recorder (util/heat.py observes every
# recorded plan); served at GET /debug/sequences.
MINER = TransitionModel()
