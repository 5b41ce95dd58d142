"""Miner over recorded query plans: the shared-subtree report that sizes
whole-program fusion, and the first-order plan-signature transition model
served at ``GET /debug/sequences``.

A plan's masks are the mask-subtree texts of its calls, the
canonicalization the fused planner hash-conses masks by
(``parallel/fusion.subtree_texts``).  ``mine`` buckets recorded plans
into time windows and counts, per window, the mask evaluations a per-query
execution pays and those a whole-program fuse would save: the same counts
``pilosa_engine_fused_program_masks_{evaluated,referenced}_total`` record
once the traffic rides the fused path.  A plan's signature is its index
plus its sorted mask texts; dashboards repeat, so "after signature A,
signature B follows within the window with probability p" is learnable
from the plans alone (``TransitionModel``, and ``mine_sequences`` offline).

A copy of ``pilosa_tpu/util/plan_miner.py`` (stdlib only; the parser and
``fusion.subtree_texts`` are the port's own), with the CLI of the
reference's ``scripts/plan_miner.py`` as ``main``::

    python -m pilosa_tpu_torch.util.plan_miner --url http://localhost:10101
    curl -s localhost:10101/debug/plans?limit=128 > plans.json
    python -m pilosa_tpu_torch.util.plan_miner --file plans.json --json
    python -m pilosa_tpu_torch.util.plan_miner --file plans.json --sequences

The heat recorder (``util/heat.py``) feeds ``MINER`` every recorded plan,
and the prefetch advisor reads ``predict_next``."""

from __future__ import annotations

import json
import sys
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

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


def flatten_plans(doc) -> List[dict]:
    """Plan dicts from a /debug/plans document (recent ring + slow
    retention, deduped), a bare list, or {"plans": [...]}."""
    if isinstance(doc, list):
        plans = list(doc)
    else:
        plans = list(doc.get("recent") or doc.get("plans") or [])
        for worst in (doc.get("slow") or {}).values():
            plans.extend(worst)
    seen = set()
    out = []
    for p in plans:
        key = (p.get("traceID"), p.get("startTime"), p.get("query"))
        if key in seen:
            continue
        seen.add(key)
        out.append(p)
    return out


def mine(plans: Iterable[dict], window_s: float = 60.0,
         top: int = 20) -> dict:
    """Fusion-opportunity report over recorded plans.

    Plans are bucketed into ``window_s`` windows by their recorded
    ``startTime`` (a fused drain can only merge queries that are in
    flight together; a window approximates a drain's reach across a
    dashboard burst).  Within each (index, window), a mask subtree
    occurring k times costs the sequential path k evaluations and a
    fused drain exactly 1 — so ``projected_evals_saved`` sums (k - 1)
    over every repeated subtree."""
    windows: Dict[tuple, Dict[str, int]] = {}
    mask_queries: Dict[tuple, set] = {}
    n_queries = 0
    for p in plans:
        text = p.get("query")
        if not text:
            continue
        masks = plan_masks(text)
        if not masks:
            continue
        n_queries += 1
        ts = float(p.get("startTime") or 0.0)
        wkey = (p.get("index"), int(ts // window_s) if window_s else 0)
        bucket = windows.setdefault(wkey, {})
        for m in masks:
            bucket[m] = bucket.get(m, 0) + 1
            mask_queries.setdefault((p.get("index"), m), set()).add(
                (text, wkey[1])
            )
    total_evals = 0
    distinct = 0
    saved = 0
    per_mask: Dict[tuple, dict] = {}
    for (index, w), bucket in windows.items():
        for m, k in bucket.items():
            total_evals += k
            distinct += 1
            saved += k - 1
            agg = per_mask.setdefault(
                (index, m),
                {"mask": m, "index": index, "occurrences": 0,
                 "windows": 0, "evals_saved": 0},
            )
            agg["occurrences"] += k
            agg["windows"] += 1
            agg["evals_saved"] += k - 1
    for (index, m), agg in per_mask.items():
        agg["queries"] = len(
            {q for q, _w in mask_queries.get((index, m), ())}
        )
    ranked = sorted(
        per_mask.values(),
        key=lambda a: (-a["evals_saved"], -a["occurrences"], a["mask"]),
    )
    return {
        "windowSeconds": window_s,
        "windows": len(windows),
        "queries": n_queries,
        "distinctMasks": distinct,
        "maskEvaluations": total_evals,
        "projectedEvalsSaved": saved,
        "projectedSavedFraction": (
            round(saved / total_evals, 4) if total_evals else 0.0
        ),
        "topShared": ranked[: max(0, int(top))],
    }


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


def mine_sequences(plans: Iterable[dict], window_s: float = WINDOW_S,
                   top: int = 5) -> dict:
    """Offline replay of a /debug/plans dump through a fresh
    TransitionModel (``scripts/plan_miner.py --sequences``)."""
    model = TransitionModel(window_s=window_s)
    ordered = sorted(
        (p for p in plans if p.get("query")),
        key=lambda p: float(p.get("startTime") or 0.0),
    )
    for p in ordered:
        model.observe(
            signature(p.get("index") or "", p["query"]),
            float(p.get("startTime") or 0.0),
        )
    return model.to_doc(top=top)


def render_sequences(doc: dict) -> str:
    """Human-readable transition report."""
    lines = [
        f"sequences: {doc['observed']} queries observed, "
        f"{doc['edgesObserved']} in-window transitions, "
        f"{doc['signatures']} signatures "
        f"(window {doc['windowSeconds']:g}s)",
    ]
    for t in doc.get("transitions", ()):
        lines.append(f"  after {t['signature']}")
        for nxt in t["next"]:
            lines.append(
                f"    -> p={nxt['p']:.2f} n={nxt['count']} "
                f"gap={nxt['avgGapMs']:.0f}ms  {nxt['signature']}"
            )
    return "\n".join(lines)


def render(report: dict) -> str:
    """Human-readable report table."""
    lines = [
        f"plans mined: {report['queries']} queries over "
        f"{report['windows']} window(s) of {report['windowSeconds']:g}s",
        f"mask evaluations: {report['maskEvaluations']} "
        f"({report['distinctMasks']} distinct) — fusion would save "
        f"{report['projectedEvalsSaved']} "
        f"({100 * report['projectedSavedFraction']:.1f}%)",
    ]
    if report["topShared"]:
        lines.append("top shared subtrees (evals saved / occurrences / "
                     "distinct queries):")
        for a in report["topShared"]:
            if a["evals_saved"] <= 0:
                continue
            lines.append(
                f"  {a['evals_saved']:6d} / {a['occurrences']:6d} / "
                f"{a['queries']:4d}  [{a['index']}] {a['mask']}"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    """The reference's ``scripts/plan_miner.py``: the shared-subtree
    report (or, with ``--sequences``, the transition report) of a live
    node's ``/debug/plans`` (``--url``) or of a saved dump (``--file``)."""
    import argparse
    import urllib.request

    ap = argparse.ArgumentParser(description="Mine recorded query plans for shared Row "
                                             "subtrees, or for access sequences.")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--url", help="server base URL (fetches /debug/plans)")
    src.add_argument("--file", help="saved /debug/plans JSON document")
    ap.add_argument("--window", type=float, default=60.0,
                    help="sharing window in seconds (default 60; 0 = one window)")
    ap.add_argument("--limit", type=int, default=128,
                    help="plans to request from a live server (default 128)")
    ap.add_argument("--top", type=int, default=20,
                    help="top shared subtrees to list (default 20)")
    ap.add_argument("--json", action="store_true", help="emit the raw JSON report")
    ap.add_argument("--sequences", action="store_true",
                    help="mine access SEQUENCES instead of shared subtrees: replay the dump "
                    "through a fresh first-order transition model (the signatures the live "
                    "/debug/sequences learns) and report per-signature next-signature "
                    "probabilities; --window is the transition window (default 5s)")
    args = ap.parse_args(argv)
    if args.url:
        url = args.url.rstrip("/") + f"/debug/plans?limit={args.limit}"
        with urllib.request.urlopen(url, timeout=30) as resp:
            doc = json.load(resp)
    else:
        with open(args.file) as f:
            doc = json.load(f)
    plans = flatten_plans(doc)
    if args.sequences:
        window = args.window if "--window" in (argv if argv is not None else sys.argv) \
            else WINDOW_S
        report = mine_sequences(plans, window_s=window, top=args.top)
        text = render_sequences(report)
    else:
        report = mine(plans, window_s=args.window, top=args.top)
        text = render(report)
    if args.json:
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
