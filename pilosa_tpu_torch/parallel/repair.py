"""Repair-on-write materialized results (docs/incremental.md).

The versioned result memo (_ResultMemo) makes a repeat query against
unchanged data free — but ONE write bumps a version token and the next
dashboard drain recomputes from the full index, even though the write
changed a handful of words.  This layer keeps a second, footprint-aware
registry of materialized results (Count, BSI Sum, BSI Min/Max, cache-only
TopN, GroupBy tables) and advances them to the current version tokens in
O(changed bits): the write path stages its touched (row, word) keys and
before-words on the delta bus (core/delta.py), and a memo miss whose
entry can account for EVERY version bump since its base re-reads just
the touched truth words and applies the algebraic delta.

The correctness protocol is the same token gate the memo itself uses,
applied twice:

* **Coverage** — view versions are dense integers; a repair is legal
  only when the packet log holds one packet per version in
  ``(base, current]`` for every footprint view.  Un-instrumented write
  paths publish OPAQUE packets; an opaque bump on a footprint view (or
  any hole — pre-subscription write, trimmed log) forces fallback, so a
  stale repaired result is structurally unservable, never merely
  unlikely.
* **Truth-read validation** — packets carry only BEFORE-words.  The
  after-state is read from the fragments (words64_at, under each
  fragment's lock), then the version tokens are re-walked: if ANY
  footprint view moved during the reads, the read set may tear across
  versions, so the attempt retries against the new target (the packets
  now cover more) and falls back after a few rounds.  A repair
  therefore lands against the token it validated or not at all — the
  repair-vs-write race resolves to "new token or discard", never to a
  stale value under a current token.

Registration is equally guarded: an entry is only admitted when a
post-compute token walk matches the tokens the query was keyed under
(no write landed mid-compute), and its views are subscribed on the bus
BEFORE that walk, so the first repairable bump can never fall between
check and subscribe.

This module must not import parallel.engine (engine imports it); the
engine object is passed in and duck-typed (holder, memo_tokens,
result_memo, _collect_fields).

A copy of ``pilosa_tpu/parallel/repair.py``: the repair runs on the host,
in numpy, from the fragments' truth words, and launches nothing on the
card.  The one change is the lazy read of a Count's base value, which
here may be the engine's 0-d device tensor (``_apply_count``).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.delta import HUB
from ..core.view import VIEW_STANDARD, view_bsi_name
from ..ops import bitops
from ..util.stats import (
    METRIC_RESULT_REPAIRS,
    METRIC_RESULT_REPAIR_FALLBACKS,
    METRIC_RESULT_REPAIR_SECONDS,
    METRIC_RESULT_REPAIR_TOUCHED_WORDS,
    REGISTRY,
    REPAIR_KINDS,
)


class _NoCompile(Exception):
    """Tree shape the host evaluator doesn't model — entry not
    registered (the memo still covers it; only repair is off)."""


def compile_tree(call):
    """Boolean tree -> (leaves, eval) or None.  ``leaves`` is a list of
    (field, view, row_id); ``eval(words, nwords)`` combines the leaves'
    uint64 word vectors with exactly the executor's per-shard host
    semantics (_execute_bitmap_call_shard): Union=OR (empty ok),
    Intersect=AND, Difference=first&~rest, Xor, Not=existence&~child.
    Restricting every leaf to the same word subset W commutes with all
    of these, so a delta evaluated at W is exact — words outside W are
    identical before and after by construction."""
    from ..core.index import EXISTENCE_FIELD_NAME

    leaves: List[Tuple[str, str, int]] = []

    def walk(c):
        name = c.name
        if name == "Row":
            try:
                fname = c.field_arg()
            except ValueError:
                raise _NoCompile
            row_id, ok = c.uint_arg(fname)
            if not ok:
                raise _NoCompile
            if any(k.startswith("_") for k in c.args if k != fname):
                raise _NoCompile  # time-ranged Row reads other views
            leaves.append((fname, VIEW_STANDARD, int(row_id)))
            return ("leaf", len(leaves) - 1)
        if name == "Not":
            if len(c.children) != 1:
                raise _NoCompile
            leaves.append((EXISTENCE_FIELD_NAME, VIEW_STANDARD, 0))
            return ("diff", [("leaf", len(leaves) - 1), walk(c.children[0])])
        if name in ("Intersect", "Difference") and not c.children:
            raise _NoCompile
        if name == "Union":
            return ("or", [walk(ch) for ch in c.children])
        if name == "Intersect":
            return ("and", [walk(ch) for ch in c.children])
        if name == "Difference":
            return ("diff", [walk(ch) for ch in c.children])
        if name == "Xor":
            return ("xor", [walk(ch) for ch in c.children])
        raise _NoCompile

    try:
        prog = walk(call)
    except _NoCompile:
        return None

    def ev(node, words, nwords):
        op = node[0]
        if op == "leaf":
            return words[node[1]]
        parts = [ev(p, words, nwords) for p in node[1]]
        if not parts:
            return np.zeros(nwords, dtype=np.uint64)
        if op == "or":
            out = parts[0].copy()
            for p in parts[1:]:
                out |= p
            return out
        if op == "and":
            out = parts[0].copy()
            for p in parts[1:]:
                out &= p
            return out
        if op == "xor":
            out = parts[0].copy()
            for p in parts[1:]:
                out ^= p
            return out
        out = parts[0].copy()  # diff
        for p in parts[1:]:
            out &= ~p
        return out

    return leaves, (lambda words, nwords: ev(prog, words, nwords))


def _pc(a: np.ndarray) -> int:
    return int(np.bitwise_count(a).sum())


class _Entry:
    __slots__ = (
        "kind", "sig", "tokens", "value", "aux",
        "fields", "fviews", "vkeys", "lock",
    )

    def __init__(self, kind, sig, tokens, value, aux, fields, fviews):
        self.kind = kind
        self.sig = sig          # (kind, index, qstr, shards_tuple)
        self.tokens = tokens    # memo token tuple the value is valid at
        self.value = value
        self.aux = aux          # per-kind repair state (see register_*)
        self.fields = fields    # field names the token walk covers
        self.fviews = fviews    # {(field, view)} the VALUE depends on
        # Subscribed delta-bus keys: footprint views only — writes to
        # value-neutral views (time siblings) need no capture at all.
        # The key carries the view GENERATION from the tokens, so a
        # dropped-and-recreated view (fresh version counter) can never
        # feed this entry's packet chain (ABA).
        gens = {(t[0], t[1]): t[2] for t in tokens[1:] if len(t) == 4}
        self.vkeys = [
            (sig[1], f, v, gens[(f, v)])
            for f, v in sorted(fviews)
            if (f, v) in gens
        ]
        self.lock = threading.Lock()


class RepairLayer:
    """Per-engine registry of write-repairable materialized results."""

    MAX_ENTRIES = 512
    MAX_ATTEMPTS = 3
    # Candidate-universe cap for TopN repair tables ([S, K] int64).
    MAX_TOPN_TABLE = 2048
    # Distinct raw values a Min/Max extremum table tracks per shard
    # descent: writes that stay inside this band repair in O(touched);
    # one that drains the band falls back to the recompute oracle.
    MINMAX_TABLE_K = 8

    def __init__(self, engine):
        self.engine = engine
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self._suspended = 0
        # Host-visible tallies (cache_snapshot / tests) + process metrics.
        self.repaired = {k: 0 for k in REPAIR_KINDS}
        self.fallbacks = {k: 0 for k in REPAIR_KINDS}
        self.touched_words = 0
        self._c_repair = {
            k: REGISTRY.counter(METRIC_RESULT_REPAIRS, kind=k)
            for k in REPAIR_KINDS
        }
        self._c_fallback = {
            k: REGISTRY.counter(METRIC_RESULT_REPAIR_FALLBACKS, kind=k)
            for k in REPAIR_KINDS
        }
        self._h_seconds = REGISTRY.histogram(METRIC_RESULT_REPAIR_SECONDS)
        self._c_words = REGISTRY.counter(METRIC_RESULT_REPAIR_TOUCHED_WORDS)

    # -- lifecycle -----------------------------------------------------------

    @contextmanager
    def suspended(self):
        """Disable probe AND registration (the bench oracle's recompute
        arm must hit the real dispatch path, not the repair layer)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def clear(self):
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            for vk in e.vkeys:
                HUB.unsubscribe(vk)

    def snapshot(self) -> dict:
        with self._lock:
            n = len(self._entries)
        return {
            "entries": n,
            "repaired": dict(self.repaired),
            "fallbacks": dict(self.fallbacks),
            "touchedWords": self.touched_words,
            "hub": HUB.snapshot(),
        }

    # -- registration --------------------------------------------------------

    def _admit(self, entry: _Entry):
        """Subscribe-then-verify: the delta bus must be listening before
        the token walk that proves no write landed mid-compute, so a
        bump can never fall into the gap between proof and log."""
        if self._suspended or getattr(self.engine, "multiproc", False):
            return
        for vk in entry.vkeys:
            # Base = the version the entry's tokens carry for this view.
            base = 0
            for t in entry.tokens[1:]:
                if len(t) == 4 and (entry.sig[1],) + tuple(t[:3]) == vk:
                    base = t[3]
            HUB.subscribe(vk, base)
        now = self.engine.memo_tokens(entry.sig[1], entry.fields)
        if now != entry.tokens:
            # A write landed while the value was computing: the value's
            # true base token is unknowable, so don't register (the
            # plain memo path still stored it — only repair is off).
            for vk in entry.vkeys:
                HUB.unsubscribe(vk)
            return
        with self._lock:
            old = self._entries.pop(entry.sig, None)
            self._entries[entry.sig] = entry
            evicted = []
            while len(self._entries) > self.MAX_ENTRIES:
                evicted.append(self._entries.popitem(last=False)[1])
        for e in ([old] if old is not None else []) + evicted:
            for vk in e.vkeys:
                HUB.unsubscribe(vk)

    def register_count(self, key, call, value):
        """A fresh fused-Count result: ``key`` is the memo key computed
        at submit time, ``value`` a host int or the tiny replicated
        device scalar (read back lazily at first repair)."""
        if key is None or value is None:
            return
        compiled = compile_tree(call)
        if compiled is None:
            return
        leaves, ev = compiled
        index, qstr, shards, tokens = key
        fields = self.engine._collect_fields(call)
        if fields is None:
            return
        self._admit(_Entry(
            "count", ("count", index, qstr, shards), tokens, value,
            {"leaves": leaves, "eval": ev},
            fields, {(f, v) for f, v, _r in leaves},
        ))

    def register_sum(self, key, field_name, filter_call, value):
        """A fresh BSI Sum (total, n).  Footprint: plane rows 0..depth
        of the bsig view (row ``depth`` is the not-null row) plus the
        filter tree's leaves.  total already includes n*min."""
        if key is None or not isinstance(value, tuple):
            return
        index, qstr, shards, tokens = key
        idx = self.engine.holder.index(index)
        f = idx.field(field_name) if idx is not None else None
        bsig = f.bsi_group(field_name) if f is not None else None
        if bsig is None:
            return
        filt = None
        if filter_call is not None:
            filt = compile_tree(filter_call)
            if filt is None:
                return
        fields = {field_name}
        fviews = {(field_name, view_bsi_name(field_name))}
        if filter_call is not None:
            ffields = self.engine._collect_fields(filter_call)
            if ffields is None:
                return
            fields |= ffields
            fviews |= {(lf, lv) for lf, lv, _r in filt[0]}
        self._admit(_Entry(
            "sum", ("sum", index, qstr, shards), tokens,
            (int(value[0]), int(value[1])),
            {"field": field_name, "depth": bsig.bit_depth(),
             "min": bsig.min, "filter": filt},
            fields, fviews,
        ))

    def register_minmax(self, key, field_name, filter_call, is_min, value):
        """A fresh BSI Min/Max (value, count).  The repair state is a
        small per-field extremum table — the most extreme distinct raw
        values under the consideration set (not-null & filter) with
        EXACT global counts, plus the coverage bound the table is exact
        down to.  Writes whose columns stay inside the covered band
        repair by moving counts between table entries; a write that
        drains the band (every covered value deleted) falls back to the
        recompute oracle, because the new extremum may live below the
        bound where counts were never tracked."""
        if key is None or not isinstance(value, tuple):
            return
        if self._suspended or getattr(self.engine, "multiproc", False):
            return  # skip the table-build walk, not just _admit
        index, qstr, shards, tokens = key
        idx = self.engine.holder.index(index)
        f = idx.field(field_name) if idx is not None else None
        bsig = f.bsi_group(field_name) if f is not None else None
        if bsig is None:
            return
        filt = None
        if filter_call is not None:
            filt = compile_tree(filter_call)
            if filt is None:
                return
        fields = {field_name}
        fviews = {(field_name, view_bsi_name(field_name))}
        if filter_call is not None:
            ffields = self.engine._collect_fields(filter_call)
            if ffields is None:
                return
            fields |= ffields
            fviews |= {(lf, lv) for lf, lv, _r in filt[0]}
        depth = bsig.bit_depth()
        tables, bounds = self._build_extremum_tables(
            index, field_name, depth, filt, shards, is_min
        )
        self._admit(_Entry(
            "minmax", ("minmax", index, qstr, shards), tokens,
            (int(value[0]), int(value[1])),
            {"field": field_name, "depth": depth, "min": bsig.min,
             "filter": filt, "is_min": bool(is_min), "tables": tables,
             "bounds": bounds},
            fields, fviews,
        ))

    def _build_extremum_tables(self, index, field_name, depth, filt,
                               shards, is_min):
        """Per-shard {raw value -> exact count} of the K most extreme
        distinct raw values, via BSI radix descents restricted to the
        consideration set's nonzero words.  The tables stay PER SHARD
        because the serve reduce is per shard too (decode_min_max keeps
        the first best shard's count; cross-shard ties don't sum).
        Returns (tables, bounds), both keyed by shard: with ``score`` =
        the raw value oriented so bigger is more extreme (negated for
        Min), every consideration column of shard s with score >=
        bounds[s] is counted exactly in tables[s]; bounds[s] is None
        when the descent exhausted the shard (EVERY column counted)."""
        bv = view_bsi_name(field_name)
        holder = self.engine.holder
        all_w = np.arange(bitops.WORDS64, dtype=np.int64)
        tables: Dict[int, Dict[int, int]] = {}
        bounds: Dict[int, Optional[int]] = {}
        for s in shards:
            table: Dict[int, int] = {}
            tables[s], bounds[s] = table, None
            frag = holder.fragment(index, field_name, bv, s)
            if frag is None:
                continue  # empty shard: exhausted by definition
            cons = frag.words64_at(depth, all_w)  # the not-null row
            if filt is not None:
                fl, fe = filt
                lw = {}
                for i, (lf, lv, r) in enumerate(fl):
                    lfr = holder.fragment(index, lf, lv, s)
                    lw[i] = (
                        np.zeros(all_w.size, dtype=np.uint64)
                        if lfr is None else lfr.words64_at(r, all_w)
                    )
                cons = cons & fe(lw, all_w.size)
            W0 = np.flatnonzero(cons)
            if W0.size == 0:
                continue
            planes = [frag.words64_at(i, W0) for i in range(depth)]
            cand0 = cons[W0]
            last = 0
            for _ in range(self.MINMAX_TABLE_K):
                if not cand0.any():
                    break
                # One descent: narrow the candidate set to the columns
                # holding the most extreme remaining value (fragment.go
                # minUnsigned/maxUnsigned, vectorized over words).
                cand = cand0
                val = 0
                for i in range(depth - 1, -1, -1):
                    if is_min:
                        off = cand & ~planes[i]
                        if off.any():
                            cand = off
                        else:
                            val |= 1 << i
                    else:
                        on = cand & planes[i]
                        if on.any():
                            cand = on
                            val |= 1 << i
                table[val] = table.get(val, 0) + _pc(cand)
                cand0 = cand0 & ~cand
                last = val
            if cand0.any():
                # Budget hit with columns left: exact only down to the
                # least extreme value the descent reached.
                bounds[s] = -last if is_min else last
        return tables, bounds

    def register_topn(self, key, field_name, n, threshold, row_ids):
        """A cache-only TopN (no src bitmap): the repair state is the
        per-(shard, candidate) count table, maintained from popcount
        deltas and re-ranked on serve with exactly topn_cache_only's
        host reduce — so a repaired serve is bit-identical to a
        recompute at the same tokens.  The value is DERIVED from the
        table (serve_topn), never stored."""
        if key is None:
            return
        index, qstr, shards, tokens = key
        holder = self.engine.holder
        if row_ids:
            cands = sorted(set(int(r) for r in row_ids), reverse=True)
            n = 0  # explicit ids: never truncate (topn_cache_only)
        else:
            rows: Set[int] = set()
            for s in shards:
                frag = holder.fragment(index, field_name, VIEW_STANDARD, s)
                if frag is not None:
                    rows.update(frag.row_ids())
            cands = sorted(rows, reverse=True)
        if len(cands) > self.MAX_TOPN_TABLE:
            return
        cpos = {r: i for i, r in enumerate(cands)}
        cnt = np.zeros((len(shards), len(cands)), dtype=np.int64)
        for si, s in enumerate(shards):
            frag = holder.fragment(index, field_name, VIEW_STANDARD, s)
            if frag is None:
                continue
            for r in frag.row_ids():
                i = cpos.get(r)
                if i is not None:
                    cnt[si, i] = frag.row_count(r)
        self._admit(_Entry(
            "topn", ("topn", index, qstr, shards), tokens, None,
            {"field": field_name, "cands": cands, "cpos": cpos, "cnt": cnt,
             "n": int(n), "threshold": int(threshold),
             "explicit": bool(row_ids), "shard_pos": {
                 s: i for i, s in enumerate(shards)}},
            {field_name}, {(field_name, VIEW_STANDARD)},
        ))

    def register_groupby(self, key, fields, row_lists, filter_call, counts):
        """A fused GroupBy count tensor (row-id order, requested shards
        only).  The executor re-runs its own assembly (limit/offset,
        count>0 filter) over the repaired tensor, so serving semantics
        can't drift.  A write that creates a ROW the row_lists never saw
        falls back — the group axes themselves changed."""
        if key is None or counts is None:
            return
        index, qstr, shards, tokens = key
        filt = None
        tfields = set(fields)
        fviews = {(f, VIEW_STANDARD) for f in fields}
        if filter_call is not None:
            filt = compile_tree(filter_call)
            if filt is None:
                return
            ffields = self.engine._collect_fields(filter_call)
            if ffields is None:
                return
            tfields |= ffields
            fviews |= {(lf, lv) for lf, lv, _r in filt[0]}
        shape = tuple(len(rows) for rows in row_lists)
        self._admit(_Entry(
            "groupby", ("groupby", index, qstr, shards), tokens, None,
            {"fields": list(fields),
             "row_lists": [list(r) for r in row_lists],
             "row_sets": [set(r) for r in row_lists],
             # Copy, never alias: the caller may have memoized the same
             # tensor, and repair mutates this one in place.
             "counts": np.array(counts, dtype=np.int64).reshape(shape),
             "filter": filt},
            tfields, fviews,
        ))

    # -- probe / repair ------------------------------------------------------

    def probe(self, kind: str, key):
        """Attempt to serve the missed memo ``key`` by repairing a
        registered entry up to the current tokens.  Returns the result
        (count int / (total, n) / sorted TopN pairs / GroupBy count
        tensor) or None — the caller then recomputes as before."""
        if key is None or self._suspended:
            return None
        if getattr(self.engine, "multiproc", False):
            return None
        sig = (kind,) + key[:3]
        with self._lock:
            entry = self._entries.get(sig)
            if entry is not None:
                self._entries.move_to_end(sig)
        if entry is None:
            return None
        t0 = time.monotonic()
        with entry.lock:
            out = self._repair_locked(entry)
        self._h_seconds.observe(time.monotonic() - t0)
        if out is None:
            self.fallbacks[kind] += 1
            self._c_fallback[kind].inc()
            self._drop(entry)
            return None
        self.repaired[kind] += 1
        self._c_repair[kind].inc()
        # Refresh the plain memo under the repaired tokens: the NEXT
        # identical probe hits the memo directly, no repair walk at all.
        memo = getattr(self.engine, "result_memo", None)
        if memo is not None:
            # topn -> hashable pair tuple; groupby's `out` is already a
            # private copy of the entry tensor (never aliased, so a later
            # in-place repair cannot corrupt the memoized value).
            stored = tuple(map(tuple, out)) if kind == "topn" else out
            memo.put(
                (entry.sig[1], entry.sig[2], entry.sig[3], entry.tokens),
                stored,
            )
        return out

    def _drop(self, entry: _Entry):
        with self._lock:
            if self._entries.get(entry.sig) is entry:
                del self._entries[entry.sig]
            else:
                return
        for vk in entry.vkeys:
            HUB.unsubscribe(vk)

    def _repair_locked(self, entry: _Entry):
        index = entry.sig[1]
        shards = entry.sig[3]
        for _ in range(self.MAX_ATTEMPTS):
            target = self.engine.memo_tokens(index, entry.fields)
            if target is None:
                return None
            plan = self._diff(entry, target)
            if plan is None:
                return None
            words, packets = plan
            reads = self._truth_read(entry, index, words, packets)
            # Validate: if any footprint view moved during the truth
            # reads, the read set may mix versions — retry against the
            # new target (its packets cover the extra bumps too).
            check = self.engine.memo_tokens(index, entry.fields)
            if check != target:
                continue
            value = self._apply(entry, index, shards, words, packets, reads)
            if value is None:
                return None
            entry.tokens = target
            entry.value = (
                value if entry.kind in ("count", "sum", "minmax") else None
            )
            self._account(words)
            return self._serve(entry)
        return None

    def _serve(self, entry: _Entry):
        if entry.kind == "count":
            return int(entry.value)
        if entry.kind in ("sum", "minmax"):
            return entry.value
        if entry.kind == "topn":
            return serve_topn(entry.aux)
        return entry.aux["counts"].copy()  # groupby tensor

    def _account(self, words: Dict[int, np.ndarray]):
        n = sum(w.size for w in words.values())
        if n:
            self.touched_words += n
            self._c_words.inc(n)

    # -- the delta plan ------------------------------------------------------

    def _diff(self, entry: _Entry, target):
        """Token diff -> (touched words per shard, footprint packets) or
        None when the gap is structurally unrepairable: shard epoch
        moved, view identity changed, a view appeared/vanished, a
        coverage hole, or an opaque packet on a footprint view."""
        base_t, now_t = entry.tokens, target
        if len(base_t) != len(now_t) or base_t[0] != now_t[0]:
            return None
        index = entry.sig[1]
        words: Dict[int, list] = {}
        packets: List[tuple] = []  # (fname, vname, packet)
        shard_set = set(entry.sig[3])
        for bt, nt in zip(base_t[1:], now_t[1:]):
            if len(bt) != len(nt) or bt[:3] != nt[:3]:
                return None  # field vanished / view identity changed
            if len(bt) != 4 or bt[3] == nt[3]:
                continue
            if bt[3] > nt[3]:
                return None
            fname, vname = bt[0], bt[1]
            if (fname, vname) not in entry.fviews:
                continue  # value-neutral view (e.g. a time-quantum
                # sibling of a standard-view query): any write there —
                # even an opaque one — leaves the result unchanged, so
                # its version gap needs no packet coverage at all
            pks = HUB.packets_for((index, fname, vname, bt[2]), bt[3], nt[3])
            if pks is None:
                return None
            rows_of_interest = self._footprint_rows(entry, fname, vname)
            for p in pks:
                if p.opaque:
                    return None
                if p.shard not in shard_set:
                    continue  # outside the query's shard subset
                if rows_of_interest is None:
                    rel = np.ones(p.rows.size, dtype=bool)
                else:
                    rel = np.isin(p.rows, rows_of_interest)
                    if not rel.all() and self._new_row_matters(entry):
                        # A write touched a ROW the materialized shape
                        # never saw (new TopN candidate / new group):
                        # the axes changed, not just the counts.
                        return None
                if rel.any():
                    words.setdefault(p.shard, []).append(p.widxs[rel])
                    packets.append((fname, vname, p))
        merged = {
            s: np.unique(np.concatenate(ws)) for s, ws in words.items()
        }
        return merged, packets

    def _footprint_rows(self, entry: _Entry, fname, vname):
        """The row ids of view (fname, vname) the value depends on, as
        a sorted int64 array — or None meaning ALL rows matter."""
        if entry.kind == "count":
            rows = {r for lf, lv, r in entry.aux["leaves"]
                    if (lf, lv) == (fname, vname)}
            return np.asarray(sorted(rows), dtype=np.int64)
        if entry.kind in ("sum", "minmax"):
            aux = entry.aux
            if (fname, vname) == (aux["field"], view_bsi_name(aux["field"])):
                return np.arange(aux["depth"] + 1, dtype=np.int64)
            filt = aux["filter"]
            rows = {r for lf, lv, r in (filt[0] if filt else [])
                    if (lf, lv) == (fname, vname)}
            return np.asarray(sorted(rows), dtype=np.int64)
        if entry.kind == "topn":
            return np.asarray(sorted(entry.aux["cpos"]), dtype=np.int64)
        aux = entry.aux
        rows: Set[int] = set()
        for fi, gf in enumerate(aux["fields"]):
            if (gf, VIEW_STANDARD) == (fname, vname):
                rows |= aux["row_sets"][fi]
        filt = aux["filter"]
        for lf, lv, r in (filt[0] if filt else []):
            if (lf, lv) == (fname, vname):
                rows.add(r)
        return np.asarray(sorted(rows), dtype=np.int64)

    def _new_row_matters(self, entry: _Entry):
        """A packet row outside the entry's row universe means the
        materialized SHAPE changed (a new TopN candidate, a new group
        row), not just the counts — fall back.  Scalar kinds (count,
        sum, min/max) and explicit-ids TopN are row-closed: writes to
        other rows can't change the value, so they're simply dropped."""
        if entry.kind in ("count", "sum", "minmax"):
            return False
        if entry.kind == "topn" and entry.aux["explicit"]:
            return False
        return True

    # -- truth reads ---------------------------------------------------------

    def _reader(self, index, fname, vname, shard):
        frag = self.engine.holder.fragment(index, fname, vname, shard)
        return frag

    def _truth_read(self, entry: _Entry, index, words, packets):
        """After-words for every (leaf/row, shard) at the touched word
        set W[shard] — each gather under its fragment's lock.  These
        reads complete BEFORE the token re-walk that validates them
        (for every kind, TopN included), so a validated repair's truth
        words are provably at the validated tokens."""
        reads: Dict[tuple, np.ndarray] = {}
        for s, W in words.items():
            for fname, vname, row in self._read_set(entry, packets):
                frag = self._reader(index, fname, vname, s)
                if frag is None:
                    reads[(fname, vname, row, s)] = np.zeros(
                        W.size, dtype=np.uint64
                    )
                else:
                    reads[(fname, vname, row, s)] = frag.words64_at(row, W)
        return reads

    def _read_set(self, entry: _Entry, packets) -> List[Tuple[str, str, int]]:
        """Every (field, view, row) whose words the delta evaluation
        reads — the repair's whole I/O footprint.  TopN's row universe
        is every candidate, so it reads only the rows the packets
        actually touched; the other kinds read their fixed leaf set."""
        if entry.kind == "count":
            return list(entry.aux["leaves"])
        if entry.kind in ("sum", "minmax"):
            aux = entry.aux
            bv = view_bsi_name(aux["field"])
            out = [(aux["field"], bv, i) for i in range(aux["depth"] + 1)]
            if aux["filter"]:
                out += list(aux["filter"][0])
            return out
        if entry.kind == "topn":
            cpos = entry.aux["cpos"]
            return sorted({
                (fname, vname, int(r))
                for fname, vname, p in packets
                for r in p.rows.tolist()
                if int(r) in cpos
            })
        aux = entry.aux
        out = []
        for fi, gf in enumerate(aux["fields"]):
            out += [(gf, VIEW_STANDARD, r) for r in aux["row_lists"][fi]]
        if aux["filter"]:
            out += list(aux["filter"][0])
        return out

    # -- per-kind delta application ------------------------------------------

    def _before_words(self, entry, packets, words, reads):
        """Overlay the EARLIEST packet mention of each (leaf, word) onto
        the truth reads: a word's value at the entry's base tokens is
        the before-word of the FIRST packet that touched it (untouched
        words are identical before and after).  Packets arrive version-
        sorted per view from packets_for; interleaving across views is
        irrelevant because each (field, view, row, word) belongs to one
        view's chain."""
        before = {k: v.copy() for k, v in reads.items()}
        seen: Dict[tuple, Set[int]] = {}
        for fname, vname, p in packets:
            W = words[p.shard]
            idx = np.searchsorted(W, p.widxs)
            for j in range(p.rows.size):
                row = int(p.rows[j])
                key = (fname, vname, row, p.shard)
                if key not in before:
                    continue  # row outside this entry's read set
                done = seen.setdefault(key, set())
                w = int(p.widxs[j])
                if w in done:
                    continue
                done.add(w)
                before[key][idx[j]] = p.before[j]
        return before

    def _apply(self, entry, index, shards, words, packets, reads):
        before = self._before_words(entry, packets, words, reads)
        if entry.kind == "count":
            return self._apply_count(entry, words, reads, before)
        if entry.kind == "sum":
            return self._apply_sum(entry, words, reads, before)
        if entry.kind == "minmax":
            return self._apply_minmax(entry, words, reads, before)
        if entry.kind == "topn":
            return self._apply_topn(entry, words, reads, before)
        return self._apply_groupby(entry, words, reads, before)

    def _apply_count(self, entry, words, reads, before):
        leaves, ev = entry.aux["leaves"], entry.aux["eval"]
        delta = 0
        for s, W in words.items():
            a = ev({i: reads[(lf, lv, r, s)]
                    for i, (lf, lv, r) in enumerate(leaves)}, W.size)
            b = ev({i: before[(lf, lv, r, s)]
                    for i, (lf, lv, r) in enumerate(leaves)}, W.size)
            delta += _pc(a) - _pc(b)
        base = entry.value
        if not isinstance(base, (int, np.integer)):
            # Lazily sync the device scalar (a 0-d tensor on the card):
            # the first repair pays the readback, never the registration.
            base = int(base)
        return base + delta

    def _apply_sum(self, entry, words, reads, before):
        aux = entry.aux
        field, depth, bmin, filt = (
            aux["field"], aux["depth"], aux["min"], aux["filter"]
        )
        bv = view_bsi_name(field)
        d_total, d_n = 0, 0
        for s, W in words.items():
            def cons(src):
                nn = src[(field, bv, depth, s)]
                if filt is None:
                    return nn
                fl, fe = filt
                fw = fe({i: src[(lf, lv, r, s)]
                         for i, (lf, lv, r) in enumerate(fl)}, W.size)
                return nn & fw
            ca, cb = cons(reads), cons(before)
            d_n += _pc(ca) - _pc(cb)
            for i in range(depth):
                d_total += (
                    _pc(reads[(field, bv, i, s)] & ca)
                    - _pc(before[(field, bv, i, s)] & cb)
                ) << i
        total, n = entry.value
        return (total + d_total + bmin * d_n, n + d_n)

    def _apply_minmax(self, entry, words, reads, before):
        """Extremum-table maintenance: per touched word, zip the plane
        bits back into per-column raw values before and after, then move
        the covered counts (a write is a decrement at its old value and
        an increment at its new one; values below a shard's coverage
        bound are untracked and simply ignored).  Falls back (None) when
        a covered decrement has no table entry — impossible unless the
        band itself is stale — or when a non-exhausted shard's band
        drains: that shard's extremum may now live below its bound,
        where counts were never kept.  The final reduce replays
        decode_min_max exactly (first best shard's count wins; ties
        across shards don't sum), so a repaired serve is bit-identical
        to a recompute at the same tokens."""
        aux = entry.aux
        field, depth, bmin = aux["field"], aux["depth"], aux["min"]
        filt, is_min = aux["filter"], aux["is_min"]
        tables, bounds = aux["tables"], aux["bounds"]
        bv = view_bsi_name(field)

        def bits(w):
            return np.unpackbits(w.view(np.uint8), bitorder="little")

        def columns(src, s, W):
            # Consideration mask + raw value per column of the touched
            # words (64 columns per uint64 word, little-endian bits).
            nn = bits(src[(field, bv, depth, s)]).astype(bool)
            if filt is not None:
                fl, fe = filt
                fw = fe({i: src[(lf, lv, r, s)]
                         for i, (lf, lv, r) in enumerate(fl)}, W.size)
                nn &= bits(fw).astype(bool)
            vals = np.zeros(W.size * 64, dtype=np.int64)
            for i in range(depth):
                vals += bits(src[(field, bv, i, s)]).astype(np.int64) << i
            return nn, vals

        for s, W in words.items():
            table, bound = tables.get(s), bounds.get(s)
            if table is None:
                return None  # packet for a shard outside the universe
            nn_a, va = columns(reads, s, W)
            nn_b, vb = columns(before, s, W)
            for c in np.flatnonzero((nn_a != nn_b) | (nn_a & (va != vb))):
                if nn_b[c]:
                    v = int(vb[c])
                    if bound is None or (-v if is_min else v) >= bound:
                        n = table.get(v, 0) - 1
                        if n < 0:
                            return None
                        table[v] = n
                if nn_a[c]:
                    v = int(va[c])
                    if bound is None or (-v if is_min else v) >= bound:
                        table[v] = table.get(v, 0) + 1
        best_val, best_n = 0, 0
        for s in entry.sig[3]:  # ascending = decode's canonical scan
            live = [v for v, c in tables[s].items() if c > 0]
            if not live:
                if bounds[s] is None:
                    continue  # shard provably empty under the filter
                return None  # band drained: shard extremum unknowable
            v = min(live) if is_min else max(live)
            if best_n == 0 or (v < best_val if is_min else v > best_val):
                best_val, best_n = v, int(tables[s][v])
        if best_n == 0:
            return (0, 0)  # every shard provably empty — recompute's (0, 0)
        return (best_val + bmin, best_n)

    def _apply_topn(self, entry, words, reads, before):
        """Count-table maintenance: per touched (shard, candidate) the
        count moves by pc(after@W) - pc(before@W), both O(touched).
        Untouched (row, shard) pairs in the read set have identical
        before/after words and contribute zero."""
        aux = entry.aux
        cpos, cnt, spos = aux["cpos"], aux["cnt"], aux["shard_pos"]
        for (fname, vname, row, s), a in reads.items():
            d = _pc(a) - _pc(before[(fname, vname, row, s)])
            if d:
                cnt[spos[s], cpos[row]] += d
        return True  # value derives from the table (serve_topn)

    def _apply_groupby(self, entry, words, reads, before):
        aux = entry.aux
        fields, row_lists, filt = aux["fields"], aux["row_lists"], aux["filter"]
        counts = aux["counts"]
        for s, W in words.items():
            if filt is not None:
                fl, fe = filt
                fa = fe({i: reads[(lf, lv, r, s)]
                         for i, (lf, lv, r) in enumerate(fl)}, W.size)
                fb = fe({i: before[(lf, lv, r, s)]
                         for i, (lf, lv, r) in enumerate(fl)}, W.size)
            else:
                fa = fb = None
            axes_a = [
                np.stack([reads[(gf, VIEW_STANDARD, r, s)]
                          for r in row_lists[fi]])
                for fi, gf in enumerate(fields)
            ]
            axes_b = [
                np.stack([before[(gf, VIEW_STANDARD, r, s)]
                          for r in row_lists[fi]])
                for fi, gf in enumerate(fields)
            ]
            for combo in np.ndindex(counts.shape):
                wa = axes_a[0][combo[0]]
                wb = axes_b[0][combo[0]]
                for d in range(1, len(fields)):
                    wa = wa & axes_a[d][combo[d]]
                    wb = wb & axes_b[d][combo[d]]
                if fa is not None:
                    wa = wa & fa
                    wb = wb & fb
                d = _pc(wa) - _pc(wb)
                if d:
                    counts[combo] += d
        return True


def serve_topn(aux) -> list:
    """Rank + trim a TopN repair table with EXACTLY topn_cache_only's
    host reduce (engine.py): per-shard threshold gate, phase-1 top-n
    union via stable argsort over the id-descending candidate axis,
    exact totals, pair_sort_key order, trim to n."""
    from ..core import cache as cache_mod

    cands, cnt = aux["cands"], aux["cnt"]
    n, thr = aux["n"], max(aux["threshold"], 1)
    K = len(cands)
    if K == 0:
        return []
    gated = np.where(cnt >= thr, cnt, 0)
    totals = gated.sum(axis=0, dtype=np.int64)
    if n:
        sel = np.argsort(-gated, axis=1, kind="stable")[:, : int(n)]
        pos = np.nonzero(np.take_along_axis(gated, sel, axis=1) > 0)
        union = np.zeros(K, dtype=bool)
        union[sel[pos]] = True
    else:
        union = (gated > 0).any(axis=0)
    pairs = [
        (cands[k], int(totals[k]))
        for k in np.nonzero(union)[0]
        if totals[k] > 0
    ]
    pairs.sort(key=cache_mod.pair_sort_key)
    if n:
        pairs = pairs[: int(n)]
    return pairs
