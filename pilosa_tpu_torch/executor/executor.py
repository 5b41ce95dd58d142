"""The query executor: PQL call dispatch, the fused Count lane and the host
bitmap lane.

The port of the Count slice of ``pilosa_tpu/executor/executor.py``
(upstream Pilosa: executor.go:84-2890), single node:

- ``execute`` parses PQL and dispatches each call (executeCall
  :256-295).
- Count: a bare ``Count(Row(f=n))`` sums maintained row cardinalities
  with no device work (the O(1) lane); any other tree runs as one fused
  device count through ``TorchEngine.count``.  Only
  ``UnsupportedLowering`` sends a Count to the host lane instead, so a
  kernel fault is never hidden behind a fallback.
- The host bitmap lane evaluates Row/Union/Intersect/Difference/Xor/Not
  per shard on the fragments' row mirrors and merges the per-shard rows.
- TopN (executor.go :694-828): with an engine, one fused device TopN
  (``TorchEngine.topn_full``, or the host-only ``topn_cache_only`` with no
  src); when that declines (an attribute or Tanimoto filter, or a
  candidate union past ``MAX_TOPN_CANDIDATES``), the two-phase
  composition: phase-1 scores for every shard in one device launch
  (``topn_scores``), the per-shard heap walk of ``Fragment.top`` on the
  host, then the exact phase-2 recount of the merged ids.  Without an
  engine every shard runs ``Fragment.top(src=...)``.  Single node: no
  result memo, batcher or singleflight yet.
- Set/Clear write single bits (and the existence bit).

Every other call raises NotImplementedError naming the ROADMAP.md queue
item that ports it.
"""

from __future__ import annotations

import datetime as dt
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .. import pql
from ..core import cache as cache_mod
from ..core.field import FIELD_TYPE_BOOL, FIELD_TYPE_INT
from ..core.index import EXISTENCE_FIELD_NAME
from ..core.row import Row
from ..core.view import VIEW_STANDARD
from ..parallel.engine import UnsupportedLowering
from ..pql import Call, Condition, Query

TIME_FORMAT = "%Y-%m-%dT%H:%M"  # pilosa.TimeFormat

MAX_WRITES_PER_REQUEST = 5000

DEFAULT_FIELD = "general"

# TopN's default minimum threshold (executor.go defaultMinThreshold).
DEFAULT_MIN_THRESHOLD = 1

_WRITE_CALLS = {"Set", "Clear", "SetRowAttrs", "SetColumnAttrs", "Store", "ClearRow"}

# Calls of the JAX executor this slice does not run yet, and the
# ROADMAP.md item that ports each.
_UNPORTED = {
    "Sum": "Queue 1 item 9 (BSI)",
    "Min": "Queue 1 item 9 (BSI)",
    "Max": "Queue 1 item 9 (BSI)",
    "Range": "Queue 1 item 9 (BSI and time-quantum Range)",
    "Rows": "Queue 1 item 11 (GroupBy and Rows)",
    "GroupBy": "Queue 1 item 11 (GroupBy and Rows)",
    "Store": "Queue 1 item 6 (write path)",
    "ClearRow": "Queue 1 item 6 (write path)",
    "Options": "Queue 1 item 5 (executor lanes)",
    "Explain": "Queue 1 item 14 (serving and observability)",
    "SetRowAttrs": "Queue 1 item 14 (serving and observability)",
    "SetColumnAttrs": "Queue 1 item 14 (serving and observability)",
}


class Error(Exception):
    pass


class IndexNotFoundError(Error):
    pass


class FieldNotFoundError(Error):
    pass


class QueryResponse:
    __slots__ = ("results",)

    def __init__(self, results=None):
        self.results = results if results is not None else []


def _unported(name: str):
    raise NotImplementedError(
        f"{name}() is not ported to pilosa_tpu_torch yet: ROADMAP.md {_UNPORTED[name]}"
    )


def _call_cacheable(c: Call) -> bool:
    """True when a parsed call can be reused across executions: read-only
    and free of string/bool args anywhere in the tree."""
    if c.name in _WRITE_CALLS:
        return False
    for v in c.args.values():
        if isinstance(v, (str, bool)):
            return False
        if isinstance(v, list) and any(isinstance(x, (str, bool)) for x in v):
            return False
        if isinstance(v, Condition) and isinstance(v.value, (str, bool)):
            return False
    return all(_call_cacheable(ch) for ch in c.children)


class Executor:
    """Single-node query executor over a Holder and, optionally, a
    ``TorchEngine`` for the fused Count lane."""

    _PARSE_CACHE_MAX = 512

    def __init__(self, holder, engine=None):
        self.holder = holder
        self.engine = engine
        # Parsed-query LRU for read-only queries (writes re-validate).
        self._parse_cache: "OrderedDict[str, Query]" = OrderedDict()
        self._parse_lock = threading.Lock()
        # index -> (shard_epoch, default shard list).
        self._default: Dict[str, Tuple[int, List[int]]] = {}

    def _parse_cached(self, s: str) -> Query:
        with self._parse_lock:
            q = self._parse_cache.get(s)
            if q is not None:
                self._parse_cache.move_to_end(s)
                return q
        q = pql.parse(s)
        if all(_call_cacheable(c) for c in q.calls):
            with self._parse_lock:
                self._parse_cache[s] = q
                while len(self._parse_cache) > self._PARSE_CACHE_MAX:
                    self._parse_cache.popitem(last=False)
        return q

    # -- entry point (executor.go Execute :84) -----------------------------

    def execute(self, index: str, query, shards: Optional[List[int]] = None) -> QueryResponse:
        if not index:
            raise Error("index required")
        if isinstance(query, str):
            query = self._parse_cached(query)
        if self.holder.index(index) is None:
            raise IndexNotFoundError(index)
        if query.write_call_n() > MAX_WRITES_PER_REQUEST:
            raise Error("too many writes in a single request")
        needs = any(c.name not in _WRITE_CALLS for c in query.calls)
        if not shards and needs:
            shards = self._default_shards(index) or [0]
        return QueryResponse(
            [self._execute_call(index, c, shards) for c in query.calls]
        )

    def _default_shards(self, index: str) -> List[int]:
        """The index's available-shard list, cached behind its shard epoch."""
        epoch = self.holder.shard_epoch(index)
        cached = self._default.get(index)
        if cached is not None and cached[0] == epoch:
            return cached[1]
        shards = [int(s) for s in self.holder.index(index).available_shards()]
        self._default[index] = (epoch, shards)
        return shards

    # -- dispatch (executor.go executeCall :245-295) -----------------------

    def _execute_call(self, index: str, c: Call, shards):
        ids = c.args.get("ids")
        if ids is not None and not isinstance(ids, list):
            raise Error("ids must be a list")
        name = c.name
        if name == "Count":
            return self._execute_count(index, c, shards)
        if name == "Set":
            return self._execute_set(index, c)
        if name == "Clear":
            return self._execute_clear_bit(index, c)
        if name == "TopN":
            return self._execute_topn(index, c, shards)
        if name in _UNPORTED:
            _unported(name)
        return self._execute_bitmap_call(index, c, shards)

    @staticmethod
    def _field_arg(c: Call) -> str:
        try:
            return c.field_arg()
        except ValueError:
            raise Error(f"{c.name}() argument required: field") from None

    def _field(self, index: str, field_name: str):
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        f = idx.field(field_name)
        if f is None:
            raise FieldNotFoundError(field_name)
        return f

    # -- host bitmap lane --------------------------------------------------

    def _execute_bitmap_call(self, index, c: Call, shards) -> Row:
        row = Row()
        for shard in shards:
            row.merge(self._execute_bitmap_call_shard(index, c, shard))
        return row

    def _execute_bitmap_call_shard(self, index, c: Call, shard: int) -> Row:
        name = c.name
        if name == "Row":
            return self._execute_row_shard(index, c, shard)
        if name == "Difference":
            return self._execute_nary_shard(index, c, shard, "difference")
        if name == "Intersect":
            return self._execute_nary_shard(index, c, shard, "intersect")
        if name == "Union":
            return self._execute_nary_shard(index, c, shard, "union", empty_ok=True)
        if name == "Xor":
            return self._execute_nary_shard(index, c, shard, "xor", empty_ok=True)
        if name == "Not":
            return self._execute_not_shard(index, c, shard)
        if name in _UNPORTED:
            _unported(name)
        raise Error(f"unknown call: {name}")

    def _execute_row_shard(self, index, c: Call, shard: int) -> Row:
        field_name = self._field_arg(c)
        self._field(index, field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise Error("Row() must specify a row")
        frag = self.holder.fragment(index, field_name, VIEW_STANDARD, shard)
        if frag is None:
            return Row()
        return frag.row(row_id)

    def _execute_nary_shard(self, index, c: Call, shard: int, op: str,
                            empty_ok: bool = False) -> Row:
        if not c.children and not empty_ok:
            raise Error(f"empty {c.name} query is currently not supported")
        other = Row()
        for i, child in enumerate(c.children):
            row = self._execute_bitmap_call_shard(index, child, shard)
            other = row if i == 0 else getattr(other, op)(row)
        return other

    def _execute_not_shard(self, index, c: Call, shard: int) -> Row:
        if len(c.children) != 1:
            raise Error("Not() requires a single input row")
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        if idx.existence_field() is None:
            raise Error(f"index does not support existence tracking: {index}")
        frag = self.holder.fragment(index, EXISTENCE_FIELD_NAME, VIEW_STANDARD, shard)
        existence = frag.row(0) if frag is not None else Row()
        return existence.difference(
            self._execute_bitmap_call_shard(index, c.children[0], shard)
        )

    # -- Count -------------------------------------------------------------

    def _execute_count(self, index, c: Call, shards) -> int:
        if len(c.children) != 1:
            raise Error("Count() requires a single bitmap input")
        child = c.children[0]
        fast = self._count_from_cardinalities(index, child, shards)
        if fast is not None:
            return fast
        fused = self._mesh_count(index, child, shards)
        if fused is not None:
            return fused
        return sum(
            self._execute_bitmap_call_shard(index, child, shard).count()
            for shard in shards
        )

    def _count_from_cardinalities(self, index, child: Call, shards):
        """O(1)-per-shard Count of an unfiltered Row: sum the maintained
        per-row cardinalities with zero device work (the analogue of
        summing roaring container ``n`` fields).  None for anything else."""
        if child.name != "Row" or child.children or len(child.args) != 1:
            return None
        (field_name, row_val), = child.args.items()
        if isinstance(row_val, bool) or not isinstance(row_val, int):
            return None
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx is not None else None
        if f is None or f.options.type == FIELD_TYPE_INT:
            return None
        view = f.view(VIEW_STANDARD)
        if view is None:
            return 0
        frags = view.fragments
        total = 0
        for s in shards:
            frag = frags.get(s)
            if frag is not None:
                total += frag.row_count(row_val)
        return total

    def _mesh_count(self, index, child: Call, shards):
        """Fused Count through the engine, or None when the tree has no
        device lowering."""
        if self.engine is None or not shards:
            return None
        try:
            return self.engine.count(index, child, list(shards))
        except UnsupportedLowering:
            return None

    # -- TopN (executor.go :694-828) ---------------------------------------

    @staticmethod
    def _topn_args(c: Call):
        """(field, n, ids, min_threshold, attr_name, attr_values,
        tanimoto) of a TopN call, with the reference's defaults and
        checks."""
        field_name = c.args.get("_field") or DEFAULT_FIELD
        n, _ = c.uint_arg("n")
        row_ids, _ = c.uint_slice_arg("ids")
        min_threshold, _ = c.uint_arg("threshold")
        if min_threshold <= 0:
            min_threshold = DEFAULT_MIN_THRESHOLD
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            raise Error("Tanimoto Threshold is from 1 to 100 only")
        return (field_name, n, row_ids, min_threshold, c.args.get("attrName", ""),
                c.args.get("attrValues"), tanimoto)

    def _execute_topn(self, index, c: Call, shards):
        ids_arg, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")

        fused = self._mesh_topn_full(index, c, shards)
        if fused is not None:
            return fused

        pairs = self._execute_topn_shards(index, c, shards)
        if not pairs or ids_arg:
            return pairs

        # Phase 2: refetch exact counts for the merged candidate ids
        # (executor.go :715-733).
        other = c.clone()
        other.args["ids"] = sorted(r for r, _ in pairs)
        trimmed = self._execute_topn_shards(index, other, shards)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return trimmed

    def _mesh_topn_full(self, index, c: Call, shards):
        """Single-dispatch TopN: both reference phases collapse into one K3
        launch plus the K4 trim, with one small readback.  None when there
        is no engine, an attribute or Tanimoto filter needs the host walk,
        the candidate union is past MAX_TOPN_CANDIDATES, or the src tree
        has no device lowering; the two-phase path then runs."""
        if self.engine is None:
            return None
        if c.args.get("attrName") or c.args.get("attrValues"):
            return None
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 0:
            return None
        if len(c.children) > 1:
            raise Error("TopN() can only have one input bitmap")
        field_name, n, row_ids, min_threshold, _, _, _ = self._topn_args(c)
        if not c.children:
            return self.engine.topn_cache_only(
                index, field_name, shards, n, min_threshold, row_ids or None
            )
        try:
            return self.engine.topn_full(
                index, field_name, c.children[0], shards, n, min_threshold,
                row_ids or None,
            )
        except UnsupportedLowering:
            return None

    def _execute_topn_shards(self, index, c: Call, shards):
        fused = self._mesh_topn_shards(index, c, shards)
        if fused is not None:
            pairs = fused
        else:
            pairs = []
            for shard in shards:
                pairs = cache_mod.merge_pairs(
                    [pairs, self._execute_topn_shard(index, c, shard)]
                )
        pairs.sort(key=cache_mod.pair_sort_key)
        return pairs

    def _mesh_topn_shards(self, index, c: Call, shards):
        """TopN phase 1 over every requested shard: the per-candidate src
        intersection counts of all shards in one K3 launch
        (``TorchEngine.topn_scores``), then the reference's per-shard heap
        walk on the host over the precomputed scores.  Returns the merged
        pairs, or None to run the per-shard host lane.

        The reference first tries its device slab lane
        (``kernels.topn_slab_tree``) here.  On one node it declines every
        call that reaches this point (the filters and the oversized union
        that sent the call here decline it too), and otherwise serves only
        peer calls of a cluster, so it is not ported (ROADMAP.md Queue 2
        item 11)."""
        if self.engine is None or len(c.children) != 1 or not shards:
            return None
        (field_name, n, row_ids, min_threshold, attr_name, attr_values,
         tanimoto) = self._topn_args(c)
        frags = {}
        cand_set = set()
        for s in shards:
            frag = self.holder.fragment(index, field_name, VIEW_STANDARD, s)
            if frag is None:
                continue
            pairs = (
                [(r, frag.row_count(r)) for r in row_ids]
                if row_ids
                else list(frag.cache.top())
            )
            frags[s] = frag
            cand_set.update(r for r, _ in pairs)
        if not frags:
            return []
        candidates = sorted(cand_set)
        try:
            scored = self.engine.topn_scores(
                index, field_name, candidates, c.children[0], list(shards)
            )
        except UnsupportedLowering:
            return None
        if scored is None:
            return []
        scores, src_counts, shard_pos = scored
        cand_pos = {r: i for i, r in enumerate(candidates)}
        all_pairs = []
        for s in shards:
            frag = frags.get(s)
            si = shard_pos.get(s)
            if frag is None or si is None:
                continue
            per_shard = {r: int(scores[si, cand_pos[r]]) for r in cand_set}
            all_pairs.append(
                frag.top(
                    n=int(n),
                    row_ids=row_ids or None,
                    min_threshold=min_threshold,
                    filter_name=attr_name,
                    filter_values=attr_values,
                    tanimoto_threshold=tanimoto,
                    src_counts=per_shard,
                    src_count_total=int(src_counts[si]),
                )
            )
        return cache_mod.merge_pairs(all_pairs)

    def _execute_topn_shard(self, index, c: Call, shard: int):
        (field_name, n, row_ids, min_threshold, attr_name, attr_values,
         tanimoto) = self._topn_args(c)
        src = None
        if len(c.children) == 1:
            src = self._execute_bitmap_call_shard(index, c.children[0], shard)
        elif len(c.children) > 1:
            raise Error("TopN() can only have one input bitmap")
        frag = self.holder.fragment(index, field_name, VIEW_STANDARD, shard)
        if frag is None:
            return []
        return frag.top(
            n=int(n),
            src=src,
            row_ids=row_ids or None,
            min_threshold=min_threshold,
            filter_name=attr_name,
            filter_values=attr_values,
            tanimoto_threshold=tanimoto,
        )

    # -- writes ------------------------------------------------------------

    def _execute_set(self, index, c: Call) -> bool:
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise Error("Set() column argument 'col' required")
        field_name = self._field_arg(c)
        f = self._field(index, field_name)
        ef = self.holder.index(index).existence_field()
        if ef is not None:
            ef.set_bit(0, col_id)
        if f.options.type == FIELD_TYPE_INT:
            value, ok = c.int_arg(field_name)
            if not ok:
                raise Error("Set() row argument required")
            return f.set_value(col_id, value)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise Error("Set() row argument required")
        timestamp = None
        ts = c.args.get("_timestamp")
        if isinstance(ts, str):
            try:
                timestamp = dt.datetime.strptime(ts, TIME_FORMAT)
            except ValueError:
                raise Error(f"invalid date: {ts}") from None
        if f.options.type == FIELD_TYPE_BOOL and row_id not in (0, 1):
            raise Error("bool field rows must be 0 or 1")
        return f.set_bit(row_id, col_id, timestamp)

    def _execute_clear_bit(self, index, c: Call) -> bool:
        field_name = self._field_arg(c)
        f = self._field(index, field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise Error("Clear() row argument required")
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise Error("Clear() col argument required")
        return f.clear_bit(row_id, col_id)
