"""Whole-dashboard fusion: plan a heterogeneous drain so that every distinct
Row subtree is evaluated once on the card.

The port of ``pilosa_tpu/parallel/fusion.py``.  A dashboard refresh sends
N widgets that share one audience segment: Counts, a Sum, Min/Max, TopNs,
a GroupBy, each filtered by the same ``Intersect`` of a few rows.  Run one
by one, every widget rebuilds the segment from its rows.  ``build``
canonicalizes every item's Row tree by text and hash-conses each subtree
level into a MASK SLOT keyed ``(index, subtree text)``; a repeat resolves to
``("mref", j)``, so each slot is a flat node over leaves and earlier slots.
Per index the plan is a ``kernels.FusedSpec``: one F1 launch evaluates the
slots once per word and counts the count edges, and the aggregate edges run
K6, K7, K3 and K8 with their slot as the filter row (``kernels.fused_tree``).
A drain spanning indexes has one such part per index (their shard axes
differ), all launched on one stream, and every output of the drain comes
back in one copy (``pack``/``unpack``).

The sparse block-occupancy planner keeps working per mask: a Count whose
tree shares nothing with its drain-mates may peel onto K2.  An index with
no canonical shards answers its items with constants, a missing BSI field
with an empty result, a TopN past MAX_TOPN_CANDIDATES with DECLINED (the
caller falls back to the two-phase lane), and one bad item fails alone.
A part past F1's limits (``kernels.check_fused``) runs its items on their
per-op programs instead (``engine.fused_declines``).

The decode helpers here turn each op's device output into the engine's
public result shape; the fused path, the batcher's solo path and the
engine's synchronous wrappers share them.

Residency: the drain's row hints (``_item_hints`` merged by
``merge_hints``) go to every lowering of the build, so an item that misses
a partial stack requests the whole drain's working set; a pool stack's
rows are leaves of the slot table like any row (``("rowb", ...)``), and the
aggregate edges require full stacks (an item that misses fails alone with
``ResidencyMiss``, which its caller serves from the host lane).  Each
item's plan note carries its own working-set touches (``_item_touches``,
the heat recorder's input), resolved against the drain's stacks.  The reference pads slots
and edges to pow2 tiers to key XLA executables; F1 takes its table as data
and templates only on the slot tier, so nothing is padded here, and the
canonical build order is kept so that a drain in any arrival order maps to
one cached plan.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.cache import pair_sort_key
from ..core.index import EXISTENCE_FIELD_NAME
from ..core.view import VIEW_STANDARD, view_bsi_name
from ..util import heat as heat_mod
from ..util import plans as plans_mod
from . import bsi as bsi_mod
from . import groupby as groupby_mod
from . import kernels

# Sentinel a decoder returns when the fused path declines an item the
# caller must re-route (a TopN whose candidate union exceeds
# MAX_TOPN_CANDIDATES falls back to the two-phase composition).
DECLINED = object()

def op_signature(kind: str, spec: dict) -> str:
    """Canonical text of an aggregate op spec: the result memo's signature
    for non-Count ops (engine.memo_key_op)."""
    if kind in ("sum", "min", "max"):
        return f"{kind}|{spec['field']}|{spec.get('filter')}"
    if kind == "topn":
        return f"topn|{spec['field']}|{spec['src']}|{list(spec.get('rows') or ())}"
    if kind == "group":
        return (
            f"group|{list(spec.get('fields') or ())}|"
            f"{[list(r) for r in spec.get('rows') or ()]}|{spec.get('filter')}"
        )
    return (
        f"topnf|{spec['field']}|{spec.get('src')}|{spec.get('n')}|"
        f"{spec.get('threshold')}|{spec.get('row_ids')}"
    )


def op_fields(kind: str, spec: dict, collect_fields):
    """Every field an op's version tokens must cover: the aggregated field
    plus the filter/src tree's fields; None when the tree is not walkable
    (the op then skips the memo)."""
    if kind == "group":
        fields = set(spec.get("fields") or ())
    else:
        fields = {spec["field"]}
    tree = spec.get("filter") if kind in ("sum", "min", "max", "group") else spec.get("src")
    if tree is not None:
        sub = collect_fields(tree)
        if sub is None:
            return None
        fields |= sub
    return fields


def _item_hints(engine, index, spec) -> dict:
    """The row hints of ONE drain item: every (index, field, view) stack
    it reads -> the row ids it reads there (None: the whole stack, as a BSI
    plane walk or a TopN candidate sweep does).  The reference's
    ``pilosa_tpu/parallel/fusion.py:378``."""
    kind = spec["kind"]
    hints: dict = {}
    if kind == "count":
        hints = engine._collect_row_hints(index, spec["call"])
    elif kind in ("sum", "min", "max"):
        hints[(index, spec["field"], view_bsi_name(spec["field"]))] = None
        if spec.get("filter") is not None:
            engine._collect_row_hints(index, spec["filter"], hints)
    elif kind == "topn":
        hints[(index, spec["field"], VIEW_STANDARD)] = {int(r) for r in spec["rows"]}
        engine._collect_row_hints(index, spec["src"], hints)
    elif kind == "topnf":
        hints[(index, spec["field"], VIEW_STANDARD)] = None
        engine._collect_row_hints(index, spec["src"], hints)
    elif kind == "group":
        for fname, rows in zip(spec.get("fields") or (), spec.get("rows") or ()):
            hints[(index, fname, VIEW_STANDARD)] = {int(r) for r in rows}
        if spec.get("filter") is not None:
            engine._collect_row_hints(index, spec["filter"], hints)
    return hints


def merge_hints(into: dict, hints: dict) -> dict:
    """Merge one item's hints into a drain-wide map: None (the whole
    stack) wins, row sets unite."""
    for key, rows in hints.items():
        if rows is None or into.get(key, ()) is None:
            into[key] = None
        else:
            into.setdefault(key, set()).update(rows)
    return into


# Plan-note op names per item kind (the reference's, so that the plans of
# both packages name their ops alike).
OP_NAMES = {
    "count": "Count",
    "sum": "Sum",
    "min": "Min",
    "max": "Max",
    "topn": "TopN",
    "topnf": "TopN",
    "group": "GroupBy",
}


def _pow2(n: int) -> int:
    return max(1, 1 << (max(1, n) - 1).bit_length())


def subtree_texts(call, out=None) -> set:
    """Canonical text of every subtree of a call tree: the sharing key the
    planner hash-conses masks by."""
    if out is None:
        out = set()
    if call is None:
        return out
    out.add(str(call))
    for ch in call.children:
        subtree_texts(ch, out)
    return out


def item_texts(spec: dict) -> set:
    """The subtree texts of one drain item's mask tree."""
    kind = spec["kind"]
    if kind == "count":
        return subtree_texts(spec["call"])
    if kind in ("sum", "min", "max", "group"):
        return subtree_texts(spec.get("filter"))
    return subtree_texts(spec.get("src"))


def _entry_sort_key(entry) -> tuple:
    """Canonical build order: the planner lowers entries in THIS order
    (not arrival order), so two drains carrying the same multiset of
    (index, op kind, mask) items build the same plan.  ``entry`` is an
    (index, spec, shards) triple."""
    index, spec, shards = entry
    kind = spec["kind"]
    if kind == "count":
        t = str(spec["call"])
    elif kind in ("sum", "min", "max"):
        t = f"{spec['field']}|{spec.get('filter')}"
    elif kind == "topn":
        t = f"{spec['field']}|{spec['src']}|{list(spec.get('rows') or ())}"
    elif kind == "group":
        t = (
            f"{list(spec.get('fields') or ())}|"
            f"{[list(r) for r in spec.get('rows') or ()]}|{spec.get('filter')}"
        )
    else:
        t = (
            f"{spec['field']}|{spec['src']}|{spec.get('n')}|"
            f"{spec.get('threshold')}|{spec.get('row_ids')}"
        )
    return (kind, str(index), t, tuple(shards))


# -- one readback per drain ---------------------------------------------------

_NP_OF = {torch.int32: np.int32, torch.int64: np.int64}


def pack(tensors, device) -> tuple:
    """Every output tensor of a drain in one uint8 buffer on ``device``
    (one concatenation, so the drain reads back in one copy), and its
    layout: (byte offset, numpy dtype, shape) per tensor."""
    layout, views, off = [], [], 0
    for t in tensors:
        flat = t.reshape(-1)
        layout.append((off, _NP_OF[t.dtype], tuple(t.shape)))
        off += flat.numel() * flat.element_size()
        views.append(flat.view(torch.uint8))
    if not views:
        return torch.empty(0, dtype=torch.uint8, device=device), layout
    return torch.cat(views), layout


def unpack(host: np.ndarray, layout) -> List[np.ndarray]:
    """The host arrays of a packed drain (``pack``), in order."""
    buf = np.ascontiguousarray(host, dtype=np.uint8)
    return [np.frombuffer(buf, dtype=dt, count=int(np.prod(shape, dtype=np.int64)),
                          offset=off).reshape(shape) for off, dt, shape in layout]


# -- decode helpers (shared by fused, solo, and sync paths) ------------------


def decode_topn_scores(host, present, pos: dict):
    """(scores int32[K, S], src_counts int32[S]) -> (scores int32[S, K]
    with absent candidates zeroed, src_counts, pos): TorchEngine.topn_scores'
    host transform."""
    dev_scores, dev_counts = host
    scores = np.array(dev_scores).T.copy()
    scores[:, ~present] = 0
    return scores, np.asarray(dev_counts), pos


def decode_topn_full(host, cands, n_out):
    """The fused TopN readback (trimmed (vals, idx) rows, or the full
    totals when ``n_out`` is None) as sorted (row_id, count) pairs; zero
    totals and pad slots (index >= len(cands)) drop out."""
    if host is None:
        return []
    if n_out is None:
        totals = np.asarray(host)
        pairs = [(cands[k], int(totals[k])) for k in range(len(cands)) if totals[k] > 0]
        pairs.sort(key=pair_sort_key)
        return pairs
    vals, top_idx = host
    return [
        (cands[int(i)], int(v))
        for v, i in zip(vals, top_idx)
        if v > 0 and int(i) < len(cands)
    ]


# -- the planner -------------------------------------------------------------


class FusedDispatch:
    """One dispatched drain: the packed device outputs and their layout, a
    decoder per item over the unpacked host arrays, the per-item device-cost
    weights (footprint-proportional), the per-item plan notes and the
    per-item errors."""

    __slots__ = ("dev", "layout", "decoders", "weights", "errors", "item_notes")

    def __init__(self, dev, layout, decoders, weights, errors, item_notes=None):
        self.dev = dev
        self.layout = layout
        self.decoders = decoders
        self.weights = weights
        self.errors = errors
        self.item_notes = item_notes if item_notes is not None else [None] * len(decoders)

    def results(self, host: np.ndarray) -> list:
        """Every item's result from the fetched packed bytes, raising the
        first item error."""
        parts = unpack(host, self.layout)
        out = []
        for err, dec in zip(self.errors, self.decoders):
            if err is not None:
                raise err
            out.append(dec(parts))
        return out


class _Part:
    """One index's share of a plan: its lowering (the stacks it reads),
    slot table and edges (``spec``), masks and tensors, and the gate of
    every shard an edge asks for.  ``declined``: past F1's limits, its
    items run on their per-op programs."""

    __slots__ = ("index", "lw", "slots", "count_edges", "agg_edges", "masks", "mask_ids",
                 "tensors", "need_shards", "need", "refs", "declined", "spec")

    def __init__(self, index, lw):
        self.index = index
        self.lw = lw
        self.slots: list = []
        self.count_edges: list = []
        self.agg_edges: list = []
        self.masks: list = []
        self.mask_ids: Dict[tuple, int] = {}
        self.tensors: list = []
        self.need_shards: set = set()
        self.need = None
        self.refs = 0
        self.declined = False
        self.spec = None

    def mask(self, engine, shards) -> int:
        key = tuple(sorted(set(shards)))
        i = self.mask_ids.get(key)
        if i is None:
            i = self.mask_ids[key] = len(self.masks)
            self.masks.append(engine._mask_words(shards, self.lw.canonical))
            self.need_shards.update(key)
        return i


class FusedPlan:
    """A drain plan, reusable across dispatches: the per-index parts, the
    sparse peels, a decoder per item (a ``_Solo`` where the item runs on
    its per-op program), the weights and errors, and the stack version
    tokens that gate reuse (``TorchEngine._fused_plan_valid``): dashboards
    repeat, and any write to a referenced view bumps its token so that the
    plan rebuilds."""

    __slots__ = (
        "indexes", "parts", "sparse", "decoders", "weights", "errors", "n_items",
        "fused_riders", "masks_evaluated", "masks_referenced", "stacks", "stack_tokens",
        "canonical", "cacheable", "item_notes", "bytes_touched", "masks_tier",
    )

    def have_fused(self) -> bool:
        return any(not p.declined and (p.count_edges or p.agg_edges) for p in self.parts)


def dispatch(engine, plan: FusedPlan) -> FusedDispatch:
    """Launch a (possibly cached) plan without waiting for the device: the
    parts' F1 and edge kernels, the sparse peels (K2), then the per-op
    programs of declined items, all on the current stream, and the outputs
    packed for one readback.  Runs under the engine's stacks lock (the
    caller is TorchEngine.fused_drain_async)."""
    outs: list = []

    def launch():
        for part in plan.parts:
            if part.spec is not None:
                outs.extend(kernels.fused_tree(part.spec, part.lw.mats, part.masks,
                                               part.tensors, part.need))
        for prog, lw1, splan in plan.sparse:
            outs.append(engine._dispatch_sparse(prog, lw1.mats, splan))
            # The peeled item's note was captured into its item note at
            # build time: drop the fresh one, which must not reach the
            # shared batch note below.
            plans_mod.take_dispatch_note()

    engine._reading(plan.stacks, launch)
    decoders = list(plan.decoders)
    errors = list(plan.errors)
    for i, dec in enumerate(decoders):
        if isinstance(dec, _Solo):
            try:
                tensors, d = engine.solo_op_async(dec.index, dec.kind, dec.spec, dec.shards)
            except Exception as e:  # noqa: BLE001 — one bad item must not fail its drain-mates
                errors[i] = e
                continue
            if tensors is None:
                decoders[i] = _Const(d(None))
            else:
                decoders[i] = _Agg(len(outs), len(tensors), d)
                outs.extend(tensors)
    # Counters record what rode a fused program: a drain whose items all
    # resolved const/peeled/errored/declined launched no F1 or edge.
    if plan.have_fused():
        engine.fused_programs += 1
        engine.fused_program_queries += plan.fused_riders
        engine.fused_masks_evaluated += plan.masks_evaluated
        engine.fused_masks_referenced += plan.masks_referenced
    plans_mod.note_dispatch(
        path="fused_program",
        fused=True,
        fused_queries=plan.n_items,
        masks_evaluated=plan.masks_evaluated,
        masks_referenced=plan.masks_referenced,
        masks_tier=plan.masks_tier if plan.have_fused() else 0,
        bytes_touched=plan.bytes_touched,
        fused_indexes=len(plan.indexes),
    )
    dev, layout = pack(outs, engine.device)
    return FusedDispatch(dev, layout, decoders, plan.weights, errors, plan.item_notes)


def _slot_rows(prog) -> float:
    """Shard rows a slot's OWN prog sweeps (mrefs cost nothing here: their
    slots carry their own cost)."""
    kind = prog[0]
    if kind in ("row", "rowb"):
        return 1
    if kind == "range":
        return len(prog[3])
    if kind in ("zero", "mref"):
        return 0
    return sum(_slot_rows(p) for p in prog[1:])


def _slot_refs(prog, out: set) -> set:
    """Slot indices a prog references directly."""
    if prog[0] == "mref":
        out.add(prog[1])
        return out
    if prog[0] in ("and", "or", "andnot", "xor"):
        for p in prog[1:]:
            _slot_refs(p, out)
    return out


# Empty-canonical (no shards) per-index results: a drain spanning indexes
# routes these inside the build so one empty index never blanks its
# drain-mates.
_EMPTY = {
    "count": 0, "sum": (0, 0), "min": (0, 0), "max": (0, 0),
    "topn": None, "topnf": [], "group": DECLINED,
}


def _item_touches(engine, index, spec, stacks):
    """Working-set touches of ONE fused item (util/heat.py's note format),
    from the same hint map the lowering used; ``stacks`` is the drain's
    merged (index, field, view) -> stack map, so block counts come from
    the summaries the launch read."""
    return [engine._touch_of(key, stacks.get(key), rows)
            for key, rows in _item_hints(engine, index, spec).items()]


def build(engine, entries: List[tuple]) -> FusedPlan:
    """Plan one heterogeneous drain (no launch: ``dispatch`` runs the plan,
    possibly many times).  ``entries`` is a list of (index, spec, shards)
    triples; a drain may span indexes: mask slots are hash-consed per
    (index, subtree text) and each index is a part of its own.  Runs under
    the engine's stacks lock (the caller is TorchEngine.fused_drain_async)."""
    from .engine import UnsupportedLowering, _Lowering

    n_items = len(entries)
    parts: Dict[str, _Part] = {}
    slot_of: Dict[tuple, int] = {}  # (index, subtree text) -> slot of its part
    slot_hits: Dict[tuple, int] = {}

    # The whole drain's row hints, before any stack fetch: an item that
    # misses a partial stack requests the drain's working set.  A malformed
    # item raises again in its own lowering below.
    hints: dict = {}
    for idx_h, spec_h, _ in entries:
        try:
            merge_hints(hints, _item_hints(engine, idx_h, spec_h))
        except Exception:  # noqa: BLE001 — hints are advisory only
            pass

    def part_for(index, canonical) -> _Part:
        p = parts.get(index)
        if p is None:
            p = parts[index] = _Part(index, _Lowering(engine, canonical))
            p.lw.row_hints = hints
        return p

    def lower_shared(part: _Part, call):
        """Hash-consing lowering: every distinct subtree becomes one slot
        of its index's part; repeats resolve to ("mref", j).  Combinators
        recurse through the cache so INNER shared subtrees (the segment
        inside N Intersects) share too."""
        part.refs += 1
        key = (part.index, str(call))
        j = slot_of.get(key)
        if j is not None:
            slot_hits[key] += 1
            return ("mref", j)
        name = call.name
        if name in ("Union", "Intersect", "Difference", "Xor") and call.children:
            op = {"Union": "or", "Intersect": "and", "Difference": "andnot",
                  "Xor": "xor"}[name]
            prog = (op,) + tuple(lower_shared(part, ch) for ch in call.children)
        elif name == "Not" and call.children:
            if len(call.children) != 1:
                raise UnsupportedLowering("Not() requires a single input row")
            exist = engine._lower_row(part.index, EXISTENCE_FIELD_NAME, 0, part.lw)
            prog = ("andnot", exist, lower_shared(part, call.children[0]))
        else:
            prog = engine._lower(part.index, call, part.lw)
        j = len(part.slots)
        part.slots.append(prog)
        slot_of[key] = j
        slot_hits[key] = 1
        return ("mref", j)

    # Sharing decides the sparse peel: a Count whose subtrees no other item
    # of its index holds may take the occupancy-guided sparse path.
    texts = [{(idx, t) for t in item_texts(spec)} for idx, spec, _ in entries]
    text_items: Dict[tuple, int] = {}
    for ts in texts:
        for t in ts:
            text_items[t] = text_items.get(t, 0) + 1

    sparse: list = []  # (prog, lowering, sparse plan) of each peeled Count
    peel_lws: list = []
    edge_of: Dict[tuple, tuple] = {}
    # Per item: ("count", part, edge) | ("agg", part, edge, decoder) |
    # ("extra", k) | ("const", value) | ("error", exc)
    routes: list = [None] * n_items
    top_slot: List[Optional[tuple]] = [None] * n_items  # (index, slot)
    reduce_rows = [0.0] * n_items
    sparse_notes: list = [None] * n_items  # a peel's occupancy note
    extra_notes: list = [None] * n_items  # per-item plan-note stamps
    # The reference's replicated operands besides stacks and masks (TopN
    # index vectors and count tables, GroupBy row lists), in bytes: its
    # plan's bytes_touched counts them.
    ref_extra = [0]

    order = sorted(range(n_items), key=lambda k: _entry_sort_key(entries[k]))
    for i in order:
        index, spec, shards = entries[i]
        kind = spec["kind"]
        try:
            canonical = engine.canonical_shards(index)
            if not canonical:
                routes[i] = ("const", _EMPTY[kind])
                continue
            part = part_for(index, canonical)
            if kind == "count":
                call = spec["call"]
                if not any(text_items[t] > 1 for t in texts[i]):
                    lw1 = _Lowering(engine, canonical)
                    lw1.row_hints = hints
                    prog1 = engine._lower(index, call, lw1)
                    if not kernels.fits(prog1):
                        raise UnsupportedLowering("count tree exceeds the kernels' limits")
                    splan = engine._sparse_plan(prog1, lw1, shards, canonical)
                    peel_lws.append(lw1)
                    if splan is not None:
                        # Claim the occupancy note for THIS item only: the
                        # shared batch note must not charge its batchmates
                        # the skipped bytes.
                        probe_note = plans_mod.take_dispatch_note() or {}
                        probe_note.update(path="sparse", fused=True, bytes_skipped=int(splan[1]))
                        sparse_notes[i] = probe_note
                        routes[i] = ("extra", len(sparse))
                        sparse.append((prog1, lw1, splan))
                        reduce_rows[i] = 0.25
                        continue
                    plans_mod.take_dispatch_note()  # drop the occupancy probe
                j = lower_shared(part, call)[1]
                top_slot[i] = (index, j)
                mi = part.mask(engine, shards)
                ekey = (index, "count", j, mi)
                hit = edge_of.get(ekey)
                if hit is None:
                    hit = edge_of[ekey] = ("count", part, len(part.count_edges))
                    part.count_edges.append((j, mi))
                routes[i] = hit
            elif kind in ("sum", "min", "max"):
                field = spec["field"]
                bsig = engine._bsi_group(index, field)
                stack = (part.lw.stack_for(index, field, view_bsi_name(field))
                         if bsig is not None else None)
                if bsig is None or stack is None:
                    routes[i] = ("const", (0, 0))
                    continue
                engine._require_full_stack(index, field, view_bsi_name(field), stack)
                depth = bsig.bit_depth()
                j = -1
                if spec.get("filter") is not None:
                    j = lower_shared(part, spec["filter"])[1]
                    top_slot[i] = (index, j)
                mi = part.mask(engine, shards)
                pm = part.lw.add_matrix(stack)
                planes = engine._plane_spec(stack, depth)
                if kind == "sum":
                    edge = ("sum", j, mi, pm, planes)
                    dec = _SumDecode(depth, bsig.min)
                else:
                    edge = ("minmax", j, mi, pm, planes, kind == "min")
                    dec = _MinMaxDecode(list(canonical), bsig.min, kind == "min")
                ekey = (index,) + edge + (field,)
                hit = edge_of.get(ekey)
                if hit is None:
                    hit = edge_of[ekey] = ("agg", part, len(part.agg_edges), dec)
                    part.agg_edges.append(edge)
                routes[i] = hit
                reduce_rows[i] = depth + 1
            elif kind in ("topn", "topnf"):
                field = spec["field"]
                stack = part.lw.stack_for(index, field, VIEW_STANDARD)
                if stack is None:
                    routes[i] = ("const", None if kind == "topn" else [])
                    continue
                engine._require_full_stack(index, field, VIEW_STANDARD, stack)
                if kind == "topn":
                    rows = list(spec["rows"])
                    present = np.asarray([r in stack.row_index for r in rows], dtype=bool)
                    idx = np.asarray([stack.row_index.get(r, 0) for r in rows], dtype=np.int32)
                    dec = _TopNScoresDecode(present, {s: k for k, s in enumerate(stack.shards)})
                    dedup = (tuple(rows),)
                    weight = _pow2(len(rows)) if rows else 1
                else:
                    row_ids = spec.get("row_ids")
                    entry = engine._topn_candidates(index, field, stack, row_ids)
                    if not entry.cands:
                        routes[i] = ("const", [])
                        continue
                    if len(entry.cands) > engine.MAX_TOPN_CANDIDATES:
                        routes[i] = ("const", DECLINED)
                        continue
                    K_pad = entry.host_cnt.shape[1]
                    n = int(spec.get("n") or 0)
                    n_out = min(n, K_pad) if n and not row_ids else None
                    thr = max(int(spec.get("threshold") or 1), 1)
                    dec = _TopNDeviceDecode(list(entry.cands), n_out)
                    dedup = (tuple(entry.cands), n_out, thr)
                    weight = K_pad
                j = lower_shared(part, spec["src"])[1]
                top_slot[i] = (index, j)
                mi = part.mask(engine, shards)
                cm = part.lw.add_matrix(stack)
                ekey = (index, kind, j, mi, cm, field) + dedup
                hit = edge_of.get(ekey)
                if hit is None:
                    if kind == "topn":
                        part.tensors.append(torch.from_numpy(idx).to(engine.device))
                        edge = ("topn", j, mi, cm, len(part.tensors) - 1)
                        ref_extra[0] += 4 * weight  # int32[K_pad] row indexes
                    else:
                        part.tensors += [entry.cand_idx, entry.dev_cnt]
                        edge = ("topnf", j, mi, cm, len(part.tensors) - 2,
                                len(part.tensors) - 1, thr, n_out)
                        # int32[K_pad] row indexes, int32[S, K_pad] counts
                        # and the threshold scalar.
                        ref_extra[0] += 4 * weight + 4 * len(canonical) * weight
                        if n_out is not None:
                            ref_extra[0] += 4
                    hit = edge_of[ekey] = ("agg", part, len(part.agg_edges), dec)
                    part.agg_edges.append(edge)
                routes[i] = hit
                reduce_rows[i] = weight
                if kind == "topnf" and n_out is not None:
                    extra_notes[i] = {"topkDevice": int(n_out)}
            elif kind == "group":
                fields = list(spec.get("fields") or ())
                row_lists = [list(r) for r in spec.get("rows") or ()]
                if not fields:
                    routes[i] = ("const", DECLINED)
                    continue
                combos = 1
                for rows in row_lists:
                    combos *= max(len(rows), 1)
                if combos > engine.MAX_GROUP_COMBOS or len(fields) > groupby_mod.MAX_GROUP_FIELDS:
                    # group_counts_async's overflow contract: the host
                    # iterator serves it (DECLINED -> None at the entry).
                    engine.group_host_fallbacks += 1
                    routes[i] = ("const", DECLINED)
                    continue
                g_mats, g_idx = [], []
                g_extra = 0
                for fname, rows in zip(fields, row_lists):
                    stack = part.lw.stack_for(index, fname, VIEW_STANDARD)
                    if stack is None:
                        break
                    engine._require_full_stack(index, fname, VIEW_STANDARD, stack)
                    g_mats.append(part.lw.add_matrix(stack))
                    g_idx.append(tuple(stack.row_index.get(r, -1) for r in rows))
                    ref_t = [stack.row_index.get(r, 0) for r in rows]
                    if not (ref_t == list(range(len(ref_t)))
                            or ref_t == list(range(len(ref_t) - 1, -1, -1))):
                        g_extra += 4 * len(ref_t)  # a row list the reference gathers
                if len(g_mats) != len(fields):
                    routes[i] = ("const", DECLINED)
                    continue
                j = -1
                if spec.get("filter") is not None:
                    j = lower_shared(part, spec["filter"])[1]
                    top_slot[i] = (index, j)
                mi = part.mask(engine, shards)
                edge = ("group", j, mi, tuple(g_mats), tuple(g_idx))
                ekey = (index,) + edge + (tuple(fields), tuple(tuple(r) for r in row_lists))
                ref_extra[0] += g_extra
                hit = edge_of.get(ekey)
                if hit is None:
                    dec = _GroupDecode(tuple(len(r) for r in row_lists))
                    hit = edge_of[ekey] = ("agg", part, len(part.agg_edges), dec)
                    part.agg_edges.append(edge)
                routes[i] = hit
                reduce_rows[i] = float(sum(len(r) for r in row_lists))
                extra_notes[i] = {"fusedGroupBy": int(combos)}
            else:
                raise ValueError(f"unknown fused item kind: {kind!r}")
        except Exception as e:  # noqa: BLE001 — one bad item must not
            routes[i] = ("error", e)  # fail its drain-mates

    # -- F1's limits: a part past them runs its items on per-op programs --
    for part in parts.values():
        if not (part.count_edges or part.agg_edges):
            continue
        spec = kernels.FusedSpec(part.slots, part.count_edges, part.agg_edges)
        try:
            if spec.slots and (spec.count_edges or spec.mat_slots):
                kernels.check_fused(spec.code(), len(spec.count_edges))
        except ValueError:
            part.declined = True
            engine.fused_declines += 1
            continue
        part.spec = spec
        part.need = engine._mask_words(sorted(part.need_shards), part.lw.canonical)

    # -- sharing accounting + footprint weights ---------------------------
    reach_cache: Dict[tuple, frozenset] = {}

    def reachable(key) -> frozenset:
        got = reach_cache.get(key)
        if got is None:
            index, j = key
            acc = {key}
            for r in _slot_refs(parts[index].slots[j], set()):
                acc |= reachable((index, r))
            got = reach_cache[key] = frozenset(acc)
        return got

    sharers: Dict[tuple, int] = {}
    item_reach: List[frozenset] = []
    for i in range(n_items):
        r = reachable(top_slot[i]) if top_slot[i] is not None else frozenset()
        item_reach.append(r)
        for key in r:
            sharers[key] = sharers.get(key, 0) + 1
    weights = []
    for i in range(n_items):
        w = reduce_rows[i]
        for index, j in item_reach[i]:
            w += _slot_rows(parts[index].slots[j]) / sharers[(index, j)]
        weights.append(max(w, 0.25))

    # Per-item plan notes (pilosa_tpu/parallel/fusion.py:846-882), each with
    # its own touches: the shared dispatch note stays touch-free, and the
    # batcher overlays each rider's item note on its copy.
    indexes = sorted({idx for idx, _, _ in entries})
    stacks_all: dict = {}
    for lw_t in peel_lws + [p.lw for p in parts.values()]:
        stacks_all.update(lw_t._by_key)
    note_touches = plans_mod.ENABLED and heat_mod.HEAT.enabled
    item_notes: list = [None] * n_items
    for i in range(n_items):
        if routes[i] is None or routes[i][0] == "error":
            continue
        note = {
            "op": OP_NAMES[entries[i][1]["kind"]],
            "path": "fused_program",
            "mask_shared_with": (sharers.get(top_slot[i], 1) - 1
                                 if top_slot[i] is not None else 0),
        }
        if len(indexes) > 1:
            note["crossIndex"] = True
        if extra_notes[i] is not None:
            note.update(extra_notes[i])
        if sparse_notes[i] is not None:
            note.update(sparse_notes[i])
            note["op"] = "Count"
            note["path"] = "sparse"
        if note_touches:
            try:
                touches = _item_touches(engine, entries[i][0], entries[i][1], stacks_all)
                if touches:
                    note["touches"] = touches
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        item_notes[i] = note

    # -- output positions and decoders ------------------------------------
    # Every live part's outputs in part order (its count vector first, then
    # each aggregate edge's), then each sparse peel's count.
    base: Dict[str, int] = {}
    agg_pos: Dict[tuple, int] = {}
    pos = 0
    for index, part in parts.items():
        if part.spec is None:
            continue
        base[index] = pos
        pos += int(bool(part.count_edges))
        for k, e in enumerate(part.agg_edges):
            agg_pos[(index, k)] = pos
            pos += kernels.FUSED_ARITY[e[0]]
    decoders: list = [None] * n_items
    errors: list = [None] * n_items
    riders = 0
    for i in range(n_items):
        r = routes[i]
        tag = r[0]
        if tag in ("count", "agg") and r[1].declined:
            index, spec, shards = entries[i]
            decoders[i] = _Solo(index, spec["kind"], spec, shards)
        elif tag == "error":
            errors[i] = r[1]
        elif tag == "const":
            decoders[i] = _Const(r[1])
        elif tag == "extra":
            decoders[i] = _Extra(pos + r[1])
        elif tag == "count":
            decoders[i] = _Count(base[r[1].index], r[2])
            riders += 1
        else:  # ("agg", part, edge, decoder)
            kind = r[1].agg_edges[r[2]][0]
            decoders[i] = _Agg(agg_pos[(r[1].index, r[2])], kernels.FUSED_ARITY[kind], r[3])
            riders += 1

    plan = FusedPlan()
    live = [p for p in parts.values() if p.spec is not None]
    plan.indexes = sorted({idx for idx, _, _ in entries})
    plan.parts = list(parts.values())
    plan.sparse = sparse
    plan.decoders = decoders
    plan.weights = weights
    plan.errors = errors
    plan.n_items = n_items
    plan.fused_riders = riders
    plan.masks_evaluated = sum(len(p.slots) for p in live)
    plan.masks_referenced = sum(p.refs for p in live)
    plan.item_notes = item_notes
    # The reference pads its one slot list to a power of two.
    n_slots = sum(len(p.slots) for p in parts.values())
    plan.masks_tier = _pow2(n_slots) if n_slots else 0
    plan.bytes_touched = engine._operand_bytes(
        [(p.lw, p.slots) for p in parts.values()], slot_vector=True, extra=ref_extra[0],
        mask_bytes=sum(4 * len(p.lw.canonical) * len(p.masks) for p in parts.values()))
    lws = [p.lw for p in parts.values()] + peel_lws
    plan.stacks = [st for lw in lws for st in lw.stacks]
    # Reuse gates: each index's canonical shard axis and every referenced
    # stack's version token (an in-place sync and a rebuild both move it).
    plan.canonical = {idx: list(engine.canonical_shards(idx)) for idx in plan.indexes}
    plan.stack_tokens = {}
    for lw in lws:
        for key, st in lw._by_key.items():
            plan.stack_tokens[key] = (st is None, None if st is None else st.versions)
    plan.cacheable = not any(errors)
    return plan


# Decoder objects: each takes the drain's unpacked host arrays.


class _Const:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __call__(self, parts):
        return self.v


class _Solo:
    """A placeholder: the item runs on its per-op program at dispatch
    (``engine.solo_op_async``), which gives its real decoder."""

    __slots__ = ("index", "kind", "spec", "shards")

    def __init__(self, index, kind, spec, shards):
        self.index = index
        self.kind = kind
        self.spec = spec
        self.shards = shards

    def __call__(self, parts):
        raise RuntimeError("a solo item decodes through the decoder its dispatch gave")


class _Extra:
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i

    def __call__(self, parts):
        return int(parts[self.i].reshape(-1)[0])


class _Count:
    __slots__ = ("pos", "i")

    def __init__(self, pos, i):
        self.pos = pos
        self.i = i

    def __call__(self, parts):
        return int(parts[self.pos][self.i])


class _Agg:
    __slots__ = ("pos", "arity", "dec")

    def __init__(self, pos, arity, dec):
        self.pos = pos
        self.arity = arity
        self.dec = dec

    def __call__(self, parts):
        return self.dec(parts[self.pos: self.pos + self.arity])


class _ScalarDecode:
    """A solo Count's 0-d result."""

    __slots__ = ()

    def __call__(self, parts):
        return int(parts[0].reshape(-1)[0])


class _SumDecode:
    __slots__ = ("depth", "base_min")

    def __init__(self, depth, base_min):
        self.depth = depth
        self.base_min = base_min

    def __call__(self, parts):
        return bsi_mod.decode_sum(parts[0], self.depth, self.base_min)


class _MinMaxDecode:
    __slots__ = ("canonical", "base_min", "is_min")

    def __init__(self, canonical, base_min, is_min):
        self.canonical = canonical
        self.base_min = base_min
        self.is_min = is_min

    def __call__(self, parts):
        return bsi_mod.decode_min_max((parts[0], parts[1]), self.canonical, self.base_min,
                                      self.is_min)


class _TopNScoresDecode:
    __slots__ = ("present", "pos")

    def __init__(self, present, pos):
        self.present = present
        self.pos = pos

    def __call__(self, parts):
        return decode_topn_scores((parts[0], parts[1]), self.present, self.pos)


class _TopNDeviceDecode:
    """A full TopN edge: (vals, ids) of K3's trim, or the totals with no
    trim; the host maps candidate indices back to row ids."""

    __slots__ = ("cands", "n_out")

    def __init__(self, cands, n_out):
        self.cands = cands
        self.n_out = n_out

    def __call__(self, parts):
        host = parts[0]
        return decode_topn_full(host if self.n_out is None else (host[0], host[1]),
                                self.cands, self.n_out)


class _GroupDecode:
    """A GroupBy edge's flat int64[prod(K_i)] counts as [K_1, ..., K_n]."""

    __slots__ = ("dims",)

    def __init__(self, dims):
        self.dims = dims

    def __call__(self, parts):
        return np.asarray(parts[0]).reshape(self.dims)
