"""TorchEngine: fused Count(tree) and TopN over device-resident field stacks.

The port of the Count and TopN slices of ``pilosa_tpu/parallel/engine.py``
(``MeshEngine``).  Per Count query:

1. the call tree is lowered to a normalized program over a list of field
   stacks ``int32[R, S, WORDS]`` — S the index's canonical shard axis,
   R the view's row table — with row indices as plain integers;
2. ``_sparse_plan`` combines the stacks' exact block-occupancy summaries
   through the tree on the host; when at most ``sparse_threshold`` of the
   requested blocks survive, the count runs on K2 (``sparse.py``) over
   only those blocks, else on K1 (``kernels.py``) over every word;
3. the kernel reduces on the device and the result is one int64.

TopN (``topn_full``): the candidates are the id-descending union of the
fragments' ranked caches, cached per (index, field) against the stack's
token with their per-shard store counts; K3 scores every candidate
against the masked src tree by index into the resident stack, gates each
(candidate, shard) and sums the totals, and K4 trims them to the top n.
``topn_scores`` is the two-phase lane's phase 1 (scores and src counts of
every shard in one K3 launch) and ``topn_cache_only`` the no-src TopN,
reduced on the host.

Field stacks are cached per (index, field, view) over the canonical shard
list, so queries over different shard subsets share one resident stack;
the requested subset is a per-shard mask.  A stack is rebuilt whole when
its view's version moves (``stack_rebuilds``): the in-place scatter-sync,
partial residency, the block pool, the batcher and the result memo are
later slices (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.cache import pair_sort_key
from ..core.index import EXISTENCE_FIELD_NAME
from ..core.view import VIEW_STANDARD
from ..ops import bitops
from ..pql import Call
from . import kernels
from . import sparse as sparse_mod
from .mesh import host_stack, put_stack, resolve_device, shard_mask


class UnsupportedLowering(Exception):
    """The call tree has no device lowering here (an unported call, a
    missing field or row argument, or a tree past the kernels' limits).
    The executor serves such a Count from the host bitmap lane; no other
    exception from the engine is caught, so a kernel fault surfaces."""


class _FieldStack:
    """Device-resident int32[R, S, WORDS] for one (index, field, view),
    rows major so a row slice is one contiguous [S, WORDS] block."""

    __slots__ = ("matrix", "row_index", "versions", "shards", "occ")

    def __init__(self, matrix: torch.Tensor, row_index: Dict[int, int],
                 versions, shards: List[int], occ: np.ndarray):
        self.matrix = matrix
        self.row_index = row_index
        self.versions = versions
        self.shards = shards
        # EXACT host-side block-occupancy summary, uint64[R, S]: bit b of
        # occ[r, s] set iff occupancy block b of (row r, shard s) holds a
        # set bit.  The sparse plan combines these through the query tree
        # to decide which device blocks to read at all, so a missing bit
        # here would silently undercount.
        self.occ = occ


class _Lowering:
    """The field stacks one query program reads.  ``stack_for`` fetches
    each (index, field, view) once, so the query sees one consistent
    snapshot; ``add_matrix`` dedups stacks into program slots."""

    def __init__(self, engine: "TorchEngine", canonical: List[int]):
        self.engine = engine
        self.canonical = canonical
        self.mats: List[torch.Tensor] = []
        self.stacks: List[_FieldStack] = []
        self._slots: Dict[int, int] = {}
        self._by_key: dict = {}

    def stack_for(self, index, field, view) -> Optional[_FieldStack]:
        key = (index, field, view)
        if key not in self._by_key:
            self._by_key[key] = self.engine.field_stack(
                index, field, view, self.canonical
            )
        return self._by_key[key]

    def add_matrix(self, stack: _FieldStack) -> int:
        i = self._slots.get(id(stack.matrix))
        if i is None:
            i = self._slots[id(stack.matrix)] = len(self.mats)
            self.mats.append(stack.matrix)
            self.stacks.append(stack)
        return i


class _TopNCandidates:
    """Candidate set + per-shard row-count matrix for the fused TopN.

    ``cands`` is the id-DESCENDING union of the per-fragment ranked-cache
    entries (fragment.go :1018-1040), descending so that K4's lower-index
    tie-break equals the (-count, -id) pair order.  ``host_cnt``
    int32[S, K_pad] holds each candidate's STORE row count per canonical
    shard (the phase-2 ``cnt`` gate); ``dev_cnt`` is its device twin laid
    out [K_pad, S] like the kernel's scores, and ``cand_idx`` int32[K_pad]
    the stack rows to score.  Pad slots and absent rows name row 0 and
    carry count 0, so the gate (thr >= 1) drops them."""

    __slots__ = ("cands", "cand_idx", "dev_cnt", "host_cnt")

    def __init__(self, cands, cand_idx, dev_cnt, host_cnt):
        self.cands = cands
        self.cand_idx = cand_idx
        self.dev_cnt = dev_cnt
        self.host_cnt = host_cnt


def decode_topn_full(host, cands, n_out):
    """The fused TopN readback (trimmed (vals, idx), or the full totals
    when ``n_out`` is None) as sorted (row_id, count) pairs; a copy of
    ``pilosa_tpu/parallel/fusion.py:200 decode_topn_full``.  Zero totals
    and pad slots (index >= len(cands)) drop out."""
    if host is None:
        return []
    if n_out is None:
        totals = np.asarray(host)
        pairs = [
            (cands[k], int(totals[k])) for k in range(len(cands)) if totals[k] > 0
        ]
        pairs.sort(key=pair_sort_key)
        return pairs
    vals, top_idx = host
    return [
        (cands[int(i)], int(v))
        for v, i in zip(vals, top_idx)
        if v > 0 and int(i) < len(cands)
    ]


class TorchEngine:
    # Above this candidate-union size the fused TopN declines and the
    # executor runs the two-phase composition (engine.py:4197).
    MAX_TOPN_CANDIDATES = 4096

    def __init__(self, holder, device=None):
        self.holder = holder
        self.device = resolve_device(device)
        self._stacks: "OrderedDict[Tuple[str, str, str], _FieldStack]" = OrderedDict()
        # Serializes stack build/replace: two threads rebuilding one stale
        # stack must not interleave their assignments.
        self._stacks_lock = threading.RLock()
        self._canonical: Dict[str, Tuple[int, List[int]]] = {}
        self._masks: "OrderedDict[Tuple[int, bytes], torch.Tensor]" = OrderedDict()
        # Full stack (re)builds: every write to a resident view costs one
        # in this slice.
        self.stack_rebuilds = 0
        # Occupancy-guided block skipping: when the surviving block
        # fraction is at or under this threshold the count runs on K2.
        # 0.25 is the JAX package's prior; the crossover on this card is
        # still to be measured (ROADMAP.md Queue 1 item 7).
        self.sparse_threshold = 0.25
        self.dense_dispatches = 0
        self.sparse_dispatches = 0
        self.device_bytes_skipped = 0
        # The path the last count dispatch took: "dense" or "sparse".
        self.last_path: Optional[str] = None
        # (index, field) -> (stack token, _TopNCandidates): the cache-fed
        # TopN candidate build, rebuilt when the stack's token moves.
        self._topn_cands: Dict[Tuple[str, str], tuple] = {}

    # -- canonical shard axis ---------------------------------------------

    def canonical_shards(self, index: str) -> List[int]:
        """The index's local-fragment shard list: the one shard axis every
        stack of this index is laid out over, cached behind the holder's
        shard epoch."""
        epoch = self.holder.shard_epoch(index)
        cached = self._canonical.get(index)
        if cached is not None and cached[0] == epoch:
            return cached[1]
        shards = self.holder.local_shards(index)
        self._canonical[index] = (epoch, shards)
        return shards

    def _mask_words(self, shards, canonical) -> torch.Tensor:
        """int32[S] per-shard gate on the device: 1 for requested shards,
        0 otherwise.  Cached per bitset — masks recur across a stream."""
        req = set(shards)
        bits = bytes(1 if s in req else 0 for s in canonical)
        key = (len(canonical), bits)
        m = self._masks.get(key)
        if m is None:
            pos = [i for i, b in enumerate(bits) if b]
            m = self._masks[key] = shard_mask(len(canonical), pos, self.device)
            while len(self._masks) > 1024:  # tiny buffers, but bounded
                self._masks.popitem(last=False)
        else:
            self._masks.move_to_end(key)
        return m

    # -- residency ---------------------------------------------------------

    def field_stack(self, index: str, field: str, view: str,
                    canonical: Optional[List[int]] = None) -> Optional[_FieldStack]:
        """The device stack of every row of a view across the index's
        canonical shard axis, rebuilt whole when the view changed."""
        if canonical is None:
            canonical = self.canonical_shards(index)
        key = (index, field, view)
        with self._stacks_lock:
            view_obj = self.holder.view(index, field, view)
            token = (
                self.holder.shard_epoch(index),
                id(view_obj),
                -1 if view_obj is None else view_obj.version,
            )
            cached = self._stacks.get(key)
            if cached is not None and cached.versions == token and cached.shards == canonical:
                self._stacks.move_to_end(key)
                return cached
            self._stacks.pop(key, None)
            if not canonical:
                return None
            row_index, buf, occ = self._assemble_host(index, field, view, canonical)
            stack = _FieldStack(
                put_stack(buf, self.device), row_index, token, list(canonical), occ
            )
            self.stack_rebuilds += 1
            self._stacks[key] = stack
            return stack

    def _assemble_host(self, index, field, view, canonical):
        """Host half of a stack build: walk the view's fragments and fill
        the dense [R, S, WORDS] staging buffer plus the exact occupancy
        summary, computed from the words just copied.  Returns
        (row_index, host buffer, occ)."""
        frags = [self.holder.fragment(index, field, view, s) for s in canonical]
        row_ids = sorted({r for f in frags if f is not None for r in f.row_ids()})
        if not row_ids:
            row_ids = [0]
        row_index = {r: i for i, r in enumerate(row_ids)}
        S = len(canonical)
        buf, mat = host_stack((len(row_ids), S, bitops.WORDS), self.device)
        occ = np.zeros((len(row_ids), S), dtype=np.uint64)
        for si, f in enumerate(frags):
            if f is None:
                continue
            for r in f.row_ids():
                ri = row_index[r]
                mat[ri, si] = f.row_words(r)
                occ[ri, si] = bitops.occupancy64(mat[ri, si])
        return row_index, buf, occ

    # -- call-tree lowering -------------------------------------------------

    def _lower(self, index: str, c: Call, lw: _Lowering):
        """Lower a bitmap call tree to a normalized count program."""
        name = c.name
        if name == "Row":
            try:
                field_name = c.field_arg()
                row_id, ok = c.uint_arg(field_name)
            except ValueError as e:  # the host lane reports the argument error
                raise UnsupportedLowering(str(e)) from None
            if not ok:
                raise UnsupportedLowering("Row() requires a row id")
            return self._lower_row(index, field_name, row_id, lw)
        if name in ("Union", "Intersect", "Difference", "Xor"):
            op = {"Union": "or", "Intersect": "and", "Difference": "andnot",
                  "Xor": "xor"}[name]
            subs = tuple(self._lower(index, ch, lw) for ch in c.children)
            if not subs:
                return self._lower_zero()
            return (op,) + subs
        if name == "Not":
            if len(c.children) != 1:
                raise UnsupportedLowering("Not() requires a single input row")
            exist = self._lower_row(index, EXISTENCE_FIELD_NAME, 0, lw)
            return ("andnot", exist, self._lower(index, c.children[0], lw))
        raise UnsupportedLowering(f"no device lowering for {name}()")

    @staticmethod
    def _lower_zero():
        return ("zero",)

    def _lower_row(self, index, field, row_id, lw: _Lowering):
        # A missing FIELD is the host lane's FieldNotFound error; the
        # existence field is exempt (an index without existence tracking
        # contributes zeros to Not()).
        idx_obj = self.holder.index(index)
        if field != EXISTENCE_FIELD_NAME and (
            idx_obj is None or idx_obj.field(field) is None
        ):
            raise UnsupportedLowering(f"field not found: {field!r}")
        stack = lw.stack_for(index, field, VIEW_STANDARD)
        if stack is None:
            return self._lower_zero()
        ridx = stack.row_index.get(row_id)
        if ridx is None:
            return self._lower_zero()
        return ("row", lw.add_matrix(stack), ridx)

    # -- fused evaluation ---------------------------------------------------

    def count(self, index: str, c: Call, shards: List[int]) -> int:
        """Count(tree): one kernel launch, one readback."""
        return int(self.count_async(index, c, shards))

    def count_async(self, index: str, c: Call, shards: List[int]) -> torch.Tensor:
        """Count(tree) as a 0-d int64 device tensor, without waiting for
        the device."""
        canonical = self.canonical_shards(index)
        if not canonical:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return self._dispatch_count(index, c, shards, canonical)

    def _dispatch_count(self, index, c, shards, canonical):
        lw = _Lowering(self, canonical)
        prog = self._lower(index, c, lw)
        if not kernels.fits(prog):
            raise UnsupportedLowering("count tree exceeds the kernels' limits")
        plan = self._sparse_plan(prog, lw, shards, canonical)
        if plan is not None:
            return self._dispatch_sparse(prog, lw.mats, plan)
        self.dense_dispatches += 1
        self.last_path = "dense"
        return kernels.count_tree(prog, lw.mats, self._mask_words(shards, canonical))

    def _dispatch_sparse(self, prog, mats, plan):
        blk_idx, blk_n, skipped = plan
        self.sparse_dispatches += 1
        self.device_bytes_skipped += skipped
        self.last_path = "sparse"
        return sparse_mod.count_tree_blocks(
            prog,
            mats,
            torch.from_numpy(blk_idx).to(self.device),
            torch.from_numpy(blk_n).to(self.device),
        )

    def _sparse_plan(self, prog, lw: _Lowering, shards, canonical):
        """Block lists for the sparse count, or None to take the dense
        path.  Combines the stacks' occupancy summaries through the tree
        on the host (and intersects, or/xor unite, andnot keeps its left
        side — the right can only clear bits), gates by the requested
        shards, and when the surviving block fraction is at or under
        ``sparse_threshold`` returns ``(blk_idx int32[S, Kb], blk_n
        int32[S], bytes_skipped)`` with the shard mask folded into
        ``blk_n``."""
        S = len(canonical)
        n_leaves = 0

        def occ_of(p):
            nonlocal n_leaves
            kind = p[0]
            if kind == "zero":
                return np.zeros(S, dtype=np.uint64)
            if kind == "row":
                n_leaves += 1
                return lw.stacks[p[1]].occ[p[2]]
            subs = [occ_of(q) for q in p[1:]]
            occ = subs[0]
            for so in subs[1:]:
                if kind == "and":
                    occ = occ & so
                elif kind != "andnot":  # or / xor widen; andnot keeps left
                    occ = occ | so
            return occ

        occ = occ_of(prog)
        if n_leaves == 0:
            return None
        pos = {s: i for i, s in enumerate(canonical)}
        req = np.zeros(S, dtype=bool)
        for s in shards:
            i = pos.get(s)
            if i is not None:
                req[i] = True
        n_req = int(req.sum())
        if n_req == 0:
            return None
        occ = np.where(req, occ, np.uint64(0))
        bits = np.unpackbits(
            occ.view(np.uint8).reshape(S, 8), axis=1, bitorder="little"
        )  # [S, OCC_BLOCKS] 0/1
        blk_n = bits.sum(axis=1).astype(np.int32)
        total_blocks = int(blk_n.sum())
        denom = n_req * bitops.OCC_BLOCKS
        if total_blocks / denom > self.sparse_threshold:
            return None
        # Occupied block ids first (the stable sort keeps them ascending),
        # padded with block 0 — padding slots are skipped by the kernel.
        # Kb pads to power-of-two tiers, as the JAX planner's do.
        kmax = max(1, int(blk_n.max()))
        Kb = 1 << (kmax - 1).bit_length()
        order = np.argsort(~bits.astype(bool), axis=1, kind="stable")
        blk_idx = np.where(
            np.arange(Kb, dtype=np.int64)[None, :] < blk_n[:, None],
            order[:, :Kb],
            0,
        ).astype(np.int32)
        skipped = n_leaves * (denom - total_blocks) * bitops.OCC_BLOCK_WORDS * 4
        return np.ascontiguousarray(blk_idx), blk_n, skipped

    # -- TopN (pilosa_tpu/parallel/engine.py:4102-4565) ---------------------

    def _lower_src(self, index: str, src_call: Call, canonical: List[int]):
        """The src tree of a TopN as a normalized program and its stacks;
        a tree past the kernels' limits is UnsupportedLowering."""
        lw = _Lowering(self, canonical)
        prog = self._lower(index, src_call, lw)
        if not kernels.fits(prog):
            raise UnsupportedLowering("src tree exceeds the kernels' limits")
        return prog, lw

    def topn_scores(self, index: str, field: str, candidate_rows: List[int],
                    src_call: Call, shards: List[int]):
        """Batched TopN phase-1 scoring across all requested shards in one
        K3 launch: (scores int32[S, K], src_counts int32[S], shard_pos) as
        numpy, ``shard_pos`` mapping shard -> canonical position.
        Candidates absent from the row table score 0 (they read row 0 on
        the card and are zeroed here).  None when the field has no stack."""
        canonical = self.canonical_shards(index)
        stack = self.field_stack(index, field, VIEW_STANDARD, canonical)
        if stack is None:
            return None
        present = np.asarray([r in stack.row_index for r in candidate_rows], dtype=bool)
        idx = np.asarray(
            [stack.row_index.get(r, 0) for r in candidate_rows], dtype=np.int32
        )
        mask = self._mask_words(shards, canonical)
        prog, lw = self._lower_src(index, src_call, canonical)
        scores, counts = kernels.topn_tree(
            prog, lw.mats, mask, stack.matrix, torch.from_numpy(idx).to(self.device)
        )
        # The kernel's score matrix is rows-major [K, S]; callers take [S, K].
        scores = scores.cpu().numpy().T.copy()
        scores[:, ~present] = 0
        pos = {s: i for i, s in enumerate(stack.shards)}
        return scores, counts.cpu().numpy(), pos

    def _build_topn_candidates(self, index, field, stack, cands) -> _TopNCandidates:
        """Assemble the id-descending candidate arrays for a stack."""
        S = len(stack.shards)
        K = len(cands)
        K_pad = max(8, 1 << (K - 1).bit_length()) if K else 8
        host_cnt = np.zeros((S, K_pad), dtype=np.int32)
        if K:
            cand_arr = np.asarray(cands, dtype=np.int64)
            for si, s in enumerate(stack.shards):
                frag = self.holder.fragment(index, field, VIEW_STANDARD, s)
                if frag is not None:
                    host_cnt[si, :K] = frag.counts_for(cand_arr).astype(np.int32)
        idx = np.zeros(K_pad, dtype=np.int32)
        idx[:K] = [stack.row_index.get(r, 0) for r in cands]
        return _TopNCandidates(
            list(cands),
            torch.from_numpy(idx).to(self.device),
            torch.from_numpy(host_cnt.T.copy()).to(self.device),
            host_cnt,
        )

    def _topn_candidates(self, index, field, stack, row_ids=None) -> _TopNCandidates:
        """Cached candidate arrays (the union of every shard's ranked-cache
        ids); explicit ids= queries build ad hoc."""
        if row_ids:
            return self._build_topn_candidates(
                index, field, stack, sorted(set(row_ids), reverse=True)
            )
        key = (index, field)
        cached = self._topn_cands.get(key)
        if cached is not None and cached[0] == stack.versions:
            return cached[1]
        cols = []
        for s in stack.shards:
            frag = self.holder.fragment(index, field, VIEW_STANDARD, s)
            if frag is None:
                continue
            rank_columns = getattr(frag.cache, "rank_columns", None)
            if rank_columns is not None:
                cols.append(rank_columns()[0])
            elif frag.cache.top():
                cols.append(np.asarray([r for r, _ in frag.cache.top()], dtype=np.int64))
        cands = [int(r) for r in np.unique(np.concatenate(cols))[::-1]] if cols else []
        entry = self._build_topn_candidates(index, field, stack, cands)
        self._topn_cands[key] = (stack.versions, entry)
        return entry

    def topn_full_async(self, index: str, field: str, src_call: Call, shards,
                        n: int, min_threshold: int, row_ids=None):
        """The whole TopN (phase-1 scores, per-shard gates, exact totals
        and the trim) as K3 then K4, without waiting for the device:
        (candidates, n_out, device result), or None when the candidate
        union is past MAX_TOPN_CANDIDATES (the two-phase path runs)."""
        canonical = self.canonical_shards(index)
        stack = self.field_stack(index, field, VIEW_STANDARD, canonical)
        if stack is None:
            return [], None, None
        entry = self._topn_candidates(index, field, stack, row_ids)
        if not entry.cands:
            return [], None, None
        if len(entry.cands) > self.MAX_TOPN_CANDIDATES:
            return None
        # ids= mode and n=0 skip the trim (never truncate).
        K_pad = entry.host_cnt.shape[1]
        n_out = min(int(n), K_pad) if n and not row_ids else None
        mask = self._mask_words(shards, canonical)
        prog, lw = self._lower_src(index, src_call, canonical)
        out = kernels.topn_full_tree(
            prog, lw.mats, mask, stack.matrix, entry.cand_idx, entry.dev_cnt,
            max(int(min_threshold), 1), n_out,
        )
        return entry.cands, n_out, out

    def topn_full(self, index: str, field: str, src_call: Call, shards,
                  n: int, min_threshold: int, row_ids=None):
        """Synchronous fused TopN -> sorted (row_id, count) pairs, one small
        readback, or None when the fused path declines."""
        res = self.topn_full_async(index, field, src_call, shards, n, min_threshold, row_ids)
        if res is None:
            return None
        cands, n_out, out = res
        if out is None:
            host = None
        elif n_out is None:
            host = out.cpu().numpy()
        else:
            host = (out[0].cpu().numpy(), out[1].cpu().numpy())
        return decode_topn_full(host, cands, n_out)

    def topn_cache_only(self, index: str, field: str, shards, n, min_threshold,
                        row_ids=None):
        """TopN with no src bitmap: the per-shard store counts of the
        candidates, reduced on the host (phase-1 per-shard top-n union plus
        phase-2 exact totals over the requested shards), no device work.
        Sorted trimmed pairs, or None when the candidate union is too
        large."""
        canonical = self.canonical_shards(index)
        stack = self.field_stack(index, field, VIEW_STANDARD, canonical)
        if stack is None:
            return []
        entry = self._topn_candidates(index, field, stack, row_ids)
        if row_ids:
            n = 0  # explicit ids: never truncate
        K = len(entry.cands)
        if K == 0:
            return []
        if K > self.MAX_TOPN_CANDIDATES:
            return None
        pos = {s: i for i, s in enumerate(stack.shards)}
        rows = [pos[s] for s in shards if s in pos]
        if not rows:
            return []
        thr = max(int(min_threshold), 1)
        cnt = entry.host_cnt[np.asarray(rows, dtype=np.intp)][:, :K]
        gated = np.where(cnt >= thr, cnt, 0)
        totals = gated.sum(axis=0, dtype=np.int64)
        if n:
            # Phase-1 candidate union: each shard's top-n by (count desc,
            # id desc) — a stable argsort over the id-descending axis.
            sel = np.argsort(-gated, axis=1, kind="stable")[:, : int(n)]
            hit = np.nonzero(np.take_along_axis(gated, sel, axis=1) > 0)
            union = np.zeros(K, dtype=bool)
            union[sel[hit]] = True
        else:
            union = (gated > 0).any(axis=0)
        pairs = [
            (entry.cands[k], int(totals[k]))
            for k in np.nonzero(union)[0]
            if totals[k] > 0
        ]
        pairs.sort(key=pair_sort_key)
        if n:
            pairs = pairs[: int(n)]
        return pairs
