"""Count(tree) and TopN scoring over field stacks: K1 ``count_tree_dense``,
K3 ``score_rows`` (with TopN's trim in its last block) and P2
``and_popcount_rows``, each beside its plain twin.

The engine lowers a PQL call tree to a normalized program over a list of
field stacks ``int32[R, S, WORDS]`` (rows major, the canonical shard axis
second, no padding):

- leaves ``("row", mat_slot, row)`` — row ``row`` of stack ``mats[mat_slot]``
  — and ``("zero",)``;
- range leaves ``("range", kind, mat_slot, planes, lo, hi)`` — a BSI
  condition (``kind`` one of ``ops.bsi.RANGE_KINDS``, ``lo`` the rebased
  predicate, ``hi`` BETWEEN's upper bound, else 0) over the bit planes of
  stack ``mats[mat_slot]`` whose rows ``planes`` names, value planes first
  and the not-null plane last, -1 for a plane the stack lacks;
- nodes ``("and" | "or" | "andnot" | "xor", child, child, ...)``, folded
  left to right.

``count_tree(prog, mats, mask)`` returns the masked popcount of the tree
summed over every word of the requested shards, as a 0-d int64 tensor on
the stacks' device.  It replaces the XLA program ``count_tree`` +
``apply_prog`` of ``pilosa_tpu/parallel/kernels.py:242`` (which sums in
int32; the two agree below 2^31).

For tensors on the card the wrapper launches the hand-written CUDA kernel
``csrc/count_tree_dense.cu`` and raises if it cannot; for tensors on the
CPU it evaluates the plain PyTorch version.  Both enforce the same
program limits (``check_prog``).  The tree travels to the kernel as a
postfix program (``compile_prog``), shared with K2 in ``sparse.py``; a
range leaf carries its stack, plane rows and predicate bits by value
(``csrc/tree_eval.cuh`` RangeLeaf), so its planes take no entry of the
leaf table.

``topn_tree`` and ``topn_full_tree`` (TopN, below) take the same src tree
and wrap K3 ``csrc/score_rows.cu`` the same way: a CUDA tensor launches
or raises, a CPU tensor takes the plain version.  A full TopN is one K3
launch: its last block ranks the totals and writes the top n.  P2 ``csrc/and_popcount_rows.cu`` scores one fragment's rows,
named by index, against one src row (``bitops.popcount_and_rows``).

``count_batch_tree`` (K Counts in one launch, below) compiles a batch of
trees into one table of distinct leaf rows and one postfix program per
query (``compile_batch``) and wraps K5 ``csrc/count_batch_tree.cu`` the
same way.
"""

from __future__ import annotations

import array
import ctypes
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import bitops
from ..ops import bsi as bsi_ops

# Postfix opcodes and limits: csrc/tree_eval.cuh holds the same values.
OP_LEAF, OP_ZERO, OP_AND, OP_OR, OP_ANDNOT, OP_XOR, OP_RANGE = range(7)
_NODE_OPS = {"and": OP_AND, "or": OP_OR, "andnot": OP_ANDNOT, "xor": OP_XOR}
_ITEM_OPS = (OP_LEAF, OP_ZERO, OP_RANGE)
MAX_PROG = 128
MAX_LEAVES = 32
MAX_STACK = 16
MAX_RANGES = 4  # range leaves per tree
MAX_PLANES = 64  # BSI depth up to 63, then the not-null plane


class Postfix:
    """A tree compiled for the kernels: opcodes, distinct leaves
    ``(mat_slot, row)`` in leaf-index order, distinct range leaves
    ``(mat_slot, kind, planes, lo, hi)`` in range-index order, the stack
    depth, and whether the program has the chain form (``_is_chain``).
    Shared by every caller of ``compile_prog`` (it is cached): never
    mutated."""

    __slots__ = ("ops", "leaves", "ranges", "depth", "chain")

    def __init__(self, ops: List[int], leaves: List[Tuple[int, int]], depth: int,
                 ranges: Optional[list] = None):
        self.ops = ops
        self.leaves = leaves
        self.ranges = ranges or []
        self.depth = depth
        self.chain = _is_chain(ops)


@functools.lru_cache(maxsize=4096)
def compile_prog(prog) -> Postfix:
    """Postfix form of a normalized tree, cached per tree: a serving
    stream repeats its trees, and a batch compiles each one.  Raises
    ValueError on an unknown node."""
    ops: List[int] = []
    leaf_of: Dict[Tuple[int, int], int] = {}
    range_of: Dict[tuple, int] = {}

    def walk(p):
        kind = p[0]
        if kind == "row":
            key = (int(p[1]), int(p[2]))
            k = leaf_of.setdefault(key, len(leaf_of))
            ops.append(OP_LEAF | (k << 8))
        elif kind == "range" and len(p) == 6 and p[1] in bsi_ops.RANGE_KINDS:
            key = (int(p[2]), p[1], tuple(int(x) for x in p[3]), int(p[4]), int(p[5]))
            k = range_of.setdefault(key, len(range_of))
            ops.append(OP_RANGE | (k << 8))
        elif kind == "zero":
            ops.append(OP_ZERO)
        elif kind in _NODE_OPS and len(p) >= 2:
            walk(p[1])
            for q in p[2:]:
                walk(q)
                ops.append(_NODE_OPS[kind])
        else:
            raise ValueError(f"bad count-tree node: {p!r}")

    walk(prog)
    depth = sp = 0
    for code in ops:
        sp += 1 if (code & 0xFF) in _ITEM_OPS else -1
        depth = max(depth, sp)
    return Postfix(ops, list(leaf_of), depth, list(range_of))


def check_prog(code: Postfix) -> None:
    """Raise ValueError when a compiled program does not fit the kernels'
    fixed stack, program and leaf-table sizes."""
    if code.depth > MAX_STACK:
        raise ValueError(
            f"count tree needs a stack of {code.depth}; the kernels hold {MAX_STACK}"
        )
    if len(code.ops) > MAX_PROG:
        raise ValueError(
            f"count tree has {len(code.ops)} ops; the kernels take {MAX_PROG}"
        )
    if len(code.leaves) > MAX_LEAVES:
        raise ValueError(
            f"count tree has {len(code.leaves)} leaf rows; the kernels take {MAX_LEAVES}"
        )
    if len(code.ranges) > MAX_RANGES:
        raise ValueError(
            f"count tree has {len(code.ranges)} range leaves; the kernels take {MAX_RANGES}"
        )
    for _, _, planes, lo, hi in code.ranges:
        if not 1 <= len(planes) <= MAX_PLANES or not (0 <= lo < 1 << 63 and 0 <= hi < 1 << 63):
            raise ValueError(f"range leaf of {len(planes)} planes (the kernels take 1 to "
                             f"{MAX_PLANES}) or predicate outside 0..2^63-1")


def fits(prog) -> bool:
    """True when ``prog`` compiles within the kernels' limits."""
    try:
        check_prog(compile_prog(prog))
    except ValueError:
        return False
    return True


# -- plain PyTorch version ---------------------------------------------------

_COMBINE = {
    "and": torch.bitwise_and,
    "or": torch.bitwise_or,
    "andnot": bitops.row_andnot,
    "xor": torch.bitwise_xor,
}


def range_planes(mat: torch.Tensor, planes, select) -> torch.Tensor:
    """The planes of a range leaf, ``select`` applied to each: a stack
    ``[len(planes), ...]`` with zeros for a missing (-1) plane."""
    like = select(mat[0])
    return torch.stack([select(mat[p]) if p >= 0 else torch.zeros_like(like) for p in planes])


def eval_prog(prog, mats: Sequence[torch.Tensor], select) -> torch.Tensor:
    """Evaluate a normalized tree with ``select(row_words)`` applied to
    every leaf row (the identity for the dense count, a block gather for
    the sparse one) and to every plane a range leaf reads.  ``("zero",)``
    takes the shape of the first leaf."""
    if prog[0] == "row":
        return select(mats[prog[1]][prog[2]])
    if prog[0] == "range":
        _, kind, slot, planes, lo, hi = prog
        return bsi_ops.range_rows(kind, range_planes(mats[slot], planes, select), lo, hi)
    subs = [
        None if p[0] == "zero" else eval_prog(p, mats, select) for p in prog[1:]
    ]
    like = next((s for s in subs if s is not None), None)
    if like is None:
        return None  # the whole subtree is zero
    out = subs[0] if subs[0] is not None else torch.zeros_like(like)
    for s in subs[1:]:
        out = _COMBINE[prog[0]](out, s if s is not None else torch.zeros_like(like))
    return out


def filter_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
    """The masked filter rows int32[S, W] of an optional tree, shaped like
    ``like``: every column of the requested shards for ``prog`` None, zeros
    for a zero tree.  The plain filter of K6, K7 and K8."""
    if prog is None:
        f = torch.full(like.shape, -1, dtype=torch.int32, device=like.device)
    else:
        f = None if prog[0] == "zero" else eval_prog(prog, mats, lambda words: words)
        if f is None:
            f = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
    return torch.where(mask[:, None] != 0, f, torch.zeros_like(f))


def count_tree_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """sum(popcount(tree(rows) & mask)) in plain PyTorch ops: the CPU path
    and the reference the card's kernel is held against."""
    device = mask.device
    if prog[0] == "zero":
        return torch.zeros((), dtype=torch.int64, device=device)
    row = eval_prog(prog, mats, lambda words: words)
    if row is None:
        return torch.zeros((), dtype=torch.int64, device=device)
    return bitops.popcount_words(row[mask != 0]).sum()


# -- CUDA kernel K1 ----------------------------------------------------------

class RangeLeaf(ctypes.Structure):
    """csrc/tree_eval.cuh's RangeLeaf: a BSI stack's planes (its row 0,
    uint4 per stack row, the rows of planes 0..depth, -1 for a missing
    one) and a range condition (kind, predicate bits)."""

    _fields_ = [("base", ctypes.c_void_p), ("stride", ctypes.c_uint64),
                ("lo", ctypes.c_uint64), ("hi", ctypes.c_uint64), ("kind", ctypes.c_int),
                ("depth", ctypes.c_int), ("plane", ctypes.c_int * MAX_PLANES)]


def c_planes(mat: torch.Tensor, planes, kind: str = "eq", lo: int = 0, hi: int = 0) -> RangeLeaf:
    """A RangeLeaf over stack ``mat`` int32[R, S, W] (on the card)."""
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"{len(planes)} planes; the kernels take 1 to {MAX_PLANES}")
    R = mat.shape[0]
    if any(not -1 <= int(p) < R for p in planes):
        raise ValueError(f"plane row outside stack of {R} rows")
    leaf = RangeLeaf(mat.data_ptr(), mat.stride(0) // 4, int(lo), int(hi),
                     bsi_ops.RANGE_KINDS.index(kind), len(planes) - 1)
    for i, p in enumerate(planes):
        leaf.plane[i] = int(p)
    return leaf


def _c_leaves(code: Postfix, mats: Sequence[torch.Tensor]) -> tuple:
    """The tree's launch arguments, in the kernels' order: the leaf row
    base pointers and their count, the range leaves, their stacks' row
    counts and their count, the opcodes and their count."""
    ptrs = []
    for m, r in code.leaves:
        mat = mats[m]
        ptrs.append(mat.data_ptr() + int(r) * mat.stride(0) * mat.element_size())
    leaf_arr = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    n_r = len(code.ranges)
    ranges, rows = _NO_RANGES
    if n_r:
        ranges = (RangeLeaf * n_r)(*[c_planes(mats[m], planes, kind, lo, hi)
                                     for m, kind, planes, lo, hi in code.ranges])
        rows = (ctypes.c_int * n_r)(*[mats[m].shape[0] for m, *_ in code.ranges])
    ops_arr = (ctypes.c_int * len(code.ops))(*code.ops)
    return leaf_arr, len(ptrs), ranges, rows, n_r, ops_arr, len(code.ops)


# The range arguments of a tree without range leaves (never read, never
# written: the kernels copy n_ranges = 0 entries).
_NO_RANGES = ((RangeLeaf * 1)(), (ctypes.c_int * 1)())


def check_stacks(mats: Sequence[torch.Tensor], n_shards: int) -> int:
    """Validate the field stacks a kernel reads; returns the row width."""
    words = None
    for mat in mats:
        if mat.dtype != torch.int32 or mat.dim() != 3 or not mat.is_contiguous():
            raise ValueError("field stacks must be contiguous int32[R, S, W]")
        if not mat.is_cuda:
            raise ValueError("field stacks must live on the card")
        if mat.shape[1] != n_shards:
            raise ValueError(
                f"stack shard axis {mat.shape[1]} != mask length {n_shards}"
            )
        if words is not None and mat.shape[2] != words:
            raise ValueError("field stacks disagree on the row width")
        words = mat.shape[2]
    return bitops.WORDS if words is None else int(words)


def _lib_fn(lib_name: str, fn_name: str, argtypes):
    """C entry ``fn_name`` of kernel library ``lib_name`` (built at first
    use), with its argument types set: every pointer and the stream as
    ``c_void_p``, so ctypes never cuts one to 32 bits."""
    from . import build

    fn = getattr(build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
# The argument types of a tree (_c_leaves), first in every kernel that takes one.
_TREE_ARGS = [_P, _I, _P, _P, _I, _P, _I]


def count_tree_dense(code: Postfix, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the card: returns a 0-d int64 tensor, without waiting
    for the device."""
    if not mask.is_cuda or mask.dtype != torch.int32 or mask.dim() != 1:
        raise ValueError("mask must be an int32[S] tensor on the card")
    mask = mask.contiguous()
    n_shards = mask.shape[0]
    words = check_stacks(mats, n_shards)
    for m, r in code.leaves:
        if not 0 <= r < mats[m].shape[0]:
            raise ValueError(f"leaf row {r} outside stack of {mats[m].shape[0]} rows")
    fn = _lib_fn("count_tree_dense", "count_tree_dense", _TREE_ARGS + [_P, _I, _I, _P, _P])
    out = torch.zeros(1, dtype=torch.int64, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = fn(*_c_leaves(code, mats), mask.data_ptr(), n_shards, words, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"count_tree_dense launch failed: cudaError {err}")
    count_tree_dense.launches += 1
    range_leaf(code)
    return out[0]


count_tree_dense.launches = 0


def range_leaf(code: Postfix) -> None:
    """Called by K1, K2 and K3 after a launch: ``range_leaf.launches``
    counts those whose tree holds a range leaf (csrc/tree_eval.cuh), the
    range leaf's own launch counter."""
    if code.ranges:
        range_leaf.launches += 1


range_leaf.launches = 0


def count_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """Count(tree) over the requested shards (``mask`` int32[S], nonzero =
    requested).  CUDA tensors launch K1 or raise; CPU tensors take the
    plain version."""
    code = compile_prog(prog)
    check_prog(code)
    if mask.is_cuda:
        return count_tree_dense(code, mats, mask)
    return count_tree_plain(prog, mats, mask)


# -- TopN scoring: K3 score_rows (and the trim in its last block) -----------
#
# The ports of pilosa_tpu/parallel/kernels.py:227 score_rows, :316
# topn_tree and :346 topn_full_tree, minus the mesh arguments.  Candidates
# are rows of a field stack ``cand_mat`` int32[R, S, W] named by
# ``cand_idx`` int32[K] (stack row indices; pad and absent slots name row
# 0 and are gated out by a zero ``cnt``); they are read by index and never
# gathered into a [K, S, W] copy.  Scores and src counts are int32, as in
# the reference; totals are int64 (the reference sums in int32; the two
# agree below 2^31).

def _src_plain(prog, mats, mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The masked src row stack int32[S, W] of a tree (zeros for a zero
    tree), in plain PyTorch ops."""
    row = None if prog[0] == "zero" else eval_prog(prog, mats, lambda words: words)
    if row is None:
        return torch.zeros(like.shape[1:], dtype=torch.int32, device=mask.device)
    return torch.where(mask[:, None] != 0, row, torch.zeros_like(row))


def _scores_plain(cand_mat: torch.Tensor, cand_idx, src: torch.Tensor) -> torch.Tensor:
    """int32[K, S] scores, one candidate at a time, so the int64 popcount
    temporaries stay the size of one [S, W] row stack."""
    rows = [int(r) for r in cand_idx]
    out = torch.zeros((len(rows), src.shape[0]), dtype=torch.int32, device=src.device)
    for k, r in enumerate(rows):
        out[k] = bitops.popcount_words(torch.bitwise_and(cand_mat[r], src)).sum(dim=-1)
    return out


def score_rows_plain(cands: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Per-candidate scores int32[K, S] of materialized candidates
    int32[K, S, W] against src int32[S, W] (fragment.go top :1089's
    intersection counts), in plain PyTorch ops."""
    return _scores_plain(cands, range(cands.shape[0]), src)


def topn_tree_plain(prog, mats, mask, cand_mat, cand_idx):
    """(scores int32[K, S], src_counts int32[S]) in plain PyTorch ops."""
    src = _src_plain(prog, mats, mask, cand_mat)
    counts = bitops.popcount_words(src).sum(dim=-1).to(torch.int32)
    return _scores_plain(cand_mat, cand_idx.tolist(), src), counts


def topn_trim_plain(totals: torch.Tensor, n_out: int):
    """The top ``n_out`` of ``totals`` int64[K] as (vals int32, idx int32),
    value descending and the lower index first on ties (jax.lax.top_k's
    order), by a plain stable descending sort.  K3's last block gives the
    same order by a bitonic sort of (total, index) keys."""
    order = torch.sort(totals, descending=True, stable=True).indices[:n_out]
    return totals[order].to(torch.int32), order.to(torch.int32)


def topn_full_tree_plain(prog, mats, mask, cand_mat, cand_idx, cnt, thr: int, n_out):
    """Gated totals int64[K] (row count and score both >= thr per shard,
    summed over shards), trimmed to (vals, idx) of length ``n_out`` unless
    ``n_out`` is None, in plain PyTorch ops."""
    src = _src_plain(prog, mats, mask, cand_mat)
    scores = _scores_plain(cand_mat, cand_idx.tolist(), src)
    gate = (cnt >= thr) & (scores >= thr)
    totals = torch.where(gate, scores, torch.zeros_like(scores)).sum(dim=1, dtype=torch.int64)
    if n_out is None:
        return totals
    return topn_trim_plain(totals, n_out)


_SCORE_ROWS_ARGS = _TREE_ARGS + [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P]

# K3 sums TopN's totals in a scratch of this many int64 (then its arrival
# counter), kept per (device, stream): the most candidates a full TopN
# takes (csrc/score_rows.cu kMaxCands, the engine's MAX_TOPN_CANDIDATES).
TOTALS_MAX = 4096
_totals_scratch: Dict[Tuple[int, int], torch.Tensor] = {}
_totals_lock = threading.Lock()


def _totals_scratch_for(device: torch.device, stream: int) -> torch.Tensor:
    """K3's totals scratch for one (device, stream), zeroed once; every
    launch leaves it at zero, and launches on one stream run one after
    another, so two launches never share one at the same time."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    with _totals_lock:
        buf = _totals_scratch.get(key)
        if buf is None:
            buf = _totals_scratch[key] = torch.zeros(TOTALS_MAX + 1, dtype=torch.int64,
                                                     device=device)
        return buf


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _on_card_int32(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    if not t.is_cuda or t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be an int32{list(shape)} tensor on the card")
    return t.contiguous()


def score_rows_cuda(code: Postfix, mats: Sequence[torch.Tensor],
                    mask: Optional[torch.Tensor], cand_mat: torch.Tensor,
                    cand_idx: Optional[torch.Tensor], *, scores: bool = True,
                    src_counts: bool = False, cnt: Optional[torch.Tensor] = None,
                    thr: int = 1, n_out: Optional[int] = None):
    """Launch K3 on the card, on the current stream, without waiting for
    the device.  Returns ``(scores int32[K, S] | None, src_counts int32[S]
    | None, result)``.  With ``cnt`` int32[K, S] (1 <= K <= TOTALS_MAX)
    the launch also gates and sums TopN's totals, and its last block
    writes ``result``: the totals int64[K] when ``n_out`` is None, else
    their top ``n_out`` (1 <= n_out <= K) as int32[2, n_out], values then
    candidate indices, value descending and the lower index first on
    ties (past 256 candidates the trim is a second launch of one block
    on the same stream).  ``mask`` None requests every shard,
    ``cand_idx`` None names stack rows 0..K-1."""
    if cand_mat.dtype != torch.int32 or cand_mat.dim() != 3 or not cand_mat.is_contiguous():
        raise ValueError("cand_mat must be a contiguous int32[R, S, W] tensor")
    if not cand_mat.is_cuda:
        raise ValueError("cand_mat must live on the card")
    R, S, W = cand_mat.shape
    K = R if cand_idx is None else cand_idx.shape[0]
    if mask is not None:
        mask = _on_card_int32(mask, "mask", (S,))
    if cand_idx is not None:
        cand_idx = _on_card_int32(cand_idx, "cand_idx", (K,))
    if cnt is not None:
        cnt = _on_card_int32(cnt, "cnt", (K, S))
        if not 1 <= K <= TOTALS_MAX or S < 1:
            raise ValueError(f"TopN totals take 1 <= K <= {TOTALS_MAX} candidates and "
                             f"at least one shard, got K={K}, S={S}")
        if n_out is not None and not 1 <= n_out <= K:
            raise ValueError(f"the trim takes 1 <= n_out <= K, got n_out={n_out}, K={K}")
    if check_stacks(mats, S) != W and mats:
        raise ValueError("src stacks and candidate stack disagree on the row width")
    for m, r in code.leaves:
        if not 0 <= r < mats[m].shape[0]:
            raise ValueError(f"leaf row {r} outside stack of {mats[m].shape[0]} rows")
    dev = cand_mat.device
    # The kernel stores every score and src count (zeros included); with
    # no candidates it does not run, and the src counts stay zero.
    out_scores = torch.empty((K, S), dtype=torch.int32, device=dev) if scores else None
    out_src = None
    if src_counts and K:
        out_src = torch.empty(S, dtype=torch.int32, device=dev)
    elif src_counts:
        out_src = torch.zeros(S, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = result = None
    if cnt is not None:
        # The last block writes every entry: no fill.
        scratch = _totals_scratch_for(dev, stream)
        result = (torch.empty(K, dtype=torch.int64, device=dev) if n_out is None
                  else torch.empty((2, n_out), dtype=torch.int32, device=dev))
    fn = _lib_fn("score_rows", "score_rows", _SCORE_ROWS_ARGS)
    err = fn(
        *_c_leaves(code, mats), _ptr(mask), cand_mat.data_ptr(), _ptr(cand_idx), K, S, W,
        _ptr(out_scores), _ptr(out_src), _ptr(cnt), int(thr), _ptr(scratch), n_out or 0,
        _ptr(result), stream,
    )
    if err != 0:
        raise RuntimeError(f"score_rows launch failed: cudaError {err}")
    score_rows_cuda.launches += 1
    if cnt is not None and n_out is not None:
        score_rows_cuda.trims += 1  # a call that trims its totals
    range_leaf(code)
    return out_scores, out_src, result


score_rows_cuda.launches = 0
score_rows_cuda.trims = 0


# P2 carries up to this many row indices in its launch parameters
# (csrc/and_popcount_rows.cu kMaxListed); a longer list goes up in one
# pinned, non-blocking copy.
P2_MAX_LISTED = 512


def and_popcount_rows_cuda(matrix: torch.Tensor, row: torch.Tensor,
                           rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Launch P2 on the card: int32[K] counts of popcount(matrix[rows[k]]
    & row), the rows read by index from ``matrix`` int32[R, W] (every row
    when ``rows`` is None), without waiting for the device."""
    if matrix.dtype != torch.int32 or matrix.dim() != 2 or not matrix.is_cuda:
        raise ValueError("matrix must be an int32[R, W] tensor on the card")
    R, W = matrix.shape
    matrix = matrix.contiguous()
    row = _on_card_int32(row, "row", (W,))
    dev = matrix.device
    listed = dev_rows = None
    K = R
    if rows is not None:
        listed = array.array("i", rows)  # the host list the launch copies
        K = len(listed)
        if K and (min(listed) < 0 or max(listed) >= R):
            raise ValueError(f"row index outside the matrix of {R} rows")
        if K > P2_MAX_LISTED:
            dev_rows = torch.frombuffer(listed, dtype=torch.int32).pin_memory().to(
                dev, non_blocking=True)
            listed = None
    out = torch.empty(K, dtype=torch.int32, device=dev)
    if K == 0:
        return out
    fn = _lib_fn("and_popcount_rows", "and_popcount_rows", [_P, _I, _P, _P, _P, _I, _I, _P, _P])
    err = fn(matrix.data_ptr(), R, row.data_ptr(), None if listed is None else listed.buffer_info()[0],
             _ptr(dev_rows), K, W, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"and_popcount_rows launch failed: cudaError {err}")
    and_popcount_rows_cuda.launches += 1
    return out


and_popcount_rows_cuda.launches = 0

def score_rows(cands: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """int32[K, S] scores of candidates int32[K, S, W] against src
    int32[S, W].  CUDA tensors launch K3 or raise; CPU tensors take the
    plain version."""
    if not src.is_cuda:
        return score_rows_plain(cands, src)
    src = src.contiguous()
    code = compile_prog(("row", 0, 0))
    scores, _, _ = score_rows_cuda(code, [src[None]], None, cands.contiguous(), None)
    return scores


def topn_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
              cand_mat: torch.Tensor, cand_idx: torch.Tensor):
    """TopN phase 1: (scores int32[K, S], src_counts int32[S]) of the
    candidates against the masked src tree.  CUDA tensors launch K3 or
    raise; CPU tensors take the plain version."""
    code = compile_prog(prog)
    check_prog(code)
    if mask.is_cuda:
        scores, counts, _ = score_rows_cuda(code, mats, mask, cand_mat, cand_idx,
                                            src_counts=True)
        return scores, counts
    return topn_tree_plain(prog, mats, mask, cand_mat, cand_idx)


def topn_full_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                   cand_mat: torch.Tensor, cand_idx: torch.Tensor,
                   cnt: torch.Tensor, thr: int, n_out: Optional[int]):
    """Full TopN: per-shard gates (row count >= thr and score >= thr),
    totals over shards, and their top ``n_out`` as int32[2, n_out] (values,
    then candidate indices) — or the int64[K] totals when ``n_out`` is
    None.  CUDA tensors launch K3 once (its last block trims), or raise;
    CPU tensors take the plain version."""
    code = compile_prog(prog)
    check_prog(code)
    if not mask.is_cuda:
        out = topn_full_tree_plain(prog, mats, mask, cand_mat, cand_idx, cnt, thr, n_out)
        return out if n_out is None else torch.stack(out)
    return score_rows_cuda(code, mats, mask, cand_mat, cand_idx, scores=False,
                           cnt=cnt, thr=thr, n_out=n_out)[2]


# -- K Counts in one launch: K5 count_batch_tree ------------------------------
#
# The port of pilosa_tpu/parallel/kernels.py:255 count_batch_tree.  A batch
# is K normalized trees over one list of field stacks, each with its own
# requested-shard mask.  ``compile_batch`` gives the batch ONE table of
# distinct leaf rows (a row read by several queries appears once), one
# postfix program per query whose leaf opcodes index that table, and one
# mask id per query into a table of distinct masks.  K5 reads each table
# row's words of a shard once per launch, whatever the number of queries
# that read it.  The reference pads batches to fixed tiers so that XLA
# compiles one program per (structure, tier); K5 takes its programs as
# data, so no batch is padded and an absent row is a ``("zero",)`` leaf.

# Queries per launch and distinct leaf rows per batch (csrc/count_batch_tree.cu
# kMaxQueries, kMaxLeaves); the engine splits a larger batch.
BATCH_MAX = 1024
MAX_BATCH_LEAVES = 4096


class BatchProgram:
    """A batch compiled for K5: ``leaves`` the distinct (mat_slot, row)
    leaf rows, ``qinfo`` int32[K, 4] (program offset, program length,
    mask id, chain form 0/1) and ``ops`` the concatenated postfix
    programs, whose leaf opcodes carry indices into ``leaves``."""

    __slots__ = ("leaves", "qinfo", "ops")

    def __init__(self, leaves, qinfo, ops):
        self.leaves = leaves
        self.qinfo = qinfo
        self.ops = ops


def _leaf_rows(prog, out: set) -> set:
    if prog[0] == "row":
        out.add((int(prog[1]), int(prog[2])))
    elif prog[0] not in ("zero", "range"):
        for p in prog[1:]:
            _leaf_rows(p, out)
    return out


def batch_groups(progs) -> List[Tuple[int, int]]:
    """Cut a batch into consecutive [start, end) groups of at most
    BATCH_MAX queries and MAX_BATCH_LEAVES distinct leaf rows each: one K5
    launch per group (one group unless a batch is past either limit)."""
    groups, start, seen = [], 0, set()
    for k, prog in enumerate(progs):
        rows = _leaf_rows(prog, set())
        if k > start and (k - start >= BATCH_MAX or len(seen | rows) > MAX_BATCH_LEAVES):
            groups.append((start, k))
            start, seen = k, set()
        seen |= rows
    groups.append((start, len(progs)))
    return groups


def _is_chain(ops: List[int]) -> bool:
    """The left-deep form ``item (item op)*`` (items: rows, zeros and
    range leaves) that K1 and K5 evaluate in registers (csrc/tree_eval.cuh
    is_chain)."""
    item = lambda code: (code & 0xFF) in _ITEM_OPS  # noqa: E731
    if not ops or len(ops) % 2 == 0 or not item(ops[0]):
        return False
    return all(item(ops[pc]) and not item(ops[pc + 1]) for pc in range(1, len(ops), 2))


def batchable(prog) -> bool:
    """True when K5 takes the tree: it stages leaf rows in shared memory
    and has no range leaf (ROADMAP.md Queue 2 item 18), so the engine
    sends a tree with one to K1 or K2 instead."""
    return not compile_prog(prog).ranges


def compile_batch(progs, mask_ids: Sequence[int]) -> BatchProgram:
    """Compile K normalized trees into one BatchProgram.  Raises
    ValueError when a query's program exceeds MAX_PROG or MAX_STACK, holds
    a range leaf (``batchable``), or the batch exceeds MAX_BATCH_LEAVES
    distinct leaf rows."""
    if len(progs) != len(mask_ids):
        raise ValueError("one mask id per query")
    table: Dict[Tuple[int, int], int] = {}
    qinfo = np.zeros((len(progs), 4), dtype=np.int32)
    ops: List[int] = []
    for k, prog in enumerate(progs):
        code = compile_prog(prog)
        if code.ranges:
            raise ValueError("K5 takes no range leaves: the engine sends such a tree to K1/K2")
        if code.depth > MAX_STACK or len(code.ops) > MAX_PROG:
            check_prog(Postfix(code.ops, [], code.depth))
        glob = [table.setdefault(leaf, len(table)) for leaf in code.leaves]
        qops = [OP_LEAF | (glob[c >> 8] << 8) if (c & 0xFF) == OP_LEAF else c
                for c in code.ops]
        qinfo[k] = (len(ops), len(qops), int(mask_ids[k]), int(code.chain))
        ops.extend(qops)
    if len(table) > MAX_BATCH_LEAVES:
        raise ValueError(f"count batch reads {len(table)} distinct leaf rows; "
                         f"K5 takes {MAX_BATCH_LEAVES}")
    return BatchProgram(list(table), qinfo, np.asarray(ops or [OP_ZERO], dtype=np.int32))


def count_batch_tree_plain(progs, mats: Sequence[torch.Tensor], masks: np.ndarray,
                           mask_ids: Sequence[int], device,
                           out_index: Optional[Sequence[int]] = None) -> torch.Tensor:
    """int64[K] masked popcounts of K trees, ``count_tree_plain`` per query
    (``masks`` bool[M, S] the distinct requested-shard masks, query k
    reading row ``mask_ids[k]``); with ``out_index`` the answers fanned out
    as ``result[out_index]``.  The CPU path and the reference K5 is held
    against."""
    dev_masks = torch.from_numpy(np.ascontiguousarray(masks, dtype=np.int32)).to(device)
    out = torch.zeros(len(progs), dtype=torch.int64, device=device)
    for k, prog in enumerate(progs):
        out[k] = count_tree_plain(prog, mats, dev_masks[int(mask_ids[k])])
    if out_index is not None:
        out = out[torch.as_tensor(np.asarray(out_index, dtype=np.int64), device=device)]
    return out


_BATCH_ARGS = [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P]
_batch_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _batch_scratch_for(device: torch.device, stream: int) -> torch.Tensor:
    """K5's totals scratch (BATCH_MAX int64, then its arrival counter) for
    one (device, stream), zeroed once; every launch leaves it at zero, and
    launches on one stream run one after another."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    with _totals_lock:
        buf = _batch_scratch.get(key)
        if buf is None:
            buf = _batch_scratch[key] = torch.zeros(BATCH_MAX + 1, dtype=torch.int64,
                                                    device=device)
        return buf


def mask_bits(masks: np.ndarray) -> np.ndarray:
    """K5's mask table: uint32[M, ceil(S / 32)] of bool[M, S] requested-
    shard masks, bit b of word w of row m set iff shard 32 * w + b of mask
    m is requested (at least one word per mask)."""
    M, S = masks.shape
    bits = np.zeros((M, max(1, -(-S // 32)) * 32), dtype=bool)
    bits[:, :S] = masks
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


def _pack(sections) -> Tuple[np.ndarray, List[int]]:
    """One byte buffer holding each numpy array of ``sections`` at a
    16-byte aligned offset; returns it and the offsets."""
    offs, n = [], 0
    for a in sections:
        offs.append(n)
        n += -(-a.nbytes // 16) * 16
    buf = np.zeros(max(n, 16), dtype=np.uint8)
    for a, o in zip(sections, offs):
        buf[o: o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    return buf, offs


def count_batch_tree_cuda(batch: BatchProgram, mats: Sequence[torch.Tensor],
                          masks: np.ndarray, device: torch.device,
                          out_index: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Launch K5 on the card, on the current stream, without waiting for
    the device: int64[K] (or int64[len(out_index)], answer i being query
    ``out_index[i]``'s).  The leaf row addresses, programs, masks (one bit
    per shard) and the fan-out travel in one pinned buffer, uploaded with
    one non-blocking copy.  PyTorch's caching host allocator keeps the
    pinned buffer until that copy has run, and its device allocator hands
    the device copy out again only to work queued after K5 on this stream,
    so neither is reused while the launch may still read it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("K5 runs on the card")
    K = batch.qinfo.shape[0]
    if not 1 <= K <= BATCH_MAX:
        raise ValueError(f"K5 takes 1 <= K <= {BATCH_MAX} queries, got {K}")
    masks = np.asarray(masks, dtype=bool)
    if masks.ndim != 2:
        raise ValueError("masks must be bool[M, S]")
    M, S = masks.shape
    if int(batch.qinfo[:, 2].min()) < 0 or int(batch.qinfo[:, 2].max()) >= M:
        raise ValueError("mask id outside the mask table")
    words = check_stacks(mats, S)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if any(mat.device.index != index for mat in mats):
        raise ValueError("field stacks and the launch disagree on the device")
    for m, r in batch.leaves:
        if not 0 <= r < mats[m].shape[0]:
            raise ValueError(f"leaf row {r} outside stack of {mats[m].shape[0]} rows")
    fan = None if out_index is None else np.asarray(out_index, dtype=np.int32)
    if fan is not None and fan.size and (int(fan.min()) < 0 or int(fan.max()) >= K):
        raise ValueError("out_index names a query outside the batch")
    k_out = K if fan is None else int(fan.size)
    out = torch.empty(k_out, dtype=torch.int64, device=device)
    if k_out == 0:
        return out
    ptrs = np.asarray([mats[m].data_ptr() + int(r) * mats[m].stride(0) * 4
                       for m, r in batch.leaves] or [0], dtype=np.uint64)
    sections = [ptrs, batch.qinfo, batch.ops, mask_bits(masks)]
    if fan is not None:
        sections.append(fan)
    buf, offs = _pack(sections)
    dev_buf = torch.from_numpy(buf).pin_memory().to(device, non_blocking=True)
    base = dev_buf.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = _lib_fn("count_batch_tree", "count_batch_tree", _BATCH_ARGS)
    err = fn(base + offs[0], len(batch.leaves), base + offs[1], K, base + offs[2],
             base + offs[3], None if fan is None else base + offs[4], k_out, S, words,
             _batch_scratch_for(device, stream).data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"count_batch_tree launch failed: cudaError {err}")
    count_batch_tree_cuda.launches += 1
    return out


count_batch_tree_cuda.launches = 0


def count_batch_tree(progs, mats: Sequence[torch.Tensor], masks: np.ndarray,
                     mask_ids: Sequence[int], device,
                     out_index: Optional[Sequence[int]] = None) -> torch.Tensor:
    """K Count(tree) queries in one launch: int64[K] of sum(popcount(tree_k
    & mask_k)), query k requesting the shards of ``masks[mask_ids[k]]``
    (``masks`` bool[M, S]); with ``out_index`` the answers fanned out as
    ``result[out_index]``.  On the card K5 launches or raises; on the CPU
    the plain version runs."""
    batch = compile_batch(progs, mask_ids)
    if torch.device(device).type == "cuda":
        return count_batch_tree_cuda(batch, mats, masks, device, out_index)
    return count_batch_tree_plain(progs, mats, masks, mask_ids, device, out_index)
