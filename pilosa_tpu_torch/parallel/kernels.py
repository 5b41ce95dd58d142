"""Count(tree) and TopN scoring over field stacks: K1 ``count_tree_dense``,
K3 ``score_rows`` (with its P2 entry ``and_popcount_rows``) and K4
``topn_trim``, each beside its plain twin.

The engine lowers a PQL call tree to a normalized program over a list of
field stacks ``int32[R, S, WORDS]`` (rows major, the canonical shard axis
second, no padding):

- leaves ``("row", mat_slot, row)`` — row ``row`` of stack ``mats[mat_slot]``
  — and ``("zero",)``;
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
postfix program (``compile_prog``), shared with K2 in ``sparse.py``.

``topn_tree`` and ``topn_full_tree`` (TopN, below) take the same src tree
and wrap K3 ``csrc/score_rows.cu`` and K4 ``csrc/topn_trim.cu`` the same
way: a CUDA tensor launches or raises, a CPU tensor takes the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import bitops

# Postfix opcodes and limits: csrc/tree_eval.cuh holds the same values.
OP_LEAF, OP_ZERO, OP_AND, OP_OR, OP_ANDNOT, OP_XOR = range(6)
_NODE_OPS = {"and": OP_AND, "or": OP_OR, "andnot": OP_ANDNOT, "xor": OP_XOR}
MAX_PROG = 128
MAX_LEAVES = 32
MAX_STACK = 16


class Postfix:
    """A tree compiled for the kernels: opcodes, distinct leaves
    ``(mat_slot, row)`` in leaf-index order, and the stack depth."""

    __slots__ = ("ops", "leaves", "depth")

    def __init__(self, ops: List[int], leaves: List[Tuple[int, int]], depth: int):
        self.ops = ops
        self.leaves = leaves
        self.depth = depth


def compile_prog(prog) -> Postfix:
    """Postfix form of a normalized tree.  Raises ValueError on an unknown
    node or when the program exceeds the kernels' limits."""
    ops: List[int] = []
    leaf_of: Dict[Tuple[int, int], int] = {}

    def walk(p):
        kind = p[0]
        if kind == "row":
            key = (int(p[1]), int(p[2]))
            k = leaf_of.setdefault(key, len(leaf_of))
            ops.append(OP_LEAF | (k << 8))
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
        sp += 1 if (code & 0xFF) in (OP_LEAF, OP_ZERO) else -1
        depth = max(depth, sp)
    return Postfix(ops, list(leaf_of), depth)


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


def eval_prog(prog, mats: Sequence[torch.Tensor], select) -> torch.Tensor:
    """Evaluate a normalized tree with ``select(row_words)`` applied to
    every leaf row (the identity for the dense count, a block gather for
    the sparse one).  ``("zero",)`` takes the shape of the first leaf."""
    if prog[0] == "row":
        return select(mats[prog[1]][prog[2]])
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

def _c_leaves(code: Postfix, mats: Sequence[torch.Tensor]):
    """ctypes arrays of the leaf row base pointers and the opcodes."""
    ptrs = []
    for m, r in code.leaves:
        mat = mats[m]
        ptrs.append(mat.data_ptr() + int(r) * mat.stride(0) * mat.element_size())
    leaf_arr = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    ops_arr = (ctypes.c_int * len(code.ops))(*code.ops)
    return leaf_arr, ops_arr


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
    fn = _lib_fn("count_tree_dense", "count_tree_dense", [_P, _I, _P, _I, _P, _I, _I, _P, _P])
    out = torch.zeros(1, dtype=torch.int64, device=mask.device)
    leaf_arr, ops_arr = _c_leaves(code, mats)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = fn(
        leaf_arr, len(code.leaves), ops_arr, len(code.ops), mask.data_ptr(),
        n_shards, words, out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"count_tree_dense launch failed: cudaError {err}")
    count_tree_dense.launches += 1
    return out[0]


count_tree_dense.launches = 0


def count_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """Count(tree) over the requested shards (``mask`` int32[S], nonzero =
    requested).  CUDA tensors launch K1 or raise; CPU tensors take the
    plain version."""
    code = compile_prog(prog)
    check_prog(code)
    if mask.is_cuda:
        return count_tree_dense(code, mats, mask)
    return count_tree_plain(prog, mats, mask)


# -- TopN scoring: K3 score_rows and K4 topn_trim ----------------------------
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
    value descending and the lower index first on ties, by the same
    rank-by-counting as K4."""
    K = totals.shape[0]
    v = totals[:, None]  # candidate i, against every j along dim 1
    j = torch.arange(K, device=totals.device)
    before = (totals[None, :] > v) | ((totals[None, :] == v) & (j[None, :] < j[:, None]))
    rank = before.sum(dim=1)
    vals = torch.zeros(n_out, dtype=torch.int32, device=totals.device)
    idx = torch.zeros(n_out, dtype=torch.int32, device=totals.device)
    keep = rank < n_out
    vals[rank[keep]] = totals[keep].to(torch.int32)
    idx[rank[keep]] = j[keep].to(torch.int32)
    return vals, idx


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


_SCORE_ROWS_ARGS = [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P]


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
                    thr: int = 1):
    """Launch K3 on the card, without waiting for the device.  Returns
    ``(scores int32[K, S] | None, src_counts int32[S] | None, totals
    int64[K] | None)``; totals are computed when ``cnt`` int32[K, S] is
    given.  ``mask`` None requests every shard, ``cand_idx`` None names
    stack rows 0..K-1."""
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
    if check_stacks(mats, S) != W and mats:
        raise ValueError("src stacks and candidate stack disagree on the row width")
    for m, r in code.leaves:
        if not 0 <= r < mats[m].shape[0]:
            raise ValueError(f"leaf row {r} outside stack of {mats[m].shape[0]} rows")
    dev = cand_mat.device
    out_scores = torch.zeros((K, S), dtype=torch.int32, device=dev) if scores else None
    out_src = torch.zeros(S, dtype=torch.int32, device=dev) if src_counts else None
    totals = torch.zeros(K, dtype=torch.int64, device=dev) if cnt is not None else None
    fn = _lib_fn("score_rows", "score_rows", _SCORE_ROWS_ARGS)
    leaf_arr, ops_arr = _c_leaves(code, mats)
    err = fn(
        leaf_arr, len(code.leaves), ops_arr, len(code.ops), _ptr(mask),
        cand_mat.data_ptr(), _ptr(cand_idx), K, S, W, _ptr(out_scores),
        _ptr(out_src), _ptr(cnt), int(thr), _ptr(totals),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"score_rows launch failed: cudaError {err}")
    score_rows_cuda.launches += 1
    return out_scores, out_src, totals


score_rows_cuda.launches = 0


def and_popcount_rows_cuda(matrix: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Launch K3's P2 entry on the card: int32[R] counts of
    popcount(matrix[r] & row), without waiting for the device."""
    if matrix.dtype != torch.int32 or matrix.dim() != 2 or not matrix.is_cuda:
        raise ValueError("matrix must be an int32[R, W] tensor on the card")
    R, W = matrix.shape
    matrix = matrix.contiguous()
    row = _on_card_int32(row, "row", (W,))
    out = torch.zeros(R, dtype=torch.int32, device=matrix.device)
    fn = _lib_fn("score_rows", "and_popcount_rows", [_P, _P, _I, _I, _P, _P])
    err = fn(matrix.data_ptr(), row.data_ptr(), R, W, out.data_ptr(),
             torch.cuda.current_stream(matrix.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"and_popcount_rows launch failed: cudaError {err}")
    and_popcount_rows_cuda.launches += 1
    return out


and_popcount_rows_cuda.launches = 0

# K4 stages the totals in 32 KiB of shared memory: the most candidates it
# ranks (the engine's MAX_TOPN_CANDIDATES).
TRIM_MAX = 4096


def topn_trim_cuda(totals: torch.Tensor, n_out: int):
    """Launch K4 on the card: the top ``n_out`` of int64[K] totals as
    (vals int32, idx int32), without waiting for the device."""
    if not totals.is_cuda or totals.dtype != torch.int64 or totals.dim() != 1:
        raise ValueError("totals must be an int64[K] tensor on the card")
    K = totals.shape[0]
    if not 1 <= K <= TRIM_MAX or not 1 <= n_out <= K:
        raise ValueError(f"topn_trim takes 1 <= n_out <= K <= {TRIM_MAX}, got n_out={n_out}, K={K}")
    totals = totals.contiguous()
    vals = torch.empty(n_out, dtype=torch.int32, device=totals.device)
    idx = torch.empty(n_out, dtype=torch.int32, device=totals.device)
    fn = _lib_fn("topn_trim", "topn_trim", [_P, _I, _I, _P, _P, _P])
    err = fn(totals.data_ptr(), K, n_out, vals.data_ptr(), idx.data_ptr(),
             torch.cuda.current_stream(totals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topn_trim launch failed: cudaError {err}")
    topn_trim_cuda.launches += 1
    return vals, idx


topn_trim_cuda.launches = 0


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
    totals over shards, and the top ``n_out`` as (vals, idx) — or the
    int64[K] totals when ``n_out`` is None.  CUDA tensors launch K3 then
    K4, or raise; CPU tensors take the plain version."""
    code = compile_prog(prog)
    check_prog(code)
    if not mask.is_cuda:
        return topn_full_tree_plain(prog, mats, mask, cand_mat, cand_idx, cnt, thr, n_out)
    _, _, totals = score_rows_cuda(code, mats, mask, cand_mat, cand_idx,
                                   scores=False, cnt=cnt, thr=thr)
    if n_out is None:
        return totals
    return topn_trim_cuda(totals, n_out)
