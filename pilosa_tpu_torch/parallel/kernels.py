"""Count(tree) over field stacks: K1 ``count_tree_dense`` and its plain twin.

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
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

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


def _lib_dense():
    from . import build

    lib = build.load("count_tree_dense")
    fn = lib.count_tree_dense
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


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
    fn = _lib_dense()
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
