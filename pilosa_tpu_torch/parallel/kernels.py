"""Count(tree) and TopN scoring over field stacks: K1 ``count_tree_dense``,
K1P ``count_tree_pool``, K3 ``score_rows`` (with TopN's trim in its last
block, or launched alone), P2 ``and_popcount_rows``, K5/K5P
``count_batch_tree``, F1/F1P ``fused_tree`` and K10 ``eval_tree``, each
beside its plain twin.

The engine lowers a PQL call tree to a normalized program over a list of
field stacks ``int32[R, S, WORDS]`` (rows major, the canonical shard axis
second, no padding):

- leaves ``("row", mat_slot, row)`` — row ``row`` of stack ``mats[mat_slot]``
  — and ``("zero",)``;
- pool leaves ``("rowb", pool_slot, table_slot, row)`` — a row of a partial
  stack's packed block pool ``mats[pool_slot]`` int32[P, S, 512] (slot 0
  all zero), its block layout row ``row`` of the slot table
  ``mats[table_slot]`` int32[n, 64]: block b of the row, in every shard, is
  pool slot ``table[row, b]`` (the reference's ``apply_prog`` ``rowb`` leaf,
  ``pilosa_tpu/parallel/kernels.py:84-97``).  The kernels read the pool in
  place through the slot vector (``csrc/tree_eval.cuh`` load_pool): a block
  in slot 0 reads as zero with no load, and no dense row is ever built;
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
``csrc/count_tree_dense.cu`` (K1) and raises if it cannot; a tree with a
pool leaf launches ``csrc/count_tree_pool.cu`` (K1P) instead, which reads
only the tree's live blocks (``live_blocks``).  For tensors on the CPU
each evaluates its plain PyTorch version.  Both enforce the same
program limits (``check_prog``).  The tree travels to the kernel as a
postfix program (``compile_prog``), shared with K2 in ``sparse.py``; a
range leaf carries its stack, plane rows and predicate bits by value
(``csrc/tree_eval.cuh`` RangeLeaf), so its planes take no entry of the
leaf table.

``topn_tree`` and ``topn_full_tree`` (TopN, below) take the same src tree
and wrap K3 ``csrc/score_rows.cu`` the same way: a CUDA tensor launches
or raises, a CPU tensor takes the plain version; a src tree with a pool
leaf launches K3P (``score_rows_pool`` in the same source), which reads
the src leaves and the candidate rows at the tree's live blocks only.  A
full TopN is one K3 launch: its last block ranks the totals and writes
the top n.  P2 ``csrc/and_popcount_rows.cu`` scores one fragment's rows,
named by index, against one src row (``bitops.popcount_and_rows``).
``topn_slab_tree`` (a cluster node's TopN phase 1) wraps K9
``csrc/topn_slab.cu`` the same way: the candidates' scores against the src
tree, then each shard's gated walk and top k_out in one CTA a shard.
``topn_trim`` launches K3's trim alone over totals the caller passes in
(a multi-process mesh's TopN, whose totals are summed across the ranks
between K3 and the trim).

``eval_tree`` (a Row-valued tree, below) wraps K10 ``csrc/eval_tree.cu``
the same way: the tree's words over the requested shards, written whole,
for the multi-process mesh's Row results.

``count_batch_tree`` (K Counts in one launch, below) compiles a batch of
trees into one table of distinct leaf rows and one postfix program per
query (``compile_batch``) and wraps K5 ``csrc/count_batch_tree.cu`` the
same way; a batch with a pool row launches K5P (``count_batch_tree_pool``
in the same source), which stages and evaluates only the blocks where
the rows its queries read can be non-zero.

``fused_tree`` (a whole dashboard of one index, below) evaluates a table
of mask slots, each a flat node over leaves and ``("mref", j)`` references
to earlier slots, counts the count edges and runs the aggregate edges on
the slots: F1 ``csrc/fused_tree.cu`` for the slots and counts, then K3,
K6, K7 and K8 with a slot as their filter row.  A table with a pool leaf
launches F1P (``fused_tree_pool`` in the same source), which walks only
its slots' live blocks and writes each materialized slot as a pool row,
so that the Sum, TopN, Min/Max and group edges take K6P, K3P, K7P and
K8P.
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
# OP_MREF, a reference to an earlier mask slot (its index in bits 8 and
# up), exists only inside a fused program (F1): check_prog refuses it.
# OP_ROWB, a row of a block pool, indexes the leaf table like OP_LEAF; its
# entry is (pool slot, slot-table row, slot-table slot).
OP_LEAF, OP_ZERO, OP_AND, OP_OR, OP_ANDNOT, OP_XOR, OP_RANGE, OP_MREF, OP_ROWB = range(9)
_NODE_OPS = {"and": OP_AND, "or": OP_OR, "andnot": OP_ANDNOT, "xor": OP_XOR}
_ITEM_OPS = (OP_LEAF, OP_ZERO, OP_RANGE, OP_MREF, OP_ROWB)
# A pool row's block layout: OCC_BLOCKS slots of OCC_BLOCK_WORDS words.
POOL_BLOCKS = bitops.OCC_BLOCKS
POOL_BLOCK_WORDS = bitops.OCC_BLOCK_WORDS
MAX_PROG = 128
MAX_LEAVES = 32
MAX_STACK = 16
MAX_RANGES = 4  # range leaves per tree
MAX_PLANES = 64  # BSI depth up to 63, then the not-null plane


class Postfix:
    """A tree compiled for the kernels: opcodes, distinct leaves
    ``(mat_slot, row)`` (a pool leaf ``(pool_slot, row, table_slot)``) in
    leaf-index order, distinct range leaves
    ``(mat_slot, kind, planes, lo, hi)`` in range-index order, the stack
    depth, whether the program has the chain form (``_is_chain``), and
    ``reads``/``pooled`` (``leaf_reads``).  Shared by every caller of
    ``compile_prog`` (it is cached): never mutated."""

    __slots__ = ("ops", "leaves", "ranges", "depth", "chain", "reads", "pooled")

    def __init__(self, ops: List[int], leaves: List[Tuple[int, int]], depth: int,
                 ranges: Optional[list] = None):
        self.ops = ops
        self.leaves = leaves
        self.ranges = ranges or []
        self.depth = depth
        self.chain = _is_chain(ops)
        self.reads, self.pooled = leaf_reads(self.leaves, self.ranges)


# The kinds of matrix a launch reads (leaf_reads, check_stacks).
_STACK, _POOL, _TABLE = range(3)


def leaf_reads(leaves, ranges=()) -> tuple:
    """What a leaf table reads, worked out once per compiled program so
    that a launch checks only that: the sorted (mat_slot, kind) pairs of
    its stacks, pools and slot tables, and whether a leaf is a pool leaf."""
    reads = set()
    for leaf in leaves:
        if len(leaf) == 3:
            reads.update(((leaf[0], _POOL), (leaf[2], _TABLE)))
        else:
            reads.add((leaf[0], _STACK))
    reads.update((r[0], _STACK) for r in ranges)
    return tuple(sorted(reads)), any(len(leaf) == 3 for leaf in leaves)


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
        elif kind == "rowb" and len(p) == 4:
            key = (int(p[1]), int(p[3]), int(p[2]))
            k = leaf_of.setdefault(key, len(leaf_of))
            ops.append(OP_ROWB | (k << 8))
        elif kind == "range" and len(p) == 6 and p[1] in bsi_ops.RANGE_KINDS:
            key = (int(p[2]), p[1], tuple(int(x) for x in p[3]), int(p[4]), int(p[5]))
            k = range_of.setdefault(key, len(range_of))
            ops.append(OP_RANGE | (k << 8))
        elif kind == "zero":
            ops.append(OP_ZERO)
        elif kind == "mref" and len(p) == 2:
            ops.append(OP_MREF | (int(p[1]) << 8))
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
    fixed stack, program and leaf-table sizes, or holds a slot reference
    (only a fused program has slots)."""
    if any((op & 0xFF) == OP_MREF for op in code.ops):
        raise ValueError("a slot reference (mref) runs only inside a fused program")
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


def pool_row(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """A row int32[S, POOL_BLOCKS * POOL_BLOCK_WORDS] of block pool ``pool``
    int32[P, S, POOL_BLOCK_WORDS] with slot vector ``slots`` int32[64]: the
    gather ``pool[slots]`` [64, S, 512], blocks then made the row's words
    (the reference's ``jnp.take`` and transpose).  The plain version of the
    pool leaf; slot 0 must be all zero."""
    blocks = pool[slots.long()]
    return blocks.permute(1, 0, 2).reshape(pool.shape[1], -1)


def eval_prog(prog, mats: Sequence[torch.Tensor], select, slots=None,
              blocks=None) -> torch.Tensor:
    """Evaluate a normalized tree with ``select(row_words)`` applied to
    every leaf row (the identity for the dense count, a block gather for
    the sparse one) and to every plane a range leaf reads.  ``("zero",)``
    takes the shape of the first leaf.  ``("mref", j)`` reads ``slots[j]``,
    an evaluated mask slot of a fused program (``fused_slots_plain``).
    With ``blocks`` (block indices, ``select`` then the same restriction
    of a row's words), a pool row is gathered from those blocks' slots
    only."""
    if prog[0] == "row":
        return select(mats[prog[1]][prog[2]])
    if prog[0] == "rowb":
        slots_of = mats[prog[2]][prog[3]]
        if blocks is not None:
            return pool_row(mats[prog[1]], slots_of[blocks])
        return select(pool_row(mats[prog[1]], slots_of))
    if prog[0] == "mref":
        return slots[prog[1]]
    if prog[0] == "range":
        _, kind, slot, planes, lo, hi = prog
        return bsi_ops.range_rows(kind, range_planes(mats[slot], planes, select), lo, hi)
    subs = [
        None if p[0] == "zero" else eval_prog(p, mats, select, slots, blocks) for p in prog[1:]
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


def live_blocks(prog, mats: Sequence[torch.Tensor], device, slots=None) -> torch.Tensor:
    """The tree's live word as bool[POOL_BLOCKS]: block b is live where
    the tree's words can be non-zero in some shard.  A pool leaf is live
    where its slot is not 0 (the same slot in every shard), a stack row or
    range leaf everywhere, zero nowhere; ``and`` intersects, ``or`` and
    ``xor`` unite, ``andnot`` keeps its left side (K1P's prologue,
    csrc/count_tree_pool.cu).  In a fused slot ``("mref", j)`` is live
    where slot j is (``slots[j]``, its word), and an ``xor`` unites only
    the slots it names an odd number of times, as ``compile_fused`` keeps
    them (F1P's prologue, csrc/tree_eval.cuh slots_live)."""
    kind = prog[0]
    if kind == "rowb":
        return mats[prog[2]][prog[3]] != 0
    if kind in ("row", "range"):
        return torch.ones(POOL_BLOCKS, dtype=torch.bool, device=device)
    if kind == "zero":
        return torch.zeros(POOL_BLOCKS, dtype=torch.bool, device=device)
    if kind == "mref":
        return slots[prog[1]]
    kids = prog[1:]
    if kind == "xor":
        kids = [p for p in kids if p[0] != "mref" or kids.count(p) % 2]
    live = torch.zeros(POOL_BLOCKS, dtype=torch.bool, device=device) if not kids else \
        live_blocks(kids[0], mats, device, slots)
    for p in kids[1:]:
        if kind == "and":
            live = live & live_blocks(p, mats, device, slots)
        elif kind != "andnot":
            live = live | live_blocks(p, mats, device, slots)
    return live


def live_select(prog, mats, device):
    """The tree's live blocks (``live_blocks``) as an index tensor, and
    the restriction of a row's words int32[S, W] to them, int32[S,
    n_live * POOL_BLOCK_WORDS]."""
    idx = torch.nonzero(live_blocks(prog, mats, device)).flatten()

    def select(words):
        return words.reshape(words.shape[0], POOL_BLOCKS, POOL_BLOCK_WORDS)[:, idx].reshape(
            words.shape[0], -1)

    return idx, select


def count_tree_pool_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """K1P's plain version: the live word from the slot table
    (``live_blocks``), then the masked popcount of the tree over the live
    blocks of each leaf only (a pool row gathered from those slots).
    Equal to ``count_tree_plain`` for every tree over full-width rows."""
    idx, select = live_select(prog, mats, mask.device)
    if idx.numel() == 0:  # a zero tree too: nothing is read
        return torch.zeros((), dtype=torch.int64, device=mask.device)
    # A non-empty live word means the tree is not made of zero leaves
    # alone, so eval_prog returns words here, never None.
    row = eval_prog(prog, mats, select, blocks=idx)
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


def leaf_pointers(leaves, mats: Sequence[torch.Tensor]) -> list:
    """The leaf table's device addresses, as csrc/tree_eval.cuh pack_args
    takes them: each leaf's base (a stack row's [S, W] words, or a pool's
    slot 0), then each leaf's slot vector (a row of the slot table; 0 for
    a stack row)."""
    bases, slots = [], []
    for leaf in leaves:
        mat = mats[leaf[0]]
        if len(leaf) == 3:
            table = mats[leaf[2]]
            bases.append(mat.data_ptr())
            slots.append(table.data_ptr() + int(leaf[1]) * table.stride(0) * 4)
        else:
            bases.append(mat.data_ptr() + int(leaf[1]) * mat.stride(0) * mat.element_size())
            slots.append(0)
    return bases + slots


def _c_table(leaves, ranges, mats: Sequence[torch.Tensor]) -> tuple:
    """A leaf table's launch arguments: the leaf pointers
    (``leaf_pointers``) and the leaf count, the range leaves, their stacks'
    row counts and their count."""
    ptrs = [p or None for p in leaf_pointers(leaves, mats)]
    leaf_arr = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    n_r = len(ranges)
    range_arr, rows = _NO_RANGES
    if n_r:
        range_arr = (RangeLeaf * n_r)(*[c_planes(mats[m], planes, kind, lo, hi)
                                        for m, kind, planes, lo, hi in ranges])
        rows = (ctypes.c_int * n_r)(*[mats[m].shape[0] for m, *_ in ranges])
    return leaf_arr, len(leaves), range_arr, rows, n_r


def _c_leaves(code: Postfix, mats: Sequence[torch.Tensor]) -> tuple:
    """The tree's launch arguments, in the kernels' order: the leaf table
    (``_c_table``), the opcodes and their count."""
    ops_arr = (ctypes.c_int * len(code.ops))(*code.ops)
    return _c_table(code.leaves, code.ranges, mats) + (ops_arr, len(code.ops))


# The range arguments of a tree without range leaves (never read, never
# written: the kernels copy n_ranges = 0 entries).
_NO_RANGES = ((RangeLeaf * 1)(), (ctypes.c_int * 1)())


def check_stacks(mats: Sequence[torch.Tensor], n_shards: int, code=None, extra=()) -> int:
    """Validate what a kernel reads of ``mats``: the stacks, pools and slot
    tables that ``code``'s leaves and range leaves name (``code.reads``),
    and the stacks at the positions ``extra`` (a BSI stack's planes,
    GroupBy's fields, TopN's candidates); a matrix no leaf names is never
    read.  Stacks are contiguous int32[R, S, W] with one W; a pool leaf's
    pool is int32[P, S, POOL_BLOCK_WORDS] and its table int32[n,
    POOL_BLOCKS], and the row width is then the full WORDS.  Every leaf's
    row must lie in its stack (or its table).  Returns the row width."""
    leaves, reads = ((), ()) if code is None else (code.leaves, code.reads)
    if extra:
        reads = sorted(set(reads).union((i, _STACK) for i in extra))
    words = None
    for i, kind in reads:
        mat = mats[i]
        if not mat.is_cuda:
            raise ValueError("field stacks must live on the card")
        if kind == _TABLE:
            if (mat.dtype != torch.int32 or mat.dim() != 2 or mat.shape[1] != POOL_BLOCKS
                    or not mat.is_contiguous()):
                raise ValueError(f"slot tables must be contiguous int32[n, {POOL_BLOCKS}]")
            continue
        if mat.dtype != torch.int32 or mat.dim() != 3 or not mat.is_contiguous():
            raise ValueError("field stacks must be contiguous int32[R, S, W]")
        if mat.shape[1] != n_shards:
            raise ValueError(
                f"stack shard axis {mat.shape[1]} != mask length {n_shards}"
            )
        if kind == _POOL:
            if mat.shape[2] != POOL_BLOCK_WORDS or mat.shape[0] < 1:
                raise ValueError(f"block pools must be int32[P >= 1, S, {POOL_BLOCK_WORDS}]")
            continue
        if words is not None and mat.shape[2] != words:
            raise ValueError("field stacks disagree on the row width")
        words = mat.shape[2]
    if code is not None and code.pooled and words not in (None, bitops.WORDS):
        raise ValueError(f"pool rows are {bitops.WORDS} words wide; the stacks are {words}")
    for leaf in leaves:
        n = mats[leaf[2] if len(leaf) == 3 else leaf[0]].shape[0]
        if not 0 <= leaf[1] < n:
            raise ValueError(f"leaf row {leaf[1]} outside stack of {n} rows")
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


def _count_launch(name: str, code: Postfix, mats: Sequence[torch.Tensor],
                  mask: torch.Tensor) -> torch.Tensor:
    """Launch K1 or K1P (kernel library ``name``, the same C arguments) on
    the card: returns a 0-d int64 tensor, without waiting for the device."""
    if not mask.is_cuda or mask.dtype != torch.int32 or mask.dim() != 1:
        raise ValueError("mask must be an int32[S] tensor on the card")
    mask = mask.contiguous()
    n_shards = mask.shape[0]
    words = check_stacks(mats, n_shards, code)
    fn = _lib_fn(name, name, _TREE_ARGS + [_P, _I, _I, _P, _P])
    out = torch.zeros(1, dtype=torch.int64, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = fn(*_c_leaves(code, mats), mask.data_ptr(), n_shards, words, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    range_leaf(code)
    pool_leaf(code, name)
    return out[0]


def count_tree_dense(code: Postfix, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the card: returns a 0-d int64 tensor, without waiting
    for the device."""
    out = _count_launch("count_tree_dense", code, mats, mask)
    count_tree_dense.launches += 1
    return out


count_tree_dense.launches = 0


def count_tree_pool(code: Postfix, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """Launch K1P (``csrc/count_tree_pool.cu``) on the card: Count(tree)
    over only the tree's live blocks (``live_blocks``), for a tree with
    pool leaves; any tree over full-width rows gives K1's answer.  Returns
    a 0-d int64 tensor, without waiting for the device."""
    out = _count_launch("count_tree_pool", code, mats, mask)
    count_tree_pool.launches += 1
    return out


count_tree_pool.launches = 0


def range_leaf(code) -> None:
    """Called by K1, K1P, K2, K3, K3P, K5 and K5P after a launch:
    ``range_leaf.launches`` counts those whose tree (or batch) holds a
    range leaf (csrc/tree_eval.cuh), the range leaf's own launch counter."""
    if len(code.ranges):
        range_leaf.launches += 1


range_leaf.launches = 0


def pool_leaf(code, kernel: str) -> None:
    """Called by every kernel wrapper whose launch may carry pool leaves
    (K1, K1P, K2, K3, K3P, K5, K5P, K6, K6P, K7, K7P, K8, K8P, F1, F1P, K9 and K10)
    after it launched (K3P under "score_rows", K6P under "sum_tree", K7P
    under "minmax_tree", K8P under "groupn_tree", K5P under
    "count_batch_tree", F1P under "fused_tree"):
    ``pool_leaf.launches`` counts the launches that read a block pool
    (csrc/tree_eval.cuh load_pool, or K5's staging), ``pool_leaf.by_kernel``
    them per kernel."""
    if code.pooled:
        pool_leaf.launches += 1
        pool_leaf.by_kernel[kernel] = pool_leaf.by_kernel.get(kernel, 0) + 1


pool_leaf.launches = 0
pool_leaf.by_kernel = {}


def count_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """Count(tree) over the requested shards (``mask`` int32[S], nonzero =
    requested).  CUDA tensors launch K1P for a tree with a pool leaf and
    K1 for any other, or raise; CPU tensors take the matching plain
    version."""
    code = compile_prog(prog)
    check_prog(code)
    if mask.is_cuda:
        return (count_tree_pool if code.pooled else count_tree_dense)(code, mats, mask)
    return (count_tree_pool_plain if code.pooled else count_tree_plain)(prog, mats, mask)



# -- The masked tree words: K10 eval_tree ---------------------------------------
#
# The port of pilosa_tpu/parallel/kernels.py:284 eval_tree: the tree's words
# over the requested shards (a Row() query's bitmap), no reduction.  On a
# multi-process mesh each rank evaluates its block and
# ``multihost.all_gather_shards`` replicates the words (:297
# eval_tree_replicated).


def eval_tree_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """The masked words int32[S, W] of a tree, in plain PyTorch ops
    (``filter_plain`` with the tree required): the CPU path and the
    reference the card's kernel is held against.  A tree that is zero
    whole gives WORDS zeros a shard."""
    like = torch.empty((mask.shape[0], bitops.WORDS), dtype=torch.int32, device=mask.device)
    return filter_plain(prog, mats, mask, like)


def eval_tree_cuda(code: Postfix, mats: Sequence[torch.Tensor],
                   mask: torch.Tensor) -> torch.Tensor:
    """Launch K10 (``csrc/eval_tree.cu``) on the card: the masked words
    int32[S, W], every word written, without waiting for the device."""
    if not mask.is_cuda or mask.dtype != torch.int32 or mask.dim() != 1:
        raise ValueError("mask must be an int32[S] tensor on the card")
    mask = mask.contiguous()
    n_shards = mask.shape[0]
    words = check_stacks(mats, n_shards, code)
    fn = _lib_fn("eval_tree", "eval_tree", _TREE_ARGS + [_P, _I, _I, _P, _P])
    out = torch.empty((n_shards, words), dtype=torch.int32, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = fn(*_c_leaves(code, mats), mask.data_ptr(), n_shards, words, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"eval_tree launch failed: cudaError {err}")
    range_leaf(code)
    pool_leaf(code, "eval_tree")
    eval_tree_cuda.launches += 1
    return out


eval_tree_cuda.launches = 0


def eval_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """The masked words int32[S, W] of a tree over the requested shards
    (``mask`` int32[S], nonzero = requested; the other shards' words are
    zero).  CUDA tensors launch K10 or raise; CPU tensors take the plain
    version."""
    code = compile_prog(prog)
    check_prog(code)
    if mask.is_cuda:
        return eval_tree_cuda(code, mats, mask)
    return eval_tree_plain(prog, mats, mask)


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


def _scores_plain(cand_mat: torch.Tensor, cand_idx, src: torch.Tensor,
                  select=lambda words: words) -> torch.Tensor:
    """int32[K, S] scores, one candidate at a time, so the int64 popcount
    temporaries stay the size of one [S, W] row stack; ``select`` restricts
    a candidate row to the words ``src`` holds (K3P's live blocks)."""
    rows = [int(r) for r in cand_idx]
    out = torch.zeros((len(rows), src.shape[0]), dtype=torch.int32, device=src.device)
    for k, r in enumerate(rows):
        out[k] = bitops.popcount_words(torch.bitwise_and(select(cand_mat[r]), src)).sum(dim=-1)
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


def _src_pool_plain(prog, mats, mask, cand_mat):
    """K3P's plain src: the masked src tree over its live blocks only
    int32[S, n_live * POOL_BLOCK_WORDS] (a pool row gathered from those
    slots), and the restriction that reads a candidate row there."""
    idx, select = live_select(prog, mats, mask.device)
    S = cand_mat.shape[1]
    if idx.numel() == 0:  # a zero tree too: no leaf is read
        return torch.zeros((S, 0), dtype=torch.int32, device=mask.device), select
    # A non-empty live word means the tree is not made of zero leaves
    # alone, so eval_prog returns words here, never None.
    row = eval_prog(prog, mats, select, blocks=idx)
    return torch.where(mask[:, None] != 0, row, torch.zeros_like(row)), select


def topn_tree_pool_plain(prog, mats, mask, cand_mat, cand_idx):
    """K3P's plain version of phase 1: (scores int32[K, S], src_counts
    int32[S]) from the src tree's live blocks alone (``live_blocks``),
    each candidate row read there only.  Equal to ``topn_tree_plain`` for
    every tree over full-width rows."""
    src, select = _src_pool_plain(prog, mats, mask, cand_mat)
    counts = bitops.popcount_words(src).sum(dim=-1).to(torch.int32)
    return _scores_plain(cand_mat, cand_idx.tolist(), src, select), counts


def topn_trim_plain(totals: torch.Tensor, n_out: int):
    """The top ``n_out`` of ``totals`` int64[K] as (vals int32, idx int32),
    value descending and the lower index first on ties (jax.lax.top_k's
    order), by a plain stable descending sort.  K3's last block gives the
    same order by a bitonic sort of (total, index) keys."""
    order = torch.sort(totals, descending=True, stable=True).indices[:n_out]
    return totals[order].to(torch.int32), order.to(torch.int32)


def _gated_totals(scores, cnt, thr, n_out):
    gate = (cnt >= thr) & (scores >= thr)
    totals = torch.where(gate, scores, torch.zeros_like(scores)).sum(dim=1, dtype=torch.int64)
    if n_out is None:
        return totals
    return topn_trim_plain(totals, n_out)


def topn_full_tree_plain(prog, mats, mask, cand_mat, cand_idx, cnt, thr: int, n_out):
    """Gated totals int64[K] (row count and score both >= thr per shard,
    summed over shards), trimmed to (vals, idx) of length ``n_out`` unless
    ``n_out`` is None, in plain PyTorch ops."""
    src = _src_plain(prog, mats, mask, cand_mat)
    return _gated_totals(_scores_plain(cand_mat, cand_idx.tolist(), src), cnt, thr, n_out)


def topn_full_tree_pool_plain(prog, mats, mask, cand_mat, cand_idx, cnt, thr: int, n_out):
    """K3P's plain version of the full TopN: ``topn_full_tree_plain``'s
    gated totals and trim over the scores of ``topn_tree_pool_plain``."""
    src, select = _src_pool_plain(prog, mats, mask, cand_mat)
    return _gated_totals(_scores_plain(cand_mat, cand_idx.tolist(), src, select), cnt, thr, n_out)


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


def _score_rows_launch(entry: str, code: Postfix, mats: Sequence[torch.Tensor],
                       mask: Optional[torch.Tensor], cand_mat: torch.Tensor,
                       cand_idx: Optional[torch.Tensor], scores: bool, src_counts: bool,
                       cnt: Optional[torch.Tensor], thr: int, n_out: Optional[int]):
    """Launch K3 or K3P (C entry ``entry`` of the score_rows library, the
    same arguments): score_rows_cuda's checks, outputs and result."""
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
    check_stacks(list(mats) + [cand_mat], S, code, extra=(len(mats),))
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
    fn = _lib_fn("score_rows", entry, _SCORE_ROWS_ARGS)
    err = fn(
        *_c_leaves(code, mats), _ptr(mask), cand_mat.data_ptr(), _ptr(cand_idx), K, S, W,
        _ptr(out_scores), _ptr(out_src), _ptr(cnt), int(thr), _ptr(scratch), n_out or 0,
        _ptr(result), stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    range_leaf(code)
    pool_leaf(code, "score_rows")
    return out_scores, out_src, result


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
    out = _score_rows_launch("score_rows", code, mats, mask, cand_mat, cand_idx, scores,
                             src_counts, cnt, thr, n_out)
    score_rows_cuda.launches += 1
    if cnt is not None and n_out is not None:
        score_rows_cuda.trims += 1  # a call that trims its totals
    return out


score_rows_cuda.launches = 0
score_rows_cuda.trims = 0


def score_rows_pool_cuda(code: Postfix, mats: Sequence[torch.Tensor],
                         mask: Optional[torch.Tensor], cand_mat: torch.Tensor,
                         cand_idx: Optional[torch.Tensor], *, scores: bool = True,
                         src_counts: bool = False, cnt: Optional[torch.Tensor] = None,
                         thr: int = 1, n_out: Optional[int] = None):
    """Launch K3P (``csrc/score_rows.cu`` score_rows_pool) on the card:
    ``score_rows_cuda``'s arguments and outputs, for a src tree with pool
    leaves, reading the src leaves and the candidate rows at the tree's
    live blocks only (``live_blocks``); any tree over full-width rows
    gives K3's answer.  Rows are the full WORDS wide."""
    out = _score_rows_launch("score_rows_pool", code, mats, mask, cand_mat, cand_idx, scores,
                             src_counts, cnt, thr, n_out)
    score_rows_pool_cuda.launches += 1
    if cnt is not None and n_out is not None:
        score_rows_pool_cuda.trims += 1
    return out


score_rows_pool_cuda.launches = 0
score_rows_pool_cuda.trims = 0


# P2 carries up to this many row indices in its launch parameters
# (csrc/and_popcount_rows.cu kMaxListed); a longer list goes up in one
# pinned, non-blocking copy.
P2_MAX_LISTED = 512


def score_rows_trim_cuda(totals: torch.Tensor, n_out: int) -> torch.Tensor:
    """K3's trim alone (``csrc/score_rows.cu`` score_rows_trim, one block of
    ``score_rows_trim_kernel``) over totals the caller passes in, int64[K]
    on the card (1 <= K <= TOTALS_MAX): their top ``n_out`` as int32[2,
    n_out], values then candidate indices, value descending and the lower
    index first on ties, without waiting for the device.  The kernel
    zeroes what it reads, so it runs on a copy."""
    if not totals.is_cuda or totals.dtype != torch.int64 or totals.dim() != 1:
        raise ValueError("totals must be an int64[K] tensor on the card")
    K = totals.shape[0]
    if not 1 <= K <= TOTALS_MAX or not 1 <= n_out <= K:
        raise ValueError(f"the trim takes 1 <= n_out <= K <= {TOTALS_MAX}, "
                         f"got n_out={n_out}, K={K}")
    work = totals.clone()
    out = torch.empty((2, n_out), dtype=torch.int32, device=totals.device)
    fn = _lib_fn("score_rows", "score_rows_trim", [_P, _I, _I, _P, _P])
    err = fn(work.data_ptr(), K, int(n_out), out.data_ptr(),
             torch.cuda.current_stream(totals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_rows_trim launch failed: cudaError {err}")
    score_rows_trim_cuda.launches += 1
    return out


score_rows_trim_cuda.launches = 0


def topn_trim(totals: torch.Tensor, n_out: int) -> torch.Tensor:
    """The top ``n_out`` of totals int64[K] as int32[2, n_out] (values, then
    candidate indices; jax.lax.top_k's order).  CUDA tensors launch K3's
    trim alone or raise; CPU tensors take ``topn_trim_plain``."""
    if totals.is_cuda:
        return score_rows_trim_cuda(totals, n_out)
    return torch.stack(topn_trim_plain(totals, n_out))


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
    candidates against the masked src tree.  CUDA tensors launch K3P for
    a src tree with a pool leaf and K3 for any other, or raise; CPU
    tensors take the matching plain version."""
    code = compile_prog(prog)
    check_prog(code)
    if mask.is_cuda:
        launch = score_rows_pool_cuda if code.pooled else score_rows_cuda
        scores, counts, _ = launch(code, mats, mask, cand_mat, cand_idx, src_counts=True)
        return scores, counts
    plain = topn_tree_pool_plain if code.pooled else topn_tree_plain
    return plain(prog, mats, mask, cand_mat, cand_idx)


def topn_full_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                   cand_mat: torch.Tensor, cand_idx: torch.Tensor,
                   cnt: torch.Tensor, thr: int, n_out: Optional[int]):
    """Full TopN: per-shard gates (row count >= thr and score >= thr),
    totals over shards, and their top ``n_out`` as int32[2, n_out] (values,
    then candidate indices) — or the int64[K] totals when ``n_out`` is
    None.  CUDA tensors launch K3 once (its last block trims), K3P for a
    src tree with a pool leaf, or raise; CPU tensors take the matching
    plain version."""
    code = compile_prog(prog)
    check_prog(code)
    if not mask.is_cuda:
        plain = topn_full_tree_pool_plain if code.pooled else topn_full_tree_plain
        out = plain(prog, mats, mask, cand_mat, cand_idx, cnt, thr, n_out)
        return out if n_out is None else torch.stack(out)
    launch = score_rows_pool_cuda if code.pooled else score_rows_cuda
    return launch(code, mats, mask, cand_mat, cand_idx, scores=False, cnt=cnt, thr=thr,
                  n_out=n_out)[2]


# -- TopN's per-shard slab: K9 topn_slab ---------------------------------------
#
# The port of pilosa_tpu/parallel/kernels.py:396 topn_slab_tree: for each
# shard, fragment.top's heap walk in closed form (csrc/topn_slab.cu's
# comment), so a cluster node returns at most k_out pairs a shard.

SLAB_MAX = 4096  # K_pad at most (csrc/topn_slab.cu kMaxCands)


def slab_select_plain(scores: torch.Tensor, cnt: torch.Tensor, thr: int, n_sel: int,
                      k_out: int):
    """The selection of ``topn_slab_tree`` from scores and cache counts
    int32[K, S]: (vals int32[S, k_out], idx int32[S, k_out], qual int32[S]),
    in plain PyTorch ops.  The walk is a stable sort of -cnt, and the slab a
    stable descending sort, so ties go to the lower candidate position
    (jax.lax.top_k's order) without relying on torch.topk's tie order."""
    scores = scores.to(torch.int64)
    cnt = cnt.to(torch.int64)
    g = torch.where((cnt >= thr) & (scores >= thr), scores, torch.zeros_like(scores))
    order = torch.sort(-cnt, dim=0, stable=True).indices
    g_ord = torch.gather(g, 0, order)
    q = g_ord > 0
    nq = q.sum(dim=0)
    if n_sel:
        c = torch.cumsum(q.to(torch.int64), dim=0)
        a = torch.where(q & (c <= n_sel), g_ord, torch.full_like(g_ord, 2**31 - 1))
        t = torch.where(nq >= n_sel, a.min(dim=0).values, torch.full_like(nq, thr))
    else:
        t = torch.full_like(nq, thr)
    keep = (g > 0) & (g >= t[None, :])
    qual = keep.sum(dim=0).to(torch.int32)
    kept = torch.where(keep, g, torch.zeros_like(g)).T
    top = torch.sort(kept, dim=1, descending=True, stable=True)
    vals = top.values[:, :k_out].to(torch.int32)
    idx = top.indices[:, :k_out].to(torch.int32)
    return vals, idx, qual


def topn_slab_tree_plain(prog, mats, mask, cand_mat, cand_idx, cnt, thr: int, n_sel: int,
                         k_out: int):
    """K9's plain version: the candidates' scores against the masked src
    tree (the SWAR popcount, one candidate at a time; a src tree with a
    pool leaf read at its live blocks), then ``slab_select_plain``."""
    if compile_prog(prog).pooled:
        src, select = _src_pool_plain(prog, mats, mask, cand_mat)
    else:
        src, select = _src_plain(prog, mats, mask, cand_mat), (lambda words: words)
    scores = _scores_plain(cand_mat, cand_idx.tolist(), src, select)
    return slab_select_plain(scores, cnt, thr, n_sel, k_out)


_TOPN_SLAB_ARGS = _TREE_ARGS + [_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P]


def topn_slab_cuda(code: Postfix, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                   cand_mat: torch.Tensor, cand_idx: torch.Tensor, cnt: torch.Tensor,
                   thr: int, n_sel: int, k_out: int):
    """Launch K9 (``csrc/topn_slab.cu``) on the card, on the current
    stream, without waiting for the device: (vals int32[S, k_out], idx
    int32[S, k_out], qual int32[S]).  ``cand_idx`` int32[K_pad] (K_pad a
    power of two, 8 <= K_pad <= SLAB_MAX), ``cnt`` int32[K_pad, S],
    ``thr`` >= 1, 1 <= ``k_out`` <= K_pad."""
    if cand_mat.dtype != torch.int32 or cand_mat.dim() != 3 or not cand_mat.is_contiguous():
        raise ValueError("cand_mat must be a contiguous int32[R, S, W] tensor")
    if not cand_mat.is_cuda:
        raise ValueError("cand_mat must live on the card")
    R, S, W = cand_mat.shape
    K = cand_idx.shape[0]
    if not 8 <= K <= SLAB_MAX or K & (K - 1):
        raise ValueError(f"K9 takes a power-of-two K_pad in [8, {SLAB_MAX}], got {K}")
    if thr < 1 or n_sel < 0 or not 1 <= k_out <= K:
        raise ValueError(f"K9 takes thr >= 1, n_sel >= 0 and 1 <= k_out <= K_pad, got "
                         f"thr={thr}, n_sel={n_sel}, k_out={k_out}, K_pad={K}")
    mask = _on_card_int32(mask, "mask", (S,))
    cand_idx = _on_card_int32(cand_idx, "cand_idx", (K,))
    cnt = _on_card_int32(cnt, "cnt", (K, S))
    check_stacks(list(mats) + [cand_mat], S, code, extra=(len(mats),))
    if int(cand_idx.min()) < 0 or int(cand_idx.max()) >= R:
        raise ValueError(f"candidate row outside the stack of {R} rows")
    dev = cand_mat.device
    scores = torch.empty((K, S), dtype=torch.int32, device=dev)
    vals = torch.empty((S, k_out), dtype=torch.int32, device=dev)
    idx = torch.empty((S, k_out), dtype=torch.int32, device=dev)
    qual = torch.empty(S, dtype=torch.int32, device=dev)
    fn = _lib_fn("topn_slab", "topn_slab", _TOPN_SLAB_ARGS)
    err = fn(*_c_leaves(code, mats), mask.data_ptr(), cand_mat.data_ptr(), cand_idx.data_ptr(),
             K, S, W, cnt.data_ptr(), int(thr), int(n_sel), int(k_out), scores.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), qual.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topn_slab launch failed: cudaError {err}")
    range_leaf(code)
    pool_leaf(code, "topn_slab")
    topn_slab_cuda.launches += 1
    return vals, idx, qual


topn_slab_cuda.launches = 0


def topn_slab_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                   cand_mat: torch.Tensor, cand_idx: torch.Tensor, cnt: torch.Tensor,
                   thr: int, n_sel: int, k_out: int):
    """TopN's per-shard slab (pilosa_tpu/parallel/kernels.py:396
    topn_slab_tree): each shard's gated candidate walk and top ``k_out``,
    (vals int32[S, k_out], idx int32[S, k_out], qual int32[S]); ``qual[s]``
    > k_out means shard s's walk overflowed its slab.  ``cand_idx`` names
    the id-descending candidates' stack rows, ``cnt`` int32[K_pad, S] their
    ranked-cache counts (0 where absent from a shard's cache).  CUDA tensors
    launch K9 or raise; CPU tensors take ``topn_slab_tree_plain``."""
    code = compile_prog(prog)
    check_prog(code)
    if mask.is_cuda:
        return topn_slab_cuda(code, mats, mask, cand_mat, cand_idx, cnt, thr, n_sel, k_out)
    return topn_slab_tree_plain(prog, mats, mask, cand_mat, cand_idx, cnt, thr, n_sel, k_out)


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
    leaf rows, the ``n_rows`` rows some query reads as a row first, then
    the planes that only range leaves read; ``qinfo`` int32[K, 4] (program
    offset, program length, mask id, chain form 0/1) and ``ops`` the
    concatenated postfix programs, whose leaf opcodes carry indices into
    ``leaves``; ``ranges`` int64[n, 4] the distinct range leaves (``lo``,
    ``hi``, kind + depth << 8, offset into ``planes``), whose OP_RANGE
    opcodes index it, and ``planes`` int32 each group's depth + 1 planes
    as indices into ``leaves`` (-1 for a missing plane, a zero row that
    nothing reads); ``groups`` int32[g, 4] the range leaves over one
    field's planes (first range, count, depth, offset into ``planes``,
    shared by the group's ranges, which are numbered group by group), and
    ``walks`` int64[n, 3] each range leaf in the form K5's grouped pass
    walks (``walk_form``); ``reads``/``pooled`` as ``leaf_reads`` gives
    them."""

    __slots__ = ("leaves", "qinfo", "ops", "ranges", "planes", "groups", "walks", "n_rows",
                 "reads", "pooled")

    def __init__(self, leaves, qinfo, ops, ranges, planes, groups, walks, n_rows):
        self.leaves = leaves
        self.qinfo = qinfo
        self.ops = ops
        self.ranges = ranges
        self.planes = planes
        self.groups = groups
        self.walks = walks
        self.n_rows = n_rows
        self.reads, self.pooled = leaf_reads(leaves)


# The walk classes of K5's grouped range pass (csrc/count_batch_tree.cu
# kWalk*): equality, >= and <= comparisons of the value against the
# predicate, or both for BETWEEN, each a chain over the planes low bit
# first; a strict comparison starts its chain empty, neq negates eq.
WALK_EQ, WALK_GE, WALK_LE, WALK_BETWEEN = range(4)
WALK_NEG, WALK_STRICT = 1 << 8, 1 << 9


def walk_form(kind: str, depth: int, lo: int, hi: int) -> Tuple[int, int, int]:
    """A range condition as K5's grouped pass walks it: (lo, hi, class |
    flags), the predicates cut to their low ``depth`` bits, the only ones
    eval_range reads.  eq and neq compare for equality (neq negated
    against the not-null plane), gte and lte walk their comparison, gt and
    lt the same strictly, between both; at depth 0, with no value planes,
    every kind but neq is the not-null plane, so nothing is strict there."""
    mask = (1 << depth) - 1
    x, y = lo & mask, hi & mask
    strict = WALK_STRICT if depth and kind in ("gt", "lt") else 0
    if kind in ("eq", "neq"):
        return x, 0, WALK_EQ | (WALK_NEG if kind == "neq" else 0)
    if kind == "between":
        return x, y, WALK_BETWEEN
    if kind in ("gt", "gte"):
        return x, 0, WALK_GE | strict
    if kind in ("lt", "lte"):
        return x, 0, WALK_LE | strict
    raise ValueError(f"bad range kind: {kind!r}")


def _leaf_rows(prog, out: set) -> set:
    """The distinct leaf-table rows a tree reads: its rows, pool rows and
    the present planes of its range leaves."""
    if prog[0] == "row":
        out.add((int(prog[1]), int(prog[2])))
    elif prog[0] == "rowb":
        out.add((int(prog[1]), int(prog[3]), int(prog[2])))
    elif prog[0] == "range":
        out.update((int(prog[2]), int(p)) for p in prog[3] if p >= 0)
    elif prog[0] != "zero":
        for p in prog[1:]:
            _leaf_rows(p, out)
    return out


def batch_groups(progs) -> List[Tuple[int, int]]:
    """Cut a batch into consecutive [start, end) groups of at most
    BATCH_MAX queries and MAX_BATCH_LEAVES distinct leaf rows each (range
    planes included): one K5 launch per group (one group unless a batch is
    past either limit)."""
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


def compile_batch(progs, mask_ids: Sequence[int]) -> BatchProgram:
    """Compile K normalized trees into one BatchProgram.  The rows that
    queries read as rows come first in the leaf table; the distinct range
    leaves are grouped by the planes they walk (one field's, at one depth),
    so eight conditions on one field are one group whose planes K5 reads
    once a tile.  Raises ValueError when a query's program exceeds
    MAX_PROG, MAX_STACK or MAX_RANGES (a range leaf past MAX_PLANES planes),
    or the batch exceeds MAX_BATCH_LEAVES distinct leaf rows."""
    if len(progs) != len(mask_ids):
        raise ValueError("one mask id per query")
    codes = []
    table: Dict[tuple, int] = {}
    conds: Dict[tuple, Dict[tuple, None]] = {}  # (mat, planes) -> its conditions, in order
    for prog in progs:
        code = compile_prog(prog)
        if any((c & 0xFF) == OP_MREF for c in code.ops):
            raise ValueError("a slot reference (mref) runs only inside a fused program")
        if code.depth > MAX_STACK or len(code.ops) > MAX_PROG or code.ranges:
            check_prog(Postfix(code.ops, [], code.depth, code.ranges))
        for leaf in code.leaves:
            table.setdefault(leaf, len(table))
        for m, kind, rplanes, lo, hi in code.ranges:
            conds.setdefault((m, rplanes), {}).setdefault((kind, lo, hi), None)
        codes.append(code)
    n_rows = len(table)
    range_of: Dict[tuple, int] = {}
    ranges, walks, groups, planes = [], [], [], []
    for (m, rplanes), group in conds.items():
        depth, off = len(rplanes) - 1, len(planes)
        planes.extend(table.setdefault((m, p), len(table)) if p >= 0 else -1 for p in rplanes)
        groups.append((len(ranges), len(group), depth, off))
        for kind, lo, hi in group:
            range_of[(m, kind, rplanes, lo, hi)] = len(ranges)
            ranges.append((lo, hi, bsi_ops.RANGE_KINDS.index(kind) | depth << 8, off))
            walks.append(walk_form(kind, depth, lo, hi))
    qinfo = np.zeros((len(progs), 4), dtype=np.int32)
    ops: List[int] = []
    for k, code in enumerate(codes):
        qops = []
        for c in code.ops:
            op = c & 0xFF
            if op in (OP_LEAF, OP_ROWB):
                c = op | (table[code.leaves[c >> 8]] << 8)
            elif op == OP_RANGE:
                c = op | (range_of[code.ranges[c >> 8]] << 8)
            qops.append(c)
        qinfo[k] = (len(ops), len(qops), int(mask_ids[k]), int(code.chain))
        ops.extend(qops)
    if len(table) > MAX_BATCH_LEAVES:
        raise ValueError(f"count batch reads {len(table)} distinct leaf rows; "
                         f"K5 takes {MAX_BATCH_LEAVES}")
    return BatchProgram(list(table), qinfo, np.asarray(ops or [OP_ZERO], dtype=np.int32),
                        np.asarray(ranges, dtype=np.int64).reshape(-1, 4),
                        np.asarray(planes, dtype=np.int32),
                        np.asarray(groups, dtype=np.int32).reshape(-1, 4),
                        np.asarray(walks, dtype=np.int64).reshape(-1, 3), n_rows)


# K5's shared-memory stage (csrc/count_batch_tree.cu kStageBytes; K5P
# stages half as much) and its tile widths in uint4 positions.
BATCH_STAGE_BYTES = 64 * 1024
BATCH_DIRECT_TILE = 1024


def batch_tile(batch: BatchProgram, pooled: bool = False) -> int:
    """The tile K5 (K5P with ``pooled``) takes for ``batch``, as its
    launcher picks it (csrc/count_batch_tree.cu run): the widest power of
    two up to BATCH_DIRECT_TILE whose staged rows fit the stage, 0 for the
    direct path (no stage, every leaf word from device memory).  A batch
    without range leaves stages each leaf row once; one with range leaves
    stages each row read as a row twice (two tiles in flight) and each
    range leaf's result once."""
    n_r = batch.ranges.shape[0]
    rows = 2 * batch.n_rows + n_r if n_r else len(batch.leaves)
    stage = BATCH_STAGE_BYTES // 2 if pooled else BATCH_STAGE_BYTES
    tile = BATCH_DIRECT_TILE
    while tile >= 32 and rows * tile * 16 > stage:
        tile >>= 1
    return tile if tile >= 32 else 0


def count_batch_tree_plain(progs, mats: Sequence[torch.Tensor], masks: np.ndarray,
                           mask_ids: Sequence[int], device,
                           out_index: Optional[Sequence[int]] = None) -> torch.Tensor:
    """int64[K] masked popcounts of K trees, ``count_tree_plain`` per query
    (``masks`` bool[M, S] the distinct requested-shard masks, query k
    reading row ``mask_ids[k]``); with ``out_index`` the answers fanned out
    as ``result[out_index]``.  A range leaf's row is evaluated once per
    batch, its planes gathered once per field (``_ranges_once``), as K5
    walks a group once a tile.  The CPU path and the reference K5 is held
    against."""
    return _batch_plain(count_tree_plain, progs, mats, masks, mask_ids, device, out_index)


def count_batch_tree_pool_plain(progs, mats: Sequence[torch.Tensor], masks: np.ndarray,
                                mask_ids: Sequence[int], device,
                                out_index: Optional[Sequence[int]] = None) -> torch.Tensor:
    """K5P's plain version: ``count_batch_tree_plain``'s answers, each
    query's from its tree's live blocks only (``count_tree_pool_plain``).
    Equal to ``count_batch_tree_plain`` for every batch over full-width
    rows."""
    return _batch_plain(count_tree_pool_plain, progs, mats, masks, mask_ids, device, out_index)


def _ranges_once(progs, mats: Sequence[torch.Tensor]) -> tuple:
    """The batch's range leaves evaluated once each (``ops.bsi.range_rows``
    over planes gathered once per field and plane list, the groups of
    ``compile_batch``): the trees with every range leaf replaced by
    ``("row", len(mats), j)`` and ``mats`` with the list of those rows
    appended (unchanged without a range leaf)."""
    groups: Dict[tuple, Dict[tuple, None]] = {}

    def find(p):
        if p[0] == "range":
            groups.setdefault((int(p[2]), tuple(p[3])), {}).setdefault((p[1], p[4], p[5]), None)
        elif p[0] in _NODE_OPS:
            for q in p[1:]:
                find(q)

    for p in progs:
        find(p)
    if not groups:
        return progs, mats
    rows, index = [], {}
    for (slot, planes), conds in groups.items():
        stack = range_planes(mats[slot], planes, lambda words: words)
        for kind, lo, hi in conds:
            index[(kind, slot, planes, lo, hi)] = len(rows)
            rows.append(bsi_ops.range_rows(kind, stack, lo, hi))
    extra = len(mats)

    def sub(p):
        if p[0] == "range":
            return ("row", extra, index[(p[1], int(p[2]), tuple(p[3]), p[4], p[5])])
        if p[0] in _NODE_OPS:
            return (p[0],) + tuple(sub(q) for q in p[1:])
        return p

    return [sub(p) for p in progs], list(mats) + [rows]


def _batch_plain(count, progs, mats, masks, mask_ids, device, out_index) -> torch.Tensor:
    """``count(prog, mats, mask)`` per query into int64[K], fanned out,
    each range leaf evaluated once (``_ranges_once``)."""
    progs, mats = _ranges_once(progs, mats)
    dev_masks = torch.from_numpy(np.ascontiguousarray(masks, dtype=np.int32)).to(device)
    out = torch.zeros(len(progs), dtype=torch.int64, device=device)
    for k, prog in enumerate(progs):
        out[k] = count(prog, mats, dev_masks[int(mask_ids[k])])
    if out_index is not None:
        out = out[torch.as_tensor(np.asarray(out_index, dtype=np.int64), device=device)]
    return out


_BATCH_ARGS = [_P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I,
               _P, _P, _P]
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


def _batch_launch(entry: str, batch: BatchProgram, mats: Sequence[torch.Tensor],
                  masks: np.ndarray, device: torch.device,
                  out_index: Optional[Sequence[int]]) -> torch.Tensor:
    """Launch K5 or K5P (C entry ``entry`` of the count_batch_tree library,
    the same arguments): count_batch_tree_cuda's checks and result."""
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
    words = check_stacks(mats, S, batch)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if any(mat.device.index != index for mat in mats):
        raise ValueError("field stacks and the launch disagree on the device")
    fan = None if out_index is None else np.asarray(out_index, dtype=np.int32)
    if fan is not None and fan.size and (int(fan.min()) < 0 or int(fan.max()) >= K):
        raise ValueError("out_index names a query outside the batch")
    k_out = K if fan is None else int(fan.size)
    out = torch.empty(k_out, dtype=torch.int64, device=device)
    if k_out == 0:
        return out
    ptrs = np.asarray(leaf_pointers(batch.leaves, mats) or [0], dtype=np.uint64)
    n_r = batch.ranges.shape[0]
    sections = [ptrs, batch.qinfo, batch.ops, mask_bits(masks), batch.ranges, batch.planes,
                batch.groups, batch.walks]
    if fan is not None:
        sections.append(fan)
    buf, offs = _pack(sections)
    dev_buf = torch.from_numpy(buf).pin_memory().to(device, non_blocking=True)
    base = dev_buf.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = _lib_fn("count_batch_tree", entry, _BATCH_ARGS)
    ranged = (lambda i: base + offs[i] if n_r else None)  # noqa: E731
    err = fn(base + offs[0], len(batch.leaves), int(batch.pooled), base + offs[1], K,
             base + offs[2], base + offs[3], ranged(4), n_r, ranged(5), ranged(6),
             ranged(7), batch.groups.shape[0], batch.n_rows,
             int(batch.groups[:, 2].max()) if n_r else 0,
             None if fan is None else base + offs[8], k_out, S, words,
             _batch_scratch_for(device, stream).data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    range_leaf(batch)
    pool_leaf(batch, "count_batch_tree")
    return out


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
    out = _batch_launch("count_batch_tree", batch, mats, masks, device, out_index)
    count_batch_tree_cuda.launches += 1
    K = batch.qinfo.shape[0]
    count_batch_tree_cuda.by_k[K] = count_batch_tree_cuda.by_k.get(K, 0) + 1
    return out


count_batch_tree_cuda.launches = 0
# Launches by batch size K (the queries of one launch).
count_batch_tree_cuda.by_k = {}


def count_batch_tree_pool_cuda(batch: BatchProgram, mats: Sequence[torch.Tensor],
                               masks: np.ndarray, device: torch.device,
                               out_index: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Launch K5P (``csrc/count_batch_tree.cu`` count_batch_tree_pool) on
    the card: ``count_batch_tree_cuda``'s arguments and result, for a
    batch with pool rows (rows the full WORDS wide), each shard's tiles
    over the live blocks of the rows its requesting queries read only."""
    if not batch.pooled:
        raise ValueError("K5P takes a batch with pool rows")
    out = _batch_launch("count_batch_tree_pool", batch, mats, masks, device, out_index)
    count_batch_tree_pool_cuda.launches += 1
    return out


count_batch_tree_pool_cuda.launches = 0


def count_batch_tree(progs, mats: Sequence[torch.Tensor], masks: np.ndarray,
                     mask_ids: Sequence[int], device,
                     out_index: Optional[Sequence[int]] = None) -> torch.Tensor:
    """K Count(tree) queries in one launch: int64[K] of sum(popcount(tree_k
    & mask_k)), query k requesting the shards of ``masks[mask_ids[k]]``
    (``masks`` bool[M, S]); with ``out_index`` the answers fanned out as
    ``result[out_index]``.  On the card K5P launches for a batch with a
    pool row and K5 for any other, or raises; on the CPU the matching plain
    version runs."""
    batch = compile_batch(progs, mask_ids)
    if torch.device(device).type == "cuda":
        launch = count_batch_tree_pool_cuda if batch.pooled else count_batch_tree_cuda
        return launch(batch, mats, masks, device, out_index)
    plain = count_batch_tree_pool_plain if batch.pooled else count_batch_tree_plain
    return plain(progs, mats, masks, mask_ids, device, out_index)


# -- whole-dashboard fusion: F1 fused_tree -----------------------------------
#
# The port of pilosa_tpu/parallel/kernels.py:545 fused_tree, minus the mesh
# arguments, for the mask slots of ONE index (a drain spanning indexes runs
# one per index: their shard axes differ).  ``parallel/fusion.py`` builds
# the slot table by hash-consing every subtree of a drain's trees, so each
# slot is a flat node over items: a leaf row, a range leaf, zero, or
# ``("mref", j)``, the value of an earlier slot j.  F1 evaluates every slot
# once per word, keeps every slot's value in registers (an mref costs no
# memory access), counts the count edges, and writes only the slots an
# aggregate edge reads to a scratch int32[n_mat, S, W]; the aggregate edges
# then run K6, K7, K3 and K8 with such a slot as an ordinary filter row.

MAX_FUSED_SLOTS = 16  # csrc/fused_tree.cu kMaxSlots: 16 uint4 of registers
MAX_FUSED_EDGES = 32  # count edges per F1 launch (kMaxEdges)
MAX_FUSED_ITEMS = 128  # leaf, range and zero items over all slots (kMaxItems)


class FusedCode:
    """A slot table compiled for F1.  Slot k is the flat node ``op[k]``
    (OP_AND, OP_OR, OP_ANDNOT or OP_XOR; a bare item is an OR of one)
    over: ``first[k]``, ANDNOT's left side (an item code or an OP_MREF;
    -1 for the other ops, which start from their identity); the items
    ``items[item_off[k]: item_off[k] + item_len[k]]`` (OP_LEAF with its
    index into ``leaves``, OP_RANGE with its index into ``ranges``,
    OP_ZERO); and ``mref[k]``, the bit set of earlier slots it combines
    (for XOR, those named an odd number of times: the others cancel).
    ``leaves`` (mat_slot, row) and ``ranges`` are shared by every slot.
    F1 evaluates the slots in its own order: every slot that reads no
    other slot first (their loads all in flight before the first node
    waits on one), then the rest in table order; ``pos[j]`` is the place
    of table slot j (-1 for a one-row slot compiled into its readers,
    ``compile_fused``), and every field above is in F1's order.  Cached
    and shared: never mutated."""

    __slots__ = ("op", "first", "item_off", "item_len", "mref", "items", "leaves", "ranges",
                 "pos", "reads", "pooled")

    def __init__(self, op, first, item_off, item_len, mref, items, leaves, ranges, pos):
        self.pos = pos
        self.op = op
        self.first = first
        self.item_off = item_off
        self.item_len = item_len
        self.mref = mref
        self.items = items
        self.leaves = leaves
        self.ranges = ranges
        self.reads, self.pooled = leaf_reads(leaves, ranges)


@functools.lru_cache(maxsize=1024)
def compile_fused(slots, keep=None) -> FusedCode:
    """F1's form of a slot table (a tuple of slot progs).  ``keep`` is the
    frozenset of slots an edge reads (None: every slot): a slot of one leaf
    row (or zero) outside it is not one of F1's slots, each slot that
    references it reads the row itself (a repeat of a word the thread just
    read), and its ``pos`` is -1.  That keeps the registers and the
    unrolled reference tests of a dashboard's F1 to its nodes.  Raises
    ValueError on a slot that is not flat (a node whose children are all
    items) or that references itself or a later slot."""
    leaf_of: Dict[Tuple[int, int], int] = {}
    range_of: Dict[tuple, int] = {}
    ops, first, offs, lens, mrefs, items = [], [], [], [], [], []

    def item(p, k) -> int:
        kind = p[0]
        if kind == "row" and len(p) == 3:
            return OP_LEAF | (leaf_of.setdefault((int(p[1]), int(p[2])), len(leaf_of)) << 8)
        if kind == "rowb" and len(p) == 4:
            key = (int(p[1]), int(p[3]), int(p[2]))
            return OP_ROWB | (leaf_of.setdefault(key, len(leaf_of)) << 8)
        if kind == "range" and len(p) == 6 and p[1] in bsi_ops.RANGE_KINDS:
            key = (int(p[2]), p[1], tuple(int(x) for x in p[3]), int(p[4]), int(p[5]))
            return OP_RANGE | (range_of.setdefault(key, len(range_of)) << 8)
        if kind == "zero":
            return OP_ZERO
        if kind == "mref" and len(p) == 2:
            j = int(p[1])
            if not 0 <= j < k:
                raise ValueError(f"fused slot {k} references slot {j}: only earlier slots")
            return OP_MREF | (j << 8)
        raise ValueError(f"fused slot {k}: {p!r} is not flat (leaf, range leaf, zero or mref "
                         "under one node)")

    nodes = []
    for k, prog in enumerate(slots):
        if prog[0] in _NODE_OPS and len(prog) >= 2:
            op, kids = _NODE_OPS[prog[0]], prog[1:]
        else:
            op, kids = OP_OR, (prog,)
        nodes.append((op, [item(p, k) for p in kids]))
    inline = {}
    for k, (op, codes) in enumerate(nodes):
        if (keep is not None and k not in keep and op == OP_OR and len(codes) == 1
                and (codes[0] & 0xFF) in (OP_LEAF, OP_ROWB, OP_ZERO)):
            inline[k] = codes[0]
    nodes = [(op, [inline.get(c >> 8, c) if (c & 0xFF) == OP_MREF else c for c in codes])
             for op, codes in nodes]
    live = [k for k in range(len(nodes)) if k not in inline]
    # A valid order stays valid when the slots that read no slot move to
    # the front: the others read only earlier slots.
    reads = [any((c & 0xFF) == OP_MREF for c in codes) for _, codes in nodes]
    order = [k for k in live if not reads[k]] + [k for k in live if reads[k]]
    pos = [-1] * len(nodes)
    for at, k in enumerate(order):
        pos[k] = at

    def moved(c):
        return OP_MREF | (pos[c >> 8] << 8) if (c & 0xFF) == OP_MREF else c

    for k in order:
        op, codes = nodes[k]
        codes = [moved(c) for c in codes]
        f = codes.pop(0) if op == OP_ANDNOT else -1
        m, rest = 0, []
        for c in codes:
            if (c & 0xFF) == OP_MREF:
                m = m ^ (1 << (c >> 8)) if op == OP_XOR else m | (1 << (c >> 8))
            else:
                rest.append(c)
        ops.append(op)
        first.append(f)
        offs.append(len(items))
        lens.append(len(rest))
        mrefs.append(m)
        items.extend(rest)
    return FusedCode(ops, first, offs, lens, mrefs, items, list(leaf_of), list(range_of), pos)


def check_fused(code: FusedCode, n_count_edges: int = 0) -> None:
    """Raise ValueError when a slot table (and its count edges) does not
    fit F1: at most MAX_FUSED_SLOTS slots, MAX_FUSED_EDGES count edges,
    MAX_FUSED_ITEMS items, MAX_LEAVES leaf rows and MAX_RANGES range
    leaves.  The planner declines such a drain to the per-op programs."""
    if not 1 <= len(code.op) <= MAX_FUSED_SLOTS:
        raise ValueError(f"fused program of {len(code.op)} slots; F1 takes 1 to "
                         f"{MAX_FUSED_SLOTS}")
    if n_count_edges > MAX_FUSED_EDGES:
        raise ValueError(f"fused program of {n_count_edges} count edges; F1 takes "
                         f"{MAX_FUSED_EDGES}")
    if len(code.items) > MAX_FUSED_ITEMS:
        raise ValueError(f"fused program of {len(code.items)} items; F1 takes {MAX_FUSED_ITEMS}")
    check_prog(Postfix([OP_ZERO], code.leaves, 1, code.ranges))


def fused_slots_plain(slots, mats: Sequence[torch.Tensor], shape, device) -> List[torch.Tensor]:
    """Every slot's value int32[S, W] (``shape``), in order, with
    ``eval_prog`` reading earlier slots for ``("mref", j)``: the plain
    version of F1's slot evaluation."""
    vals: List[torch.Tensor] = []
    for prog in slots:
        v = eval_prog(prog, mats, lambda words: words, vals)
        vals.append(torch.zeros(shape, dtype=torch.int32, device=device) if v is None else v)
    return vals


def _fused_live(spec, mats, S: int, device) -> tuple:
    """Every slot's value int32[S, WORDS] (``fused_slots_plain``) and live
    word bool[64] (``live_blocks`` over the table), in table order."""
    live: List[torch.Tensor] = []
    for prog in spec.slots:
        live.append(live_blocks(prog, mats, device, live))
    return fused_slots_plain(spec.slots, mats, (S, bitops.WORDS), device), live


def fused_mat_pool_plain(spec, mats: Sequence[torch.Tensor],
                         masks: Sequence[torch.Tensor]) -> tuple:
    """F1P's materialized slots in plain PyTorch ops: ``(pool int32[1 +
    64 n_mat, S, 512], table int32[n_mat, 64])`` for the slots
    ``spec.mat_slots``, slot r's live blocks (``live_blocks`` with mref,
    over the table) at pool slots 1 + 64 r + b, its table row naming them
    and 0 elsewhere; every other pool slot zero.  The tests' and the
    card check's yardstick for F1P's pool and table."""
    S = masks[0].shape[0]
    device = masks[0].device
    vals, live = _fused_live(spec, mats, S, device)
    n_mat = len(spec.mat_slots)
    pool = torch.zeros((1 + POOL_BLOCKS * n_mat, S, POOL_BLOCK_WORDS), dtype=torch.int32,
                       device=device)
    table = torch.zeros((n_mat, POOL_BLOCKS), dtype=torch.int32, device=device)
    for r, j in enumerate(spec.mat_slots):
        blocks = torch.nonzero(live[j]).flatten()
        table[r, blocks] = (1 + POOL_BLOCKS * r + blocks).to(torch.int32)
        words = vals[j].reshape(S, POOL_BLOCKS, POOL_BLOCK_WORDS)[:, blocks]
        pool[1 + POOL_BLOCKS * r + blocks] = words.permute(1, 0, 2)
    return pool, table


_fused_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _fused_scratch_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """F1's scratch of materialized slots for one (device, stream): at
    least ``n`` int32, grown on demand.  A drain's F1 writes it and the
    drain's aggregate launches read it after, on that stream; the next
    drain's F1 on the stream runs after them.  A grown buffer's old block
    goes back to the caching allocator, which hands it out again only to
    work queued after it on this stream."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    with _totals_lock:
        buf = _fused_scratch.get(key)
        if buf is None or buf.numel() < n:
            buf = _fused_scratch[key] = torch.empty(n, dtype=torch.int32, device=device)
        return buf[:n]


# F1P's pools, apart from F1's scratch, one per (device, stream).  Slot 0
# of a pool over S shards is the buffer's first S * 512 int32.  F1P never
# writes slot 0, but a drain over fewer shards writes its slots inside a
# longer drain's slot 0, so each drain zeroes its slot 0 on the stream
# before F1P.
_fused_pool: Dict[Tuple[int, int], torch.Tensor] = {}


def _fused_pool_for(device: torch.device, stream: int, n_mat: int, S: int) -> torch.Tensor:
    """F1P's pool int32[1 + 64 n_mat, S, 512] for one (device, stream),
    slot 0 zero: valid until the next F1P on this stream."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    slot = S * POOL_BLOCK_WORDS
    n = (1 + POOL_BLOCKS * n_mat) * slot
    with _totals_lock:
        buf = _fused_pool.get(key)
        if buf is None or buf.numel() < n:
            buf = _fused_pool[key] = torch.empty(n, dtype=torch.int32, device=device)
    buf[:slot].zero_()
    return buf[:n].view(1 + POOL_BLOCKS * n_mat, S, POOL_BLOCK_WORDS)


_FUSED_ARGS = [_P, _I, _P, _P, _I, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P]


def _fused_args(code: FusedCode, mats, count_slots, gates, mat_slots, need, n_shards):
    """F1's and F1P's checked arguments: (S, W, device, gates, need, the C
    arguments up to the shard count)."""
    S = (need.shape[0] if need is not None else gates[0].shape[0] if gates
         else n_shards if n_shards is not None else mats[0].shape[1])
    W = check_stacks(mats, S, code)
    n_slots, E = len(code.op), len(count_slots)

    def compiled(j) -> bool:  # a slot of the table that F1 evaluates
        return 0 <= int(j) < len(code.pos) and code.pos[int(j)] >= 0

    if len(gates) != E or not all(compiled(j) for j in count_slots):
        raise ValueError("one gate per count edge, each edge on a slot of the table in keep")
    if len(set(mat_slots)) != len(mat_slots) or not all(compiled(j) for j in mat_slots):
        raise ValueError("materialized slots must be distinct slots of the table in keep")
    gates = [_on_card_int32(g, "gate", (S,)) for g in gates]
    if need is not None:
        need = _on_card_int32(need, "need", (S,))
    dev = gates[0].device if gates else need.device if need is not None else mats[0].device
    if dev.type != "cuda":
        raise ValueError("F1 runs on the card")
    mat_row = [-1] * n_slots
    for i, j in enumerate(mat_slots):
        mat_row[code.pos[int(j)]] = i
    edge_slots = [code.pos[int(j)] for j in count_slots]
    counted = 0
    for j in edge_slots:
        counted |= 1 << j
    info = (ctypes.c_int * (5 * n_slots))(*[
        v for k in range(n_slots) for v in (code.op[k], code.first[k], code.item_off[k],
                                            code.item_len[k], code.mref[k])])
    items = (ctypes.c_int * max(1, len(code.items)))(*code.items)
    args = (*_c_table(code.leaves, code.ranges, mats), n_slots, info, items, len(code.items),
            (ctypes.c_int * n_slots)(*mat_row), counted, E,
            (ctypes.c_int * max(1, E))(*edge_slots),
            (ctypes.c_void_p * max(1, E))(*[g.data_ptr() for g in gates]), _ptr(need), S)
    return S, W, dev, args


def fused_tree_cuda(code: FusedCode, mats: Sequence[torch.Tensor], count_slots: Sequence[int],
                    gates: Sequence[torch.Tensor], mat_slots: Sequence[int] = (),
                    need: Optional[torch.Tensor] = None, n_shards: Optional[int] = None):
    """Launch F1 on the card, on the current stream, without waiting for
    the device.  Returns ``(counts int64[E], mat)``: count edge e is
    sum(popcount(slot[count_slots[e]] & gates[e])) over the shards (each
    gate int32[S], nonzero = requested); ``mat`` int32[len(mat_slots), S,
    W] holds slot ``mat_slots[i]`` in row i (None without mat_slots), in
    the per-(device, stream) scratch, valid until the next F1 on this
    stream.  With ``need`` int32[S] F1 reads and writes only the shards it
    marks: every gate must lie inside it, and ``mat`` is unspecified
    outside it (each aggregate kernel skips the shards its mask leaves
    out)."""
    S, W, dev, args = _fused_args(code, mats, count_slots, gates, mat_slots, need, n_shards)
    E = len(count_slots)
    out = torch.zeros(max(E, 1), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mat = None
    if mat_slots:
        mat = _fused_scratch_for(dev, stream, len(mat_slots) * S * W).view(len(mat_slots), S, W)
    fn = _lib_fn("fused_tree", "fused_tree", _FUSED_ARGS)
    err = fn(*args, W, _ptr(mat), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_tree launch failed: cudaError {err}")
    fused_tree_cuda.launches += 1
    range_leaf(code)
    pool_leaf(code, "fused_tree")
    return out[:E], mat


fused_tree_cuda.launches = 0


def fused_tree_pool_cuda(code: FusedCode, mats: Sequence[torch.Tensor],
                         count_slots: Sequence[int], gates: Sequence[torch.Tensor],
                         mat_slots: Sequence[int] = (), need: Optional[torch.Tensor] = None,
                         n_shards: Optional[int] = None):
    """Launch F1P (``csrc/fused_tree.cu`` fused_tree_pool) on the card:
    ``fused_tree_cuda``'s arguments, for a slot table with pool leaves
    (rows the full WORDS wide), reading and writing only the blocks its
    slots can make non-zero.  Returns ``(counts int64[E], mat)`` with
    ``mat`` the materialized slots as pool rows, ``(pool int32[1 + 64 n,
    S, 512], table int32[n, 64])``: slot ``mat_slots[i]`` is the pool row
    of table row i, ``("rowb", 0, 1, i)`` over ``[pool, table]`` (None
    without mat_slots).  The pool is per (device, stream), valid until the
    next F1P on this stream, unspecified outside ``need`` as F1's scratch
    is; the table is the launch's own."""
    S, W, dev, args = _fused_args(code, mats, count_slots, gates, mat_slots, need, n_shards)
    E = len(count_slots)
    out = torch.zeros(max(E, 1), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pool = table = None
    if mat_slots:
        pool = _fused_pool_for(dev, stream, len(mat_slots), S)
        table = torch.empty((len(mat_slots), POOL_BLOCKS), dtype=torch.int32, device=dev)
    fn = _lib_fn("fused_tree", "fused_tree_pool", _FUSED_ARGS + [_P])
    err = fn(*args, W, _ptr(pool), _ptr(table), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_tree_pool launch failed: cudaError {err}")
    fused_tree_pool_cuda.launches += 1
    range_leaf(code)
    pool_leaf(code, "fused_tree")
    return out[:E], (None if pool is None else (pool, table))


fused_tree_pool_cuda.launches = 0

# Device outputs of each aggregate edge kind (FusedSpec).
FUSED_ARITY = {"sum": 1, "minmax": 2, "topn": 2, "topnf": 1, "group": 1}


class FusedSpec:
    """One index's part of a fused drain: ``slots`` the mask-slot progs in
    dependency order, ``count_edges`` (slot, mask) pairs, and
    ``agg_edges``, each reading slot ``slot`` as its filter (-1: none; a
    TopN always has one):

      ("sum", slot, mask, plane_mat, planes)            -> int64[D + 1]
      ("minmax", slot, mask, plane_mat, planes, is_min) -> values int64[S], counts int64[S]
      ("topn", slot, mask, cand_mat, idx)               -> scores int32[K, S], src counts int32[S]
      ("topnf", slot, mask, cand_mat, idx, cnt, thr, n_out)
                                                        -> int32[2, n_out] (int64[K] for n_out None)
      ("group", slot, mask, (mat, ...), (rows, ...))    -> int64[K_1 * ... * K_n]

    ``mat``/``plane_mat``/``cand_mat`` index the field stacks, ``mask``
    the int32[S] masks, ``idx``/``cnt`` the other tensors (TopN's
    candidate stack rows int32[K] and per-shard row counts int32[K, S]);
    ``planes`` and ``rows`` are stack rows as for K6/K7 and K8."""

    __slots__ = ("slots", "count_edges", "agg_edges", "mat_slots")

    def __init__(self, slots, count_edges, agg_edges):
        self.slots = tuple(slots)
        self.count_edges = tuple(count_edges)
        self.agg_edges = tuple(agg_edges)
        self.mat_slots = tuple(sorted({e[1] for e in self.agg_edges if e[1] >= 0}))

    def code(self) -> FusedCode:
        """F1's form of the slot table, every slot an edge reads kept."""
        return compile_fused(self.slots, frozenset(j for j, _ in self.count_edges)
                             | frozenset(self.mat_slots))


def _agg_outputs(spec: FusedSpec, mats, mat, masks, tensors, plain: bool) -> list:
    """The aggregate edges' outputs, each edge's kernel (or, with
    ``plain``, its plain version) reading its slot as row
    ``spec.mat_slots.index(slot)`` of ``mat``: a stack int32[n_mat, S, W]
    (F1's), or F1P's ``(pool, table)``, whose pool row i is the leaf
    ``("rowb", 0, 1, i)`` (so the Sum, TopN, Min/Max and group edges take
    K6P, K3P, K7P and K8P)."""
    from . import bsi as bsi_mod
    from . import groupby as groupby_mod

    # An edge's filter is one row of ``mat``, its only leaf stack (the part's
    # pools and slot tables stay out of the edge kernels' stack list).
    pooled = isinstance(mat, tuple)
    ext = [] if mat is None else list(mat) if pooled else [mat]
    row_of = {j: i for i, j in enumerate(spec.mat_slots)}
    outs: list = []
    for e in spec.agg_edges:
        kind, slot, mask = e[0], e[1], masks[e[2]]
        prog = None if slot < 0 else ("rowb", 0, 1, row_of[slot]) if pooled else \
            ("row", 0, row_of[slot])
        pool_plain = pooled and prog is not None
        if kind == "sum":
            fn = bsi_mod.sum_tree if not plain else \
                bsi_mod.sum_tree_pool_plain if pool_plain else bsi_mod.sum_tree_plain
            outs.append(fn(prog, ext, mask, mats[e[3]], e[4]))
        elif kind == "minmax":
            fn = bsi_mod.minmax_tree if not plain else \
                bsi_mod.minmax_tree_pool_plain if pool_plain else bsi_mod.minmax_tree_plain
            outs.extend(fn(prog, ext, mask, mats[e[3]], e[4], e[5]))
        elif kind == "topn":
            fn = topn_tree if not plain else \
                topn_tree_pool_plain if pool_plain else topn_tree_plain
            outs.extend(fn(prog, ext, mask, mats[e[3]], tensors[e[4]]))
        elif kind == "topnf":
            _, _, _, cm, ix, cnt, thr, n_out = e
            if plain:
                fn = topn_full_tree_pool_plain if pool_plain else topn_full_tree_plain
                out = fn(prog, ext, mask, mats[cm], tensors[ix], tensors[cnt], thr, n_out)
                outs.append(out if n_out is None else torch.stack(out))
            else:
                outs.append(topn_full_tree(prog, ext, mask, mats[cm], tensors[ix], tensors[cnt],
                                           thr, n_out))
        elif kind == "group":
            fn = groupby_mod.groupn_tree if not plain else \
                groupby_mod.groupn_tree_pool_plain if pool_plain else groupby_mod.groupn_tree_plain
            outs.append(fn(prog, ext, mask, [mats[i] for i in e[3]], e[4]))
        else:
            raise ValueError(f"bad fused edge {kind!r}")
    return outs


def fused_tree_plain(spec: FusedSpec, mats: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                     tensors: Sequence[torch.Tensor] = ()) -> list:
    """The outputs of a fused drain's part in plain PyTorch ops: the count
    vector int64[n_count] (when it has count edges), then each aggregate
    edge's outputs in edge order (FusedSpec).  The slots by
    ``fused_slots_plain``, the counts by the SWAR popcount, the edges by
    the plain versions of K6, K7, K3 and K8.  The CPU path and the
    reference F1 and the drain's launches are held against."""
    if not masks:
        return []
    S = masks[0].shape[0]
    W = int(mats[0].shape[2]) if mats else bitops.WORDS
    vals = fused_slots_plain(spec.slots, mats, (S, W), masks[0].device)
    outs = []
    if spec.count_edges:
        outs.append(torch.stack([bitops.popcount_words(vals[j][masks[m] != 0]).sum()
                                 for j, m in spec.count_edges]).to(torch.int64))
    mat = torch.stack([vals[j] for j in spec.mat_slots]) if spec.mat_slots else None
    return outs + _agg_outputs(spec, mats, mat, masks, tensors, plain=True)


def fused_tree_pool_plain(spec: FusedSpec, mats: Sequence[torch.Tensor],
                          masks: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor] = ()
                          ) -> list:
    """F1P's drain in plain PyTorch ops, ``fused_tree_plain``'s outputs:
    each count edge over its slot's live blocks only, the materialized
    slots as ``fused_mat_pool_plain``'s pool rows, and the edges' pool
    plain versions over them (K6P's, K3P's, K7P's and K8P's).  Equal to
    ``fused_tree_plain`` for every drain over full-width rows."""
    if not masks:
        return []
    S = masks[0].shape[0]
    vals, live = _fused_live(spec, mats, S, masks[0].device)
    outs = []
    if spec.count_edges:
        outs.append(torch.stack([
            bitops.popcount_words(vals[j].reshape(S, POOL_BLOCKS, POOL_BLOCK_WORDS)[
                masks[m] != 0][:, live[j]]).sum() for j, m in spec.count_edges]).to(torch.int64))
    mat = fused_mat_pool_plain(spec, mats, masks) if spec.mat_slots else None
    return outs + _agg_outputs(spec, mats, mat, masks, tensors, plain=True)


def fused_tree(spec: FusedSpec, mats: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
               tensors: Sequence[torch.Tensor] = (), need: Optional[torch.Tensor] = None) -> list:
    """A fused drain's part (FusedSpec): its outputs as ``fused_tree_plain``
    returns them.  CUDA tensors launch F1 (when the part has slots), or
    F1P for a slot table with a pool leaf, and then each aggregate edge's
    kernel, all on the current stream without waiting for the device, or
    raise; CPU tensors take the plain version.  After F1P an edge reads its
    slot as a pool row (``_agg_outputs``).  ``need`` (see
    ``fused_tree_cuda``) must cover every mask."""
    if not masks:
        return []
    if not masks[0].is_cuda:
        return fused_tree_plain(spec, mats, masks, tensors)
    outs: list = []
    mat = None
    if spec.slots and (spec.count_edges or spec.mat_slots):
        code = spec.code()
        check_fused(code, len(spec.count_edges))
        launch = fused_tree_pool_cuda if code.pooled else fused_tree_cuda
        counts, mat = launch(code, mats, [j for j, _ in spec.count_edges],
                             [masks[m] for _, m in spec.count_edges], spec.mat_slots,
                             need, n_shards=masks[0].shape[0])
        if spec.count_edges:
            outs.append(counts)
    return outs + _agg_outputs(spec, mats, mat, masks, tensors, plain=False)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launches in this process, by C entry: the
    counts /debug/vars shows under ``engine.kernelLaunches``."""
    from . import bsi, groupby, sparse

    wrappers = (count_tree_dense, count_tree_pool, sparse.count_tree_blocks_cuda,
                score_rows_cuda, score_rows_pool_cuda, and_popcount_rows_cuda,
                count_batch_tree_cuda, count_batch_tree_pool_cuda, bsi.sum_tree_cuda,
                bsi.sum_tree_pool_cuda, bsi.minmax_tree_cuda, bsi.minmax_tree_pool_cuda,
                groupby.groupn_tree_cuda, groupby.groupn_tree_pool_cuda, fused_tree_cuda,
                fused_tree_pool_cuda, topn_slab_cuda, eval_tree_cuda, score_rows_trim_cuda)
    return {w.__name__.removesuffix("_cuda"): int(w.launches) for w in wrappers}
