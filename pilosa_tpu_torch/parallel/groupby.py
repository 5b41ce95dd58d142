"""GroupBy's combination counts over resident field stacks: K8
``groupn_tree`` (with K8P for a filter over pool rows) beside its plain
twin.

Each of the n group fields (1 <= n <= MAX_GROUP_FIELDS) is a field stack
``int32[R_i, S, WORDS]``; ``row_idx_lists[i]`` names the K_i stack rows of
field i to group by (-1 for a row the stack lacks, which reads as zeros).
The optional filter is a normalized tree of ``kernels.py`` (range leaves
included) over ``mats``; None means every column.  The mask is the
requested-shard gate int32[S].  The result is int64[K_1 * ... * K_n],
row-major over the lists:

    out[k_1, ..., k_n] = sum over requested shards of
        popcount(filter & row_1[k_1] & ... & row_n[k_n])

It replaces the XLA program ``pilosa_tpu/parallel/kernels.py:707
groupn_tree`` (which sums in int32; the two agree below 2^31).  At most
MAX_GROUP_COMBOS combinations: the engine sends a larger GroupBy to the
executor's host iterator before any launch, as the reference does.

For tensors on the card ``groupn_tree`` launches the hand-written CUDA
kernel (``csrc/groupn_tree.cu``) or raises; for tensors on the CPU it
evaluates the plain PyTorch version.  ``groupn_plan`` orders the fields
for the kernel (the one with the most rows first) and picks its form for
the shape: registers (the counts per thread) where it fits, else the walk
(the deeper levels' rows staged in shared memory).  Either form brings
each listed row of a tile on chip once per pass.  A filter with a pool
leaf launches K8P (``csrc/groupn_tree_pool.cu``), either form over the
filter's live blocks only, its leaves and every listed row read there
alone.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import bitops
from . import kernels
from .kernels import _I, _P, _TREE_ARGS

# csrc/groupn_tree.cuh kMaxFields and kMaxCombos.
MAX_GROUP_FIELDS = 8
MAX_GROUP_COMBOS = 1024
# csrc/groupn_tree.cuh's register form: at most REG_FIELDS fields, REG_K0
# rows on the first level and REG_K on each later one (kRegFields, kRegK0,
# kRegK), so at most 32 combinations.
REG_FIELDS = 4
REG_K0 = 4
REG_K = 2


def _walk_plain(filt: torch.Tensor, field_mats: Sequence[torch.Tensor], lists,
                select) -> torch.Tensor:
    """The combination counts under the masked filter rows ``filt``, every
    listed row restricted by ``select``: the combinations walked depth
    first with one running AND per level, the last level's rows counted
    together."""
    zero = torch.zeros_like(filt)

    def rows_of(d):
        return [select(field_mats[d][r]) if r >= 0 else zero for r in lists[d]]

    last = torch.stack(rows_of(len(lists) - 1))  # [K_n, S, W']
    out = []

    def walk(d, acc):
        if d == len(lists) - 1:
            out.append(bitops.popcount_words(torch.bitwise_and(last, acc)).sum(dim=(1, 2)))
            return
        for row in rows_of(d):
            walk(d + 1, torch.bitwise_and(acc, row))

    walk(0, filt)
    return torch.cat(out).to(torch.int64)


def groupn_tree_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                      field_mats: Sequence[torch.Tensor], row_idx_lists) -> torch.Tensor:
    """int64[K_1 * ... * K_n] combination counts in plain PyTorch ops, the
    combinations walked depth first with one running AND per level, the
    last level's rows counted together: the CPU path and the reference K8
    is held against."""
    lists = [[int(r) for r in rows] for rows in row_idx_lists]
    if not all(lists):
        return torch.zeros(0, dtype=torch.int64, device=mask.device)
    filt = kernels.filter_plain(prog, mats, mask, field_mats[0][0])
    return _walk_plain(filt, field_mats, lists, lambda words: words)


def groupn_tree_pool_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                           field_mats: Sequence[torch.Tensor], row_idx_lists) -> torch.Tensor:
    """K8P's plain version: ``groupn_tree_plain``'s counts from the filter
    tree's live blocks alone (``kernels.live_blocks``), the filter's leaves
    and every listed row read there only; a live word of 0 counts nothing.
    Equal to ``groupn_tree_plain`` for every filter over full-width rows."""
    lists = [[int(r) for r in rows] for rows in row_idx_lists]
    idx, select = kernels.live_select(prog, mats, mask.device)
    if not all(lists) or idx.numel() == 0:  # a zero filter too: nothing is read
        return torch.zeros(math.prod(len(rows) for rows in lists), dtype=torch.int64,
                           device=mask.device)
    f = kernels.eval_prog(prog, mats, select, blocks=idx)
    return _walk_plain(torch.where(mask[:, None] != 0, f, torch.zeros_like(f)), field_mats,
                       lists, select)


def _check_lists(field_mats: Sequence[torch.Tensor], row_idx_lists):
    """The lists as ints, after the checks both versions share."""
    n = len(field_mats)
    if not 1 <= n <= MAX_GROUP_FIELDS or len(row_idx_lists) != n:
        raise ValueError(f"GroupBy takes 1 to {MAX_GROUP_FIELDS} fields, one row list each")
    lists = [[int(r) for r in rows] for rows in row_idx_lists]
    if math.prod(len(rows) for rows in lists) > MAX_GROUP_COMBOS:
        raise ValueError(f"GroupBy takes at most {MAX_GROUP_COMBOS} combinations")
    for mat, rows in zip(field_mats, lists):
        if any(not -1 <= r < mat.shape[0] for r in rows):
            raise ValueError(f"group row outside stack of {mat.shape[0]} rows")
    return lists


def groupn_plan(ks: Sequence[int]):
    """K8's launch plan for fields listing ``ks`` rows: ``(form, order,
    strides)``.  ``order`` is the fields in level order, the one with the
    most rows first (a stable sort: the walk then stages the fewest rows,
    at most 32 within MAX_GROUP_COMBOS); ``strides`` each level's stride
    in the row-major output; ``form`` "registers" where the shape fits
    the register form in that order, else "walk"."""
    n = len(ks)
    order = sorted(range(n), key=lambda i: -ks[i])
    stride = [math.prod(ks[i + 1:]) for i in range(n)]
    regs = (n <= REG_FIELDS and ks[order[0]] <= REG_K0
            and all(ks[i] <= REG_K for i in order[1:]))
    return "registers" if regs else "walk", order, [stride[i] for i in order]


def _groupn_launch(entry: str, code: Optional[kernels.Postfix], mats: Sequence[torch.Tensor],
                   mask: torch.Tensor, field_mats: Sequence[torch.Tensor],
                   row_idx_lists) -> torch.Tensor:
    """Launch K8 or K8P (C entry ``entry`` of the library of that name, the
    same arguments) in ``groupn_plan``'s form: int64[K_1 * ... * K_n].
    The row lists travel to the card in one pinned, non-blocking copy;
    PyTorch's caching allocators keep the host buffer until the copy has
    run and hand the device copy out again only to work queued after the
    kernel on this stream."""
    if not mask.is_cuda or mask.dtype != torch.int32 or mask.dim() != 1:
        raise ValueError("mask must be an int32[S] tensor on the card")
    mask = mask.contiguous()
    S = mask.shape[0]
    W = kernels.check_stacks(list(mats) + list(field_mats), S, code,
                             extra=range(len(mats), len(mats) + len(field_mats)))
    lists = _check_lists(field_mats, row_idx_lists)
    dev = mask.device
    C = math.prod(len(rows) for rows in lists)
    out = torch.zeros(C, dtype=torch.int64, device=dev)
    if C == 0:
        return out
    tree = (None, 0, None, None, 0, None, 0) if code is None else kernels._c_leaves(code, mats)
    form, order, strides = groupn_plan([len(rows) for rows in lists])
    idx = np.asarray([r for i in order for r in lists[i]], dtype=np.int32)
    dev_idx = torch.from_numpy(idx).pin_memory().to(dev, non_blocking=True)
    n = len(field_mats)
    ptrs = (ctypes.c_void_p * n)(*[field_mats[i].data_ptr() for i in order])
    ks = (ctypes.c_int * n)(*[len(lists[i]) for i in order])
    fn = kernels._lib_fn(entry, entry,
                         _TREE_ARGS + [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P])
    err = fn(*tree, ptrs, ks, (ctypes.c_int * n)(*strides), int(form == "registers"), n,
             dev_idx.data_ptr(), mask.data_ptr(), S, W, out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    if code is not None:
        kernels.pool_leaf(code, "groupn_tree")
    return out


def groupn_tree_cuda(code: Optional[kernels.Postfix], mats: Sequence[torch.Tensor],
                     mask: torch.Tensor, field_mats: Sequence[torch.Tensor],
                     row_idx_lists) -> torch.Tensor:
    """Launch K8 on the card, on the current stream, without waiting for
    the device: int64[K_1 * ... * K_n], in ``groupn_plan``'s form."""
    out = _groupn_launch("groupn_tree", code, mats, mask, field_mats, row_idx_lists)
    groupn_tree_cuda.launches += 1
    return out


groupn_tree_cuda.launches = 0


def groupn_tree_pool_cuda(code: kernels.Postfix, mats: Sequence[torch.Tensor],
                          mask: torch.Tensor, field_mats: Sequence[torch.Tensor],
                          row_idx_lists) -> torch.Tensor:
    """Launch K8P (``csrc/groupn_tree_pool.cu``) on the card:
    ``groupn_tree_cuda``'s counts for a filter tree with pool leaves, in
    either form, the filter's leaves and every listed row read at its live
    blocks only (``kernels.live_blocks``); any filter over full-width rows
    gives K8's answer.  Rows are the full WORDS wide; a filter is
    required."""
    if code is None:
        raise ValueError("K8P takes a filter tree")
    out = _groupn_launch("groupn_tree_pool", code, mats, mask, field_mats, row_idx_lists)
    groupn_tree_pool_cuda.launches += 1
    return out


groupn_tree_pool_cuda.launches = 0


def groupn_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                field_mats: Sequence[torch.Tensor], row_idx_lists) -> torch.Tensor:
    """GroupBy's combination counts: int64[K_1 * ... * K_n].  CUDA tensors
    launch K8P for a filter with a pool leaf and K8 for any other (or no
    filter), or raise; CPU tensors take the matching plain version."""
    code = None
    if prog is not None:
        code = kernels.compile_prog(prog)
        kernels.check_prog(code)
    pooled = code is not None and code.pooled
    if mask.is_cuda:
        return (groupn_tree_pool_cuda if pooled else groupn_tree_cuda)(
            code, mats, mask, field_mats, row_idx_lists)
    _check_lists(field_mats, row_idx_lists)
    return (groupn_tree_pool_plain if pooled else groupn_tree_plain)(
        prog, mats, mask, field_mats, row_idx_lists)
