"""BSI Sum, Min and Max over a resident field stack: K6 ``sum_tree`` and K7
``minmax_tree`` (with K6P and K7P for a filter over pool rows), each beside
its plain twin, and the host decoders.

The BSI field's planes live in its ``bsig_<field>`` view stack
``int32[R, S, WORDS]`` like any other view; ``planes`` names the stack
rows of value planes 0..depth-1 and then the not-null plane (-1 for a
plane the stack lacks, which reads as zeros).  The optional filter is a
normalized tree of ``kernels.py`` (range leaves included) over ``mats``;
None means every column.  The mask is the requested-shard gate int32[S].

- ``sum_tree`` -> int64[depth + 1]: popcount(plane_i & notnull & filter
  & mask) per value plane, then the considered count; ``decode_sum`` turns
  it into (total, count) with Python ints.  It replaces the XLA program
  ``pilosa_tpu/parallel/kernels.py:474 sum_tree``.  A filter with a pool
  leaf launches K6P (``sum_tree_pool`` in the same source), which reads
  the filter's leaves and the planes at the filter's live blocks only.
- ``minmax_tree`` -> (values int64[S], counts int64[S]): per shard the
  extreme value among the considered columns and how many hold it (count
  0: none); ``decode_min_max`` reduces the shards in canonical order.  It
  replaces ``kernels.py:511 minmax_tree``, whose value comes as (hi, lo)
  halves; here it is one int64.  A filter with a pool leaf launches K7P
  (``minmax_tree_pool`` in the same source), which reads the filter's
  leaves and the planes at the filter's live blocks only.

For tensors on the card each wrapper launches its hand-written CUDA kernel
(``csrc/sum_tree.cu``, ``csrc/minmax_tree.cu``) or raises; for tensors on
the CPU it evaluates the plain PyTorch version (``ops/bsi.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import bsi as bsi_ops
from . import kernels
from .kernels import _I, _P, _TREE_ARGS


def _planes_plain(plane_mat: torch.Tensor, planes) -> torch.Tensor:
    return kernels.range_planes(plane_mat, planes, lambda words: words)


def sum_tree_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                   plane_mat: torch.Tensor, planes) -> torch.Tensor:
    """int64[depth + 1] plane counts and considered count, in plain PyTorch
    ops: the CPU path and the reference K6 is held against."""
    p = _planes_plain(plane_mat, planes)
    counts, n = bsi_ops.sum_counts(p, kernels.filter_plain(prog, mats, mask, p[0]))
    return torch.cat([counts, n.reshape(1)])


def sum_tree_pool_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                        plane_mat: torch.Tensor, planes) -> torch.Tensor:
    """K6P's plain version: ``sum_tree_plain``'s counts from the filter
    tree's live blocks alone (``kernels.live_blocks``), the filter's leaves
    and every plane read there only.  Equal to ``sum_tree_plain`` for every
    filter over full-width rows."""
    idx, select = kernels.live_select(prog, mats, mask.device)
    if idx.numel() == 0:  # a zero filter too: nothing is read
        return torch.zeros(len(planes), dtype=torch.int64, device=mask.device)
    p = kernels.range_planes(plane_mat, planes, select)
    f = kernels.eval_prog(prog, mats, select, blocks=idx)
    counts, n = bsi_ops.sum_counts(p, torch.where(mask[:, None] != 0, f, torch.zeros_like(f)))
    return torch.cat([counts, n.reshape(1)])


def minmax_tree_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                      plane_mat: torch.Tensor, planes, is_min: bool):
    """(values int64[S], counts int64[S]) in plain PyTorch ops: the CPU
    path and the reference K7 is held against."""
    p = _planes_plain(plane_mat, planes)
    return bsi_ops.minmax_valcount_nd(p, kernels.filter_plain(prog, mats, mask, p[0]), is_min)


def minmax_tree_pool_plain(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                           plane_mat: torch.Tensor, planes, is_min: bool):
    """K7P's plain version: ``minmax_tree_plain``'s pairs from the filter
    tree's live blocks alone (``kernels.live_blocks``), the filter's leaves
    and every plane read there only; a live word of 0 gives every shard
    (0, 0).  Equal to ``minmax_tree_plain`` for every filter over
    full-width rows."""
    idx, select = kernels.live_select(prog, mats, mask.device)
    if idx.numel() == 0:  # a zero filter too: nothing is read
        zero = torch.zeros(mask.shape[0], dtype=torch.int64, device=mask.device)
        return zero, zero.clone()
    p = kernels.range_planes(plane_mat, planes, select)
    f = kernels.eval_prog(prog, mats, select, blocks=idx)
    return bsi_ops.minmax_valcount_nd(p, torch.where(mask[:, None] != 0, f, torch.zeros_like(f)),
                                      is_min)


def _launch_args(code: Optional[kernels.Postfix], mats, mask: torch.Tensor,
                 plane_mat: torch.Tensor, planes):
    """Checks shared by K6 and K7, then (tree args, the planes' RangeLeaf,
    S, W)."""
    if not mask.is_cuda or mask.dtype != torch.int32 or mask.dim() != 1:
        raise ValueError("mask must be an int32[S] tensor on the card")
    S = mask.shape[0]
    W = kernels.check_stacks(list(mats) + [plane_mat], S, code, extra=(len(mats),))
    tree = (None, 0, None, None, 0, None, 0) if code is None else kernels._c_leaves(code, mats)
    return tree, kernels.c_planes(plane_mat, planes), S, W


def _sum_launch(entry: str, code: Optional[kernels.Postfix], mats: Sequence[torch.Tensor],
                mask: torch.Tensor, plane_mat: torch.Tensor, planes) -> torch.Tensor:
    """Launch K6 or K6P (C entry ``entry`` of the sum_tree library, the
    same arguments): int64[depth + 1]."""
    tree, pl, S, W = _launch_args(code, mats, mask, plane_mat, planes)
    out = torch.zeros(len(planes), dtype=torch.int64, device=mask.device)
    fn = kernels._lib_fn("sum_tree", entry, _TREE_ARGS + [_P, _I, _P, _I, _I, _P, _P])
    err = fn(*tree, ctypes.byref(pl), plane_mat.shape[0], mask.contiguous().data_ptr(), S, W,
             out.data_ptr(), torch.cuda.current_stream(mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    if code is not None:
        kernels.pool_leaf(code, "sum_tree")
    return out


def sum_tree_cuda(code: Optional[kernels.Postfix], mats: Sequence[torch.Tensor],
                  mask: torch.Tensor, plane_mat: torch.Tensor, planes) -> torch.Tensor:
    """Launch K6 on the card, on the current stream, without waiting for
    the device: int64[depth + 1]."""
    out = _sum_launch("sum_tree", code, mats, mask, plane_mat, planes)
    sum_tree_cuda.launches += 1
    return out


sum_tree_cuda.launches = 0


def sum_tree_pool_cuda(code: kernels.Postfix, mats: Sequence[torch.Tensor],
                       mask: torch.Tensor, plane_mat: torch.Tensor, planes) -> torch.Tensor:
    """Launch K6P (``csrc/sum_tree.cu`` sum_tree_pool) on the card:
    ``sum_tree_cuda``'s result for a filter tree with pool leaves, the
    filter's leaves and the planes read at its live blocks only
    (``kernels.live_blocks``); any filter over full-width rows gives K6's
    answer.  Rows are the full WORDS wide; a filter is required."""
    if code is None:
        raise ValueError("K6P takes a filter tree")
    out = _sum_launch("sum_tree_pool", code, mats, mask, plane_mat, planes)
    sum_tree_pool_cuda.launches += 1
    return out


sum_tree_pool_cuda.launches = 0


def _minmax_launch(entry: str, code: Optional[kernels.Postfix], mats: Sequence[torch.Tensor],
                   mask: torch.Tensor, plane_mat: torch.Tensor, planes, is_min: bool):
    """Launch K7 or K7P (C entry ``entry`` of the minmax_tree library):
    (values int64[S], counts int64[S])."""
    tree, pl, S, W = _launch_args(code, mats, mask, plane_mat, planes)
    vals = torch.empty(S, dtype=torch.int64, device=mask.device)
    counts = torch.empty(S, dtype=torch.int64, device=mask.device)
    fn = kernels._lib_fn("minmax_tree", entry, _TREE_ARGS + [_P, _I, _I, _P, _I, _I, _P, _P, _P])
    err = fn(*tree, ctypes.byref(pl), plane_mat.shape[0], int(bool(is_min)),
             mask.contiguous().data_ptr(), S, W, vals.data_ptr(), counts.data_ptr(),
             torch.cuda.current_stream(mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    if code is not None:
        kernels.pool_leaf(code, "minmax_tree")
    return vals, counts


def minmax_tree_cuda(code: Optional[kernels.Postfix], mats: Sequence[torch.Tensor],
                     mask: torch.Tensor, plane_mat: torch.Tensor, planes, is_min: bool):
    """Launch K7 on the card, on the current stream, without waiting for
    the device: (values int64[S], counts int64[S])."""
    out = _minmax_launch("minmax_tree", code, mats, mask, plane_mat, planes, is_min)
    minmax_tree_cuda.launches += 1
    return out


minmax_tree_cuda.launches = 0


def minmax_tree_pool_cuda(code: kernels.Postfix, mats: Sequence[torch.Tensor],
                          mask: torch.Tensor, plane_mat: torch.Tensor, planes, is_min: bool):
    """Launch K7P (``csrc/minmax_tree.cu`` minmax_tree_pool) on the card:
    ``minmax_tree_cuda``'s pairs for a filter tree with pool leaves, the
    filter's leaves and the planes read at its live blocks only
    (``kernels.live_blocks``); any filter over full-width rows gives K7's
    answer.  Rows are the full WORDS wide; a filter is required."""
    if code is None:
        raise ValueError("K7P takes a filter tree")
    out = _minmax_launch("minmax_tree_pool", code, mats, mask, plane_mat, planes, is_min)
    minmax_tree_pool_cuda.launches += 1
    return out


minmax_tree_pool_cuda.launches = 0


def _compiled(prog) -> Optional[kernels.Postfix]:
    if prog is None:
        return None
    code = kernels.compile_prog(prog)
    kernels.check_prog(code)
    return code


def sum_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
             plane_mat: torch.Tensor, planes) -> torch.Tensor:
    """BSI Sum's counts: int64[depth + 1].  CUDA tensors launch K6P for a
    filter with a pool leaf and K6 for any other (or no filter), or raise;
    CPU tensors take the matching plain version."""
    code = _compiled(prog)
    pooled = code is not None and code.pooled
    if mask.is_cuda:
        return (sum_tree_pool_cuda if pooled else sum_tree_cuda)(code, mats, mask, plane_mat,
                                                                 planes)
    return (sum_tree_pool_plain if pooled else sum_tree_plain)(prog, mats, mask, plane_mat,
                                                               planes)


def minmax_tree(prog, mats: Sequence[torch.Tensor], mask: torch.Tensor,
                plane_mat: torch.Tensor, planes, is_min: bool):
    """BSI Min or Max per shard: (values int64[S], counts int64[S]).  CUDA
    tensors launch K7P for a filter with a pool leaf and K7 for any other
    (or no filter), or raise; CPU tensors take the matching plain
    version."""
    code = _compiled(prog)
    pooled = code is not None and code.pooled
    if mask.is_cuda:
        return (minmax_tree_pool_cuda if pooled else minmax_tree_cuda)(
            code, mats, mask, plane_mat, planes, is_min)
    return (minmax_tree_pool_plain if pooled else minmax_tree_plain)(
        prog, mats, mask, plane_mat, planes, is_min)


# -- host decoders (pilosa_tpu/parallel/fusion.py:164-190) ------------------


def decode_sum(host, depth: int, base_min: int):
    """int64[depth + 1] counts (K6's readback) -> (total, count), the
    weighted sum in Python ints: the reference's ``decode_sum``."""
    host = np.asarray(host)
    n = int(host[depth])
    total = sum(int(host[i]) << i for i in range(depth))
    return total + n * base_min, n


def decode_min_max(host, canonical, base_min: int, is_min: bool):
    """(values[S], counts[S]) (K7's readback) -> (value, count): the
    reference's ``decode_min_max``, ValCount's smaller/larger reduce over
    the shards in canonical order, so on a tie across shards the first
    shard's count stands.  (0, 0) when no column was considered."""
    vals, counts = host
    best_val, best_n = 0, 0
    for si in range(len(canonical)):
        n = int(counts[si])
        if n == 0:
            continue
        val = int(vals[si])
        if best_n == 0 or (val < best_val if is_min else val > best_val):
            best_val, best_n = val, n
    if best_n == 0:
        return 0, 0
    return best_val + base_min, best_n
