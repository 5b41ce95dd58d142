"""Occupancy-guided Count: read only the occupied 2 KiB blocks.

The engine keeps an exact per-(row, shard) block-occupancy summary on
every resident stack (``bitops.OCC_BLOCKS`` blocks of
``bitops.OCC_BLOCK_WORDS`` words).  At dispatch it combines the leaves'
occupancy through the tree on the host (and intersects, or/xor unite,
andnot keeps its left side) and, when few enough blocks survive, ships
per-shard block lists and calls ``count_tree_blocks`` here instead of the
dense ``kernels.count_tree``.

- ``blk_idx int32[S, Kb]`` lists block ids per canonical shard; slots at
  or past ``blk_n[s]`` are padding and add nothing.  Kb is a power of two
  (the planner's tiers), so launches differ only in tier, never in the
  block pattern.
- ``blk_n int32[S]`` has the requested-shard mask folded in (0 for
  unrequested shards), as ``pilosa_tpu/parallel/sparse.py:239`` does.

For tensors on the card the wrapper launches K2, the CUDA port of the
Pallas kernel ``pilosa_tpu/parallel/sparse.py:164 _pallas_shard_count``
(``csrc/count_tree_blocks.cu``), and raises if it cannot; for tensors on
the CPU it runs the plain PyTorch block gather, the counterpart of the
JAX package's ``count_tree_blocks``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..ops import bitops
from . import kernels


def count_tree_blocks_plain(prog, mats: Sequence[torch.Tensor],
                            blk_idx: torch.Tensor, blk_n: torch.Tensor) -> torch.Tensor:
    """Gather the listed blocks of every leaf row, combine, popcount and
    sum the valid slots, in plain PyTorch ops."""
    device = blk_n.device
    if prog[0] == "zero":
        return torch.zeros((), dtype=torch.int64, device=device)
    S, Kb = blk_idx.shape
    gather = blk_idx.long()[:, :, None].expand(S, Kb, bitops.OCC_BLOCK_WORDS)

    def select(row_words):  # [S, W] -> [S, Kb, OCC_BLOCK_WORDS]
        blocks = row_words.reshape(S, -1, bitops.OCC_BLOCK_WORDS)
        return torch.gather(blocks, 1, gather)

    out = kernels.eval_prog(prog, mats, select)
    if out is None:
        return torch.zeros((), dtype=torch.int64, device=device)
    per_slot = bitops.popcount_words(out).sum(dim=-1)  # [S, Kb]
    valid = torch.arange(Kb, device=device)[None, :] < blk_n.long()[:, None]
    return torch.where(valid, per_slot, torch.zeros_like(per_slot)).sum()


def count_tree_blocks_cuda(code: kernels.Postfix, mats: Sequence[torch.Tensor],
                           blk_idx: torch.Tensor, blk_n: torch.Tensor) -> torch.Tensor:
    """Launch K2 on the card: returns a 0-d int64 tensor, without waiting
    for the device."""
    for t, name in ((blk_idx, "blk_idx"), (blk_n, "blk_n")):
        if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on the card")
    if blk_idx.dim() != 2 or blk_n.shape != (blk_idx.shape[0],):
        raise ValueError("blk_idx must be int32[S, Kb] and blk_n int32[S]")
    n_shards, kb = blk_idx.shape
    words = kernels.check_stacks(mats, n_shards)
    if kb < 1 or kb > words // bitops.OCC_BLOCK_WORDS:
        raise ValueError(f"Kb={kb} outside 1..{words // bitops.OCC_BLOCK_WORDS}")
    for m, r in code.leaves:
        if not 0 <= r < mats[m].shape[0]:
            raise ValueError(f"leaf row {r} outside stack of {mats[m].shape[0]} rows")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = kernels._lib_fn("count_tree_blocks", "count_tree_blocks",
                         [P, I, P, I, P, P, I, I, I, P, P])
    out = torch.zeros(1, dtype=torch.int64, device=blk_n.device)
    leaf_arr, ops_arr = kernels._c_leaves(code, mats)
    stream = torch.cuda.current_stream(blk_n.device).cuda_stream
    err = fn(
        leaf_arr, len(code.leaves), ops_arr, len(code.ops), blk_idx.data_ptr(),
        blk_n.data_ptr(), n_shards, kb, words, out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"count_tree_blocks launch failed: cudaError {err}")
    count_tree_blocks_cuda.launches += 1
    return out[0]


count_tree_blocks_cuda.launches = 0


def count_tree_blocks(prog, mats: Sequence[torch.Tensor], blk_idx: torch.Tensor,
                      blk_n: torch.Tensor) -> torch.Tensor:
    """Count(tree) over the listed blocks only.  CUDA tensors launch K2 or
    raise; CPU tensors take the plain version."""
    code = kernels.compile_prog(prog)
    kernels.check_prog(code)
    if blk_n.is_cuda:
        return count_tree_blocks_cuda(code, mats, blk_idx, blk_n)
    return count_tree_blocks_plain(prog, mats, blk_idx, blk_n)
