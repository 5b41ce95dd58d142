"""Occupancy-guided Count: read only the occupied 2 KiB blocks.

The engine keeps an exact per-(row, shard) block-occupancy summary on
every resident stack (``bitops.OCC_BLOCKS`` blocks of
``bitops.OCC_BLOCK_WORDS`` words, one uint64 per (row, shard)).  At
dispatch it combines the leaves' occupancy through the tree on the host
(and intersects, or/xor unite, andnot keeps its left side; a BSI range
leaf takes its not-null plane's occupancy, since every range condition
is a subset of not-null) and, when few
enough blocks survive, ships the combined words and calls
``count_tree_blocks`` here instead of the dense ``kernels.count_tree``.

- ``blk_bits int64[S]``, one word per canonical shard: bit b of word s
  means "read block b of shard s" (bit 63 is the sign bit).  The
  requested-shard mask is folded in as 0 words, as
  ``pilosa_tpu/parallel/sparse.py:239`` folds it into ``blk_n``.

For tensors on the card the wrapper launches K2, the CUDA port of the
Pallas kernel ``pilosa_tpu/parallel/sparse.py:164 _pallas_shard_count``
(``csrc/count_tree_blocks.cu``), and raises if it cannot; for tensors on
the CPU it runs the plain PyTorch block gather, the counterpart of the
JAX package's ``count_tree_blocks``.  The JAX package's per-shard block
lists (``blk_idx int32[S, Kb]`` on power-of-two Kb tiers, ``blk_n``)
exist for the TPU's scalar prefetch; the card's kernel reads each shard's
word itself, so the port has no lists.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence, Tuple

import torch

from ..ops import bitops
from . import kernels


def count_tree_blocks_plain(prog, mats: Sequence[torch.Tensor],
                            blk_bits: torch.Tensor) -> torch.Tensor:
    """Gather the marked blocks of every leaf row, combine, popcount and
    sum, in plain PyTorch ops."""
    device = blk_bits.device
    zero = torch.zeros((), dtype=torch.int64, device=device)
    if prog[0] == "zero":
        return zero
    S = blk_bits.shape[0]
    n_blocks = (mats[0].shape[2] if mats else bitops.WORDS) // bitops.OCC_BLOCK_WORDS
    bit = torch.arange(n_blocks, device=device)
    s_idx, b_idx = torch.nonzero((blk_bits.long()[:, None] >> bit) & 1, as_tuple=True)

    def select(row_words):  # [S, W] -> [n_marked, OCC_BLOCK_WORDS]
        return row_words.reshape(S, n_blocks, bitops.OCC_BLOCK_WORDS)[s_idx, b_idx]

    out = kernels.eval_prog(prog, mats, select)
    if out is None:
        return zero
    return bitops.popcount_words(out).sum()


# K2's scratch word, per (device, stream): its CTAs' sums and arrivals,
# which each launch leaves at 0.  Zeroed once.  Launches on one stream run
# one after another, so two K2 launches never share a word at the same time.
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}
_scratch_lock = threading.Lock()


def _scratch_for(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    with _scratch_lock:
        buf = _scratch.get(key)
        if buf is None:
            buf = _scratch[key] = torch.zeros(1, dtype=torch.int64, device=device)
        return buf


def count_tree_blocks_cuda(code: kernels.Postfix, mats: Sequence[torch.Tensor],
                           blk_bits: torch.Tensor) -> torch.Tensor:
    """Launch K2 on the card, on the current stream: returns a 0-d int64
    tensor, without waiting for the device."""
    if (not blk_bits.is_cuda or blk_bits.dtype != torch.int64 or blk_bits.dim() != 1
            or not blk_bits.is_contiguous()):
        raise ValueError("blk_bits must be a contiguous int64[S] tensor on the card")
    n_shards = blk_bits.shape[0]
    words = kernels.check_stacks(mats, n_shards, code)
    if words % bitops.OCC_BLOCK_WORDS or not 1 <= words // bitops.OCC_BLOCK_WORDS <= 64:
        raise ValueError(f"row width {words} is not 1..64 blocks of {bitops.OCC_BLOCK_WORDS} words")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = kernels._lib_fn("count_tree_blocks", "count_tree_blocks",
                         kernels._TREE_ARGS + [P, I, I, P, P, P])
    dev = blk_bits.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(1, dtype=torch.int64, device=dev)
    scratch = _scratch_for(dev, stream)
    err = fn(*kernels._c_leaves(code, mats), blk_bits.data_ptr(), n_shards, words,
             scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"count_tree_blocks launch failed: cudaError {err}")
    count_tree_blocks_cuda.launches += 1
    kernels.range_leaf(code)
    kernels.pool_leaf(code, "count_tree_blocks")
    return out[0]


count_tree_blocks_cuda.launches = 0


def count_tree_blocks(prog, mats: Sequence[torch.Tensor], blk_bits: torch.Tensor) -> torch.Tensor:
    """Count(tree) over the marked blocks only.  CUDA tensors launch K2 or
    raise; CPU tensors take the plain version."""
    code = kernels.compile_prog(prog)
    kernels.check_prog(code)
    if blk_bits.is_cuda:
        return count_tree_blocks_cuda(code, mats, blk_bits)
    return count_tree_blocks_plain(prog, mats, blk_bits)
