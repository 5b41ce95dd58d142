"""Dense bitmap row ops on int32 word tensors.

Each 2^20-bit shard row is dense: 32768 words of 32 bits (128 KiB), so a
fragment is ``[n_rows, 32768]`` and a field stack ``[R, S, 32768]``.  The
words live as ``torch.int32``, bit-identical to the little-endian
``uint32`` words of the JAX package (``pilosa_tpu.ops.bitops``): bit ``i``
of a shard lives in word ``i >> 5``, bit position ``i & 31``, so a host
``uint64[16384]`` view and the device ``int32[32768]`` view are the same
bytes.  int32 and not ``torch.uint32``, because PyTorch's CPU build lacks
``~``, ``>>`` and ``+`` for ``uint32``.

PyTorch has no popcount operator.  The plain popcount here is SWAR
(bit-sliced adds) in int64, which keeps the sign bit out of the shifts;
the CUDA kernels of ``parallel/kernels.py`` and ``parallel/sparse.py``
use ``__popc`` instead, and ``popcount_and_rows`` on a card tensor
launches one of them.
"""

from __future__ import annotations

import numpy as np
import torch

SHARD_WIDTH_EXP = 20
SHARD_WIDTH = 1 << SHARD_WIDTH_EXP  # columns per shard (fragment.go:50-51)
WORDS = SHARD_WIDTH // 32  # 32768 32-bit words per shard row
WORDS64 = SHARD_WIDTH // 64  # host-side uint64 words per shard row

# Block-occupancy geometry (the sparsity summary the engine keeps per
# resident field stack).  A shard row's 32768 words split into 64 fixed
# blocks of 512 words (2 KiB, 16384 bit positions); one uint64
# summarizes a whole (row, shard): bit b set <=> block b holds a set bit.
OCC_BLOCK_WORDS = 512  # 32-bit words per occupancy block
OCC_BLOCKS = WORDS // OCC_BLOCK_WORDS  # 64 blocks per (row, shard)
OCC_BLOCK_BITS = OCC_BLOCK_WORDS * 32  # 16384 bit positions per block


def occupancy64(words: np.ndarray) -> int:
    """Block-occupancy bitmap of one dense row: bit b set iff any of the
    row's words in block b is nonzero.  Accepts the uint32[WORDS] view or
    the uint64[WORDS64] host view (same bytes)."""
    w = np.ascontiguousarray(words).view("<u4")
    nz = w.reshape(OCC_BLOCKS, OCC_BLOCK_WORDS).any(axis=1)
    return int(np.packbits(nz, bitorder="little").view("<u8")[0])


def occupancy64_from_positions(positions: np.ndarray) -> int:
    """Block-occupancy bitmap from sorted in-row bit positions (the
    sparse-row fast path: no densify)."""
    if len(positions) == 0:
        return 0
    blocks = np.unique(
        np.asarray(positions, dtype=np.int64) >> np.int64(14)
    )  # 2^14 = OCC_BLOCK_BITS
    out = np.zeros(OCC_BLOCKS, dtype=bool)
    out[blocks] = True
    return int(np.packbits(out, bitorder="little").view("<u8")[0])


# -- host conversions ------------------------------------------------------

def positions_to_words(positions: np.ndarray, width: int = SHARD_WIDTH) -> np.ndarray:
    """Within-shard bit positions -> dense uint32 word vector."""
    bits = np.zeros(width, dtype=np.uint8)
    if len(positions):
        bits[np.asarray(positions, dtype=np.int64)] = 1
    return np.packbits(bits, bitorder="little").view("<u4")


def popcount_np(words: np.ndarray) -> int:
    """Host-side popcount of a word vector (any unsigned dtype)."""
    return int(
        np.sum(np.bitwise_count(words))
        if hasattr(np, "bitwise_count")
        else np.sum(np.unpackbits(np.ascontiguousarray(words).view(np.uint8)))
    )


def words_to_positions(words: np.ndarray) -> np.ndarray:
    """Dense uint32 word vector -> sorted within-shard bit positions."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint64)


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """Host uint32/uint64 words -> int32 tensor on ``device`` (same bytes)."""
    host = np.ascontiguousarray(words).view(np.int32)
    return torch.from_numpy(host).to(device)


def to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> host uint32 array (same bytes)."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


# -- row ops ---------------------------------------------------------------

def row_and(a, b):
    return torch.bitwise_and(a, b)


def row_or(a, b):
    return torch.bitwise_or(a, b)


def row_andnot(a, b):
    return torch.bitwise_and(a, torch.bitwise_not(b))


def row_xor(a, b):
    return torch.bitwise_xor(a, b)


def row_not(a):
    return torch.bitwise_not(a)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit counts of an int32 word tensor, as int64 (SWAR)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 >> 24) & 0xFF


def popcount(words):
    """Total set bits of a word tensor (0-d int64)."""
    return popcount_words(words).sum()


def popcount_and(a, b):
    """Fused intersection count: the Count(Intersect(...)) row op."""
    return popcount_words(torch.bitwise_and(a, b)).sum()


def popcount_rows(matrix):
    """Per-row popcounts of [n_rows, WORDS] -> int64[n_rows]."""
    return popcount_words(matrix).sum(dim=-1)


def popcount_and_rows_plain(matrix, row, rows=None):
    """int32[K] counts of popcount(matrix[rows[k]] & row) (every row when
    ``rows`` is None), in plain PyTorch ops: the CPU path and the
    reference the card's kernel is held against."""
    if rows is not None:
        matrix = matrix[torch.as_tensor(list(rows), dtype=torch.long, device=matrix.device)]
    return popcount_words(torch.bitwise_and(matrix, row[None, :])).sum(dim=-1).to(torch.int32)


def popcount_and_rows(matrix, row, rows=None):
    """Per-row intersection counts int32[K] of [n_rows, WORDS] against one
    row (TopN scoring, fragment.go top :1089): the rows named by index in
    ``rows`` (a sequence of row positions), or every row when it is None.
    On the card it launches P2 (``csrc/and_popcount_rows.cu``, the port of
    the Pallas kernel ``scripts/pallas_vs_xla.py:56
    matrix_and_popcount_pallas``), which reads the named rows in place, or
    raises; on the CPU it runs the plain version."""
    if matrix.is_cuda:
        from ..parallel import kernels  # parallel imports ops: no cycle at load

        return kernels.and_popcount_rows_cuda(matrix, row, rows)
    return popcount_and_rows_plain(matrix, row, rows)


def union_rows(matrix):
    """OR-reduce the rows of [n_rows, WORDS] -> [WORDS]."""
    out = torch.zeros_like(matrix[0])
    for r in range(matrix.shape[0]):
        out = torch.bitwise_or(out, matrix[r])
    return out


def mask_first_n(row, n_bits: int):
    """Zero all bits >= n_bits (Not/Range against partial shards)."""
    if n_bits >= SHARD_WIDTH:
        return row
    full, rem = divmod(n_bits, 32)
    mask = torch.zeros(row.shape[-1], dtype=torch.int64, device=row.device)
    mask[:full] = 0xFFFFFFFF
    if rem and full < row.shape[-1]:
        mask[full] = (1 << rem) - 1
    # Wrap the uint32 mask values into int32 two's complement.
    mask = torch.where(mask >= (1 << 31), mask - (1 << 32), mask)
    return torch.bitwise_and(row, mask.to(torch.int32))


def empty_row(device):
    return torch.zeros(WORDS, dtype=torch.int32, device=device)


def full_row(device):
    return torch.full((WORDS,), -1, dtype=torch.int32, device=device)
