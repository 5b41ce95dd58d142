"""The port's occupancy-guided block count (pilosa_tpu_torch.parallel.sparse)
against the JAX package's XLA block gather (sparse.count_tree_blocks) and
its Pallas kernel (sparse._pallas_shard_count, run in interpret mode as
the JAX package's own tests run it), on the same seeded stacks and blocks.
The JAX side takes per-shard block lists (blk_idx padded to a
power-of-two Kb, blk_n); the port takes the same blocks as one int64 word
per shard (blk_bits, bit b = block b).  Cases: every density from one
block per shard to all 64, shards with no block, masked shards, block 63
(the sign bit), all 64 bits and single bits.  Integer counts: exact
agreement (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pilosa_tpu.parallel import make_mesh
from pilosa_tpu.parallel import sparse as jsparse
from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel import kernels, sparse

S = 8
W = bitops.WORDS
BW = bitops.OCC_BLOCK_WORDS

PROGS = {
    "and": ("and", ("row", 0, 0), ("row", 0, 1)),
    "or": ("or", ("row", 0, 2), ("row", 1, 0)),
    "andnot_zero": ("andnot", ("and", ("row", 0, 0), ("row", 1, 1)), ("zero",)),
    "xor_nested": ("xor", ("row", 1, 2), ("or", ("row", 0, 1), ("row", 0, 3))),
}
# The most blocks a shard marks, as a share of its 64: one block up to all.
DENSITIES = [1 / 64, 2 / 64, 4 / 64, 8 / 64, 16 / 64, 32 / 64, 48 / 64, 1.0]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def stacks():
    """Two stacks uint32[4, S, W] whose rows hold bits in a few blocks
    each, including all-ones and sign-bit-only blocks."""
    rng = np.random.default_rng(41)
    out = []
    for _ in range(2):
        m = np.zeros((4, S, W), np.uint32)
        for r in range(4):
            for s in range(S):
                for b in rng.choice(bitops.OCC_BLOCKS, 12, replace=False):
                    m[r, s, b * BW:(b + 1) * BW] = rng.integers(
                        0, 1 << 32, BW, dtype=np.uint64).astype(np.uint32)
        m[0, 0, :BW] = 0xFFFFFFFF
        m[1, 0, BW:2 * BW] = 0x80000000
        m[:2, :, -BW:] = rng.integers(0, 1 << 32, (2, S, BW), dtype=np.uint64).astype(np.uint32)
        out.append(m)
    return out


def bits_of(blk_idx, blk_n):
    """The port's int64[S] block words of the JAX block lists."""
    words = np.zeros(len(blk_n), np.uint64)
    for s in range(len(blk_n)):
        for b in blk_idx[s, :blk_n[s]]:
            words[s] |= np.uint64(1) << np.uint64(b)
    return torch.from_numpy(words.view(np.int64))


def lists_of(blocks):
    """JAX block lists (blk_idx padded with block 0 to a power-of-two Kb,
    blk_n) of per-shard block id lists."""
    blk_n = np.asarray([len(b) for b in blocks], np.int32)
    most = max(1, int(blk_n.max()))
    blk_idx = np.zeros((len(blocks), 1 << (most - 1).bit_length()), np.int32)
    for s, ids in enumerate(blocks):
        blk_idx[s, :len(ids)] = sorted(ids)
    return blk_idx, blk_n


def block_lists(rng, density, n_shards=S):
    """Ragged lists of at most round(64 * density) blocks: shard 0 full,
    shard 1 empty, the rest random.  Returns (blk_idx, blk_n, blk_bits)."""
    most = max(1, round(bitops.OCC_BLOCKS * density))
    counts = rng.integers(0, most + 1, n_shards)
    counts[0] = most
    counts[1 % n_shards] = 0
    blk_idx, blk_n = lists_of(
        [rng.choice(bitops.OCC_BLOCKS, c, replace=False) for c in counts])
    return blk_idx, blk_n, bits_of(blk_idx, blk_n)


def jax_prog(prog, rowvec):
    if prog[0] == "row":
        rowvec.append(prog[2])
        return ("row", prog[1], len(rowvec) - 1)
    if prog[0] == "zero":
        return prog
    return (prog[0],) + tuple(jax_prog(q, rowvec) for q in prog[1:])


def jax_blocks(mesh, prog, mats, blk_idx, blk_n, mask):
    rowvec = []
    jp = jax_prog(prog, rowvec)
    jmask = np.where(mask[:, None] != 0, 0xFFFFFFFF, 0).astype(np.uint32)
    return int(jsparse.count_tree_blocks(
        mesh, jp,
        put_global(mesh, jmask, P(SHARD_AXIS)),
        put_global(mesh, blk_idx, P(SHARD_AXIS)),
        put_global(mesh, blk_n, P(SHARD_AXIS)),
        put_global(mesh, np.asarray(rowvec, np.int32), P()),
        *[put_global(mesh, m, P(None, SHARD_AXIS)) for m in mats],
    ))


def torch_mats(mats):
    return [torch.from_numpy(m.view(np.int32)) for m in mats]


@pytest.mark.parametrize("density", DENSITIES, ids=lambda d: f"{round(d * 64)}of64")
@pytest.mark.parametrize("prog_name", sorted(PROGS))
def test_blocks_match_xla_reference(mesh, stacks, prog_name, density):
    rng = np.random.default_rng(round(density * 64))
    blk_idx, blk_n, blk_bits = block_lists(rng, density)
    want = jax_blocks(mesh, PROGS[prog_name], stacks, blk_idx, blk_n, np.ones(S, np.int32))
    got = sparse.count_tree_blocks(PROGS[prog_name], torch_mats(stacks), blk_bits)
    assert got.dtype == torch.int64 and int(got) == want


def edge_blocks(rng, pattern):
    """Per-shard block ids and the shard mask of one edge pattern."""
    mask = np.ones(S, np.int32)
    if pattern == "bit63":
        blocks = [[63]] * S
    elif pattern == "all64":
        blocks = [list(range(bitops.OCC_BLOCKS))] * S
    elif pattern == "one_bit":
        blocks = [[int(rng.integers(bitops.OCC_BLOCKS))] for _ in range(S)]
    else:  # "masked": random lists, every other shard unrequested
        blocks = [rng.choice(bitops.OCC_BLOCKS, 16, replace=False) for _ in range(S)]
        mask[1::2] = 0
    return blocks, mask


@pytest.mark.parametrize("pattern", ["bit63", "all64", "one_bit", "masked"])
@pytest.mark.parametrize("prog_name", sorted(PROGS))
def test_block_word_edges_match_xla_reference(mesh, stacks, prog_name, pattern):
    """Block 63 (the word's sign bit), all 64 bits, one bit per shard, and
    masked shards (0 words on the port's side, a separate mask on the
    reference's)."""
    rng = np.random.default_rng(3)
    blocks, mask = edge_blocks(rng, pattern)
    blk_idx, blk_n = lists_of(blocks)
    want = jax_blocks(mesh, PROGS[prog_name], stacks, blk_idx, blk_n, mask)
    blk_bits = bits_of(blk_idx, blk_n * mask)
    if pattern in ("bit63", "all64"):
        assert (blk_bits < 0).all()  # the sign bit is block 63
    got = sparse.count_tree_blocks(PROGS[prog_name], torch_mats(stacks), blk_bits)
    assert int(got) == want


def test_mask_folds_into_block_counts(mesh, stacks):
    """The port folds the requested-shard mask into blk_bits (0 words);
    the reference gates by a separate mask.  Same answer."""
    rng = np.random.default_rng(5)
    blk_idx, blk_n, _ = block_lists(rng, 8 / 64)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 0], np.int32)
    want = jax_blocks(mesh, PROGS["or"], stacks, blk_idx, blk_n, mask)
    got = sparse.count_tree_blocks(PROGS["or"], torch_mats(stacks), bits_of(blk_idx, blk_n * mask))
    assert int(got) == want


@pytest.mark.parametrize("prog_name", sorted(PROGS))
def test_all_blocks_listed_equals_dense(stacks, prog_name):
    blk_bits = torch.full((S,), -1, dtype=torch.int64)  # all 64 bits
    dense = kernels.count_tree(PROGS[prog_name], torch_mats(stacks), torch.ones(S, dtype=torch.int32))
    blocks = sparse.count_tree_blocks(PROGS[prog_name], torch_mats(stacks), blk_bits)
    assert int(blocks) == int(dense)


@pytest.mark.parametrize("density", [1 / 64, 4 / 64], ids=["1of64", "4of64"])
@pytest.mark.parametrize("prog_name", ["and", "andnot_zero"])
def test_blocks_match_pallas_interpret(stacks, prog_name, density):
    """The Pallas kernel this port's K2 replaces, in interpret mode, over
    two shards (its grid runs step by step on the CPU)."""
    rng = np.random.default_rng(100 + round(density * 64))
    mats = [m[:, :2] for m in stacks]
    blk_idx, blk_n, blk_bits = block_lists(rng, density, n_shards=2)
    rowvec = []
    jp = jax_prog(PROGS[prog_name], rowvec)
    want = int(jsparse._pallas_shard_count(
        jp, jnp.asarray(blk_idx), jnp.asarray(blk_n), jnp.asarray(np.asarray(rowvec, np.int32)),
        tuple(jnp.asarray(np.ascontiguousarray(m)) for m in mats), interpret=True,
    ))
    got = sparse.count_tree_blocks(
        PROGS[prog_name], torch_mats([np.ascontiguousarray(m) for m in mats]), blk_bits,
    )
    assert int(got) == want


def test_zero_program_and_empty_lists(stacks):
    none = torch.zeros(S, dtype=torch.int64)
    assert int(sparse.count_tree_blocks(PROGS["and"], torch_mats(stacks), none)) == 0
    assert int(sparse.count_tree_blocks(("zero",), torch_mats(stacks), none + 1)) == 0


def test_plain_reads_only_the_first_blocks_of_a_narrow_row():
    """Bits past the row's block count name no block: a 2-block row
    counts only blocks 0 and 1."""
    m = np.full((1, 2, 2 * BW), 0xFFFFFFFF, np.uint32)
    got = sparse.count_tree_blocks(("row", 0, 0), torch_mats([m]),
                                   torch.tensor([-1, 0b10], dtype=torch.int64))
    assert int(got) == 3 * BW * 32


def test_cuda_wrapper_refuses_cpu_tensors(stacks):
    code = kernels.compile_prog(PROGS["and"])
    with pytest.raises(ValueError, match="on the card"):
        sparse.count_tree_blocks_cuda(code, torch_mats(stacks), torch.zeros(S, dtype=torch.int64))
    assert sparse.count_tree_blocks_cuda.launches == 0
