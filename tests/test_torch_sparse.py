"""The port's occupancy-guided block count (pilosa_tpu_torch.parallel.sparse)
against the JAX package's XLA block gather (sparse.count_tree_blocks) and
its Pallas kernel (sparse._pallas_shard_count, run in interpret mode as
the JAX package's own tests run it), on the same seeded stacks and block
lists: padding slots, shards with no listed block, masked shards and every
Kb tier.  Integer counts: exact agreement (tolerance 0)."""

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
KB_TIERS = [1, 2, 4, 8, 16, 32, 64]


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
        out.append(m)
    return out


def block_lists(rng, kb, n_shards=S):
    """Ragged lists: shard 0 full, shard 1 empty, the rest random; padding
    slots carry block 0."""
    blk_n = rng.integers(0, kb + 1, n_shards).astype(np.int32)
    blk_n[0] = kb
    blk_n[1 % n_shards] = 0
    blk_idx = np.zeros((n_shards, kb), np.int32)
    for s in range(n_shards):
        ids = np.sort(rng.choice(bitops.OCC_BLOCKS, blk_n[s], replace=False))
        blk_idx[s, :blk_n[s]] = ids
    return blk_idx, blk_n


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


@pytest.mark.parametrize("kb", KB_TIERS)
@pytest.mark.parametrize("prog_name", sorted(PROGS))
def test_blocks_match_xla_reference(mesh, stacks, prog_name, kb):
    rng = np.random.default_rng(kb)
    blk_idx, blk_n = block_lists(rng, kb)
    want = jax_blocks(mesh, PROGS[prog_name], stacks, blk_idx, blk_n, np.ones(S, np.int32))
    got = sparse.count_tree_blocks(
        PROGS[prog_name], torch_mats(stacks), torch.from_numpy(blk_idx), torch.from_numpy(blk_n)
    )
    assert got.dtype == torch.int64 and int(got) == want


def test_mask_folds_into_block_counts(mesh, stacks):
    """The port folds the requested-shard mask into blk_n; the reference
    gates by a separate mask.  Same answer."""
    rng = np.random.default_rng(5)
    blk_idx, blk_n = block_lists(rng, 8)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 0], np.int32)
    want = jax_blocks(mesh, PROGS["or"], stacks, blk_idx, blk_n, mask)
    got = sparse.count_tree_blocks(
        PROGS["or"], torch_mats(stacks), torch.from_numpy(blk_idx),
        torch.from_numpy(blk_n * mask),
    )
    assert int(got) == want


@pytest.mark.parametrize("prog_name", sorted(PROGS))
def test_all_blocks_listed_equals_dense(stacks, prog_name):
    blk_idx = np.tile(np.arange(bitops.OCC_BLOCKS, dtype=np.int32), (S, 1))
    blk_n = np.full(S, bitops.OCC_BLOCKS, np.int32)
    dense = kernels.count_tree(PROGS[prog_name], torch_mats(stacks), torch.ones(S, dtype=torch.int32))
    blocks = sparse.count_tree_blocks(
        PROGS[prog_name], torch_mats(stacks), torch.from_numpy(blk_idx), torch.from_numpy(blk_n)
    )
    assert int(blocks) == int(dense)


@pytest.mark.parametrize("kb", [1, 4])
@pytest.mark.parametrize("prog_name", ["and", "andnot_zero"])
def test_blocks_match_pallas_interpret(stacks, prog_name, kb):
    """The Pallas kernel this port's K2 replaces, in interpret mode, over
    two shards (its grid runs step by step on the CPU)."""
    rng = np.random.default_rng(100 + kb)
    mats = [m[:, :2] for m in stacks]
    blk_idx, blk_n = block_lists(rng, kb, n_shards=2)
    rowvec = []
    jp = jax_prog(PROGS[prog_name], rowvec)
    want = int(jsparse._pallas_shard_count(
        jp, jnp.asarray(blk_idx), jnp.asarray(blk_n), jnp.asarray(np.asarray(rowvec, np.int32)),
        tuple(jnp.asarray(np.ascontiguousarray(m)) for m in mats), interpret=True,
    ))
    got = sparse.count_tree_blocks(
        PROGS[prog_name], torch_mats([np.ascontiguousarray(m) for m in mats]),
        torch.from_numpy(blk_idx), torch.from_numpy(blk_n),
    )
    assert int(got) == want


def test_zero_program_and_empty_lists(stacks):
    blk_idx = np.zeros((S, 1), np.int32)
    blk_n = np.zeros(S, np.int32)
    assert int(sparse.count_tree_blocks(PROGS["and"], torch_mats(stacks),
                                        torch.from_numpy(blk_idx), torch.from_numpy(blk_n))) == 0
    assert int(sparse.count_tree_blocks(("zero",), torch_mats(stacks),
                                        torch.from_numpy(blk_idx), torch.from_numpy(blk_n + 1))) == 0


def test_cuda_wrapper_refuses_cpu_tensors(stacks):
    code = kernels.compile_prog(PROGS["and"])
    with pytest.raises(ValueError, match="on the card"):
        sparse.count_tree_blocks_cuda(code, torch_mats(stacks),
                                      torch.zeros((S, 1), dtype=torch.int32),
                                      torch.zeros(S, dtype=torch.int32))
    assert sparse.count_tree_blocks_cuda.launches == 0
