"""The dense Count(tree) of the port (pilosa_tpu_torch.parallel.kernels)
against the JAX package's count_tree (pilosa_tpu.parallel.kernels:242) on
the 8-device CPU mesh, on the same seeded stacks.  Counts are integers:
exact agreement (tolerance 0).  The CUDA kernel itself runs only on the
card (chip_smoke.py holds it against this plain version there); here the
wrapper takes the plain version because the tensors are on the CPU."""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pilosa_tpu.parallel import kernels as jk
from pilosa_tpu.parallel import make_mesh
from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel import kernels

S = 8  # a multiple of the reference mesh size: no padding on either side
W = bitops.WORDS

PROGS = {
    "and": ("and", ("row", 0, 0), ("row", 0, 1)),
    "or3": ("or", ("row", 0, 0), ("row", 0, 1), ("row", 1, 2)),
    "andnot": ("andnot", ("row", 0, 1), ("row", 1, 0)),
    "xor3": ("xor", ("row", 0, 2), ("row", 0, 3), ("row", 1, 1)),
    "and_zero": ("and", ("row", 0, 0), ("zero",)),
    "or_zero": ("or", ("zero",), ("row", 1, 3)),
    "andnot_zero": ("andnot", ("row", 1, 1), ("zero",)),
    "nested": ("andnot", ("or", ("row", 0, 0), ("row", 1, 1)),
               ("and", ("row", 0, 2), ("xor", ("row", 1, 2), ("row", 0, 3)))),
    "same_leaf": ("and", ("row", 0, 1), ("row", 0, 1)),
    "deep_mixed": ("xor", ("and", ("or", ("row", 0, 0), ("zero",)), ("row", 0, 3)),
                   ("andnot", ("row", 1, 0), ("or", ("row", 1, 1), ("row", 0, 2)))),
    "zero": ("zero",),
}
MASKS = {"all": np.ones(S, np.int32), "none": np.zeros(S, np.int32),
         "some": np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int32)}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def stacks():
    """Two field stacks uint32[4, S, W]: random words, the all-ones and
    sign-bit-only words, an empty row and a block-clustered row."""
    rng = np.random.default_rng(31)
    out = []
    for _ in range(2):
        m = rng.integers(0, 1 << 32, (4, S, W), dtype=np.uint64).astype(np.uint32)
        m[0, 0] = 0xFFFFFFFF
        m[1, 1] = 0x80000000
        m[2, 2] = 0
        m[3, :, : W // 2] = 0
        out.append(m)
    return out


def jax_count(mesh, prog, mats, mask):
    """The reference count_tree on the same stacks and mask: leaves become
    (operand, scalar operand) pairs, zero leaves a zero stack operand."""
    operands = [put_global(mesh, m, P(None, SHARD_AXIS)) for m in mats]
    specs = [P(None, SHARD_AXIS)] * len(mats)
    operands.append(put_global(mesh, np.zeros((1, S, W), np.uint32), P(None, SHARD_AXIS)))
    specs.append(P(None, SHARD_AXIS))
    zero_i = len(operands) - 1

    def conv(p):
        if p[0] == "row":
            operands.append(put_global(mesh, np.int32(p[2]), P()))
            specs.append(P())
            return ("row", p[1], len(operands) - 1)
        if p[0] == "zero":
            return ("zero", zero_i)
        return (p[0],) + tuple(conv(q) for q in p[1:])

    jprog = conv(prog)
    jmask = put_global(
        mesh, np.where(mask[:, None] != 0, 0xFFFFFFFF, 0).astype(np.uint32), P(SHARD_AXIS)
    )
    return int(jk.count_tree(mesh, jprog, tuple(specs), jmask, *operands))


def torch_mats(mats):
    return [torch.from_numpy(m.view(np.int32)) for m in mats]


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("prog_name", sorted(PROGS))
def test_count_tree_matches_reference(mesh, stacks, prog_name, mask_name):
    prog, mask = PROGS[prog_name], MASKS[mask_name]
    want = jax_count(mesh, prog, stacks, mask)
    got = kernels.count_tree(prog, torch_mats(stacks), torch.from_numpy(mask))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want


def interpret_postfix(code, mats, mask):
    """Walk the compiled postfix program the way the CUDA kernels do (a
    stack of word rows), over numpy words: pins the opcode encoding."""
    stack = []
    for c in code.ops:
        op = c & 0xFF
        if op == kernels.OP_LEAF:
            m, r = code.leaves[c >> 8]
            stack.append(mats[m][r])
        elif op == kernels.OP_ZERO:
            stack.append(np.zeros((S, W), np.uint32))
        else:
            b, a = stack.pop(), stack.pop()
            stack.append({kernels.OP_AND: a & b, kernels.OP_OR: a | b,
                          kernels.OP_ANDNOT: a & ~b, kernels.OP_XOR: a ^ b}[op])
    assert len(stack) == 1
    return int(np.bitwise_count(stack[0][mask != 0]).sum())


@pytest.mark.parametrize("prog_name", sorted(PROGS))
def test_postfix_program_matches_plain(stacks, prog_name):
    prog, mask = PROGS[prog_name], MASKS["some"]
    code = kernels.compile_prog(prog)
    kernels.check_prog(code)
    assert len(code.leaves) == len(set(code.leaves))
    want = int(kernels.count_tree_plain(prog, torch_mats(stacks), torch.from_numpy(mask)))
    assert interpret_postfix(code, stacks, mask) == want


def test_postfix_layout():
    code = kernels.compile_prog(("andnot", ("row", 0, 5), ("or", ("row", 1, 2), ("zero",))))
    assert code.ops == [kernels.OP_LEAF | 0 << 8, kernels.OP_LEAF | 1 << 8,
                        kernels.OP_ZERO, kernels.OP_OR, kernels.OP_ANDNOT]
    assert code.leaves == [(0, 5), (1, 2)]
    assert code.depth == 3


def test_depth_cap_raises_before_launch(stacks):
    deep = ("row", 0, 0)
    for _ in range(kernels.MAX_STACK):
        deep = ("and", ("row", 0, 1), deep)
    assert kernels.compile_prog(deep).depth == kernels.MAX_STACK + 1
    assert not kernels.fits(deep)
    with pytest.raises(ValueError, match="stack"):
        kernels.count_tree(deep, torch_mats(stacks), torch.ones(S, dtype=torch.int32))
    # One level less fits, and counts.
    ok = deep[2]
    assert kernels.fits(ok)
    kernels.count_tree(ok, torch_mats(stacks), torch.ones(S, dtype=torch.int32))


def test_leaf_and_length_caps():
    wide = ("or",) + tuple(("row", 0, r) for r in range(kernels.MAX_LEAVES + 1))
    with pytest.raises(ValueError, match="leaf rows"):
        kernels.check_prog(kernels.compile_prog(wide))
    long_zero = ("or",) + (("zero",),) * (kernels.MAX_PROG // 2 + 1)
    with pytest.raises(ValueError, match="ops"):
        kernels.check_prog(kernels.compile_prog(long_zero))
    with pytest.raises(ValueError, match="bad count-tree node"):
        kernels.compile_prog(("nand", ("row", 0, 0), ("row", 0, 1)))


def test_cuda_wrapper_refuses_cpu_tensors(stacks):
    code = kernels.compile_prog(PROGS["and"])
    with pytest.raises(ValueError, match="on the card"):
        kernels.count_tree_dense(code, torch_mats(stacks), torch.ones(S, dtype=torch.int32))
    assert kernels.count_tree_dense.launches == 0
