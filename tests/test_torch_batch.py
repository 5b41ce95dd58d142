"""Batched Counts of the port (count_many, the K5 batch program and its
plain version, the executor's multi-Count runs, the micro-batcher, the
result memo, singleflight) against the JAX package on the same seeded data:
``MeshEngine.count_many``/``count`` and ``Executor`` of ``pilosa_tpu`` on
the 8-device CPU mesh, and ``kernels.count_batch_tree`` of
``pilosa_tpu.parallel.kernels:255`` for the plain batch program.  Counts are
integers: exact agreement (tolerance 0).  K5 itself runs only on the card
(chip_smoke.py holds it against ``count_batch_tree_plain`` there); here the
wrappers take the plain version because the tensors are on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pilosa_tpu import pql as jpql
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel import kernels as jk
from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor.executor import Executor as TExecutor
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.ops import bsi as tbsi
from pilosa_tpu_torch.parallel import kernels
from pilosa_tpu_torch.parallel.engine import TorchEngine, UnsupportedLowering

SW = bitops.SHARD_WIDTH
N_SHARDS = 8
SHARDS = list(range(N_SHARDS))

QUERIES = [
    "Row(f=10)",
    "Intersect(Row(f=10), Row(f=11))",
    "Union(Row(f=10), Row(f=11))",
    "Difference(Row(f=10), Row(f=11))",
    "Xor(Row(f=10), Row(f=11))",
    "Not(Row(f=11))",
    "Intersect(Union(Row(f=10), Row(f=12)), Difference(Row(f=11), Row(f=13)))",
]


def fill(holder, seed=11):
    """Index "i": field f, rows 10-13 with overlapping random columns in
    each of 8 shards, row 12 only in even shards; existence for every set
    column."""
    rng = np.random.default_rng(seed)
    idx = holder.create_index("i")
    f = idx.create_field("f")
    rows, cols = [], []
    for s in range(N_SHARDS):
        picks = s * SW + rng.choice(SW, size=400, replace=False)
        for r, sl in ((10, slice(0, 250)), (11, slice(150, 400)), (13, slice(100, 300))):
            rows += [r] * len(picks[sl])
            cols += picks[sl].tolist()
        if s % 2 == 0:
            rows += [12] * 60
            cols += picks[::7][:60].tolist()
    f.import_bulk(rows, cols)
    idx.existence_field().import_bulk([0] * len(cols), cols)
    return holder


def twins():
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    return fill(jh), fill(th)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture
def pair(mesh):
    """(JAX MeshEngine, its Executor, port TorchEngine, its Executor) over
    twin holders."""
    jh, th = twins()
    jeng = MeshEngine(jh, mesh)
    teng = TorchEngine(th, device="cpu")
    yield jeng, JExecutor(jh, mesh_engine=jeng), teng, TExecutor(th, engine=teng)
    teng.close()


def jcall(q):
    return jpql.parse(q).calls[0]


def tcall(q):
    return tpql.parse(q).calls[0]


# -- the batch program: plain version against the reference program ----------

W = bitops.WORDS
S = 8


@pytest.fixture(scope="module")
def stacks():
    """Two field stacks uint32[4, S, W]: random words, all-ones and
    sign-bit-only words, an empty row and a half-empty row."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        m = rng.integers(0, 1 << 32, (4, S, W), dtype=np.uint64).astype(np.uint32)
        m[0, 0] = 0xFFFFFFFF
        m[1, 1] = 0x80000000
        m[2, 2] = 0
        m[3, :, : W // 2] = 0
        out.append(m)
    return out


BATCH_PROGS = [
    ("and", ("row", 0, 0), ("row", 0, 1)),
    ("or", ("row", 0, 0), ("row", 0, 1), ("row", 1, 2)),
    ("andnot", ("or", ("row", 0, 0), ("row", 1, 1)),
     ("and", ("row", 0, 2), ("xor", ("row", 1, 2), ("row", 0, 3)))),
    ("zero",),
    ("row", 1, 3),
    ("and", ("row", 0, 0), ("row", 0, 1)),  # a duplicate of query 0
    ("xor", ("row", 0, 2), ("zero",), ("row", 1, 1)),
]
BATCH_MASKS = np.array([
    [1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0],
    [1, 0, 1, 1, 0, 0, 1, 0],
    [0, 0, 0, 0, 0, 1, 0, 0],
], dtype=bool)
BATCH_MASK_IDS = [0, 2, 3, 0, 1, 0, 2]


def jax_count_batch(mesh, progs, mask_ids, mats, masks, table=None):
    """The reference count_batch_tree on the same stacks: each leaf a
    (stack operand, scalar row operand) pair, a pool row a (pool operand,
    slot vector operand) pair (``table`` the slot table, its place in
    ``mats`` None), a range leaf its stack operand, its planes' gather and
    its predicate bits (``ops.bsi.to_bits``), zero leaves a zero stack,
    one uint32[S, 1] mask operand per distinct mask."""
    from pilosa_tpu.ops import bsi as jbsi

    operands = [put_global(mesh, m if m is not None else np.zeros((1, S, W), np.uint32),
                           P(None, SHARD_AXIS)) for m in mats]
    specs = [P(None, SHARD_AXIS)] * len(mats)
    operands.append(put_global(mesh, np.zeros((1, S, W), np.uint32), P(None, SHARD_AXIS)))
    specs.append(P(None, SHARD_AXIS))
    zero_i = len(operands) - 1
    mask_ops = []
    for m in masks:
        operands.append(put_global(mesh, np.where(m[:, None], 0xFFFFFFFF, 0).astype(np.uint32),
                                   P(SHARD_AXIS)))
        specs.append(P(SHARD_AXIS))
        mask_ops.append(len(operands) - 1)

    def add(value):
        operands.append(put_global(mesh, value, P()))
        specs.append(P())
        return len(operands) - 1

    def conv(p):
        if p[0] == "row":
            return ("row", p[1], add(np.int32(p[2])))
        if p[0] == "rowb":
            return ("rowb", p[1], add(table[p[3]]))
        if p[0] == "range":
            _, kind, m, planes, lo, hi = p
            depth, spec = len(planes) - 1, ("gather", tuple(planes))
            if kind == "between":
                return ("between", m, spec, add(jbsi.to_bits(lo, depth)),
                        add(jbsi.to_bits(hi, depth)))
            return ("range", kind, m, spec, add(jbsi.to_bits(lo, depth)))
        if p[0] == "zero":
            return ("zero", zero_i)
        return (p[0],) + tuple(conv(q) for q in p[1:])

    jprogs = tuple((conv(p), mask_ops[i]) for p, i in zip(progs, mask_ids))
    return [int(v) for v in np.asarray(jk.count_batch_tree(mesh, jprogs, tuple(specs), *operands))]


def torch_mats(mats):
    return [torch.from_numpy(m.view(np.int32)) for m in mats]


def test_count_batch_tree_plain_matches_reference(mesh, stacks):
    want = jax_count_batch(mesh, BATCH_PROGS, BATCH_MASK_IDS, stacks, BATCH_MASKS)
    got = kernels.count_batch_tree(BATCH_PROGS, torch_mats(stacks), BATCH_MASKS,
                                   BATCH_MASK_IDS, "cpu")
    assert got.dtype == torch.int64 and got.tolist() == want
    assert want[0] == want[5] and want[3] == 0
    # The fan-out: answer i is query out_index[i]'s.
    fan = [6, 0, 0, 3, 2]
    got = kernels.count_batch_tree(BATCH_PROGS, torch_mats(stacks), BATCH_MASKS,
                                   BATCH_MASK_IDS, "cpu", out_index=fan)
    assert got.tolist() == [want[i] for i in fan]
    assert kernels.count_batch_tree_cuda.launches == 0


def walk_np(walk, planes):
    """A range leaf's walk form (``BatchProgram.walks``: lo, hi, class |
    flags) over numpy planes uint32[depth + 1, W], as K5's grouped pass
    walks it (csrc/count_batch_tree.cu walk_range): a chain over the value
    planes, low bit first, comparing the value's low bits with the
    predicate's (equal; >=, or > when strict; <=, or <; BETWEEN both), then
    the not-null plane (neq: not-null and not equal)."""
    lo, hi, form = (int(x) for x in walk)
    depth = planes.shape[0] - 1
    nn = planes[depth]
    ones = np.full_like(nn, 0xFFFFFFFF)
    c = np.zeros_like(nn) if form & kernels.WALK_STRICT else ones.copy()
    c2 = ones.copy()
    cls = form & 0xFF
    for i in range(depth):
        v, m = planes[i], ones if (lo >> i) & 1 else np.zeros_like(nn)
        if cls == kernels.WALK_EQ:
            c &= ~(v ^ m)
        elif cls == kernels.WALK_LE:
            c = np.where(m != 0, ~v | c, ~v & c)
        else:
            c = np.where(m != 0, v & c, v | c)
        if cls == kernels.WALK_BETWEEN:
            c2 = np.where((hi >> i) & 1, ~v | c2, ~v & c2)
    return nn & ~c if form & kernels.WALK_NEG else nn & c & c2


def interpret_batch(batch, mats, mask_words, s):
    """Every query's count over shard ``s`` as K5 reads its batch: the
    leaf table (the rows read as rows first, a pool row through its slot
    vector), each query's (offset, length, mask id, chain) and postfix ops
    whose leaf opcodes index the table, mask bit s; each range group's
    planes (-1 a zero row) gathered once and every condition of the group
    walked once in its walk form (``walk_np``), a query's range leaf then
    reading its condition's result row."""
    def plane(l):
        if l < 0:
            return np.zeros(W, np.uint32)
        m, r = batch.leaves[l]
        return mats[m][r, s]

    def leaf(l):
        if len(batch.leaves[l]) == 3:
            m, r, t = batch.leaves[l]
            row = kernels.pool_row(torch.from_numpy(mats[m].view(np.int32)),
                                   torch.from_numpy(np.asarray(mats[t][r])))
            return row[s].numpy().view(np.uint32)
        return plane(l)

    result = {}
    for first, count, depth, off in batch.groups.tolist():
        planes = np.stack([plane(l) for l in batch.planes[off: off + depth + 1]])
        for c in range(first, first + count):
            lo, hi, kd, at = batch.ranges[c].tolist()
            assert at == off and kd >> 8 == depth  # the group's planes, read once
            result[c] = walk_np(batch.walks[c], planes)
    out = []
    for off, n, mid, _chain in batch.qinfo.tolist():
        if not (int(mask_words[mid, s >> 5]) >> (s & 31)) & 1:
            out.append(0)
            continue
        stack = []
        for code in batch.ops[off: off + n].tolist():
            op = code & 0xFF
            if op in (kernels.OP_LEAF, kernels.OP_ROWB):
                assert code >> 8 < batch.n_rows  # a row read as a row is staged
                stack.append(leaf(code >> 8))
            elif op == kernels.OP_ZERO:
                stack.append(np.zeros(W, np.uint32))
            elif op == kernels.OP_RANGE:
                stack.append(result[code >> 8])
            else:
                b, a = stack.pop(), stack.pop()
                stack.append({kernels.OP_AND: a & b, kernels.OP_OR: a | b,
                              kernels.OP_ANDNOT: a & ~b, kernels.OP_XOR: a ^ b}[op])
        out.append(int(np.bitwise_count(stack[0]).sum()))
    return out


def test_compiled_batch_matches_plain(stacks):
    """The batch layout K5 reads (one leaf table shared by every query,
    per-query programs, mask bits) evaluates to the plain answers, and a
    leaf row read by several queries appears once in the table."""
    batch = kernels.compile_batch(BATCH_PROGS, BATCH_MASK_IDS)
    assert len(batch.leaves) == len(set(batch.leaves)) == 7
    assert batch.qinfo[:, 3].tolist() == [1, 1, 0, 1, 1, 1, 1]  # chain forms
    words = kernels.mask_bits(BATCH_MASKS)
    assert words.shape == (4, 1) and words[2, 0] == 0b01001101
    want = kernels.count_batch_tree_plain(BATCH_PROGS, torch_mats(stacks), BATCH_MASKS,
                                          BATCH_MASK_IDS, "cpu").tolist()
    per_shard = [interpret_batch(batch, stacks, words, s) for s in range(S)]
    assert [sum(col) for col in zip(*per_shard)] == want


# -- range leaves in the batch program ------------------------------------------

DEPTH = 5
FULL = tuple(range(DEPTH + 1))  # value planes 0..4, then the not-null plane
GAP = (0, 1, -1, 3, 4, 5)  # a value plane the stack lacks
NN_GONE = (0, 1, 2, 3, 4, -1)  # no not-null plane: every condition is empty


@pytest.fixture(scope="module")
def bsi_stack():
    """A BSI stack uint32[DEPTH + 1, S, W] (mats[2]): random planes, shard
    0 every plane all ones, shard 1 the sign bit only, shard 2 all zero,
    shard 3 not-null all ones."""
    rng = np.random.default_rng(9)
    m = rng.integers(0, 1 << 32, (DEPTH + 1, S, W), dtype=np.uint64).astype(np.uint32)
    m[:, 0] = 0xFFFFFFFF
    m[:, 1] = 0x80000000
    m[:, 2] = 0
    m[DEPTH, 3] = 0xFFFFFFFF
    return m


def rg(kind, lo, hi=0, planes=FULL, slot=2):
    return ("range", kind, slot, planes, lo, hi if kind == "between" else 0)


RANGE_PROGS = [
    rg("eq", 7), rg("neq", 7), rg("lt", 9), rg("lte", 9), rg("gt", 21), rg("gte", 21),
    rg("between", 4, 26), rg("eq", 0), rg("lt", 0), rg("gte", 31), rg("between", 31, 0),
    rg("gt", 12, planes=GAP), rg("lte", 12, planes=NN_GONE), rg("between", 2, 17, planes=GAP),
    ("and", rg("gt", 3), rg("lt", 20)),  # two ranges over one field
    ("or", ("row", 0, 1), rg("eq", 5)),  # a range beside rows
    ("andnot", ("row", 1, 0), rg("neq", 2)),
    ("xor", ("and", ("row", 0, 2), rg("gte", 8)), ("or", rg("lt", 3), ("row", 1, 3))),
    ("and", rg("gt", 1), rg("lt", 30), rg("neq", 4), rg("between", 2, 28)),  # four
    rg("gt", 21),  # a repeat: one range record, its planes staged once
]


def test_count_batch_tree_plain_with_ranges_matches_reference(mesh, stacks, bsi_stack):
    """Range leaves of every kind, a missing value plane and a missing
    not-null plane, two ranges over one field, ranges beside rows, in chain
    and interpreter trees, against the reference's count_batch_tree."""
    mats = stacks + [bsi_stack]
    ids = [k % len(BATCH_MASKS) for k in range(len(RANGE_PROGS))]
    want = jax_count_batch(mesh, RANGE_PROGS, ids, mats, BATCH_MASKS)
    got = kernels.count_batch_tree(RANGE_PROGS, torch_mats(mats), BATCH_MASKS, ids, "cpu")
    assert got.tolist() == want
    assert any(want) and kernels.count_batch_tree_cuda.launches == 0
    every = [0] * len(RANGE_PROGS)
    assert (kernels.count_batch_tree(RANGE_PROGS, torch_mats(mats), BATCH_MASKS, every,
                                     "cpu").tolist()
            == jax_count_batch(mesh, RANGE_PROGS, every, mats, BATCH_MASKS))


def test_compiled_batch_with_ranges_matches_plain(stacks, bsi_stack):
    """The range leaves as K5 reads them: one record per distinct
    condition, its planes as leaf-table rows shared with every query and
    with the row leaves (a missing plane -1), evaluated from the table."""
    mats = stacks + [bsi_stack]
    progs = RANGE_PROGS + [("or", ("row", 2, 3), rg("gt", 21))]  # a plane as a row leaf
    ids = [k % len(BATCH_MASKS) for k in range(len(progs))]
    batch = kernels.compile_batch(progs, ids)
    # The 6 planes (one of them also a row leaf) and 4 rows of the two
    # stacks, each once, the 5 rows read as rows first.
    assert len(batch.leaves) == len(set(batch.leaves)) == 10 and batch.n_rows == 5
    assert batch.ranges.shape[0] == len({p for t in RANGE_PROGS for p in kernels.compile_prog(
        t).ranges})
    kd = batch.ranges[:, 2]
    assert set((kd >> 8).tolist()) == {DEPTH}
    # One group per plane list (FULL, GAP, NN_GONE), each list once.
    assert batch.groups.shape[0] == 3 and batch.groups[:, 1].sum() == batch.ranges.shape[0]
    assert (batch.planes == -1).sum() == 2
    words = kernels.mask_bits(BATCH_MASKS)
    want = kernels.count_batch_tree_plain(progs, torch_mats(mats), BATCH_MASKS, ids,
                                          "cpu").tolist()
    per_shard = [interpret_batch(batch, mats, words, s) for s in range(S)]
    assert [sum(col) for col in zip(*per_shard)] == want


def test_batch_of_ranges_reads_planes_once():
    """Eight conditions on one field put its planes in the table once; the
    groups count planes as rows."""
    progs = [rg("gt", x) for x in range(0, 32, 4)]
    batch = kernels.compile_batch(progs, [0] * 8)
    assert batch.leaves == [(2, p) for p in FULL] and batch.ranges.shape[0] == 8
    assert kernels.batch_groups(progs) == [(0, 8)]
    deep = tuple(range(64))
    wide = [rg("gt", 5, planes=deep, slot=k) for k in range(3)]
    assert len(kernels.compile_batch(wide, [0, 0, 0]).leaves) == 192


def test_batch_past_the_stage_with_ranges():
    """Three depth-63 ranges over three stacks (192 plane rows in the
    table, none of them staged: the grouped pass reads planes from device
    memory) beside row leaves take the stage; 64 more rows read as rows
    (twice 65 staged rows and the range rows, past the 128-row stage) take
    the kernel's direct path.  Either way the plain answers equal each
    query's own count and the group walk's, and the table holds every
    plane once."""
    rng = np.random.default_rng(4)
    deep = tuple(range(64))
    mats = [torch.from_numpy(rng.integers(0, 1 << 32, (64, 2, W), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)) for _ in range(3)]
    progs = [rg(k, (1 << 62) + 12345 * i, 1 << 61, planes=deep, slot=i % 3)
             for i, k in enumerate(tbsi.RANGE_KINDS)]
    progs += [("and", progs[0], progs[1]), ("or", ("row", 0, 70 - 64), progs[5])]
    wide = progs + [("or",) + tuple(("row", 1, r) for r in range(32)),
                    ("and", progs[3], ("or",) + tuple(("row", 1, r) for r in range(32, 64)))]
    masks = np.array([[1, 1], [0, 1]], dtype=bool)
    dev_masks = torch.from_numpy(masks.astype(np.int32))
    words = kernels.mask_bits(masks)
    np_mats = [m.numpy().view(np.uint32) for m in mats]
    for batch_progs, staged in ((progs, True), (wide, False)):
        ids = [k % 2 for k in range(len(batch_progs))]
        batch = kernels.compile_batch(batch_progs, ids)
        # Every row read as a row is a plane too: 1 staged (plane 6 of
        # stack 0), then 64 more (stack 1's).
        assert len(batch.leaves) == 192 and batch.n_rows == (1 if staged else 65)
        assert (kernels.batch_tile(batch) > 0) == staged
        got = kernels.count_batch_tree(batch_progs, mats, masks, ids, "cpu").tolist()
        assert got == [int(kernels.count_tree_plain(p, mats, dev_masks[i]))
                       for p, i in zip(batch_progs, ids)]
        per_shard = [interpret_batch(batch, np_mats, words, s) for s in range(2)]
        assert [sum(col) for col in zip(*per_shard)] == got
    assert kernels.fits(progs[-1])
    five = ("or",) + tuple(rg("gt", k) for k in range(5))
    assert not kernels.fits(five)
    with pytest.raises(ValueError, match="range leaves"):
        kernels.compile_batch([five], [0])


def random_bsi(rng, depth, S_=S):
    """A BSI stack uint32[depth + 1, S_, W]: random value planes, the
    not-null plane about three quarters set; shard 0 every plane all ones,
    shard 1 all zero."""
    m = rng.integers(0, 1 << 32, (depth + 1, S_, W), dtype=np.uint64).astype(np.uint32)
    m[depth] |= rng.integers(0, 1 << 32, (S_, W), dtype=np.uint64).astype(np.uint32)
    m[:, 0] = 0xFFFFFFFF
    m[:, 1] = 0
    return m


def check_grouped(mesh, progs, mats, reference=True):
    """A batch's plain answers against the reference's count_batch_tree
    (``reference``), count_tree_plain per query and the group walk per
    shard (interpret_batch); returns the compiled batch and the answers."""
    ids = [k % len(BATCH_MASKS) for k in range(len(progs))]
    got = kernels.count_batch_tree(progs, torch_mats(mats), BATCH_MASKS, ids, "cpu").tolist()
    if reference:
        assert got == jax_count_batch(mesh, progs, ids, mats, BATCH_MASKS)
    dev_masks = torch.from_numpy(BATCH_MASKS.astype(np.int32))
    assert got == [int(kernels.count_tree_plain(p, torch_mats(mats), dev_masks[i]))
                   for p, i in zip(progs, ids)]
    batch = kernels.compile_batch(progs, ids)
    words = kernels.mask_bits(BATCH_MASKS)
    per_shard = [interpret_batch(batch, mats, words, s) for s in range(S)]
    assert [sum(col) for col in zip(*per_shard)] == got
    return batch, got


@pytest.mark.parametrize("depth", [1, 8, 63])
def test_grouped_pass_every_kind(mesh, stacks, depth):
    """Every RANGE_KINDS entry at the extreme predicates (0, 1, the top
    value and the one under it) and a drawn one over one field: one group,
    each distinct condition walked once in its walk form (strict ones
    empty at the edges); beside rows too."""
    rng = np.random.default_rng(100 + depth)
    full = tuple(range(depth + 1))
    top = (1 << depth) - 1
    preds = sorted({0, 1, top, top - 1, int(rng.integers(0, top + 1))})
    progs = [rg(kind, lo, preds[(j + 2) % len(preds)], planes=full)
             for kind in tbsi.RANGE_KINDS for j, lo in enumerate(preds)]
    progs += [("and", ("row", 0, 1), rg("gt", preds[-2], planes=full)),
              ("or", rg("lt", 1, planes=full), ("row", 1, 2))]
    batch, got = check_grouped(mesh, progs, stacks + [random_bsi(rng, depth)],
                               reference=True)
    assert batch.groups.tolist() == [[0, batch.ranges.shape[0], depth, 0]]
    assert any(got) and any(w & kernels.WALK_STRICT for w in batch.walks[:, 2].tolist())


def test_grouped_pass_two_fields(mesh, stacks):
    """Conditions on two fields in one batch (depths 8 and 5): a group
    each, a condition repeated across queries walked once, a plane that is
    also a row leaf staged as a row, and a missing plane."""
    rng = np.random.default_rng(21)
    v8, v5 = random_bsi(rng, 8), random_bsi(rng, 5)
    f8, f5 = tuple(range(9)), (0, 1, -1, 3, 4, 5)
    a, b = ("range", "gt", 2, f8, 100, 0), ("range", "between", 3, f5, 3, 20)
    progs = [a, b, ("and", a, b), ("or", ("row", 2, 4), b), ("andnot", a, ("row", 3, 5)),
             ("range", "lte", 3, f5, 9, 0), a, ("xor", ("row", 0, 1), a, b)]
    batch, got = check_grouped(mesh, progs, stacks + [v8, v5])
    assert batch.groups[:, 1].tolist() == [1, 2] and batch.ranges.shape[0] == 3
    # Plane 4 of v8 is a row leaf as well: staged as a row, walked from
    # device memory; every other plane is read by the pass alone.
    assert (2, 4) in batch.leaves[:batch.n_rows] and (2, 3) in batch.leaves[batch.n_rows:]
    assert (batch.planes == -1).sum() == 1 and any(got)


def test_grouped_pass_twelve_conditions(mesh, stacks):
    """Twelve conditions on one field, one group: each walked once per
    position from the same plane words."""
    rng = np.random.default_rng(12)
    full = tuple(range(9))
    progs = [rg(tbsi.RANGE_KINDS[k % 7], int(x), int(x) + 40, planes=full)
             for k, x in enumerate(np.linspace(3, 250, 12).astype(int))]
    batch, got = check_grouped(mesh, progs, stacks + [random_bsi(rng, 8)])
    assert batch.groups.tolist() == [[0, 12, 8, 0]] and batch.n_rows == 0
    assert kernels.batch_tile(batch) == 256  # 12 range rows of 256 positions: 48 KiB


@pytest.mark.parametrize("kind", list(tbsi.RANGE_KINDS))
def test_walk_form_matches_range_rows(kind):
    """walk_form's chains (strict ones starting empty, neq a negated eq,
    depth 0's not-null plane) walked by walk_np equal ops.bsi.range_rows
    for every predicate of depths 0 to 3 and high bits past the depth."""
    rng = np.random.default_rng(7)
    for depth in range(4):
        planes = rng.integers(0, 1 << 32, (depth + 1, 64), dtype=np.uint64).astype(np.uint32)
        for lo in range(1 << depth):
            for hi in ((1 << depth) - 1 - lo, lo) if kind == "between" else (0,):
                for high in (0, 1 << depth):
                    want = tbsi.range_rows(kind, torch.from_numpy(planes.view(np.int32)), lo | high,
                                           hi | high).numpy().view(np.uint32)
                    walk = kernels.walk_form(kind, depth, lo | high, hi | high)
                    assert np.array_equal(walk_np(walk, planes), want), (kind, depth, lo, hi)


def test_count_batch_pool_with_ranges_matches_reference(mesh):
    """K5P's plain version with pool rows beside range leaves (a range leaf
    is live in every block), against the reference's count_batch_tree."""
    from test_torch_pool_count import make_case, mats_of

    pool, table, dense, bsi = make_case(13, S, 9)
    full = (0, 1, 2, 3)
    rb = lambda r: ("rowb", 1, 2, r)  # noqa: E731
    progs = [("and", rb(0), ("range", "gt", 3, full, 3, 0)),
             ("or", rb(2), ("range", "between", 3, full, 1, 5)),
             ("andnot", ("range", "lte", 3, (0, -1, 2, 3), 4, 0), rb(3)),
             ("xor", rb(4), ("row", 0, 1), ("range", "neq", 3, full, 2, 0)),
             ("and", rb(1), ("range", "gt", 3, full, 3, 0))]
    mats = mats_of(pool, table, dense, bsi)
    ids = [k % len(BATCH_MASKS) for k in range(len(progs))]
    got = kernels.count_batch_tree(progs, mats, BATCH_MASKS, ids, "cpu")
    want = jax_count_batch(mesh, progs, ids, [dense, pool, None, bsi], BATCH_MASKS,
                           table=table)
    assert got.tolist() == want
    assert torch.equal(got, kernels.count_batch_tree_plain(progs, mats, BATCH_MASKS, ids, "cpu"))


def test_grouped_pass_pool_rows_beside_ranges():
    """K5P's batch with pool rows beside range leaves: the pool rows are
    staged rows (first in the table), the range leaves one group walked
    once; the group walk per shard equals the pool plain version, which
    equals count_tree_plain per query."""
    from test_torch_pool_count import make_case, mats_of

    pool, table, dense, bsi = make_case(31, S, 9)
    full = (0, 1, 2, 3)
    rb = lambda r: ("rowb", 1, 2, r)  # noqa: E731
    progs = [("and", rb(0), ("range", "gt", 3, full, 3, 0)),
             ("or", rb(2), ("range", "lt", 3, full, 6, 0)),
             ("andnot", ("range", "neq", 3, full, 2, 0), ("or", rb(3), ("row", 0, 2))),
             ("and", rb(4), rb(5)), ("range", "gt", 3, full, 3, 0)]
    ids = [k % len(BATCH_MASKS) for k in range(len(progs))]
    mats = mats_of(pool, table, dense, bsi)
    got = kernels.count_batch_tree(progs, mats, BATCH_MASKS, ids, "cpu")
    batch = kernels.compile_batch(progs, ids)
    assert batch.pooled and batch.groups.tolist() == [[0, 3, 3, 0]] and batch.n_rows == 6
    assert kernels.batch_tile(batch, pooled=True) == 128  # (2 x 6 + 3) rows in 32 KiB
    words = kernels.mask_bits(BATCH_MASKS)
    per_shard = [interpret_batch(batch, [dense, pool, table, bsi], words, s) for s in range(S)]
    assert [sum(col) for col in zip(*per_shard)] == got.tolist()
    dev_masks = torch.from_numpy(BATCH_MASKS.astype(np.int32))
    assert got.tolist() == [int(kernels.count_tree_plain(p, mats, dev_masks[i]))
                            for p, i in zip(progs, ids)]


def test_mask_bits_past_one_word():
    rng = np.random.default_rng(2)
    masks = rng.random((3, 70)) < 0.5
    words = kernels.mask_bits(masks)
    assert words.shape == (3, 3)
    for m in range(3):
        for s in range(70):
            assert bool((int(words[m, s >> 5]) >> (s & 31)) & 1) == masks[m, s]


def test_batch_limits():
    deep = ("row", 0, 0)
    for _ in range(kernels.MAX_STACK):
        deep = ("and", ("row", 0, 1), deep)
    with pytest.raises(ValueError, match="stack"):
        kernels.compile_batch([("row", 0, 0), deep], [0, 0])
    # No per-query leaf limit within a batch: 40 leaf rows in one query.
    wide = ("or",) + tuple(("row", 0, r) for r in range(40))
    assert len(kernels.compile_batch([wide], [0]).leaves) == 40
    progs = [("row", 0, r) for r in range(10)]
    assert kernels.batch_groups(progs) == [(0, 10)]


def test_batch_groups_split_at_the_limits(monkeypatch):
    monkeypatch.setattr(kernels, "BATCH_MAX", 4)
    progs = [("row", 0, r) for r in range(10)]
    assert kernels.batch_groups(progs) == [(0, 4), (4, 8), (8, 10)]
    monkeypatch.setattr(kernels, "BATCH_MAX", 1024)
    monkeypatch.setattr(kernels, "MAX_BATCH_LEAVES", 5)
    progs = [("and", ("row", 0, r), ("row", 0, r + 1)) for r in range(0, 12, 2)]
    assert kernels.batch_groups(progs) == [(0, 2), (2, 4), (4, 6)]
    # A query re-reading rows already in the group does not split it.
    progs = [("and", ("row", 0, 1), ("row", 0, 2))] * 6
    assert kernels.batch_groups(progs) == [(0, 6)]


def test_cuda_wrapper_refuses_cpu_tensors(stacks):
    batch = kernels.compile_batch(BATCH_PROGS, BATCH_MASK_IDS)
    with pytest.raises(ValueError, match="on the card"):
        kernels.count_batch_tree_cuda(batch, torch_mats(stacks), BATCH_MASKS, "cpu")
    assert kernels.count_batch_tree_cuda.launches == 0


# -- TorchEngine.count_many against MeshEngine --------------------------------


def test_count_many_matches_singles(pair):
    jeng, _, teng, _ = pair
    want = [jeng.count("i", jcall(q), SHARDS) for q in QUERIES]
    assert jeng.count_many("i", [jcall(q) for q in QUERIES], [SHARDS] * len(QUERIES)) == want
    before = teng.batch_dispatches
    got = teng.count_many("i", [tcall(q) for q in QUERIES], [SHARDS] * len(QUERIES))
    assert got == want
    # K answers from ONE batch dispatch.
    assert teng.batch_dispatches == before + 1 and teng.last_path == "batch"


@pytest.mark.parametrize("k", [1, 2, 8, 9, 64, 65])
def test_count_many_tier_edges(pair, k):
    """K at each of the reference's tier edges: every answer its own, and
    no padding slot leaks into the result."""
    jeng, _, teng, _ = pair
    qs = [f"Intersect(Row(f={10 + i % 4}), Row(f={10 + (i // 4) % 4}))" if i % 3
          else f"Union(Row(f={10 + i % 4}), Row(f={20 + i}))" for i in range(k)]
    want = [jeng.count("i", jcall(q), SHARDS) for q in qs]
    got = teng.count_many("i", [tcall(q) for q in qs], [SHARDS] * k)
    assert got == want


def test_count_many_matches_reference_batch(pair):
    jeng, _, teng, _ = pair
    qs = QUERIES + ["Row(f=999)", "Intersect(Row(f=10), Row(f=998))"]
    shards = [SHARDS, [0, 2], [1], [], SHARDS, [3, 4, 5], [7], SHARDS, [0]]
    want = jeng.count_many("i", [jcall(q) for q in qs], shards)
    assert teng.count_many("i", [tcall(q) for q in qs], shards) == want


def test_count_many_per_query_shards(pair):
    """Each query of a batch applies ITS OWN shard mask."""
    jeng, _, teng, _ = pair
    q = "Union(Row(f=10), Row(f=12))"
    per_shard = [jeng.count("i", jcall(q), [s]) for s in SHARDS]
    got = teng.count_many("i", [tcall(q)] * N_SHARDS, [[s] for s in SHARDS])
    assert got == per_shard
    assert sum(per_shard) == jeng.count("i", jcall(q), SHARDS)


def test_count_many_missing_rows(pair):
    """An absent row lowers to a zero leaf: counts of 0 where the row is
    missing, whatever its neighbours in the batch."""
    jeng, _, teng, _ = pair
    want10 = jeng.count("i", jcall("Row(f=10)"), SHARDS)
    for qs in (["Row(f=10)", "Row(f=999)"], ["Row(f=999)", "Row(f=10)"],
               ["Row(f=999)", "Row(f=998)"], ["Union(Row(f=999), Row(f=10))", "Row(f=997)"]):
        want = [want10 if "f=10" in q else 0 for q in qs]
        assert teng.count_many("i", [tcall(q) for q in qs], [SHARDS] * 2) == want


def test_count_many_dedups_and_fans_out(pair):
    """Identical (query, shards) entries are evaluated once; one unique
    query takes the scalar path (K1 or K2), not the batch program."""
    jeng, _, teng, _ = pair
    qs = [QUERIES[1], QUERIES[2], QUERIES[1], QUERIES[1], QUERIES[2]]
    want = [jeng.count("i", jcall(q), SHARDS) for q in qs]
    before = teng.batch_cse_deduped
    assert teng.count_many("i", [tcall(q) for q in qs], [SHARDS] * 5) == want
    assert teng.batch_cse_deduped == before + 3
    dense, batches = teng.dense_dispatches, teng.batch_dispatches
    got = teng.count_many("i", [tcall(QUERIES[1])] * 4, [SHARDS] * 4)
    assert got == [want[0]] * 4
    assert (teng.dense_dispatches, teng.batch_dispatches) == (dense + 1, batches)


def test_count_many_splits_past_the_launch_limits(pair, monkeypatch):
    jeng, _, teng, _ = pair
    monkeypatch.setattr(kernels, "BATCH_MAX", 3)
    qs = QUERIES + [QUERIES[0], QUERIES[3]]
    want = [jeng.count("i", jcall(q), SHARDS) for q in qs]
    before = teng.batch_dispatches
    assert teng.count_many("i", [tcall(q) for q in qs], [SHARDS] * len(qs)) == want
    assert teng.batch_dispatches == before + 3  # 7 unique queries, 3 per launch


def test_count_many_unlowerable_raises(pair):
    _, _, teng, _ = pair
    with pytest.raises(UnsupportedLowering):
        teng.count_many("i", [tcall(QUERIES[1]), tcall("Row(nosuchfield=1)")], [SHARDS] * 2)
    assert not teng.lowerable(tcall("Shift(Row(f=10), n=1)"))
    assert teng.lowerable(tcall(QUERIES[-1]))


# -- the executor: runs of consecutive Counts ----------------------------------


def test_executor_multicall_count_batches(pair):
    _, jex, teng, tex = pair
    multi = "".join(f"Count({q})" for q in QUERIES)
    want = jex.execute("i", multi).results
    before = teng.batch_dispatches
    assert tex.execute("i", multi).results == want
    # Every Count past the O(1) lane (the bare Row) in one K5 dispatch.
    assert teng.batch_dispatches == before + 1


def test_executor_write_between_counts_not_batched(pair):
    """A Set between two Counts ends the run: the second Count sees it."""
    _, jex, _, tex = pair
    q = "Count(Union(Row(f=10), Row(f=77)))Set(5, f=77)Count(Union(Row(f=10), Row(f=77)))"
    want = jex.execute("i", q).results
    got = tex.execute("i", q).results
    assert got == want
    assert got[1] is True and got[2] == got[0] + 1


def test_executor_multicall_falls_back_on_batch_failure(pair):
    """When the batched dispatch declines the run (UnsupportedLowering),
    each Count still answers, call by call."""
    _, jex, teng, tex = pair
    multi = "Count(Intersect(Row(f=10), Row(f=11)))Count(Row(f=11))Count(Xor(Row(f=10), Row(f=13)))"
    want = jex.execute("i", multi).results

    def boom(*a, **kw):
        raise UnsupportedLowering("forced batch failure")

    teng.count_many = boom
    assert tex.execute("i", multi).results == want


def test_executor_multicall_with_unknown_field_matches_reference(pair):
    _, jex, _, tex = pair
    q = "Count(Row(f=10))Count(Intersect(Row(f=10), Row(nosuch=1)))"
    with pytest.raises(Exception) as want:
        jex.execute("i", q)
    with pytest.raises(Exception) as got:
        tex.execute("i", q)
    assert type(got.value).__name__ == type(want.value).__name__


# -- the micro-batcher ---------------------------------------------------------


def test_batcher_concurrent_submits_fuse(pair):
    """Concurrent submits while a dispatch is in flight drain into one
    batched program (batching by backpressure)."""
    jeng, _, teng, _ = pair
    teng.result_memo.maxsize = 0  # about fusing: repeats must reach the batcher
    want = {q: jeng.count("i", jcall(q), SHARDS) for q in QUERIES}
    results, errs = {}, []
    barrier = threading.Barrier(len(QUERIES) * 8)

    def worker(q):
        try:
            barrier.wait(30)
            results.setdefault(q, set()).add(teng.batched_count("i", tcall(q), SHARDS))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(q,)) for q in QUERIES * 8]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs
    assert results == {q: {v} for q, v in want.items()}
    b = teng._batcher
    assert b is not None and b.batched_queries > 0 and b.batches > 0
    assert b.pipeline_snapshot()["counters"].get("fused_batches", 0) > 0


def test_batcher_poisoned_batch_splits_fast(pair):
    """One unlowerable query in a drain fails ONLY its submitter; the
    others re-dispatch as one batch."""
    jeng, _, teng, _ = pair
    teng.result_memo.maxsize = 0
    b = teng.batcher()
    good = QUERIES[1:4]
    want = [jeng.count("i", jcall(q), SHARDS) for q in good]
    results, errors = {}, {}
    gate = threading.Event()
    real_count = teng.count

    def slow_count(*a, **kw):  # holds the direct path while the rest queue
        gate.wait(10)
        return real_count(*a, **kw)

    teng.count = slow_count

    def submit(tag, q):
        try:
            results[tag] = b.submit("i", tcall(q), SHARDS)
        except Exception as e:  # noqa: BLE001
            errors[tag] = e

    blocker = threading.Thread(target=submit, args=("b0", good[0]))
    blocker.start()
    deadline = time.monotonic() + 10
    while not b._busy and time.monotonic() < deadline:
        time.sleep(0.001)
    threads = [threading.Thread(target=submit, args=(f"g{i}", q)) for i, q in enumerate(good)]
    threads.append(threading.Thread(target=submit, args=("bad", "Row(nosuchfield=1)")))
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    gate.set()
    blocker.join(60)
    assert isinstance(errors.get("bad"), UnsupportedLowering)
    for i in range(3):
        assert results.get(f"g{i}") == want[i], (i, results, errors)
    assert results["b0"] == want[0]
    # The split itself: a failed group whose culprit the lowering probe
    # finds re-dispatches the rest as one retried batch.
    from pilosa_tpu_torch.parallel.batcher import _Item

    items = [_Item("i", tcall(q), SHARDS) for q in (good[0], "Row(nosuchfield=1)", good[2])]
    b._handle_batch_failure("i", items, False, RuntimeError("the whole batch failed"))
    for it in items:
        assert it.event.wait(30)
    assert isinstance(items[1].error, UnsupportedLowering)
    assert [items[0].result, items[2].result] == [want[0], want[2]]
    assert items[0].error is None and items[2].error is None
    # A retried batch that fails again fails every item with its error.
    items = [_Item("i", tcall(q), SHARDS) for q in good[:2]]
    err = RuntimeError("the retry failed too")
    b._handle_batch_failure("i", items, True, err)
    assert all(it.done() and it.error is err for it in items)


# -- the result memo -----------------------------------------------------------


def test_memo_repeat_hits_and_write_misses(pair):
    jeng, jex, teng, tex = pair
    q = "Count(Intersect(Row(f=10), Row(f=11)))"
    want = jex.execute("i", q).results
    assert tex.execute("i", q).results == want
    dense = teng.dense_dispatches
    hits = teng.result_memo.hits
    assert tex.execute("i", q).results == want
    assert teng.dense_dispatches == dense and teng.result_memo.hits == hits + 1
    key = teng._memo_key("i", tcall("Intersect(Row(f=10), Row(f=11))"), SHARDS)
    assert teng.result_memo.miss_reason(key) == "evicted"  # stored under these tokens
    # A write to a referenced view moves the key: the repeat misses and
    # sees the write.
    for ex in (jex, tex):
        ex.execute("i", f"Set({3 * SW + 123456}, f=10)")
        ex.execute("i", f"Set({3 * SW + 123456}, f=11)")
    want2 = jex.execute("i", q).results
    assert want2[0] == want[0] + 1
    key2 = teng._memo_key("i", tcall("Intersect(Row(f=10), Row(f=11))"), SHARDS)
    assert key2[:3] == key[:3] and key2[3] != key[3]
    assert teng.result_memo.miss_reason(key2) == "version_token_advanced"
    # The repair layer serves the miss from the writes' delta, with no
    # dispatch; suspended, the same miss dispatches.
    assert tex.execute("i", q).results == want2
    assert teng.dense_dispatches == dense and teng.repairs.repaired["count"] == 1
    with teng.repairs.suspended():
        teng.result_memo.clear()
        assert tex.execute("i", q).results == want2
    assert teng.dense_dispatches == dense + 1
    assert teng.result_memo.miss_reason(None) == "ineligible"
    other = teng._memo_key("i", tcall("Xor(Row(f=10), Row(f=12))"), SHARDS)
    assert teng.result_memo.miss_reason(other) == "first_seen"


def test_memo_hit_skips_the_kernel_path_and_a_write_reaches_it(pair):
    """A repeated Count is a memo hit: no dispatch, no stack work.  A write
    moves its key: the next repeat is repaired from the write's delta (no
    dispatch, no stack work), and with the repair layer suspended it
    dispatches once, on the stack synced in place (no rebuild)."""
    _, jex, teng, tex = pair
    q = "Count(Intersect(Row(f=10), Row(f=11)))"
    tex.execute("i", q)

    def state():
        return teng.stack_rebuilds, teng.stack_updates, teng.dense_dispatches

    rebuilds, updates, dense = state()
    assert tex.execute("i", q).results == jex.execute("i", q).results
    assert state() == (rebuilds, updates, dense)
    for ex in (jex, tex):
        ex.execute("i", f"Set({2 * SW + 77}, f=10)")
    assert tex.execute("i", q).results == jex.execute("i", q).results
    assert state() == (rebuilds, updates, dense)
    with teng.repairs.suspended():
        teng.result_memo.clear()
        assert tex.execute("i", q).results == jex.execute("i", q).results
    assert state() == (rebuilds, updates + 1, dense + 1)


def test_memo_tokens_cover_every_referenced_view(pair):
    _, _, teng, tex = pair
    c = tcall("Not(Intersect(Row(f=10), Row(f=11)))")
    key = teng._memo_key("i", c, SHARDS)
    # Not() reads the existence field: a write there moves the key.
    assert any(t[0] == "exists" for t in key[3][1:])
    tex.holder.index("i").existence_field().set_bit(0, 5 * SW + 17)
    assert teng._memo_key("i", c, SHARDS) != key
    key = teng._memo_key("i", c, SHARDS)
    # A write to a field the tree does not read leaves it alone ...
    tex.holder.index("i").create_field("g").set_bit(1, 17)
    assert teng._memo_key("i", c, SHARDS)[3][1:] == key[3][1:]
    # ... and so does a repeat of the same text with other shards: its own key.
    assert teng._memo_key("i", c, [0, 1])[2] == (0, 1)
    # A tree the walk does not know has no key (no memo, no stale hit).
    assert teng._memo_key("i", tcall("Shift(Row(f=10), n=1)"), SHARDS) is None
    teng.result_memo.maxsize = 0
    assert teng._memo_key("i", c, SHARDS) is None


def test_memo_counts(pair):
    _, jex, teng, tex = pair
    q = "Count(Intersect(Row(f=10), Row(f=11)))Count(Union(Row(f=10), Row(f=13)))"
    assert tex.memo_counts("i", q) is None  # cold
    want = jex.execute("i", q).results
    # The deferred path stores its answers (as the reference's batcher
    # does; count_many, like the reference's, neither reads nor stores).
    assert tex.execute("i", q).results == want
    assert tex.memo_counts("i", q) is None
    assert tex.execute_async("i", q).result(30).results == want
    assert tex.memo_counts("i", q) == want
    assert tex.memo_counts("i", "TopN(f, n=2)") is None
    tex.execute("i", f"Set({SW + 99}, f=13)")
    assert tex.memo_counts("i", q) is None  # a write re-keys its readers
    assert TExecutor(tex.holder).memo_counts("i", q) is None  # no engine


def test_batcher_memo_lane(pair):
    """A memo hit answers submit and submit_async with no queue and no
    launch; the collect stage stores under the tokens read at submit."""
    jeng, _, teng, _ = pair
    q = QUERIES[2]
    want = jeng.count("i", jcall(q), SHARDS)
    b = teng.batcher()
    item = b.submit_async("i", tcall(q), SHARDS)
    assert item.event.wait(30) and item.result == want
    batches = b.batches
    assert b.submit("i", tcall(q), SHARDS) == want
    item = b.submit_async("i", tcall(q), SHARDS)
    assert item.done() and item.result == want
    assert b.batches == batches


# -- singleflight --------------------------------------------------------------


def test_singleflight_collapses_identical_topns(pair):
    """N concurrent identical TopNs share one fused launch per burst, every
    caller gets the reference's answer, and a write between bursts is seen
    (singleflight is not a cache)."""
    jeng, jex, teng, tex = pair
    q = "TopN(f, Row(f=11), n=2)"
    want = jex.execute("i", q).results[0]
    real = teng.topn_full
    calls = []

    def slow_topn(*a, **kw):  # a flight long enough for the burst to join
        calls.append(1)
        time.sleep(0.2)
        return real(*a, **kw)

    teng.topn_full = slow_topn
    results, errs = [], []
    barrier = threading.Barrier(12)

    def worker():
        try:
            barrier.wait(30)
            results.append([tuple(p) for p in tex.execute("i", q).results[0]])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs and results == [[tuple(p) for p in want]] * 12
    assert tex._sflight.shared > 0 and len(calls) < 12
    for ex in (jex, tex):
        ex.execute("i", f"Set({2 * SW + 5}, f=10)")
        ex.execute("i", f"Set({2 * SW + 5}, f=11)")
    want2 = jex.execute("i", q).results[0]
    assert [tuple(p) for p in tex.execute("i", q).results[0]] == [tuple(p) for p in want2]


def test_recreated_field_never_serves_the_old_stack_or_memo(pair):
    """A field dropped and recreated under the same name, with as many
    writes (equal view versions), is a new view: new stack and memo tokens
    (its generation), so neither the old stack nor an old memo entry
    answers."""
    _, jex, teng, tex = pair
    q = "Count(Intersect(Row(g=1), Row(g=2)))"
    for cols_seed in (1, 2):
        cols = np.random.default_rng(cols_seed).choice(2 * SW, 3000, replace=False).tolist()
        for ex in (jex, tex):
            idx = ex.holder.index("i")
            if idx.field("g") is not None:
                idx.delete_field("g")
            idx.create_field("g").import_bulk([1] * 2000 + [2] * 1000, cols[:2000] + cols[1000:2000])
        key = teng._memo_key("i", tcall("Intersect(Row(g=1), Row(g=2))"), SHARDS)
        want = jex.execute("i", q).results
        assert tex.execute("i", q).results == want == [1000]
        assert tex.execute_async("i", q).result(30).results == want
        if cols_seed == 1:
            first_key = key
    assert key != first_key and key[3][1:] != first_key[3][1:]
