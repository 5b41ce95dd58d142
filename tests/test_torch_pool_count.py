"""K1P's Count over pool trees (``kernels.count_tree_pool_plain``, the
live word ``kernels.live_blocks``) on the CPU: against the plain K1
version, a numpy oracle, the JAX package's ``count_tree``
(``pilosa_tpu/parallel/kernels.py:242`` through ``apply_prog``'s ``rowb``
leaf) on a one-device CPU mesh, and at engine level against the reference
``MeshEngine`` with partial stacks.  Counts are integers: exact agreement
(tolerance 0).  The CUDA kernel itself runs only on the card (chip_smoke.py
holds it against these plain versions there); here ``count_tree`` takes the
plain version because the tensors are on the CPU."""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pilosa_tpu.ops import bsi as jbsi
from pilosa_tpu.parallel import kernels as jk
from pilosa_tpu.parallel import make_mesh
from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global
from pilosa_tpu_torch.parallel import kernels

from test_torch_residency import ROW_SHARD, make_sides

W = 32768
BLOCKS = 64
BW = 512  # words a block
DEPTH = 3  # the BSI stack's value planes
OPS = ("and", "or", "andnot", "xor")
KINDS = ("eq", "neq", "lt", "lte", "gt", "gte", "between")


def make_case(seed, S, P_slots, n_rows=6):
    """A pool uint32[P, S, 512] (slot 0 zero) and its slot table
    int32[n_rows + 1, 64] (row 1 all zero, the last row the all-zero
    vector, slots repeating across rows), a dense stack uint32[4, S, W] and
    a BSI stack uint32[DEPTH + 1, S, W] (planes, then not-null)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, (P_slots, S, BW), dtype=np.uint64).astype(np.uint32)
    pool[0] = 0
    table = np.zeros((n_rows + 1, BLOCKS), dtype=np.int32)
    if P_slots > 1:
        for r in range(n_rows):
            if r == 1:
                continue
            blocks = rng.choice(BLOCKS, int(rng.integers(1, 20)), replace=False)
            table[r, blocks] = rng.integers(1, P_slots, len(blocks))
    dense = rng.integers(0, 1 << 32, (4, S, W), dtype=np.uint64).astype(np.uint32)
    dense[3, :, : W // 2] = 0
    bsi = rng.integers(0, 1 << 32, (DEPTH + 1, S, W), dtype=np.uint64).astype(np.uint32)
    return pool, table, dense, bsi


def rand_tree(rng, n_rows, depth=3):
    """A random tree of rowb / row / range / zero leaves under and / or /
    andnot / xor, over mats [dense, pool, table, bsi]."""
    if depth == 0 or rng.random() < 0.3:
        u = rng.random()
        if u < 0.5:
            return ("rowb", 1, 2, int(rng.integers(0, n_rows + 1)))
        if u < 0.75:
            return ("row", 0, int(rng.integers(0, 4)))
        if u < 0.9:
            kind = KINDS[int(rng.integers(0, len(KINDS)))]
            lo = int(rng.integers(0, 1 << DEPTH))
            hi = int(rng.integers(lo, 1 << DEPTH)) if kind == "between" else 0
            planes = (0, -1, 2, 3) if rng.random() < 0.3 else (0, 1, 2, 3)
            return ("range", kind, 3, planes, lo, hi)
        return ("zero",)
    op = OPS[int(rng.integers(0, 4))]
    return (op,) + tuple(rand_tree(rng, n_rows, depth - 1)
                         for _ in range(int(rng.integers(2, 4))))


def pooled_tree(rng, n_rows):
    """A random tree holding at least one pool leaf."""
    while True:
        t = rand_tree(rng, n_rows)
        if kernels.compile_prog(t).pooled:
            return t


def mats_of(pool, table, dense, bsi):
    return [torch.from_numpy(dense.view(np.int32)), torch.from_numpy(pool.view(np.int32)),
            torch.from_numpy(table), torch.from_numpy(bsi.view(np.int32))]


# -- a numpy oracle --------------------------------------------------------

def np_range(kind, planes, lo, hi):
    """The range condition over numpy planes uint32[DEPTH + 1, S, W] as a
    comparator on the value bits, high bit first: the columns whose
    not-null bit is set and whose value compares so."""
    value, nn = planes[:-1], planes[-1]
    ones = np.full(nn.shape, 0xFFFFFFFF, np.uint32)

    def less(pred, or_equal):
        lt, eq = np.zeros_like(nn), ones.copy()
        for i in range(DEPTH - 1, -1, -1):
            if (pred >> i) & 1:
                lt |= eq & ~value[i]
                eq &= value[i]
            else:
                eq &= ~value[i]
        return lt | eq if or_equal else lt

    def equal(pred):
        eq = ones.copy()
        for i in range(DEPTH):
            eq &= value[i] if (pred >> i) & 1 else ~value[i]
        return eq

    cond = {"eq": lambda: equal(lo), "neq": lambda: ~equal(lo),
            "lt": lambda: less(lo, False), "lte": lambda: less(lo, True),
            "gt": lambda: ~less(lo, True), "gte": lambda: ~less(lo, False),
            "between": lambda: ~less(lo, False) & less(hi, True)}[kind]()
    return cond & nn


def np_eval(tree, pool, table, dense, bsi):
    """The tree's words uint32[S, W], a pool row gathered in numpy."""
    kind = tree[0]
    S = dense.shape[1]
    if kind == "row":
        return dense[tree[2]]
    if kind == "rowb":
        return pool[table[tree[3]]].transpose(1, 0, 2).reshape(S, W)
    if kind == "zero":
        return np.zeros((S, W), np.uint32)
    if kind == "range":
        _, rk, _, planes, lo, hi = tree
        gathered = np.stack([bsi[p] if p >= 0 else np.zeros((S, W), np.uint32) for p in planes])
        return np_range(rk, gathered, lo, hi)
    out = np_eval(tree[1], pool, table, dense, bsi)
    for sub in tree[2:]:
        v = np_eval(sub, pool, table, dense, bsi)
        out = {"and": out & v, "or": out | v, "andnot": out & ~v, "xor": out ^ v}[kind]
    return out


def np_count(tree, case, mask):
    words = np_eval(tree, *case)[mask != 0]
    return int(np.unpackbits(words.view(np.uint8)).sum())


# -- (a) the live word -----------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_live_word_covers_every_nonzero_block(seed):
    case = make_case(seed, 3, 9)
    mats = mats_of(*case)
    rng = np.random.default_rng(100 + seed)
    for _ in range(12):
        t = rand_tree(rng, 6)
        live = kernels.live_blocks(t, mats, "cpu").numpy()
        assert live.shape == (BLOCKS,) and live.dtype == bool
        words = np_eval(t, *case).reshape(3, BLOCKS, BW)
        assert not words[:, ~live].any(), t


def test_live_word_of_a_pool_only_and_is_the_and_of_the_slots():
    case = make_case(7, 2, 17)
    table = case[1]
    mats = mats_of(*case)
    for rows in ((0, 2), (0, 3, 4), (2, 2), (0, 1), (0, 6)):
        t = ("and",) + tuple(("rowb", 1, 2, r) for r in rows)
        want = np.logical_and.reduce([table[r] != 0 for r in rows])
        assert np.array_equal(kernels.live_blocks(t, mats, "cpu").numpy(), want), rows


def test_live_word_rules():
    case = make_case(8, 1, 5)
    mats = mats_of(*case)
    slot0 = case[1][0] != 0
    row, pool0, zero = ("row", 0, 0), ("rowb", 1, 2, 0), ("zero",)
    rng_leaf = ("range", "gt", 3, (0, 1, 2, 3), 2, 0)

    def live(t):
        return kernels.live_blocks(t, mats, "cpu").numpy()

    assert live(row).all() and live(rng_leaf).all() and not live(zero).any()
    assert np.array_equal(live(pool0), slot0)
    assert np.array_equal(live(("and", pool0, row)), slot0)
    assert live(("or", pool0, row)).all() and live(("xor", row, pool0)).all()
    assert np.array_equal(live(("andnot", pool0, row)), slot0)  # keeps its left side
    assert live(("andnot", row, pool0)).all()
    assert not live(("and", pool0, ("rowb", 1, 2, 6))).any()  # the all-zero vector


# -- (b) the pool plain version against count_tree_plain and numpy ----------

@pytest.mark.parametrize("S,P_slots", [(1, 9), (12, 9), (37, 33), (12, 1)])
def test_pool_plain_matches_plain_and_numpy(S, P_slots):
    case = make_case(S * 31 + P_slots, S, P_slots)
    mats = mats_of(*case)
    rng = np.random.default_rng(S + P_slots)
    masks = [np.ones(S, np.int32), np.zeros(S, np.int32),
             (rng.random(S) < 0.5).astype(np.int32)]
    trees = [pooled_tree(rng, 6) for _ in range(6)] + [
        ("and", ("rowb", 1, 2, 1), ("rowb", 1, 2, 0)),  # live word 0
        ("and", ("rowb", 1, 2, 6), ("row", 0, 1)),  # the all-zero vector
        ("or", ("rowb", 1, 2, 0), ("zero",)),
        ("andnot", ("rowb", 1, 2, 2), ("range", "between", 3, (0, 1, 2, 3), 1, 6)),
    ]
    for t in trees:
        for m in masks:
            mt = torch.from_numpy(m)
            got = kernels.count_tree_pool_plain(t, mats, mt)
            assert got.dtype == torch.int64 and got.dim() == 0
            want = np_count(t, case, m)
            assert int(got) == int(kernels.count_tree_plain(t, mats, mt)) == want, (t, m)
            assert int(kernels.count_tree(t, mats, mt)) == want


def test_pool_plain_over_a_dead_live_word_reads_no_leaf():
    case = make_case(3, 4, 9)
    mats = mats_of(*case)
    mats[0] = None  # a stack row under a dead `and` is never read
    t = ("and", ("rowb", 1, 2, 1), ("rowb", 1, 2, 0))
    assert not kernels.live_blocks(t, mats, "cpu").any()
    assert int(kernels.count_tree_pool_plain(t, mats, torch.ones(4, dtype=torch.int32))) == 0


# -- (c) against the JAX package's count_tree --------------------------------

@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1)


def jax_count(mesh, tree, case, mask):
    """The reference count_tree on the same numpy operands: stack rows as
    (operand, scalar operand), pool rows as ("rowb", pool operand, slot
    vector operand), range leaves over gathered planes with their
    predicate bits, zero leaves a zero stack."""
    pool, table, dense, bsi = case
    S = dense.shape[1]
    operands, specs = [], []

    def add(arr, spec):
        operands.append(put_global(mesh, arr, spec))
        specs.append(spec)
        return len(operands) - 1

    i_dense, i_pool = add(dense, P(None, SHARD_AXIS)), add(pool, P(None, SHARD_AXIS))
    i_bsi, i_zero = add(bsi, P(None, SHARD_AXIS)), add(np.zeros((1, S, W), np.uint32),
                                                       P(None, SHARD_AXIS))

    def conv(p):
        if p[0] == "row":
            return ("row", i_dense, add(np.int32(p[2]), P()))
        if p[0] == "rowb":
            return ("rowb", i_pool, add(table[p[3]], P()))
        if p[0] == "zero":
            return ("zero", i_zero)
        if p[0] == "range":
            _, rk, _, planes, lo, hi = p
            pspec = ("idx", tuple(planes))
            if rk == "between":
                return ("between", i_bsi, pspec, add(jbsi.to_bits(lo, DEPTH), P()),
                        add(jbsi.to_bits(hi, DEPTH), P()))
            return ("range", rk, i_bsi, pspec, add(jbsi.to_bits(lo, DEPTH), P()))
        return (p[0],) + tuple(conv(q) for q in p[1:])

    jprog = conv(tree)
    jmask = put_global(mesh, np.where(mask[:, None] != 0, 0xFFFFFFFF, 0).astype(np.uint32),
                       P(SHARD_AXIS))
    return int(jk.count_tree(mesh, jprog, tuple(specs), jmask, *operands))


@pytest.mark.parametrize("seed", range(3))
def test_count_tree_over_pool_trees_matches_reference(mesh1, seed):
    S = (1, 12, 5)[seed]
    case = make_case(40 + seed, S, (9, 17, 1)[seed])
    mats = mats_of(*case)
    rng = np.random.default_rng(50 + seed)
    trees = [pooled_tree(rng, 6) for _ in range(4)] + [
        ("and", ("rowb", 1, 2, 0), ("row", 0, 2)), ("xor", ("rowb", 1, 2, 3), ("rowb", 1, 2, 3))]
    for t in trees:
        m = (rng.random(S) < 0.7).astype(np.int32)
        got = kernels.count_tree(t, mats, torch.from_numpy(m))
        assert int(got) == jax_count(mesh1, t, case, m), t


# -- (d) engine level: partial stacks beside the reference MeshEngine --------

N_SHARDS = 3
F_ROWS = 16


def build_pools(holder):
    """Index i over 3 shards: field f of 16 rows whose bits sit in a few
    blocks of each shard (a different set per row, so the pool rows' live
    words differ), field g of 2 rows spread over every block."""
    rng = np.random.default_rng(12)
    idx = holder.create_index("i")
    rows, cols = [], []
    for r in range(F_ROWS):
        blocks = rng.choice(BLOCKS, 4, replace=False)
        for s in range(N_SHARDS):
            for b in blocks[: 2 + s % 3]:
                c = rng.choice(16384, 40, replace=False) + int(b) * 16384 + (s << 20)
                rows += [r] * len(c)
                cols += c.tolist()
    idx.create_field("f").import_bulk(rows, cols)
    rows, cols = [], []
    for r in range(2):
        c = rng.choice(N_SHARDS << 20, 3000, replace=False)
        rows += [r] * len(c)
        cols += c.tolist()
    idx.create_field("g").import_bulk(rows, cols)
    return idx


POOL_QUERIES = [
    "Count(Intersect(Row(f=10), Row(f=11)))",
    "Count(Union(Row(f=10), Row(f=11), Row(g=0)))",
    "Count(Difference(Row(f=11), Row(g=1)))",
    "Count(Xor(Row(f=10), Row(g=0)))",
    "Count(Intersect(Union(Row(f=10), Row(g=1)), Row(f=11)))",
    "Count(Difference(Row(g=0), Row(f=10)))",
]


def test_engine_counts_over_pool_rows_match_reference(mesh1, monkeypatch):
    pool_plain = kernels.count_tree_pool_plain
    calls = []

    def spy(prog, mats, mask):
        calls.append(prog)
        return pool_plain(prog, mats, mask)

    monkeypatch.setattr(kernels, "count_tree_pool_plain", spy)
    sides = make_sides(mesh1, 16 * ROW_SHARD + 4096, build=build_pools)
    try:
        for s in sides:
            s.q("Count(Row(g=0))")  # g's full stack: 6 row-shards
            for q in POOL_QUERIES:
                s.q(q)  # cold: f misses and requests its rows
            s.flush()
        fb = [s.engine.host_fallbacks for s in sides]
        assert min(fb) >= 1
        calls.clear()
        for shards in (None, [0, 2], [1]):
            for q in POOL_QUERIES:
                got = [s.ex.execute("i", q, shards=shards).results for s in sides]
                want = sides[1].host.execute("i", q, shards=shards).results
                assert got[0] == got[1] == want, (q, shards)
        assert [s.engine.host_fallbacks for s in sides] == fb  # warm: every answer on the device
        for s in sides:
            st = s.stack("f")
            assert st.partial and st.pool and set(st.row_index) == {10, 11}
            assert not s.stack("g").partial
        assert len(calls) == 3 * len(POOL_QUERIES)
        assert all(kernels.compile_prog(p).pooled for p in calls)
        assert sides[1].engine.last_path == "dense"
    finally:
        for s in sides:
            s.engine.close()
