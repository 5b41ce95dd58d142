"""K3P's TopN and K6P's Sum over pool trees on the CPU: the plain versions
that read only a src or filter tree's live blocks
(``kernels.topn_tree_pool_plain``, ``kernels.topn_full_tree_pool_plain``,
``bsi.sum_tree_pool_plain``) against the whole-row plain versions, a
numpy oracle, the JAX package's ``topn_tree``, ``topn_full_tree`` and
``sum_tree`` (``pilosa_tpu/parallel/kernels.py:316``, ``:346``, ``:475``,
through ``apply_prog``'s ``rowb`` leaf) on a one-device CPU mesh, and at
engine level against the reference ``MeshEngine`` with partial stacks.
Scores, counts and totals are integers: exact agreement (tolerance 0).
The CUDA kernels run only on the card (chip_smoke.py holds them against
these plain versions there); here the wrappers take the plain versions
because the tensors are on the CPU."""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pilosa_tpu.ops import bsi as jbsi
from pilosa_tpu.parallel import kernels as jk
from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global
from pilosa_tpu_torch.parallel import bsi, kernels

from test_torch_pool_count import (DEPTH, W, make_case, mats_of, mesh1,  # noqa: F401
                                   np_eval, pooled_tree)
from test_torch_residency import ROW_SHARD, make_sides

FULL = (0, 1, 2, 3)  # the BSI stack's planes: value planes 0..2, then not-null
HOLED = (0, -1, 2, 3)  # value plane 1 missing


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch ops: under several test
    workers on a few cores a thread pool per worker contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cand_stack(seed, S, R=6):
    """Candidate rows uint32[R, S, W]: random words, row R - 1 empty, row
    R - 2 a copy of row R - 3 (tied scores)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 1 << 32, (R, S, W), dtype=np.uint64).astype(np.uint32)
    c[R - 1] = 0
    c[R - 2] = c[R - 3]
    return c


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def pool_tree(rng):
    """A random tree with a pool leaf, within the kernels' limits."""
    while True:
        t = pooled_tree(rng, 6)
        if kernels.fits(t):
            return t


def dead_trees():
    """Pool trees whose live word is 0: an all-zero row under an and, the
    all-zero vector, a zero subtree."""
    return [("and", ("rowb", 1, 2, 1), ("rowb", 1, 2, 0)),
            ("and", ("rowb", 1, 2, 6), ("row", 0, 1)),
            ("and", ("or", ("rowb", 1, 2, 0), ("zero",)), ("zero",))]


def range_trees():
    """Pool trees with range leaves (in a src or a filter)."""
    return [("and", ("rowb", 1, 2, 2), ("range", "gt", 3, FULL, 3, 0)),
            ("andnot", ("rowb", 1, 2, 0), ("range", "between", 3, HOLED, 1, 6)),
            ("or", ("and", ("rowb", 1, 2, 3), ("range", "neq", 3, FULL, 5, 0)),
             ("rowb", 1, 2, 4))]


def masks_of(rng, S):
    return [np.ones(S, np.int32), np.zeros(S, np.int32), (rng.random(S) < 0.5).astype(np.int32)]


# -- numpy oracles -----------------------------------------------------------

def popc(words):
    """Set bits of uint32 words, summed over the last axis."""
    return np.bitwise_count(words).sum(axis=-1, dtype=np.int64)


def np_src(tree, case, mask):
    src = np_eval(tree, *case)
    return np.where(mask[:, None] != 0, src, 0).astype(np.uint32)


def np_topn(tree, case, mask, cand, idx):
    """(scores int[K, S], src counts int[S])."""
    src = np_src(tree, case, mask)
    per_row = np.stack([popc(c & src) for c in cand])
    return per_row[np.asarray(idx)], popc(src)


def np_totals(scores, cnt, thr):
    return np.where((cnt >= thr) & (scores >= thr), scores, 0).sum(axis=1)


def np_trim(totals, n_out):
    """The top n_out by value descending, the lower index first on ties."""
    order = sorted(range(len(totals)), key=lambda k: (-int(totals[k]), k))[:n_out]
    return np.array([totals[k] for k in order]), np.array(order)


def np_sum(tree, case, mask, planes):
    """int[depth + 1]: popcount(plane_i & notnull & filter & mask), then
    the considered count."""
    S = case[2].shape[1]
    bst = case[3]
    p = [bst[i] if i >= 0 else np.zeros((S, W), np.uint32) for i in planes]
    consider = p[-1] & np_src(tree, case, mask)
    return np.array([int(popc(p[i] & consider).sum()) for i in range(len(planes) - 1)]
                    + [int(popc(consider).sum())])


# -- (a) TopN phase 1 ----------------------------------------------------------

CASES = [(1, 9), (5, 9), (12, 17), (12, 1)]


@pytest.mark.parametrize("S,P_slots", CASES)
def test_topn_pool_plain_matches_plain_and_numpy(S, P_slots):
    case = make_case(S * 17 + P_slots, S, P_slots)
    mats = mats_of(*case)
    cand = cand_stack(S + 3 * P_slots, S)
    cmat = t32(cand)
    idx = np.array([3, 0, 4, 5, 2, 0, 1, 0], np.int32)
    rng = np.random.default_rng(S + P_slots)
    trees = [pool_tree(rng) for _ in range(4)] + dead_trees() + range_trees()
    for t in trees:
        for m in masks_of(rng, S):
            mt = torch.from_numpy(m)
            sc, cn = kernels.topn_tree_pool_plain(t, mats, mt, cmat, torch.from_numpy(idx))
            assert sc.dtype == cn.dtype == torch.int32 and sc.shape == (8, S)
            ws, wc = kernels.topn_tree_plain(t, mats, mt, cmat, torch.from_numpy(idx))
            ns, nc = np_topn(t, case, m, cand, idx)
            np.testing.assert_array_equal(sc.numpy(), ws.numpy())
            np.testing.assert_array_equal(cn.numpy(), wc.numpy())
            np.testing.assert_array_equal(sc.numpy(), ns)
            np.testing.assert_array_equal(cn.numpy(), nc)
            gs, gc = kernels.topn_tree(t, mats, mt, cmat, torch.from_numpy(idx))
            np.testing.assert_array_equal(gs.numpy(), ns)
            np.testing.assert_array_equal(gc.numpy(), nc)


def test_topn_pool_plain_over_a_dead_live_word_reads_no_leaf():
    S = 4
    case = make_case(3, S, 9)
    mats = mats_of(*case)
    mats[0] = None  # a stack row under a dead `and` is never read
    cmat = t32(cand_stack(4, S))
    t = ("and", ("rowb", 1, 2, 1), ("rowb", 1, 2, 0))
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    sc, cn = kernels.topn_tree_pool_plain(t, mats, torch.ones(S, dtype=torch.int32), cmat, idx)
    assert not sc.any() and not cn.any() and sc.shape == (3, S)
    cnt = torch.ones((3, S), dtype=torch.int32)
    vals, order = kernels.topn_full_tree_pool_plain(t, mats, torch.ones(S, dtype=torch.int32),
                                                    cmat, idx, cnt, 1, 3)
    assert vals.tolist() == [0, 0, 0] and order.tolist() == [0, 1, 2]


# -- (b) the full TopN: gated totals and the trim ----------------------------

@pytest.mark.parametrize("S,P_slots,K", [c + (8,) for c in CASES] + [(1, 9, 300), (2, 1, 300)])
def test_topn_full_pool_plain_matches_plain_and_numpy(S, P_slots, K):
    case = make_case(S * 7 + P_slots + K, S, P_slots)
    mats = mats_of(*case)
    cand = cand_stack(S + P_slots + K, S)
    cmat = t32(cand)
    rng = np.random.default_rng(K + S)
    idx = rng.integers(0, cand.shape[0], K).astype(np.int32)  # repeats tie
    host_cnt = rng.integers(0, 3 << 15, (K, S)).astype(np.int32)
    host_cnt[:, 0] = 0  # a row absent on one shard
    trees = [pool_tree(rng) for _ in range(2)] + dead_trees()[:1] + range_trees()[:1]
    for t in trees[::2] if K > 256 else trees:
        m = masks_of(rng, S)[2 if S > 1 else 0]
        ns, _ = np_topn(t, case, m, cand, idx)
        for thr in (1, 1 << 14):
            want = np_totals(ns, host_cnt, thr)
            args = (t, mats, torch.from_numpy(m), cmat, torch.from_numpy(idx),
                    torch.from_numpy(host_cnt), thr)
            got = kernels.topn_full_tree_pool_plain(*args, None)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(kernels.topn_full_tree_plain(*args, None).numpy(), want)
            for n_out in (1, 3, K):
                wv, wi = np_trim(want, n_out)
                gv, gi = kernels.topn_full_tree_pool_plain(*args, n_out)
                pv, pi = kernels.topn_full_tree_plain(*args, n_out)
                for g in (gv, gi, pv, pi):
                    assert g.dtype == torch.int32
                np.testing.assert_array_equal(gv.numpy(), wv)
                np.testing.assert_array_equal(gi.numpy(), wi)
                np.testing.assert_array_equal(pv.numpy(), wv)
                np.testing.assert_array_equal(pi.numpy(), wi)
                out = kernels.topn_full_tree(*args, n_out)
                np.testing.assert_array_equal(out.numpy(), np.stack([wv, wi]))


# -- (c) Sum -------------------------------------------------------------------

@pytest.mark.parametrize("S,P_slots", CASES)
def test_sum_pool_plain_matches_plain_and_numpy(S, P_slots):
    case = make_case(S * 5 + P_slots, S, P_slots)
    mats = mats_of(*case)
    bst = mats[3]
    rng = np.random.default_rng(3 * S + P_slots)
    trees = [pool_tree(rng) for _ in range(4)] + dead_trees() + range_trees()
    for i, t in enumerate(trees):
        for j, m in enumerate(masks_of(rng, S)):
            mt = torch.from_numpy(m)
            planes = (FULL, HOLED, (3,))[(i + j) % 3]  # (3,): depth 0, the count alone
            got = bsi.sum_tree_pool_plain(t, mats, mt, bst, planes)
            assert got.dtype == torch.int64 and got.shape == (len(planes),)
            want = np_sum(t, case, m, planes)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(bsi.sum_tree_plain(t, mats, mt, bst, planes).numpy(), want)
            np.testing.assert_array_equal(bsi.sum_tree(t, mats, mt, bst, planes).numpy(), want)


def test_pool_routes_on_cpu(monkeypatch):
    """On CPU tensors the wrappers send a pool tree to the pool plain
    versions and any other tree to the whole-row ones."""
    calls = []
    for mod, name in ((kernels, "topn_tree_pool_plain"), (kernels, "topn_full_tree_pool_plain"),
                      (bsi, "sum_tree_pool_plain"), (kernels, "topn_tree_plain"),
                      (kernels, "topn_full_tree_plain"), (bsi, "sum_tree_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    S = 3
    case = make_case(1, S, 9)
    mats = mats_of(*case)
    cmat, idx = t32(cand_stack(2, S)), torch.tensor([0, 2], dtype=torch.int32)
    m = torch.ones(S, dtype=torch.int32)
    cnt = torch.ones((2, S), dtype=torch.int32)
    for t in (("and", ("rowb", 1, 2, 0), ("row", 0, 1)), ("and", ("row", 0, 0), ("row", 0, 1))):
        kernels.topn_tree(t, mats, m, cmat, idx)
        kernels.topn_full_tree(t, mats, m, cmat, idx, cnt, 1, 2)
        bsi.sum_tree(t, mats, m, mats[3], FULL)
    bsi.sum_tree(None, mats, m, mats[3], FULL)
    assert calls == ["topn_tree_pool_plain", "topn_full_tree_pool_plain", "sum_tree_pool_plain",
                     "topn_tree_plain", "topn_full_tree_plain", "sum_tree_plain",
                     "sum_tree_plain"]


def test_pool_wrappers_refuse_cpu_tensors():
    """The K3P and K6P wrappers launch on the card or raise: a CPU tensor
    is refused before anything is launched."""
    S = 2
    mats = mats_of(*make_case(2, S, 9))
    code = kernels.compile_prog(("rowb", 1, 2, 0))
    with pytest.raises(ValueError):
        kernels.score_rows_pool_cuda(code, mats, torch.ones(S, dtype=torch.int32),
                                     t32(cand_stack(1, S)), None)
    with pytest.raises(ValueError):
        bsi.sum_tree_pool_cuda(code, mats, torch.ones(S, dtype=torch.int32), mats[3], FULL)
    with pytest.raises(ValueError):
        bsi.sum_tree_pool_cuda(None, mats, torch.ones(S, dtype=torch.int32), mats[3], FULL)


# -- (d) against the JAX package's topn_tree, topn_full_tree and sum_tree -----

def jax_tree(mesh, tree, case):
    """The reference form of a tree over the case's numpy operands: stack
    rows as (operand, scalar operand), pool rows as ("rowb", pool operand,
    slot vector operand), range leaves over gathered planes with their
    predicate bits, zero leaves a zero stack.  (prog, operands, specs)."""
    pool, table, dense, bst = case
    S = dense.shape[1]
    operands, specs = [], []

    def add(arr, spec):
        operands.append(put_global(mesh, arr, spec))
        specs.append(spec)
        return len(operands) - 1

    i_dense, i_pool = add(dense, P(None, SHARD_AXIS)), add(pool, P(None, SHARD_AXIS))
    i_bsi, i_zero = add(bst, P(None, SHARD_AXIS)), add(np.zeros((1, S, W), np.uint32),
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

    return conv(tree), operands, specs


def jax_mask(mesh, mask):
    return put_global(mesh, np.where(mask[:, None] != 0, 0xFFFFFFFF, 0).astype(np.uint32),
                      P(SHARD_AXIS))


JAX_CASES = [(1, 9), (12, 17), (5, 1)]


@pytest.mark.parametrize("seed", range(3))
def test_pool_aggregates_match_reference(mesh1, seed):  # noqa: F811
    S, P_slots = JAX_CASES[seed]
    case = make_case(60 + seed, S, P_slots)
    mats = mats_of(*case)
    cand = cand_stack(70 + seed, S)
    cmat = t32(cand)
    rng = np.random.default_rng(80 + seed)
    idx = np.array([3, 0, 4, 5, 2, 1, 0, 0], np.int32)  # ties, an empty row, pads
    host_cnt = rng.integers(0, 3 << 15, (len(idx), S)).astype(np.int32)
    trees = [pool_tree(rng), range_trees()[seed], dead_trees()[seed]]
    for t in trees:
        m = (rng.random(S) < 0.7).astype(np.int32)
        mt = torch.from_numpy(m)
        jprog, ops, specs = jax_tree(mesh1, t, case)
        jcmat = put_global(mesh1, cand, P(None, SHARD_AXIS))
        jscores, jcounts = jk.topn_tree(mesh1, jprog, tuple(specs), jax_mask(mesh1, m), jcmat,
                                        put_global(mesh1, idx, P()), *ops)
        scores, counts = kernels.topn_tree(t, mats, mt, cmat, torch.from_numpy(idx))
        np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        thr = 1 << 14
        for n_out in (None, 3):
            jout = jk.topn_full_tree(
                mesh1, jprog, (P(),) + tuple(specs), n_out, None, jax_mask(mesh1, m), jcmat,
                put_global(mesh1, host_cnt, P(None, SHARD_AXIS)), put_global(mesh1, np.int32(thr),
                                                                             P()),
                put_global(mesh1, idx, P()), *ops)
            out = kernels.topn_full_tree(t, mats, mt, cmat, torch.from_numpy(idx),
                                         torch.from_numpy(host_cnt), thr, n_out)
            if n_out is None:
                np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
            else:
                np.testing.assert_array_equal(out.numpy(), np.stack([np.asarray(j) for j in jout]))
        for planes in (FULL, HOLED):
            jcounts, jn = jk.sum_tree(mesh1, jprog, tuple(specs), ("idx", planes),
                                      jax_mask(mesh1, m),
                                      put_global(mesh1, case[3], P(None, SHARD_AXIS)), *ops)
            got = bsi.sum_tree(t, mats, mt, mats[3], planes)
            np.testing.assert_array_equal(got.numpy(),
                                          np.append(np.asarray(jcounts), int(np.asarray(jn))))


# -- (e) engine level: partial stacks beside the reference MeshEngine --------

N_SHARDS = 3
F_ROWS = 16


def build_aggregates(holder):
    """Index i over 3 shards: field f of 16 rows whose bits sit in 2 to 4
    of 8 blocks of each shard (a different set per row, so the pool rows'
    live words differ and overlap), field g of 2 rows spread over every block, field rt of
    4 rows (TopN candidates, a small full stack) and v, an int field
    0..15 on columns in and out of f's rows."""
    from pilosa_tpu.core.holder import Holder as JHolder

    rng = np.random.default_rng(21)
    idx = holder.create_index("i")
    rows, cols = [], []
    for r in range(F_ROWS):
        blocks = rng.choice(8, 4, replace=False) * 7  # rows share some of 8 blocks
        for s in range(N_SHARDS):
            for b in blocks[: 2 + s % 3]:
                c = rng.choice(16384, 3000, replace=False) + int(b) * 16384 + (s << 20)
                rows += [r] * len(c)
                cols += c.tolist()
    idx.create_field("f").import_bulk(rows, cols)
    f_cols = np.asarray(cols)
    for name, n_rows, n_bits in (("g", 2, 3000), ("rt", 4, 40000)):
        rows, cols = [], []
        for r in range(n_rows):
            c = rng.choice(N_SHARDS << 20, n_bits + 5000 * r, replace=False)
            rows += [r] * len(c)
            cols += c.tolist()
        idx.create_field(name).import_bulk(rows, cols)
    if isinstance(holder, JHolder):
        from pilosa_tpu.core.field import FieldOptions
    else:
        from pilosa_tpu_torch.core.field import FieldOptions
    vcols = np.unique(np.concatenate([rng.choice(N_SHARDS << 20, 20000, replace=False),
                                      rng.choice(f_cols, 20000, replace=False)]))
    idx.create_field("v", FieldOptions(type="int", min=0, max=15)).import_values(
        vcols.tolist(), (vcols % 16).tolist())
    return idx


def plain(res):
    """Query results as Python values comparable across the two packages:
    a ValCount as (val, count), a TopN pair as (id, count)."""
    if isinstance(res, list):
        return [plain(r) for r in res]
    if hasattr(res, "val"):
        return (res.val, res.count)
    if hasattr(res, "id") and hasattr(res, "count"):
        return (res.id, res.count)
    return res


AGG_QUERIES = [
    "TopN(rt, Row(f=10), n=3)",
    "TopN(rt, Intersect(Row(f=10), Row(f=11)), n=2)",
    "TopN(rt, Union(Row(f=10), Row(g=0)), n=4)",
    "TopN(rt, Row(f=11), n=2, threshold=100)",
    "TopN(rt, Difference(Row(f=10), Row(g=1)), ids=[0, 2, 3])",
    "Sum(Row(f=10), field=v)",
    "Sum(Intersect(Row(f=10), Row(f=11)), field=v)",
    "Sum(Union(Row(f=11), Row(g=0)), field=v)",
    "Sum(Difference(Row(f=10), Range(v > 7)), field=v)",
]


@pytest.mark.parametrize("lane", ["full", "two_phase"])
def test_engine_aggregates_over_pool_rows_match_reference(mesh1, monkeypatch, lane):  # noqa: F811
    calls = []
    for mod, name in ((kernels, "topn_tree_pool_plain"), (kernels, "topn_full_tree_pool_plain"),
                      (bsi, "sum_tree_pool_plain")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _n=name):
            calls.append(_n)
            return _fn(*a)

        monkeypatch.setattr(mod, name, spy)
    sides = make_sides(mesh1, 40 * ROW_SHARD + 4096, build=build_aggregates)
    try:
        if lane == "two_phase":
            for s in sides:  # the JAX engine reads the instance attribute too
                s.engine.MAX_TOPN_CANDIDATES = 2
        for s in sides:
            for q in ("Count(Intersect(Row(g=0), Row(g=1)))", "TopN(rt, Row(g=0), n=1)",
                      "Sum(Row(g=0), field=v)"):
                s.q(q)  # g, rt and v: full stacks
            for q in AGG_QUERIES:
                s.q(q)  # cold: f misses and requests its rows
            s.flush()
            for q in AGG_QUERIES:
                s.q(q)
            s.flush()
        fb = sides[1].engine.host_fallbacks
        calls.clear()
        for shards in (None, [0, 2], [1]):
            for q in AGG_QUERIES:
                got = [plain(s.ex.execute("i", q, shards=shards).results) for s in sides]
                want = plain(sides[1].host.execute("i", q, shards=shards).results)
                assert got[0] == got[1] == want, (q, shards)
        assert sides[1].engine.host_fallbacks == fb  # warm: every answer on the device
        st = sides[1].stack("f")
        assert st.partial and st.pool and {10, 11} <= set(st.row_index)
        for f in ("g", "rt"):
            assert not sides[1].stack(f).partial
        n_topn = sum(q.startswith("TopN") for q in AGG_QUERIES)
        want_topn = ("topn_full_tree_pool_plain" if lane == "full" else "topn_tree_pool_plain")
        assert calls.count(want_topn) >= 3 * n_topn
        assert calls.count("sum_tree_pool_plain") == 3 * (len(AGG_QUERIES) - n_topn)
    finally:
        for s in sides:
            s.engine.close()
