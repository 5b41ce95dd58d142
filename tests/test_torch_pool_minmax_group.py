"""K7P's Min/Max and K8P's GroupBy over pool filters on the CPU: the plain
versions that read only a filter tree's live blocks
(``bsi.minmax_tree_pool_plain``, ``groupby.groupn_tree_pool_plain``)
against the whole-row plain versions, a numpy oracle, the JAX package's
``minmax_tree`` and ``groupn_tree`` (``pilosa_tpu/parallel/kernels.py:512``
and ``:707``, through ``apply_prog``'s ``rowb`` leaf) on a one-device CPU
mesh, F1P's pool rows as their filter in a fused drain, and at engine level
against the reference ``MeshEngine`` with partial stacks, across shard sets
and writes.  Values, counts and combination counts are integers: exact
agreement (tolerance 0).  The CUDA kernels run only on the card
(chip_smoke.py holds them against these plain versions there); here the
wrappers take the plain versions because the tensors are on the CPU."""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pilosa_tpu.parallel import kernels as jk
from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global
from pilosa_tpu_torch.parallel import bsi, groupby, kernels

from test_torch_pool_aggregates import (FULL, HOLED, N_SHARDS, build_aggregates, dead_trees,
                                        jax_mask, jax_tree, masks_of, plain, pool_tree,
                                        range_trees)
from test_torch_pool_count import W, make_case, mats_of, mesh1  # noqa: F401
from test_torch_residency import ROW_SHARD, make_sides


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch ops: under several test
    workers on a few cores a thread pool per worker contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rb(r):
    """Row r of the case's pool (mats[1]) through its slot table (mats[2])."""
    return ("rowb", 1, 2, r)


def shaped_trees():
    """Pool filters of the shapes a segment can take: xor and andnot over
    pool rows, a range leaf beside a pool row, and a full live word (a
    stack row under an or)."""
    return [("xor", rb(0), rb(2), rb(3)), ("andnot", rb(2), rb(0)),
            ("andnot", ("xor", rb(4), ("row", 0, 1)), rb(5)),
            ("and", ("range", "lt", 3, FULL, 5, 0), rb(3)),
            ("or", rb(2), ("row", 0, 1))]


# K8's shapes: the register form (4 rows, then 2) and the walk (a second
# field of 3 rows; three fields), rows of -1 among them.
GROUP_SHAPES = [("registers", [[0, 2, 1, -1], [3, 1]]), ("registers", [[3, 0]]),
                ("walk", [[0, 2, 1], [3, -1, 0]]), ("walk", [[1, 3, 0], [0, 2, 3], [2, -1]])]
CASES = [(1, 9), (5, 9), (12, 17), (4, 1)]


# -- numpy oracles -----------------------------------------------------------

def np_filter(tree, case, mask):
    from test_torch_pool_count import np_eval

    return np.where(mask[:, None] != 0, np_eval(tree, *case), 0).astype(np.uint32)


def bits(words):
    """uint32[S, W] -> bool[S, 32 W], bit j of word w at 32 w + j."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1, bitorder="little")


def np_minmax(tree, case, mask, planes, is_min):
    """(values int[S], counts int[S]): per shard the least (Min) or
    greatest (Max) value among notnull & filter & mask and how many
    columns hold it; (0, 0) where no column is considered."""
    S = case[2].shape[1]
    bst = case[3]
    p = [bst[i] if i >= 0 else np.zeros((S, W), np.uint32) for i in planes]
    consider = p[-1] & np_filter(tree, case, mask)
    vals, counts = np.zeros(S, np.int64), np.zeros(S, np.int64)
    for s in range(S):
        words = np.flatnonzero(consider[s])  # unpack the considered words only
        sel = np.flatnonzero(bits(consider[s][words]))
        if not sel.size:
            continue
        v = np.zeros(sel.size, np.int64)
        for i in range(len(planes) - 1):
            v |= bits(p[i][s][words])[sel].astype(np.int64) << i
        vals[s] = v.min() if is_min else v.max()
        counts[s] = int((v == vals[s]).sum())
    return vals, counts


def np_group(tree, case, mask, lists):
    """int[K_1 * ... * K_n], row-major: popcount(filter & mask & rows)
    over every shard; a row of -1 counts zero."""
    dense = case[2]
    f = np_filter(tree, case, mask)
    rows = [[dense[r] if r >= 0 else np.zeros_like(f) for r in rl] for rl in lists]
    out = []
    for combo in np.ndindex(*(len(rl) for rl in lists)):
        acc = f
        for level, k in enumerate(combo):
            acc = acc & rows[level][k]
        out.append(int(np.bitwise_count(acc).sum()))
    return np.array(out)


def all_trees(rng):
    return [pool_tree(rng) for _ in range(3)] + dead_trees() + range_trees() + shaped_trees()


# -- (a) Min and Max -----------------------------------------------------------

@pytest.mark.parametrize("S,P_slots", CASES)
def test_minmax_pool_plain_matches_plain_and_numpy(S, P_slots):
    case = make_case(S * 11 + P_slots, S, P_slots)
    mats = mats_of(*case)
    bst = mats[3]
    rng = np.random.default_rng(7 * S + P_slots)
    for i, t in enumerate(all_trees(rng)):
        live = kernels.live_blocks(t, mats, "cpu")
        for j, m in enumerate(masks_of(rng, S)):
            mt = torch.from_numpy(m)
            planes = (FULL, HOLED, (3,))[(i + j) % 3]  # (3,): depth 0, the count alone
            for is_min in (True, False):
                got = bsi.minmax_tree_pool_plain(t, mats, mt, bst, planes, is_min)
                assert all(g.dtype == torch.int64 and g.shape == (S,) for g in got)
                want = np_minmax(t, case, m, planes, is_min)
                whole = bsi.minmax_tree_plain(t, mats, mt, bst, planes, is_min)
                for g, w, h in zip(got, want, whole):
                    np.testing.assert_array_equal(g.numpy(), w)
                    np.testing.assert_array_equal(h.numpy(), w)
                if not live.any():  # a zero live word: every shard (0, 0)
                    assert not got[0].any() and not got[1].any()


def test_minmax_pool_plain_over_a_dead_live_word_reads_no_leaf():
    S = 4
    mats = mats_of(*make_case(3, S, 9))
    mats[0] = None  # a stack row under a dead `and` is never read
    for t in dead_trees()[:2]:
        vals, counts = bsi.minmax_tree_pool_plain(t, mats, torch.ones(S, dtype=torch.int32),
                                                  mats[3], FULL, True)
        assert vals.tolist() == counts.tolist() == [0] * S


# -- (b) GroupBy ---------------------------------------------------------------

@pytest.mark.parametrize("S,P_slots", CASES)
def test_groupn_pool_plain_matches_plain_and_numpy(S, P_slots):
    case = make_case(S * 13 + P_slots, S, P_slots)
    mats = mats_of(*case)
    dense = mats[0]
    rng = np.random.default_rng(5 * S + P_slots)
    for i, t in enumerate(all_trees(rng)):
        for j, m in enumerate(masks_of(rng, S)):
            mt = torch.from_numpy(m)
            form, lists = GROUP_SHAPES[(i + j) % len(GROUP_SHAPES)]
            assert groupby.groupn_plan([len(r) for r in lists])[0] == form
            fields = [dense] * len(lists)
            got = groupby.groupn_tree_pool_plain(t, mats, mt, fields, lists)
            assert got.dtype == torch.int64
            want = np_group(t, case, m, lists)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                groupby.groupn_tree_plain(t, mats, mt, fields, lists).numpy(), want)


def test_groupn_pool_plain_edges():
    """A dead live word counts nothing and reads no leaf; an empty row
    list gives no combination."""
    S = 3
    mats = mats_of(*make_case(4, S, 9))
    dense = mats[0]
    mask = torch.ones(S, dtype=torch.int32)
    mats[0] = None
    got = groupby.groupn_tree_pool_plain(dead_trees()[1], mats, mask, [dense, dense],
                                         [[0, 1], [2, 3, 1]])
    assert got.tolist() == [0] * 6
    mats[0] = dense
    assert groupby.groupn_tree_pool_plain(rb(0), mats, mask, [dense], [[]]).tolist() == []


# -- (c) routing, and the wrappers on the card only ----------------------------

def test_pool_filters_route_to_the_pool_plain_versions(monkeypatch):
    calls = []
    for mod, name in ((bsi, "minmax_tree_pool_plain"), (bsi, "minmax_tree_plain"),
                      (groupby, "groupn_tree_pool_plain"), (groupby, "groupn_tree_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    S = 3
    mats = mats_of(*make_case(1, S, 9))
    m = torch.ones(S, dtype=torch.int32)
    for t in (("and", rb(0), ("row", 0, 1)), ("and", ("row", 0, 0), ("row", 0, 1)), None):
        bsi.minmax_tree(t, mats, m, mats[3], FULL, True)
        groupby.groupn_tree(t, mats, m, [mats[0]], [[0, 1]])
    assert calls == ["minmax_tree_pool_plain", "groupn_tree_pool_plain", "minmax_tree_plain",
                     "groupn_tree_plain", "minmax_tree_plain", "groupn_tree_plain"]


def test_pool_wrappers_refuse_cpu_tensors():
    """K7P and K8P launch on the card or raise: a CPU tensor, or no
    filter, is refused before anything is launched."""
    S = 2
    mats = mats_of(*make_case(2, S, 9))
    code = kernels.compile_prog(rb(0))
    mask = torch.ones(S, dtype=torch.int32)
    for c in (code, None):
        with pytest.raises(ValueError):
            bsi.minmax_tree_pool_cuda(c, mats, mask, mats[3], FULL, True)
        with pytest.raises(ValueError):
            groupby.groupn_tree_pool_cuda(c, mats, mask, [mats[0]], [[0, 1]])
    assert bsi.minmax_tree_pool_cuda.launches == 0
    assert groupby.groupn_tree_pool_cuda.launches == 0


def test_fused_minmax_and_group_edges_read_f1p_pool_rows(monkeypatch):
    """After F1P each Min/Max and group edge reads its slot as the pool row
    ("rowb", 0, 1, i) over [pool, table] through K7P's and K8P's plain
    versions, and the drain equals fused_tree_plain's."""
    S = 4
    case = make_case(21, S, 9)
    mats = mats_of(*case)
    masks = [torch.ones(S, dtype=torch.int32), torch.tensor([0, 1, 1, 0], dtype=torch.int32)]
    slots = (("and", rb(0), ("row", 0, 1)), ("or", ("mref", 0), rb(2)),
             ("xor", rb(3), rb(2)), ("and", rb(2), ("range", "gt", 3, FULL, 3, 0)),
             ("and", rb(1), rb(0)))
    aggs = [("minmax", 1, 0, 3, FULL, True), ("minmax", 2, 1, 3, HOLED, False),
            ("minmax", 4, 0, 3, FULL, True), ("group", 3, 1, (0,), ((0, 1, 3),)),
            ("group", 1, 0, (0, 0), ((2, 1, 0), (0, 3, -1))), ("group", 4, 1, (0,), ((1,),))]
    spec = kernels.FusedSpec(slots, [(0, 0), (2, 1)], aggs)
    calls = []
    for mod, name in ((bsi, "minmax_tree_pool_plain"), (groupby, "groupn_tree_pool_plain")):
        fn = getattr(mod, name)

        def spy(prog, mats_, *a, _fn=fn, _n=name):
            calls.append((_n, prog, len(mats_)))
            return _fn(prog, mats_, *a)

        monkeypatch.setattr(mod, name, spy)
    got = kernels.fused_tree_pool_plain(spec, mats, masks)
    want = kernels.fused_tree_plain(spec, mats, masks)
    assert len(got) == len(want) == 1 + 2 * 3 + 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rows = {j: i for i, j in enumerate(spec.mat_slots)}
    assert sorted(c[0] for c in calls) == ["groupn_tree_pool_plain"] * 3 + [
        "minmax_tree_pool_plain"] * 3
    for name, j in (("minmax_tree_pool_plain", 1), ("groupn_tree_pool_plain", 3)):
        assert (name, ("rowb", 0, 1, rows[j]), 2) in calls
    # The dead slot (row 1 is all zero): (0, 0) on every shard, no count.
    assert not got[5].any() and not got[6].any() and not got[9].any()


# -- (d) against the JAX package's minmax_tree and groupn_tree -----------------

def jax_minmax(mesh, tree, case, mask, planes, is_min):
    """(values, counts) of the reference minmax_tree, its (hi, lo) value
    halves joined."""
    jprog, ops, specs = jax_tree(mesh, tree, case)
    hi, lo, counts = jk.minmax_tree(mesh, jprog, tuple(specs), ("idx", tuple(planes)), is_min,
                                    jax_mask(mesh, mask),
                                    put_global(mesh, case[3], P(None, SHARD_AXIS)), *ops)
    vals = (np.asarray(hi).astype(np.int64) << 31) | np.asarray(lo).astype(np.int64)
    return vals, np.asarray(counts).astype(np.int64)


def jax_group(mesh, tree, case, mask, lists):
    """The reference groupn_tree over the case's dense stack, each field's
    rows a traced index vector."""
    jprog, ops, specs = jax_tree(mesh, tree, case)
    idx = [put_global(mesh, np.asarray(rows, np.int32), P()) for rows in lists]
    dense = put_global(mesh, case[2], P(None, SHARD_AXIS))
    out = jk.groupn_tree(mesh, jprog, (P(),) * len(lists) + tuple(specs), (None,) * len(lists),
                         jax_mask(mesh, mask), *[dense] * len(lists), *idx, *ops)
    return np.asarray(out).reshape(-1).astype(np.int64)


@pytest.mark.parametrize("seed", range(3))
def test_pool_minmax_and_group_match_reference(mesh1, seed):  # noqa: F811
    S, P_slots = ((1, 9), (12, 17), (5, 1))[seed]
    case = make_case(90 + seed, S, P_slots)
    mats = mats_of(*case)
    rng = np.random.default_rng(95 + seed)
    trees = [pool_tree(rng), range_trees()[seed], dead_trees()[seed], shaped_trees()[seed],
             shaped_trees()[3 + seed % 2]]
    # The reference maps a row of -1 to row 0: lists of rows that exist.
    shapes = [[[0, 2, 1, 3], [3, 1]], [[1, 3, 0], [0, 2, 3]]]
    for i, t in enumerate(trees):
        m = (rng.random(S) < 0.7).astype(np.int32)
        mt = torch.from_numpy(m)
        planes = (FULL, HOLED)[i % 2]
        for is_min in (True, False):
            vals, counts = bsi.minmax_tree(t, mats, mt, mats[3], planes, is_min)
            jvals, jcounts = jax_minmax(mesh1, t, case, m, planes, is_min)
            np.testing.assert_array_equal(counts.numpy(), jcounts)
            np.testing.assert_array_equal(vals.numpy()[jcounts > 0], jvals[jcounts > 0])
        lists = shapes[i % 2]
        got = groupby.groupn_tree(t, mats, mt, [mats[0]] * len(lists), lists)
        np.testing.assert_array_equal(got.numpy(), jax_group(mesh1, t, case, m, lists))


# -- (e) engine level: partial stacks beside the reference MeshEngine ----------

def build_groups(holder):
    """build_aggregates' index and a full field h of 3 rows, so that a
    GroupBy over rt x h (4 x 3) takes K8's walk."""
    idx = build_aggregates(holder)
    rng = np.random.default_rng(33)
    rows, cols = [], []
    for r in range(3):
        c = rng.choice(N_SHARDS << 20, 30000 + 7000 * r, replace=False)
        rows += [r] * len(c)
        cols += c.tolist()
    idx.create_field("h").import_bulk(rows, cols)
    return idx


SEG = "Intersect(Row(f=10), Row(f=11))"
FILTERS = ["Row(f=10)", SEG, "Union(Row(f=11), Row(g=0))", "Xor(Row(f=10), Row(f=11))",
           "Difference(Row(f=10), Range(v > 7))"]
MINMAX_QUERIES = [f"{op}({flt}, field=v)" for flt in FILTERS for op in ("Min", "Max")]
GROUP_QUERIES = [f"GroupBy(Rows(field=rt), filter={flt})" for flt in FILTERS] + [
    f"GroupBy(Rows(field=rt), Rows(field=g), filter={SEG})",
    f"GroupBy(Rows(field=rt), Rows(field=h), filter=Union({SEG}, Row(f=12)))"]


def group_plain(res):
    """plain() with a GroupBy's groups as ((field, row), ...), count."""
    if isinstance(res, list) and res and hasattr(res[0], "group"):
        return [(tuple((g.field, g.row_id) for g in r.group), r.count) for r in res]
    if isinstance(res, list):
        return [group_plain(r) for r in res]
    return plain(res)


def drain_entries(pql):
    """A drain with Min, Max and group edges over a pool-row slot shared
    with a Count."""
    c = lambda q: pql.parse(q).calls[0]  # noqa: E731
    return [({"kind": "count", "call": c(SEG)}, [0, 1, 2]),
            ({"kind": "min", "field": "v", "filter": c(SEG)}, [0, 1, 2]),
            ({"kind": "max", "field": "v", "filter": c(f"Union({SEG}, Row(f=12))")}, [0, 2]),
            ({"kind": "group", "fields": ["rt"], "rows": [[0, 1, 2, 3]], "filter": c(SEG)},
             [0, 1, 2]),
            ({"kind": "group", "fields": ["rt", "h"], "rows": [[0, 1, 2, 3], [0, 1, 2]],
              "filter": c(f"Union({SEG}, Row(f=12))")}, [1, 2])]


def drain_plain(res):
    return [r.tolist() if isinstance(r, np.ndarray) else plain(r) for r in res]


def test_engine_minmax_and_groupby_over_pool_rows_match_reference(mesh1, monkeypatch):  # noqa: F811
    calls = []
    for mod, name in ((bsi, "minmax_tree_pool_plain"), (groupby, "groupn_tree_pool_plain")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _n=name):
            calls.append(_n)
            return _fn(*a)

        monkeypatch.setattr(mod, name, spy)
    sides = make_sides(mesh1, 46 * ROW_SHARD + 4096, build=build_groups)
    queries = MINMAX_QUERIES + GROUP_QUERIES
    try:
        for s in sides:
            for q in ("Count(Intersect(Row(g=0), Row(g=1)))", "Sum(Row(g=0), field=v)",
                      "GroupBy(Rows(field=rt), Rows(field=h))"):
                s.q(q)  # g, v, rt and h: full stacks
            for q in queries:
                s.q(q)  # cold: f misses and requests its rows
            s.flush()
        writes = ["Set(5, f=10)Set(5, f=11)Set(5, rt=2)",
                  f"Set({(2 << 20) + 7}, f=10)Set({(2 << 20) + 7}, f=11)Set({(2 << 20) + 7}, v=3)",
                  f"Clear(5, f=11)Set({(1 << 20) + 40 * 16384 + 3}, f=12)Set(9, h=1)"]
        for rnd, write in enumerate(writes):
            for s in sides:
                s.ex.execute("i", write)
                for q in queries:
                    s.q(q)  # a write may grow the working set: a miss, then promoted
                s.flush()
            fb = sides[1].engine.host_fallbacks
            calls.clear()
            for shards in (None, [0, 2], [1]):
                for q in queries:
                    got = [group_plain(s.ex.execute("i", q, shards=shards).results) for s in sides]
                    want = group_plain(sides[1].host.execute("i", q, shards=shards).results)
                    assert got[0] == got[1] == want, (rnd, q, shards)
            assert sides[1].engine.host_fallbacks == fb  # warm: every answer on the device
            assert calls.count("minmax_tree_pool_plain") == 3 * len(MINMAX_QUERIES)
            assert calls.count("groupn_tree_pool_plain") == 3 * len(GROUP_QUERIES)
            st = sides[1].stack("f")
            assert st.partial and st.pool and {10, 11, 12} <= set(st.row_index)
            for f in ("g", "rt", "h"):
                assert not sides[1].stack(f).partial
        # A fused drain with Min, Max and group edges over the pool-row slot
        # (a first drain may miss while its working set is promoted).
        host = sides[1].host
        got = []
        for s in sides:
            for _ in range(3):
                try:
                    got.append(drain_plain(s.engine.fused_many("i", drain_entries(s.pql))))
                    break
                except Exception as e:  # noqa: BLE001 — either package's ResidencyMiss
                    assert type(e).__name__ == "ResidencyMiss", e
                    s.flush()
        assert len(got) == 2
        want = [host.execute("i", f"Count({SEG})").results[0],
                plain(host.execute("i", f"Min({SEG}, field=v)").results[0]),
                plain(host.execute("i", f"Max(Union({SEG}, Row(f=12)), field=v)",
                                   shards=[0, 2]).results[0])]
        for q, shards, dims in ((f"GroupBy(Rows(field=rt), filter={SEG})", None, (4,)),
                                (f"GroupBy(Rows(field=rt), Rows(field=h), filter=Union({SEG}, "
                                 "Row(f=12)))", [1, 2], (4, 3))):
            counts = np.zeros(dims, np.int64)
            for r in host.execute("i", q, shards=shards).results[0]:
                counts[tuple(g.row_id for g in r.group)] = r.count
            want.append(counts.tolist())
        assert got[0] == got[1] == want
    finally:
        for s in sides:
            s.engine.close()
